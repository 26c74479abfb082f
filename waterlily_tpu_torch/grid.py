"""Staggered-grid index algebra and whole-array stencil primitives.

PyTorch counterpart of `waterlily_tpu.grid`, with the same conventions
(all 0-based):

- a scalar field has shape ``S = tuple(N_d + 2)``: the interior ``N`` plus
  one ghost cell on each side;
- a vector field has shape ``(D, *S)``, component axis first;
- the interior of a field is the slice ``[1:-1]`` along every spatial axis;
- the centre of cell ``I`` sits at ``I - 0.5``; face ``i`` of that cell at
  ``I - 0.5 - 0.5*e_i``.

Every function is a plain tensor expression on the device of its input.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "shift", "plane", "interior", "interior_view", "set_interior",
    "interior_mask", "mask_interior", "pad_interior", "axis_coord",
    "loc_grid", "apply_field", "interp", "inside_count", "field_dot", "l2",
    "linf", "band_box_start", "window", "put_window",
]


def shift(f: torch.Tensor, axis: int, off: int) -> torch.Tensor:
    """Return ``g`` with ``g[I] = f[I + off*e_axis]`` (circular wrap)."""
    if off == 0:
        return f
    return torch.roll(f, -off, dims=axis)


def plane(ndim: int, axis: int, idx) -> tuple:
    """Index tuple selecting the hyperplane ``axis == idx`` of an ndim
    array."""
    return tuple(idx if a == axis else slice(None) for a in range(ndim))


def interior(ndim: int, off=None, lead: int = 0) -> tuple:
    """Index tuple for the interior ``[1:-1]`` of the ``ndim`` spatial axes,
    optionally shifted by ``off`` (one integer in [-1, 1] per axis), after
    ``lead`` full leading (component) axes."""
    off = (0,) * ndim if off is None else off
    assert all(abs(o) <= 1 for o in off), (
        f"interior offset {off} exceeds the 1-cell ghost ring")
    return (slice(None),) * lead + tuple(
        slice(1 + o, None if (-1 + o) == 0 else -1 + o) for o in off)


def interior_view(a: torch.Tensor, D: int, off=None) -> torch.Tensor:
    """Interior of the trailing ``D`` spatial axes of ``a`` (a view)."""
    return a[interior(D, off, lead=a.ndim - D)]


def set_interior(a: torch.Tensor, D: int, value) -> torch.Tensor:
    """A copy of ``a`` with ``value`` written into the interior of its
    trailing ``D`` spatial axes (``a`` itself is left as it was)."""
    out = a.clone()
    out[interior(D, lead=a.ndim - D)] = value
    return out


def axis_coord(shape: tuple, axis: int, device=None) -> torch.Tensor:
    """Integer coordinate along ``axis``, broadcastable to ``shape``."""
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return torch.arange(shape[axis], device=device).reshape(view)


def interior_mask(S: tuple, device=None) -> torch.Tensor:
    """Boolean mask of the interior cells of a ghost-padded shape."""
    m = None
    for d in range(len(S)):
        k = axis_coord(S, d, device)
        md = (k >= 1) & (k <= S[d] - 2)
        m = md if m is None else m & md
    return m.expand(S)


def mask_interior(a: torch.Tensor, D: int | None = None) -> torch.Tensor:
    """Zero the ghost cells of ``a`` (trailing ``D`` spatial axes)."""
    D = a.ndim if D is None else D
    return torch.where(interior_mask(a.shape[a.ndim - D:], a.device), a, 0.0)


def inside_count(S: tuple) -> int:
    """Number of interior cells of a ghost-padded scalar shape."""
    return math.prod(s - 2 for s in S)


def field_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """⟨a, b⟩ over whole fields, as multiply + reduce (a 0-d tensor)."""
    return torch.sum(a * b)


def pad_interior(v: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """Zero-ghost pad of an interior-shaped array (trailing ``ndim-lead``
    axes)."""
    D = v.ndim - lead
    return torch.nn.functional.pad(v, (1, 1) * D)


def band_box_start(mask: torch.Tensor, box_shape: tuple) -> torch.Tensor:
    """Lower corner of a ``box_shape`` window covering the True cells of
    ``mask``, as a (D,) int64 tensor on the mask's device.

    ``start`` addresses a ``box_shape + 2`` halo'd window whose box cells
    are ``[start+1, start+1+box_shape)`` per axis, with one in-box margin
    cell below the band (``start+2``): the Poisson row under the band reads
    the band's face coefficient.  ``start`` is clamped to
    ``S - box_shape - 2`` so the halo'd window stays in bounds; an empty
    mask gives 0."""
    D = mask.ndim
    starts = []
    for d in range(D):
        proj = torch.any(mask, dim=tuple(i for i in range(D) if i != d))
        lo = torch.argmax(proj.to(torch.uint8))  # first True cell, 0 if none
        starts.append(torch.clamp(lo - 2, 0, mask.shape[d] - box_shape[d] - 2))
    return torch.stack(starts)


def _window_slices(start, shape: tuple, lead: int, off: int) -> tuple:
    """The index tuple of a window at a host-int corner."""
    return (slice(None),) * lead + tuple(
        slice(s + off, s + off + w) for s, w in zip(start, shape))


def _window_vectors(start: torch.Tensor, shape: tuple, off: int,
                    ndim: int) -> list:
    """The index vectors ``start[d] + off + arange(shape[d])`` of a window
    of the trailing ``len(shape)`` axes of an ``ndim``-axis array, each
    shaped to broadcast over the window."""
    D = len(shape)
    out = []
    for d in range(D):
        view = [1] * ndim
        view[ndim - D + d] = shape[d]
        out.append((start[d] + off + torch.arange(
            shape[d], device=start.device)).reshape(view))
    return out


def window(a: torch.Tensor, start, shape: tuple, lead: int = 0,
           off: int = 1) -> torch.Tensor:
    """The cells ``[start+off, start+off+shape)`` of ``a`` per spatial
    axis, after ``lead`` full leading axes: with `band_box_start`'s corner
    ``off=1`` gives the box cells, ``off=0`` with ``shape + 2`` the halo'd
    window, ``off=0`` on an interior-shaped array its box.
    ``start`` is host ints (a view, the single run's form) or a ``(D,)``
    integer tensor (a gather by index vectors: JAX's ``dynamic_slice``,
    which `torch.func.vmap` batches, so each member reads its own window
    with no host read); the caller keeps the window in bounds
    (`band_box_start`'s clamp)."""
    if not isinstance(start, torch.Tensor):
        return a[_window_slices(start, shape, lead, off)]
    return a[(slice(None),) * lead
             + tuple(_window_vectors(start, shape, off, len(shape)))]


def put_window(a: torch.Tensor, start, shape: tuple, values: torch.Tensor,
               lead: int = 0, off: int = 1) -> torch.Tensor:
    """``a`` with the cells of `window` (same arguments) set to
    ``values``: host ints write into ``a`` itself (a field the caller has
    just made) and return it; a tensor ``start`` gives a new tensor
    (JAX's ``dynamic_update_slice``, by ``index_put``, which
    `torch.func.vmap` batches whether or not ``a`` is batched)."""
    if not isinstance(start, torch.Tensor):
        a[_window_slices(start, shape, lead, off)] = values
        return a
    n = lead + len(shape)
    heads = [torch.arange(a.shape[i], device=start.device).reshape(
        [a.shape[i] if j == i else 1 for j in range(n)])
        for i in range(lead)]
    return torch.index_put(
        a, tuple(heads + _window_vectors(start, shape, off, n)),
        values.to(a.dtype))


def loc_grid(S: tuple, i: int | None, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """Physical coordinates of every cell, shape ``(*S, D)``: cell centres
    for ``i=None``, the lower face of component ``i`` otherwise."""
    D = len(S)
    axes = []
    for d in range(D):
        c = torch.arange(S[d], dtype=dtype, device=device) - 0.5
        if i == d:
            c = c - 0.5
        axes.append(c)
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def apply_field(f, c_shape: tuple, dtype=torch.float32, vector: bool = False,
                device=None) -> torch.Tensor:
    """Evaluate a point-wise field function onto a ghost-padded array:
    ``f(i, x)`` at the face-``i`` locations for a vector target
    ``(D, *S)``, ``f(x)`` at cell centres for a scalar target."""
    if vector:
        D, S = c_shape[0], tuple(c_shape[1:])
        comps = []
        for i in range(D):
            pts = loc_grid(S, i, dtype, device).reshape(-1, D)
            vals = torch.func.vmap(lambda x, i=i: _as_tensor(f(i, x), x))(pts)
            comps.append(vals.to(dtype).reshape(S))
        return torch.stack(comps, dim=0)
    S = tuple(c_shape)
    pts = loc_grid(S, None, dtype, device).reshape(-1, len(S))
    vals = torch.func.vmap(lambda x: _as_tensor(f(x), x))(pts)
    return vals.to(dtype).reshape(S)


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    """Point values may be Python numbers; vmap needs tensors that depend
    on the batched input, so constants are broadcast against ``like``."""
    if not torch.is_tensor(v):
        v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v + torch.zeros_like(like[0])


def l2(a: torch.Tensor, D: int | None = None) -> torch.Tensor:
    """Squared L2 norm over the interior (reference ``L₂``)."""
    D = a.ndim if D is None else D
    v = interior_view(a, D)
    return torch.sum(v * v)


def linf(a: torch.Tensor) -> torch.Tensor:
    """Max-abs over the full array (reference ``L∞``)."""
    return torch.max(torch.abs(a))


def _interp_scalar(coord: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation of ``arr`` at the 0-based index
    coordinates ``coord`` (``(N, D)``), gathered on flat indices.

    A corner index below 0 wraps once by the axis length and is then
    clamped to ``[0, n-1]``, as JAX's gather normalises and clamps an
    index: the low edge wraps (-1 reads the last cell), the high edge
    clamps.  The clamp is explicit, so no index past the end reaches the
    gather (on a CUDA tensor it would trip a device assert)."""
    D = arr.ndim
    i = torch.floor(coord)
    y = coord - i
    i = i.to(torch.int64)
    flat = arr.reshape(-1)
    out = torch.zeros(coord.shape[0], dtype=arr.dtype, device=arr.device)
    for corner in range(2 ** D):
        w, k = None, None
        for d in range(D):
            off = (corner >> d) & 1
            wd = y[:, d] if off else 1.0 - y[:, d]
            w = wd if w is None else w * wd
            n = arr.shape[d]
            idx = i[:, d] + off
            idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
            k = idx if k is None else k * n + idx
        out = out + flat[k] * w.to(arr.dtype)
    return out


def interp(x: torch.Tensor, arr: torch.Tensor,
           vector: bool = False) -> torch.Tensor:
    """Linear interpolation at the physical positions ``x`` (``(N, D)``, or
    one point ``(D,)``): scalar fields are sampled at cell centres
    (physical ``I-0.5``), each component of a vector field ``(D, *S)`` at
    its face.  Returns ``(N,)`` (``(N, D)`` for a vector field), or a 0-d
    (``(D,)``) tensor for one point."""
    one = x.ndim == 1
    pts = x.reshape(1, -1) if one else x
    if vector:
        D = arr.shape[0]
        comps = []
        for i in range(D):
            off = torch.tensor([0.5 + (0.5 if j == i else 0.0)
                                for j in range(D)], dtype=x.dtype,
                               device=x.device)
            comps.append(_interp_scalar(pts + off, arr[i]))
        out = torch.stack(comps, dim=-1)
    else:
        out = _interp_scalar(pts + 0.5, arr)
    return out[0] if one else out
