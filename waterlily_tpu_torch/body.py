"""Implicit geometry: signed-distance bodies measured with `torch.func`.

PyTorch counterpart of `waterlily_tpu.body` (reference src/Body.jl,
src/AutoBody.jl).  The sdf normal comes from `torch.func.grad`,
the map Jacobian from `jacfwd` and the map's time derivative from `jvp`,
all under `vmap` over the grid points, evaluated in chunks so that large
grids stay within memory.  `measure_fields_banded` measures on a window
around the body only.  CSG bodies (`Bodies`: union, difference,
intersection) measure each member and select the winner as the
reference's ``reduce_sdf_map`` does; the gradient of a min/max is the
active branch's, so this equals differentiating the composite.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .grid import (loc_grid, interior, mask_interior, pad_interior,
                   band_box_start, window, put_window)
from .ops.bc import bc_vector
from .ops.stencil_kernels import vmapped
from .utils.perf import host_read, span

__all__ = ["AbstractBody", "AutoBody", "Bodies", "NoBody", "sdf", "measure",
           "measure_fields", "measure_fields_banded", "measure_sdf",
           "band_box_shape", "kern", "kern0", "kern1", "mu0", "mu1",
           "curvature"]

# points per vmapped measurement batch: bounds the autodiff temporaries
# (a few hundred bytes per point) at 256³-class grids
CHUNK = 1 << 20


# --- immersion kernel moments (reference Body.jl:56-61) ---

def kern(d):
    """Cosine immersion kernel ``½+½cos(πd)``."""
    return 0.5 + 0.5 * torch.cos(math.pi * d)


def kern0(d):
    return 0.5 + 0.5 * d + 0.5 * torch.sin(math.pi * d) / math.pi


def kern1(d):
    return (0.25 * (1 - d * d)
            - 0.5 * (d * torch.sin(math.pi * d)
                     + (1 + torch.cos(math.pi * d)) / math.pi) / math.pi)


def mu0(d, eps):
    """Zeroth kernel moment with clamped support."""
    return kern0(torch.clamp(d / eps, -1, 1))


def mu1(d, eps):
    """First kernel moment with clamped support."""
    return eps * kern1(torch.clamp(d / eps, -1, 1))


# --- body types ---

class AbstractBody:
    """Contract: subclasses implement ``sdf(x,t)`` and a point measure."""


class NoBody(AbstractBody):
    """Body-free simulation marker."""


def _as_ops(op):
    if op not in ("+", "-", "∩", "∪", "union", "inter", "diff"):
        raise ValueError(f"unsupported CSG op {op!r}")
    return {"union": "+", "∪": "+", "inter": "∩", "diff": "-"}.get(op, op)


class AutoBody(AbstractBody):
    """Implicit geometry from an sdf and an optional coordinate map.

    ``sdf(x, t) -> 0-d tensor`` and ``map(x, t) -> (D,) tensor`` are
    point-wise closures written with torch ops; ``compose=True`` uses
    ``sdf(map(x,t), t)``.  ``a + b`` (`union`), ``a - b`` and
    `intersect` build a flat `Bodies`; ``-a`` flips the sdf's sign."""

    def __init__(self, sdf: Callable, map: Callable | None = None,
                 compose: bool = True):
        self.raw_sdf = sdf
        self.map = map if map is not None else (lambda x, t: x)
        if compose and map is not None:
            self.sdf = lambda x, t: sdf(self.map(x, t), t)
        else:
            self.sdf = sdf

    def __add__(self, other):
        return _to_bodies(self) + _to_bodies(other)

    def __sub__(self, other):
        if isinstance(other, (AutoBody, Bodies)):
            return _to_bodies(self) - _to_bodies(other)
        return NotImplemented

    def __neg__(self):
        s = self.sdf
        return AutoBody(lambda x, t: -s(x, t), self.map, compose=False)

    def union(self, other):
        return self + other

    def intersect(self, other):
        o = _to_bodies(other)
        return Bodies([self, *o.bodies], ["∩"] + o.ops)


def _to_bodies(b):
    return b if isinstance(b, Bodies) else Bodies([b], [])


class Bodies(AbstractBody):
    """Flat list of `AutoBody` with pairwise CSG ops (reference
    AutoBody.jl:55-68): ``ops[k-1]`` combines ``bodies[k]`` into the
    running result, ``'+'``/``'∪'`` union, ``'-'`` difference, ``'∩'``
    intersection (one op string for all, default union)."""

    def __init__(self, bodies, ops=None):
        if ops is None:
            ops = ["+"] * (len(bodies) - 1)
        elif isinstance(ops, str):
            ops = [ops] * (len(bodies) - 1)
        ops = [_as_ops(o) for o in ops]
        if len(bodies) != len(ops) + 1:
            raise ValueError("len(bodies) != len(ops)+1")
        self.bodies = list(bodies)
        self.ops = ops

    def __add__(self, other):
        o = _to_bodies(other)
        return Bodies(self.bodies + o.bodies, self.ops + ["+"] + o.ops)

    def __sub__(self, other):
        o = _to_bodies(other)
        return Bodies(self.bodies + o.bodies, self.ops + ["-"] + o.ops)

    def sdf(self, x, t):
        return sdf(self, x, t)


def sdf(body, x, t=0.0):
    """Signed distance of ``body`` at ``x`` (reference AutoBody.jl:39,99):
    a `Bodies` folds its members' distances with min (union), max
    (intersection) and max with the negated member (difference)."""
    if isinstance(body, Bodies):
        d = body.bodies[0].sdf(x, t)
        for b, op in zip(body.bodies[1:], body.ops):
            db = b.sdf(x, t)
            if op == "+":
                d = torch.minimum(d, db)
            elif op == "∩":
                d = torch.maximum(d, db)
            else:
                d = torch.maximum(d, -db)
        return d
    return body.sdf(x, t)


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _solve_small(J, b):
    """Solve J v = b for D=2/3 in closed form."""
    D = b.shape[-1]
    nan = torch.full_like(b[0], math.nan)
    if D == 2:
        det = J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
        det = torch.where(det == 0, nan, det)
        v0 = (b[0] * J[1, 1] - b[1] * J[0, 1]) / det
        v1 = (J[0, 0] * b[1] - J[1, 0] * b[0]) / det
        return torch.stack([v0, v1])
    c0 = _cross(J[:, 1], J[:, 2])
    det = torch.sum(J[:, 0] * c0)
    det = torch.where(det == 0, nan, det)
    v0 = torch.sum(b * c0) / det
    v1 = torch.sum(b * _cross(J[:, 2], J[:, 0])) / det
    v2 = torch.sum(b * _cross(J[:, 0], J[:, 1])) / det
    return torch.stack([v0, v1, v2])


def _measure_one(sdf_fn, map_fn, x, t, fastd2=None):
    """Point measurement ``(d, n, V)``: pseudo-sdf-corrected distance, unit
    normal from ``∇sdf`` (NaN-guarded) and body velocity ``-J⁻¹ ∂map/∂t``."""
    d_raw = sdf_fn(x, t)
    n = torch.func.grad(lambda y: sdf_fn(y, t))(x)
    isnan = torch.any(torch.isnan(n))
    n = torch.where(torch.isnan(n), 0.0, n)
    m = torch.sqrt(torch.sum(n * n))
    msafe = torch.where(m == 0, 1.0, m)
    d_c = d_raw / msafe
    n_c = n / msafe
    J = torch.func.jacfwd(lambda y: map_fn(y, t))(x)
    _, mdot = torch.func.jvp(lambda tt: map_fn(x, tt), (t,),
                             (torch.ones_like(t),))
    V = -_solve_small(J, mdot.to(x.dtype))
    V = torch.where(torch.isnan(V), 0.0, V)
    zero = torch.zeros_like(x)
    d_out = torch.where(isnan, d_raw, d_c)
    n_out = torch.where(isnan, zero, n_c)
    V_out = torch.where(isnan, zero, V)
    if fastd2 is not None:
        fast = d_raw * d_raw > fastd2
        d_out = torch.where(fast, d_raw, d_out)
        n_out = torch.where(fast, zero, n_out)
        V_out = torch.where(fast, zero, V_out)
    return d_out, n_out, V_out


def measure(body, x, t=0.0, fastd2=None):
    """Geometric measurement ``(d, n, V)`` of ``body`` at point ``x``.

    A `Bodies` measures each member and selects the winner by the
    reference's ``reduce_sdf_map`` rules (AutoBody.jl:88-93): union keeps
    the smaller raw distance, intersection the larger, difference flips
    the subtracted member's distance and normal."""
    t_ = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    if isinstance(body, AutoBody):
        return _measure_one(body.sdf, body.map, x, t_, fastd2)
    if isinstance(body, Bodies):
        raws = [b.sdf(x, t_) for b in body.bodies]
        meas = [_measure_one(b.sdf, b.map, x, t_, fastd2)
                for b in body.bodies]
        d_sel = raws[0]
        dm, nm, Vm = meas[0]
        for k, op in enumerate(body.ops, start=1):
            rk = raws[k]
            dk, nk, Vk = meas[k]
            if op == "+":
                take, cand = rk < d_sel, (rk, dk, nk, Vk)
            elif op == "∩":
                take, cand = rk > d_sel, (rk, dk, nk, Vk)
            else:
                take, cand = -rk > d_sel, (-rk, -dk, -nk, Vk)
            d_sel = torch.where(take, cand[0], d_sel)
            dm = torch.where(take, cand[1], dm)
            nm = torch.where(take, cand[2], nm)
            Vm = torch.where(take, cand[3], Vm)
        return dm, nm, Vm
    raise TypeError(f"cannot measure {type(body)}")


def _chunked_vmap(fn, pts):
    """``vmap(fn)`` over the rows of ``pts`` in chunks of `CHUNK` points;
    outputs (single tensor or tuple) are concatenated."""
    outs = [torch.func.vmap(fn)(pts[i:i + CHUNK])
            for i in range(0, pts.shape[0], CHUNK)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _face_fields(body, points, shape, d_center, t_, eps, dtype):
    """BDIM fields on the cells of ``shape`` whose centre distances are
    ``d_center``: ``points(i)`` gives the face-``i`` coordinates, measured
    in the band ``d² < (2+eps)²``; far cells get ``μ₀ = 1`` (0 deep inside),
    ``V = 0`` and ``μ₁ = 0``.  Returns stacked ``(V, μ₀, μ₁)``."""
    D = len(shape)
    fastd2 = (2.0 + eps) ** 2
    near = d_center * d_center < fastd2
    inside_deep = d_center < 0
    V_comps, m0_comps, m1_comps = [], [], []
    for i in range(D):
        di, ni, Vi = _chunked_vmap(lambda x: measure(body, x, t_, fastd2),
                                   points(i).reshape(-1, D))
        di = di.reshape(shape).to(dtype)
        ni = ni.reshape(shape + (D,)).to(dtype)
        Vi = Vi.reshape(shape + (D,)).to(dtype)
        m0_comps.append(torch.where(near, mu0(di, eps),
                                    torch.where(inside_deep, 0.0, 1.0)))
        V_comps.append(torch.where(near, Vi[..., i], 0.0))
        m1_comps.append(torch.stack(
            [torch.where(near, mu1(di, eps) * ni[..., j], 0.0)
             for j in range(D)], dim=0))
    return (torch.stack(V_comps, dim=0).to(dtype),
            torch.stack(m0_comps, dim=0).to(dtype),
            torch.stack(m1_comps, dim=0).to(dtype))


def _d_center(body, S, t_, dtype, device):
    """The sdf at every cell centre (no gradients)."""
    centers = loc_grid(S, None, dtype, device).reshape(-1, len(S))
    return _chunked_vmap(lambda x: sdf(body, x, t_), centers).reshape(S).to(
        dtype)


def measure_sdf(body, S, t=0.0, dtype=torch.float32, device="cuda"):
    """The sdf at the interior cell centres (reference ``measure_sdf!``,
    Body.jl:68), zero ghosts."""
    D = len(S)
    pts = loc_grid(tuple(S), None, dtype, device)[interior(D)].reshape(-1, D)
    t_ = torch.as_tensor(t, dtype=dtype, device=device)
    vals = _chunked_vmap(lambda x: sdf(body, x, t_), pts)
    return pad_interior(vals.reshape(tuple(s - 2 for s in S)).to(dtype))


def measure_fields(body, S, t=0.0, eps=1.0, perdir=(), exitBC=False,
                   dtype=torch.float32, device="cuda"):
    """BDIM rasterization (reference ``measure!``, Body.jl:31-53): ``V``,
    ``μ₀`` and ``μ₁`` on the whole padded grid, measured at each face in
    the band ``d² < (2+eps)²``, deep-interior cells zeroed, vector BCs
    applied.  Returns ``(V, mu0, mu1, d_center)``.  A pure function of
    the body's parameters, so `torch.func.vmap` measures an ensemble of
    bodies (every write goes into a field of the step's own making)."""
    D = len(S)
    if isinstance(body, NoBody) or body is None:
        V = torch.zeros((D,) + S, dtype=dtype, device=device)
        m0 = bc_vector(torch.ones((D,) + S, dtype=dtype, device=device),
                       (0.0,) * D, False, perdir, inplace=True)
        m1 = torch.zeros((D, D) + S, dtype=dtype, device=device)
        return V, m0, m1, torch.zeros(S, dtype=dtype, device=device)

    t_ = torch.as_tensor(t, dtype=dtype, device=device)
    with span("wl.body.sdf"):
        d_center = _d_center(body, S, t_, dtype, device)
    with span("wl.body.faces"):
        V, m0, m1 = _face_fields(
            body, lambda i: loc_grid(S, i, dtype, device), tuple(S),
            d_center, t_, eps, dtype)
    # interior cells only: μ₁ ghosts stay zero, V ghosts are zero before the
    # BC fill (so an exitBC outlet plane stays 0)
    m1_in = pad_interior(m1[interior(D, lead=2)], lead=2)
    V = mask_interior(V, D)
    m0 = bc_vector(m0, (0.0,) * D, False, perdir, inplace=True)
    V = bc_vector(V, (0.0,) * D, exitBC, perdir, inplace=True)
    return V, m0, m1_in, d_center


def _loc_window(W: tuple, start, i: int | None, dtype,
                device=None) -> torch.Tensor:
    """Physical coordinates of the box-window cells (indices
    ``start+1+k``), shape ``(*W, D)``: the `loc_grid` convention generated
    on the window alone; ``start`` host ints or a ``(D,)`` tensor (a
    member's own corner under `torch.func.vmap`)."""
    axes = []
    for d in range(len(W)):
        c = (torch.arange(W[d], device=device) + (start[d] + 1)).to(dtype) \
            - 0.5
        if i == d:
            c = c - 0.5
        axes.append(c)
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def measure_fields_banded(body, S, t, eps, perdir, exitBC, dtype, box_shape,
                          device="cuda"):
    """Narrow-band BDIM rasterization (reference ``measure!``, Body.jl:32-44).

    One cheap full-grid sdf pass (no gradients) locates the band; the D
    face-grid measurements (sdf gradient, map Jacobian and jvp per point)
    run only on the ``box_shape`` window placed by `grid.band_box_start`
    and are written into the far-field constants ``μ₀ = 1, V = 0, μ₁ =
    0``.  Equal to `measure_fields` bit for bit whenever the window covers
    the ``d < 2+eps`` region (the `band_box_shape` contract).  Returns
    ``(V, mu0, mu1, d_center, start)``, ``start`` the window corner: host
    ints (one host read) in a single run; under `torch.func.vmap`, where
    each member's corner is its own, a ``(D,)`` int64 tensor that stays on
    the device (the windows are gathered and written by index vectors,
    `grid.window`/`put_window`), as JAX's traced corner does."""
    D = len(S)
    t_ = torch.as_tensor(t, dtype=dtype, device=device)
    with span("wl.body.sdf"):
        d_center = _d_center(body, S, t_, dtype, device)
        start = band_box_start(d_center < (2.0 + eps), box_shape)
        if not vmapped(start):
            with host_read("band_start"):
                start = tuple(start.tolist())
    W = tuple(box_shape)
    with span("wl.body.faces"):
        Vw, m0w, m1w = _face_fields(
            body, lambda i: _loc_window(W, start, i, dtype, device), W,
            window(d_center, start, W), t_, eps, dtype)
    m0 = put_window(torch.ones((D,) + S, dtype=dtype, device=device), start,
                    W, m0w, 1)
    V = put_window(torch.zeros((D,) + S, dtype=dtype, device=device), start,
                   W, Vw, 1)
    m1 = put_window(torch.zeros((D, D) + S, dtype=dtype, device=device),
                    start, W, m1w, 2)
    # window cells are interior: μ₁ and V ghosts are already zero
    m0 = bc_vector(m0, (0.0,) * D, False, perdir, inplace=True)
    V = bc_vector(V, (0.0,) * D, exitBC, perdir, inplace=True)
    return V, m0, m1, d_center, start


def band_box_shape(body, S, t=0.0, eps=1.0, dtype=torch.float32, margin=3,
                   max_frac=0.5, device="cuda"):
    """Static band-box extents for the banded immersed-boundary path: the
    per-axis extent of the ``d < 2+eps`` region at ``t`` plus ``margin``
    cells each side (the box's position is found again at every
    remeasure).  ``None`` when there is no band or the halo'd box would
    cover more than ``max_frac`` of the grid.  One host read, at
    construction."""
    if isinstance(body, NoBody) or body is None:
        return None
    D = len(S)
    t_ = torch.as_tensor(t, dtype=dtype, device=device)
    mask = _d_center(body, S, t_, dtype, device) < (2.0 + eps)
    with host_read("band_shape"):
        mask = mask.cpu().numpy()
    if not mask.any():
        return None
    shape = []
    for a in range(D):
        proj = mask.any(axis=tuple(i for i in range(D) if i != a))
        idx = np.nonzero(proj)[0]
        shape.append(min(int(idx[-1] - idx[0] + 1) + 2 * margin, S[a] - 2))
    if math.prod(s + 2 for s in shape) > max_frac * math.prod(S):
        return None
    return tuple(shape)


def curvature(A):
    """Mean and Gaussian curvature ``(H, K)`` from the sdf Hessian ``A``
    (AutoBody.jl:140-146); ``K`` is 0 for a 2×2 Hessian."""
    H = 0.5 * torch.trace(A)
    if tuple(A.shape) == (3, 3):
        K = (A[0, 0] * A[1, 1] + A[0, 0] * A[2, 2] + A[1, 1] * A[2, 2]
             - A[0, 1] ** 2 - A[0, 2] ** 2 - A[1, 2] ** 2)
    else:
        K = torch.zeros_like(H)
    return H, K
