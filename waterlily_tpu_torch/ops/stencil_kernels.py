"""Wrappers, plain versions and launch counters of the 3D stencil kernels.

Counterpart of `waterlily_tpu.ops.pallas_stencil`.  Each wrapper below
launches its hand-written CUDA kernel (``csrc/``) when its tensors lie on a
CUDA device, and runs its plain PyTorch version when they lie on the CPU;
any other device raises.  There is no fallback: a CUDA tensor the kernel
does not take (dtype, shape, layout, an unported variant) raises.

Each wrapper counts its launches in a plain int attribute, ``.launches``,
incremented only where the kernel is launched, and its launches at each
shape in a `collections.Counter`, ``.shapes``; a wrapper with bf16 forms
also keeps
the forms it launched in ``.forms`` (each the names of the arguments that
were bf16, ``()`` for all f32); ``conv_diff3d``'s are its limiters' names,
``bc3d``'s ``"inplace"`` or ``"copy"``.

``bc3d``, ``div3d``, ``project3d`` and ``conv_diff3d`` also have the
shard-local forms of `waterlily_tpu.parallel`: given ``S_glob`` and
``base`` (host ints), the array is one shard's block (halo-extended for
the last three) of a grid of sizes ``S_glob`` whose cell 0 sits at global
index ``base``, and the boundary tests compare global positions;
``conv_diff3d`` also takes ``modular`` (periodic axes with modular wrap
halos).  Each such launch adds ``"base"`` (and ``"modular"``) to the
wrapper's ``.forms`` and counts ``(shape, S_glob, base, form)`` in its
``.bases``, a `collections.Counter`.

The plain versions are the package's own whole-array forms (the functions
`waterlily_tpu` runs through XLA on the CPU), with the same association as
the kernels: with ``--fmad=false`` every kernel without an in-kernel sum
equals its plain version bit for bit on the card.

The dispatch gates mirror the JAX package's, with "tensor on a CUDA device"
in place of "backend is TPU" and the same size, rank and dtype conditions.

The kernels have no derivatives.  A wrapper handed an operand that
autograd tracks (`ad_tracked`: ``requires_grad`` under grad mode, a
forward-AD dual, a `torch.func` transform's tensor) off the CPU raises a
`RuntimeError`; it never detaches.  The gates' callers (`kernel_ok`,
`ops.poisson`'s level branches, `pcg_kernel.use_pcg_fused`'s caller) send
a tracked field to the plain form on its own device instead, as the JAX
package keeps its AD programs on the XLA forms (``pallas_ok=False``): the
one route of a CUDA field off a kernel, visible in the launch counters,
which count kernel launches only.

A field under `torch.func.vmap` (an ensemble's member axis) counts as
tracked here too: these eight wrappers (`bc3d`, `conv_diff3d`, `mult3d`,
`increment3d`, `div3d`, `project3d`, `cfl3d`, `ana_mult3d`) have no
member-axis form yet, so `kernel_ok` sends a batched field to its plain
form, which `vmap` batches.  Only the PCG smooth has one: its caller
(`ops.poisson.smooth`) sends a field that carries `vmap` levels and no
other (`vmap_only`) to `pcg_kernel.pcg_fused`, whose `vmap` rule launches
the kernel once for a chunk of members.
"""
from __future__ import annotations

import collections
import functools
import math

import torch
from torch.autograd import forward_ad

from ..kernels.build import THREADS, launch, library

__all__ = ["MIN_CELLS", "use_blocked", "tracked_by", "ad_tracked", "vmapped",
           "vmap_only", "kernel_ok", "mult3d", "increment3d", "ana_mult3d",
           "cfl3d", "bc3d", "div3d", "project3d", "conv_diff3d",
           "global_interior", "kernel_wrappers"]

# Minimum ghost-padded cell count for the kernel tier (the JAX gate's own
# floor): smaller levels run the plain forms on the device.
MIN_CELLS = 100_000


def use_blocked(S, dtype, device) -> bool:
    """Gate of every stencil kernel in this module: big 3D f32 fields on a
    CUDA device.  (JAX's separate `use_bc3d`/`use_project3d` gates differ
    from this one only by minimum axis-0 lengths that fit its TPU slabs;
    one-thread-per-cell kernels have no such minimum.)  A field that
    autograd tracks is held off the kernels by `kernel_ok`."""
    return (len(S) == 3 and dtype == torch.float32
            and torch.device(device).type == "cuda"
            and math.prod(S) >= MIN_CELLS)


_functorch = torch._C._functorch


def _kinds(v: torch.Tensor, grad_on: bool, duals: bool) -> set:
    """How ``v`` is tracked: ``"ad"`` for ``requires_grad`` under grad mode
    and for a forward-AD dual (a ``jvp`` level's tensor is one), ``"vmap"``
    for each `torch.func.vmap` level that batches it, ``"wrapped"`` for
    any other `torch.func` level (a ``grad`` level's tensor that does not
    require grad: a cotangent in a backward pass)."""
    kinds = set()
    if (grad_on and v.requires_grad) or (
            duals and forward_ad.unpack_dual(v).tangent is not None):
        kinds.add("ad")
    t = v
    while _functorch.is_functorch_wrapped_tensor(t):
        kinds.add("vmap" if _functorch.is_batchedtensor(t) else "wrapped")
        t = _functorch.get_unwrapped(t)
    if grad_on and t.requires_grad:
        kinds.add("ad")
    return kinds


def tracked_by(*values) -> set:
    """The union of the ways ``values`` are tracked (``"ad"``, ``"vmap"``,
    ``"wrapped"``; tuples and lists looked into, anything but a tensor
    untracked)."""
    grad_on = torch.is_grad_enabled()
    # unpack_dual's own test: no dual level open, no dual tensor
    duals = forward_ad._current_level >= 0
    kinds = set()
    for v in values:
        if isinstance(v, torch.Tensor):
            kinds |= _kinds(v, grad_on, duals)
        elif isinstance(v, (tuple, list)):
            kinds |= tracked_by(*v)
    return kinds


def ad_tracked(*values) -> bool:
    """True where autograd tracks any of ``values``: a tensor with
    ``requires_grad`` while grad mode is on, a forward-AD dual, or a
    `torch.func` transform's tensor (``jvp``, ``grad``, ``vmap``); tuples
    and lists are looked into, anything else is untracked."""
    return bool(tracked_by(*values))


def vmapped(*values) -> bool:
    """True where some of ``values`` carry `torch.func.vmap` levels."""
    return "vmap" in tracked_by(*values)


def vmap_only(*values) -> bool:
    """True where some of ``values`` carry `torch.func.vmap` levels (one or
    nested) and none is tracked otherwise (no ``grad``/``jvp`` level, no
    ``requires_grad`` under grad mode, no dual): an ensemble's fields,
    which a kernel with a member axis may take."""
    return tracked_by(*values) == {"vmap"}


def kernel_ok(S, dtype, device, *operands) -> bool:
    """`use_blocked`, closed to ``operands`` that autograd tracks or
    `vmap` batches (`ad_tracked`): such a field takes the plain form on
    its own device."""
    return use_blocked(S, dtype, device) and not ad_tracked(*operands)


# --- argument checks --------------------------------------------------------

def _on_cpu(name: str, t: torch.Tensor, *operands) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel);
    raises a `RuntimeError` where ``t`` or one of ``operands`` (tensors,
    scalars, tuples of them) is tracked by autograd off the CPU, and a
    `ValueError` for any device but the CPU and CUDA."""
    if t.device.type == "cpu":
        return True
    if ad_tracked(t, *operands):
        raise RuntimeError(
            f"{name}: an operand is tracked by autograd (requires_grad, a "
            f"forward-AD dual or a torch.func transform); the CUDA kernel "
            f"has no derivative and does not detach.  Tracked fields take "
            f"the plain forms through the kernel gates "
            f"(stencil_kernels.kernel_ok)")
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: tensors on {t.device} are not supported")


def _check(name: str, S: tuple, ranks=(3,), bf16=(), **tensors) -> None:
    """Kernel arguments: f32 (or bf16 for the arguments named in ``bf16``:
    search directions and a level's operator shadows), contiguous, one CUDA
    device, expected shape, a field rank in ``ranks``."""
    dev = None
    for arg, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype != torch.float32 and not (arg in bf16
                                             and t.dtype == torch.bfloat16):
            kinds = "float32 or bfloat16" if arg in bf16 else "float32"
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                            f"{kinds}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
    if len(S) not in ranks:
        raise ValueError(f"{name}: the kernel takes fields of rank "
                         f"{' or '.join(map(str, ranks))}, got S={S}")


def _scalar_on(v, like: torch.Tensor, name: str) -> torch.Tensor:
    """A (1,) f32 device tensor holding scalar ``v`` (a number or a
    one-element tensor on ``like``'s device); no host synchronisation."""
    if isinstance(v, torch.Tensor):
        if v.device != like.device or v.numel() != 1:
            raise ValueError(f"{name}: scalar operand must be a one-element "
                             f"tensor on {like.device}")
        return v.to(torch.float32).reshape(1).contiguous()
    return torch.full((1,), float(v), dtype=torch.float32, device=like.device)


def _vector_on(A, like: torch.Tensor, name: str) -> torch.Tensor:
    """A (3,) f32 device tensor of the BC values ``A`` (a (3,) tensor, or
    one-element tensors and numbers), with no host synchronisation."""
    if isinstance(A, torch.Tensor):
        if A.shape != (3,) or A.device != like.device:
            raise ValueError(f"{name}: A must be a (3,) tensor on "
                             f"{like.device}")
        return A.to(torch.float32).contiguous()
    return torch.cat([_scalar_on(a, like, name) for a in A])


def _axis_bits(perdir) -> int:
    """The kernels' periodic-axes argument: bit d set for each axis d in
    ``perdir``."""
    return sum(1 << d for d in set(perdir))


def _counted(fn):
    fn.launches = 0
    fn.shapes = collections.Counter()
    fn.forms = set()
    fn.bases = collections.Counter()
    return fn


def _global(S, S_glob, base) -> tuple:
    """The six ints of a launch's global grid: its sizes and the global
    index of the array's cell 0 (``S`` and zeros for a whole-grid call)."""
    if base is None:
        return tuple(S) + (0,) * len(S)
    S_glob = tuple(S) if S_glob is None else tuple(int(g) for g in S_glob)
    base = tuple(int(b) for b in base)
    if len(S_glob) != len(S) or len(base) != len(S):
        raise ValueError(f"S_glob {S_glob} and base {base} must have one "
                         f"entry per axis of {S}")
    return S_glob + base


def _count_base(fn, S, glob, extra=()) -> None:
    """One shard-local launch of wrapper ``fn`` with the global grid
    ``glob`` (`_global`): ``"base"`` in ``.forms``, and its shape, global
    sizes, base and ``extra`` (the form's other arguments) in ``.bases``."""
    fn.forms.add("base")
    fn.bases[(tuple(S), glob[:3], glob[3:]) + tuple(extra)] += 1


def global_interior(S, S_glob, base, device=None) -> torch.Tensor:
    """Mask of the cells of an array of shape ``S`` at global index
    ``base`` that are interior in the grid of sizes ``S_glob``."""
    m = None
    for d in range(len(S)):
        view = [1] * len(S)
        view[d] = S[d]
        g = (torch.arange(S[d], device=device) + base[d]).reshape(view)
        md = (g >= 1) & (g <= S_glob[d] - 2)
        m = md if m is None else m & md
    return m


def _count(fn, S, **streams) -> None:
    """One launch of wrapper ``fn`` at shape ``S``; ``streams`` are the
    arguments that may be bf16, whose bf16 names make the launched form."""
    fn.launches += 1
    fn.shapes[S] += 1
    fn.forms.add(tuple(k for k, t in streams.items()
                       if t.dtype == torch.bfloat16))


# --- Poisson operator: mult3d / increment3d ---------------------------------

def _bf16(t: torch.Tensor) -> int:
    """The kernels' stream-type flag: 1 for a bf16 tensor, 0 for f32."""
    return int(t.dtype == torch.bfloat16)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor (a search direction stored in bf16, an operator
    shadow) upcast to f32 (exact), any other as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _blocks(S) -> int:
    """Blocks of `THREADS` one-thread-per-cell threads over shape ``S``."""
    return -(-math.prod(S) // THREADS)


def _mult3d_plain(L, Dd, x, with_dot=False):
    """A bf16 ``x`` (a search direction stored in bf16) and a bf16 ``L`` (a
    level's shadow L16) are upcast first and the operator applied in f32,
    as in the kernel."""
    from .poisson import _mult_interior_arrays
    from ..grid import pad_interior, field_dot
    x = _wide(x)
    z = pad_interior(_mult_interior_arrays(_wide(L), Dd, x))
    return (z, field_dot(z, x)) if with_dot else z


@_counted
def mult3d(L, Dd, x, with_dot: bool = False):
    """z = A·x for the 7-point variable-coefficient Poisson operator with
    zero ghosts; with ``with_dot`` also ⟨A·x, x⟩ over the interior as a 0-d
    tensor, reduced in the same launch.  ``x`` may be bf16 and so may ``L``
    (a level's shadow L16, with the f32 D16): upcast in registers, z and
    the dot are f32.  Periodic ghosts of ``x`` must be filled by the
    caller.

    The kernel is `ops.attic.mult3d_stream`'s plane march
    (``csrc/stream_march.cu``), launched with its chunk rule; each wrapper
    keeps its own counts.  Like every march it refuses a shape with an
    axis under 3 cells or 3·N ≥ 2³¹ values (a ValueError): blocked levels
    are 3D and ghost-padded, so every axis has at least 3 cells, and a
    fine level past 2³¹/3 cells is refused by `cfl3d` on the same path."""
    if _on_cpu("mult3d", x, L, Dd):
        return _mult3d_plain(L, Dd, x, with_dot)
    from .attic import _mult3d_march    # attic imports this module
    return _mult3d_march(mult3d, L, Dd, x, with_dot)


def _increment3d_plain(L, Dd, eps, x, r):
    # f32 x + bf16 eps promotes to f32 in PyTorch as in JAX (eps exact)
    return x + eps, r - _mult3d_plain(L, Dd, eps)


@_counted
def increment3d(L, Dd, eps, x, r):
    """(x + eps, r − A·eps): the stencil half runs in the kernel, the axpy
    is a plain tensor op.  ``eps`` may be bf16 and so may ``L`` (a level's
    shadow L16): upcast, x and r stay f32.  Returns new tensors (nothing is
    updated in place)."""
    S = tuple(x.shape)
    if _on_cpu("increment3d", x, L, Dd, eps, r):
        return _increment3d_plain(L, Dd, eps, x, r)
    _check("increment3d", S, bf16=("L", "eps"), L=(L, (3,) + S), D=(Dd, S),
           eps=(eps, S), x=(x, S), r=(r, S))
    r_out = torch.empty_like(r)
    launch("wl_increment3d", L, Dd, eps, r, r_out, _bf16(L), _bf16(eps), *S)
    _count(increment3d, S, L=L, eps=eps)
    return x + eps, r_out


# --- the plane-marching reductions: ana_mult3d, cfl3d ---------------------

# Planes of each block's march (csrc/march.cuh): the fewest chunks of at
# most MARCH_PLANES[1] interior planes, more where the column tiles alone
# would give the card fewer than MARCH_BLOCKS blocks, down to chunks of
# MARCH_PLANES[0].  A level of L2-resident planes is latency-bound: on the
# H100, at 66³ and (98,66,66), blocks marching at least 4 planes each
# (whose loads the compiler schedules together) beat 1-plane chunks by
# 7-10% and grids of 1024 blocks by 30-40%.
MARCH_PLANES = (4, 64)
MARCH_BLOCKS = 512


def march_planes(S, tile, planes=None, blocks=None) -> int:
    """Interior planes of each block's march at shape ``S`` with ``tile``
    (axis 1, axis 2) interior columns a block, balanced over the interior;
    ``planes`` the (fewest, most) planes of a chunk, `MARCH_PLANES` by
    default, and ``blocks`` the grid's blocks to reach, `MARCH_BLOCKS` by
    default.  With (8, 32) tiles 258³ marches 4 chunks of 64 planes (1024
    blocks), 130³ 8 of 16 (512), 66³ 16 of 4 (256), (98,66,66) 24 of 4
    (384)."""
    lo, hi = planes or MARCH_PLANES
    n = S[0] - 2
    tiles = -(-(S[1] - 2) // tile[0]) * -(-(S[2] - 2) // tile[1])
    want = -(-(blocks or MARCH_BLOCKS) // tiles)
    chunks = max(-(-n // hi), min(want, -(-n // lo)))
    return -(-n // chunks)


def march_blocks(S, planes: int, tile) -> int:
    """Blocks of the march's grid: column tiles times chunks."""
    return (-(-(S[0] - 2) // planes) * -(-(S[1] - 2) // tile[0])
            * -(-(S[2] - 2) // tile[1]))


@functools.cache
def _march_tile() -> tuple[int, int]:
    """The (axis 1, axis 2) interior columns of one march block, as the
    kernel library was built with them (csrc/march.cuh MARCH_TJ,
    MARCH_TK)."""
    lib = library()
    return lib.wl_march_tile(1), lib.wl_march_tile(2)


@functools.cache
def _counter(device: torch.device) -> torch.Tensor:
    """The zeroed counter that elects the last block of a one-launch
    reduction (`mult3d`, `cfl3d`, `ana_mult3d` and `ops.attic`'s `dot3d`,
    `pcg_dir_mult`, `pcg_update`, `pcg_axpy`, `mult3d_stream`) on
    ``device``;
    each kernel leaves it zeroed, and the reductions run on one stream."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _march(name: str, S, device, results: int, planes=None, blocks=None):
    """(planes, results and partials buffer or None) of a march at ``S``
    (chunks of `march_planes` with ``planes`` and ``blocks``) reducing
    ``results`` sums or maxima: the buffer's first ``results`` elements
    are the results, then the partials of each, one a block."""
    if min(S) < 3 or 3 * math.prod(S) >= 2 ** 31:
        raise ValueError(f"{name}: the kernel takes axes of at least 3 "
                         f"cells and fewer than 2^31 values, got S={S}")
    tile = _march_tile()
    planes = march_planes(S, tile, planes, blocks)
    buf = (torch.empty(results * (1 + march_blocks(S, planes, tile)),
                       dtype=torch.float32, device=device) if results
           else None)
    return planes, buf


def _ana_mult3d_plain(x, c, perdir=(), with_dot=False):
    """Plain version of `ana_mult3d`, in the TPU kernel's association:
    ``t = lo0·x[i-1] + hi0·x[i+1] + lo1·x[j-1] + …`` left to right,
    ``nf = lo0 + hi0 + …``, ``z = c·t − (c·nf)·x``."""
    from ..grid import interior_view, pad_interior, field_dot
    from .poisson import _wall_coeffs
    S, D = tuple(x.shape), x.ndim
    off = lambda d, v: tuple(v if a == d else 0 for a in range(D))
    t = nf = None
    for d in range(D):
        # 0/1 face flags: the far-field coefficients of c = 1
        lo, hi = _wall_coeffs(S, d, perdir, x.dtype, 1.0, x.device)
        a = lo * interior_view(x, D, off(d, -1))
        t = a if t is None else t + a
        t = t + hi * interior_view(x, D, off(d, +1))
        nf = lo if nf is None else nf + lo
        nf = nf + hi
    z = pad_interior(c * t - (c * nf) * interior_view(x, D))
    return (z, field_dot(z, x)) if with_dot else z


@_counted
def ana_mult3d(x, c, perdir: tuple = (), with_dot: bool = False):
    """z = A·x for the constant-coefficient far-field operator of a banded
    level (face coefficient ``c``, wall faces zero from the index, no
    coefficient reads), zero ghosts; with ``with_dot`` also ⟨A·x, x⟩ over
    the interior as a 0-d tensor, in the same launch.  Periodic ghosts of
    ``x`` must be filled by the caller."""
    S = tuple(x.shape)
    if _on_cpu("ana_mult3d", x, c):
        return _ana_mult3d_plain(x, c, perdir, with_dot)
    _check("ana_mult3d", S, x=(x, S))
    planes, buf = _march("ana_mult3d", S, x.device, int(with_dot))
    z = torch.empty_like(x)
    launch("wl_ana_mult3d", x, z, *((buf[1:], _counter(x.device), buf[0])
                                    if with_dot else (None,) * 3),
           float(c), _axis_bits(perdir), planes, *S)
    _count(ana_mult3d, S)
    return (z, buf[0]) if with_dot else z


def _cfl3d_plain(u):
    from ..flow import cfl_flux_max
    return cfl_flux_max(u)


@_counted
def cfl3d(u):
    """Interior max of the CFL flux-out sum as a 0-d tensor, in one
    launch."""
    S = tuple(u.shape[1:])
    if _on_cpu("cfl3d", u):
        return _cfl3d_plain(u)
    _check("cfl3d", S, u=(u, (3,) + S))
    planes, buf = _march("cfl3d", S, u.device, 1)
    launch("wl_cfl3d", u, buf[1:], _counter(u.device), buf[0], planes, *S)
    _count(cfl3d, S)
    return buf[0]


# --- boundary conditions ----------------------------------------------------------

@_counted
def bc3d(u, A, save_exit: bool = False, perdir: tuple = (),
         inplace: bool = False, S_glob=None, base=None):
    """The (3, S0, S1, S2) velocity field with its boundary conditions, in
    one launch, equal to `ops.bc.bc_vector_planes` bit for bit: walls,
    periodic axes (``perdir``) and the convective outlet's kept plane
    (``save_exit``).  The kernel writes only the cells that change (ghost
    faces and the Dirichlet plane): with ``inplace`` into ``u``, which it
    returns, otherwise into a clone of ``u``.  Each launch adds its form,
    ``"inplace"`` or ``"copy"``, to ``bc3d.forms``.  With ``S_glob`` and
    ``base`` (walls and the outlet only) ``u`` is one shard's block and
    only the global faces in it are filled, from its planes 1 and S-2."""
    S = tuple(u.shape[1:])
    if base is not None and perdir:
        raise ValueError("bc3d: the periodic form is whole-grid only")
    if _on_cpu("bc3d", u, A):
        from .bc import bc_vector_planes
        return bc_vector_planes(u, A, save_exit, perdir, inplace, S_glob,
                                base)
    _check("bc3d", S, u=(u, (3,) + S))
    if 3 * math.prod(S) >= 2 ** 31:
        raise ValueError(f"bc3d: the kernel indexes fields of fewer than "
                         f"2^31 values, got S={S}")
    glob = _global(S, S_glob, base)
    out = u if inplace else u.clone()
    # numbers go with the launch; values on the device as a (3,) array
    if any(isinstance(a, torch.Tensor) for a in A):
        A_dev, A_host = _vector_on(A, u, "bc3d"), (0.0,) * 3
    else:
        A_dev, A_host = None, tuple(float(a) for a in A)
    launch("wl_bc3d", out, A_dev, *A_host,
           _axis_bits(perdir), int(bool(save_exit)), *S, *glob)
    bc3d.launches += 1
    bc3d.shapes[S] += 1
    bc3d.forms.add("inplace" if inplace else "copy")
    if base is not None:
        _count_base(bc3d, S, glob, (bool(save_exit),))
    return out


# --- projection head and tail -------------------------------------------------

def _div3d_plain(u, p, dt, S_glob=None, base=None):
    from ..flow import div
    z = div(u)
    if base is not None:
        z = torch.where(global_interior(tuple(p.shape), S_glob, base,
                                        p.device), z, 0.0)
    return z, p * dt


@_counted
def div3d(u, p, dt, S_glob=None, base=None):
    """(div(u) on the interior with zero ghosts, p·dt) in one sweep; ``dt``
    may be a one-element device tensor (no host synchronisation).  With
    ``S_glob`` and ``base`` the arrays are a shard's halo-extended block and
    div(u) is kept where a cell is interior in the array and in the global
    grid."""
    S = tuple(p.shape)
    if _on_cpu("div3d", u, p, dt):
        return _div3d_plain(u, p, dt, S_glob, base)
    _check("div3d", S, u=(u, (3,) + S), p=(p, S))
    glob = _global(S, S_glob, base)
    z = torch.empty_like(p)
    x = torch.empty_like(p)
    launch("wl_div3d", u, p, _scalar_on(dt, p, "div3d"), z, x, *S, *glob)
    div3d.launches += 1
    div3d.shapes[S] += 1
    if base is not None:
        _count_base(div3d, S, glob)
    return z, x


def _project3d_plain(L, x, u, dt, S_glob=None, base=None):
    from .poisson import pressure_grad_arrays
    from ..grid import pad_interior
    un = u - pad_interior(pressure_grad_arrays(L, x), lead=1)
    if base is not None:
        un = torch.where(global_interior(tuple(x.shape), S_glob, base,
                                         x.device), un, u)
    return un, x / dt


@_counted
def project3d(L, x, u, dt, S_glob=None, base=None):
    """(u − L∘∇x on the interior, ghosts passed through; x/dt) in one
    sweep.  Returns new tensors.  With ``S_glob`` and ``base`` the arrays
    are a shard's halo-extended block and u is corrected where a cell is
    interior in the array and in the global grid."""
    S = tuple(x.shape)
    if _on_cpu("project3d", x, L, u, dt):
        return _project3d_plain(L, x, u, dt, S_glob, base)
    _check("project3d", S, L=(L, (3,) + S), x=(x, S), u=(u, (3,) + S))
    glob = _global(S, S_glob, base)
    u_out = torch.empty_like(u)
    p = torch.empty_like(x)
    launch("wl_project3d", L, x, u, _scalar_on(dt, x, "project3d"), u_out, p,
           *S, *glob)
    project3d.launches += 1
    project3d.shapes[S] += 1
    if base is not None:
        _count_base(project3d, S, glob)
    return u_out, p


# --- convection-diffusion ------------------------------------------------------

def _conv_diff3d_plain(u, nu, limiter, perdir=(), S_glob=None, base=None,
                       modular=False):
    from .convect import conv_core
    S = tuple(u.shape[1:])
    up = torch.nn.functional.pad(u, (2, 2) * len(S))
    return conv_core(up, S, nu, perdir, limiter, u_wrap=u, S_glob=S_glob,
                     base=base, modular=modular)


def _limiter_code(limiter) -> int:
    """The code of a limiter compiled into the kernel library (QUICK 0, van
    Leer 1); raises for any other."""
    from .convect import KERNEL_LIMITERS
    for code, known in enumerate(KERNEL_LIMITERS):
        if limiter is known:
            return code
    raise NotImplementedError(f"conv_diff3d has no compiled-in variant for "
                              f"the limiter {limiter!r}")


@_counted
def conv_diff3d(u, nu, limiter, perdir: tuple = (), S_glob=None, base=None,
                modular: bool = False):
    """Full convection-diffusion tendency of all three components, zero
    wherever the reference writes nothing; periodic axes (``perdir``) take
    the ϕuP wrap and the top-face copy of face 1's flux.  QUICK and van
    Leer are compiled in; any other limiter is traced into the same kernel
    at its first launch (`kernels.limiter`), and one with no kernel form
    raises.  ``.forms`` keeps the names of the limiters launched.

    With ``S_glob`` and ``base`` ``u`` is a shard's block halo-extended by
    two cells (the caller trims the output); a periodic axis then needs
    ``modular``: its halo planes hold the modular wrap values and its faces
    take the uniform periodic flux."""
    from .convect import KERNEL_LIMITERS
    S = tuple(u.shape[1:])
    if perdir and base is not None and not modular:
        raise ValueError("conv_diff3d: a shard-local periodic call needs "
                         "modular wrap halos (modular=True)")
    if _on_cpu("conv_diff3d", u, nu):
        return _conv_diff3d_plain(u, nu, limiter, perdir, S_glob, base,
                                  modular)
    _check("conv_diff3d", S, u=(u, (3,) + S))
    glob = _global(S, S_glob, base)
    mod = int(bool(modular) and base is not None and bool(perdir))
    r = torch.empty_like(u)
    if limiter in KERNEL_LIMITERS:
        launch("wl_conv_diff3d", u, r, float(nu), _limiter_code(limiter),
               _axis_bits(perdir), mod, *S, *glob)
    else:
        from ..kernels.limiter import ENTRY, entry_point
        launch(ENTRY, u, r, float(nu), _axis_bits(perdir), mod, *S, *glob,
               lib=entry_point(limiter))
    conv_diff3d.launches += 1
    conv_diff3d.shapes[S] += 1
    conv_diff3d.forms.add(getattr(limiter, "__name__", repr(limiter)))
    if base is not None:
        _count_base(conv_diff3d, S, glob, (tuple(perdir),))
    if mod:
        conv_diff3d.forms.add("modular")
    return r


def kernel_wrappers() -> dict:
    """Name → wrapper of every kernel a solver path runs (each wrapper has
    a ``.launches`` counter, a ``.shapes`` counter and a ``.forms`` set): the
    blocked levels' PCG iteration and carried-rows operator (`ops.attic`)
    included.  The bandwidth probes run on no path (`kernels.probes`)."""
    from .pcg_kernel import pcg_fused
    from .attic import kernel_wrappers as attic_wrappers
    return {"mult3d": mult3d, "increment3d": increment3d, "cfl3d": cfl3d,
            "bc3d": bc3d, "div3d": div3d, "project3d": project3d,
            "conv_diff3d": conv_diff3d, "pcg_fused": pcg_fused,
            "ana_mult3d": ana_mult3d, **attic_wrappers()}
