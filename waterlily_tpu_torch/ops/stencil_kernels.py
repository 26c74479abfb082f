"""Wrappers, plain versions and launch counters of the 3D stencil kernels.

Counterpart of `waterlily_tpu.ops.pallas_stencil`.  Each wrapper below
launches its hand-written CUDA kernel (``csrc/``) when its tensors lie on a
CUDA device, and runs its plain PyTorch version when they lie on the CPU;
any other device raises.  There is no fallback: a CUDA tensor the kernel
does not take (dtype, shape, layout, an unported variant) raises.

Each wrapper counts its launches in a plain int attribute, ``.launches``,
incremented only where the kernel is launched, and keeps the shapes it
launched at in a set, ``.shapes``; a wrapper with bf16 forms also keeps
the forms it launched in ``.forms`` (each the names of the arguments that
were bf16, ``()`` for all f32).

The plain versions are the package's own whole-array forms (the functions
`waterlily_tpu` runs through XLA on the CPU), with the same association as
the kernels: with ``--fmad=false`` every kernel without an in-kernel sum
equals its plain version bit for bit on the card.

The dispatch gates mirror the JAX package's, with "tensor on a CUDA device"
in place of "backend is TPU" and the same size, rank and dtype conditions.
"""
from __future__ import annotations

import math

import torch

from ..kernels.build import THREADS, launch

__all__ = ["MIN_CELLS", "use_blocked", "mult3d", "increment3d",
           "ana_mult3d", "cfl3d", "bc3d", "div3d", "project3d", "conv_diff3d",
           "kernel_wrappers"]

# Minimum ghost-padded cell count for the kernel tier (the JAX gate's own
# floor): smaller levels run the plain forms on the device.
MIN_CELLS = 100_000


def use_blocked(S, dtype, device) -> bool:
    """Gate of every stencil kernel in this module: big 3D f32 fields on a
    CUDA device.  (JAX's separate `use_bc3d`/`use_project3d` gates differ
    from this one only by minimum axis-0 lengths that fit its TPU slabs;
    one-thread-per-cell kernels have no such minimum.)"""
    return (len(S) == 3 and dtype == torch.float32
            and torch.device(device).type == "cuda"
            and math.prod(S) >= MIN_CELLS)


# --- argument checks --------------------------------------------------------

def _on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel);
    raises for any other device."""
    if t.device.type == "cpu":
        return True
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
    """A (3,) f32 device tensor of the BC values ``A`` (numbers or
    one-element tensors)."""
    if isinstance(A, torch.Tensor):
        if A.shape != (3,) or A.device != like.device:
            raise ValueError(f"{name}: A must be a (3,) tensor on "
                             f"{like.device}")
        return A.to(torch.float32).contiguous()
    if all(not isinstance(a, torch.Tensor) for a in A):
        # pageable host values, copied without a stream synchronisation
        return torch.tensor([float(a) for a in A], dtype=torch.float32).to(
            like.device, non_blocking=True)
    return torch.cat([_scalar_on(a, like, name) for a in A])


def _axis_bits(perdir) -> int:
    """The kernels' periodic-axes argument: bit d set for each axis d in
    ``perdir``."""
    return sum(1 << d for d in set(perdir))


def _counted(fn):
    fn.launches = 0
    fn.shapes = set()
    fn.forms = set()
    return fn


def _count(fn, S, **streams) -> None:
    """One launch of wrapper ``fn`` at shape ``S``; ``streams`` are the
    arguments that may be bf16, whose bf16 names make the launched form."""
    fn.launches += 1
    fn.shapes.add(S)
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
    zero ghosts; with ``with_dot`` also ⟨A·x, x⟩ as a 0-d tensor (per-block
    partial sums, reduced on the device).  ``x`` may be bf16 and so may
    ``L`` (a level's shadow L16, with the f32 D16): upcast in registers, z
    and the dot are f32.  Periodic ghosts of ``x`` must be filled by the
    caller."""
    S = tuple(x.shape)
    if _on_cpu("mult3d", x):
        return _mult3d_plain(L, Dd, x, with_dot)
    _check("mult3d", S, bf16=("L", "x"), L=(L, (3,) + S), D=(Dd, S),
           x=(x, S))
    z = torch.empty(S, dtype=torch.float32, device=x.device)
    part = (torch.empty(_blocks(S), dtype=torch.float32, device=x.device)
            if with_dot else None)
    launch("wl_mult3d", L, Dd, x, z, part, _bf16(L), _bf16(x), *S)
    _count(mult3d, S, L=L, x=x)
    return (z, torch.sum(part)) if with_dot else z


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
    if _on_cpu("increment3d", x):
        return _increment3d_plain(L, Dd, eps, x, r)
    _check("increment3d", S, bf16=("L", "eps"), L=(L, (3,) + S), D=(Dd, S),
           eps=(eps, S), x=(x, S), r=(r, S))
    r_out = torch.empty_like(r)
    launch("wl_increment3d", L, Dd, eps, r, r_out, _bf16(L), _bf16(eps), *S)
    _count(increment3d, S, L=L, eps=eps)
    return x + eps, r_out


# --- analytic far-field Poisson operator: ana_mult3d -----------------------

# threads of one ana_mult3d block along axes 1 and 2 (csrc/ana_stencil.cu)
ANA_TILE = (8, 32)

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
    the interior (per-block partial sums).  Periodic ghosts of ``x`` must
    be filled by the caller."""
    S = tuple(x.shape)
    if _on_cpu("ana_mult3d", x):
        return _ana_mult3d_plain(x, c, perdir, with_dot)
    _check("ana_mult3d", S, x=(x, S))
    z = torch.empty_like(x)
    blocks = S[0] * -(-S[1] // ANA_TILE[0]) * -(-S[2] // ANA_TILE[1])
    part = (torch.empty(blocks, dtype=x.dtype, device=x.device)
            if with_dot else None)
    launch("wl_ana_mult3d", x, z, part, float(c), _axis_bits(perdir), *S)
    ana_mult3d.launches += 1
    ana_mult3d.shapes.add(S)
    return (z, torch.sum(part)) if with_dot else z


# --- CFL reduction -------------------------------------------------------------

def _cfl3d_plain(u):
    from ..flow import cfl_flux_max
    return cfl_flux_max(u)


@_counted
def cfl3d(u):
    """Interior max of the CFL flux-out sum as a 0-d tensor (per-block
    partial maxes, reduced on the device)."""
    S = tuple(u.shape[1:])
    if _on_cpu("cfl3d", u):
        return _cfl3d_plain(u)
    _check("cfl3d", S, u=(u, (3,) + S))
    part = torch.empty(_blocks(S), dtype=u.dtype, device=u.device)
    launch("wl_cfl3d", u, part, *S)
    cfl3d.launches += 1
    cfl3d.shapes.add(S)
    return torch.amax(part)


# --- boundary conditions ----------------------------------------------------------

@_counted
def bc3d(u, A, save_exit: bool = False, perdir: tuple = ()):
    """BC-filled copy of the (3, S0, S1, S2) velocity field in one sweep,
    equal to `ops.bc.bc_vector_planes` bit for bit: walls, periodic axes
    (``perdir``) and the convective outlet's kept plane (``save_exit``)."""
    S = tuple(u.shape[1:])
    if _on_cpu("bc3d", u):
        from .bc import bc_vector_planes
        return bc_vector_planes(u, A, save_exit, perdir)
    _check("bc3d", S, u=(u, (3,) + S))
    out = torch.empty_like(u)
    launch("wl_bc3d", u, out, _vector_on(A, u, "bc3d"), _axis_bits(perdir),
           int(bool(save_exit)), *S)
    bc3d.launches += 1
    bc3d.shapes.add(S)
    return out


# --- projection head and tail -------------------------------------------------

def _div3d_plain(u, p, dt):
    from ..flow import div
    return div(u), p * dt


@_counted
def div3d(u, p, dt):
    """(div(u) on the interior with zero ghosts, p·dt) in one sweep; ``dt``
    may be a one-element device tensor (no host synchronisation)."""
    S = tuple(p.shape)
    if _on_cpu("div3d", u):
        return _div3d_plain(u, p, dt)
    _check("div3d", S, u=(u, (3,) + S), p=(p, S))
    z = torch.empty_like(p)
    x = torch.empty_like(p)
    launch("wl_div3d", u, p, _scalar_on(dt, p, "div3d"), z, x, *S)
    div3d.launches += 1
    div3d.shapes.add(S)
    return z, x


def _project3d_plain(L, x, u, dt):
    from .poisson import pressure_grad_arrays
    from ..grid import pad_interior
    return u - pad_interior(pressure_grad_arrays(L, x), lead=1), x / dt


@_counted
def project3d(L, x, u, dt):
    """(u − L∘∇x on the interior, ghosts passed through; x/dt) in one
    sweep.  Returns new tensors."""
    S = tuple(x.shape)
    if _on_cpu("project3d", x):
        return _project3d_plain(L, x, u, dt)
    _check("project3d", S, L=(L, (3,) + S), x=(x, S), u=(u, (3,) + S))
    u_out = torch.empty_like(u)
    p = torch.empty_like(x)
    launch("wl_project3d", L, x, u, _scalar_on(dt, x, "project3d"), u_out, p,
           *S)
    project3d.launches += 1
    project3d.shapes.add(S)
    return u_out, p


# --- convection-diffusion ------------------------------------------------------

def _conv_diff3d_plain(u, nu, limiter, perdir=()):
    from .convect import conv_core
    S = tuple(u.shape[1:])
    up = torch.nn.functional.pad(u, (2, 2) * len(S))
    return conv_core(up, S, nu, perdir, limiter, u_wrap=u)


def _limiter_code(limiter) -> int:
    from .convect import quick, vanleer
    if limiter is quick:
        return 0
    if limiter is vanleer:
        return 1
    raise NotImplementedError(f"conv_diff3d has no kernel variant for the "
                              f"limiter {limiter!r}")


@_counted
def conv_diff3d(u, nu, limiter, perdir: tuple = ()):
    """Full convection-diffusion tendency of all three components (QUICK or
    van Leer), zero wherever the reference writes nothing; periodic axes
    (``perdir``) take the ϕuP wrap and the top-face copy of face 1's
    flux."""
    S = tuple(u.shape[1:])
    if _on_cpu("conv_diff3d", u):
        return _conv_diff3d_plain(u, nu, limiter, perdir)
    _check("conv_diff3d", S, u=(u, (3,) + S))
    lim = _limiter_code(limiter)
    r = torch.empty_like(u)
    launch("wl_conv_diff3d", u, r, float(nu), lim, _axis_bits(perdir), *S)
    conv_diff3d.launches += 1
    conv_diff3d.shapes.add(S)
    return r


def kernel_wrappers() -> dict:
    """Name → wrapper of every kernel a solver path runs (each wrapper has
    a ``.launches`` counter and ``.shapes`` and ``.forms`` sets): the
    blocked levels' PCG iteration and carried-rows operator (`ops.attic`)
    included.  The bandwidth probes run on no path (`kernels.probes`)."""
    from .pcg_kernel import pcg_fused
    from .attic import kernel_wrappers as attic_wrappers
    return {"mult3d": mult3d, "increment3d": increment3d, "cfl3d": cfl3d,
            "bc3d": bc3d, "div3d": div3d, "project3d": project3d,
            "conv_diff3d": conv_diff3d, "pcg_fused": pcg_fused,
            "ana_mult3d": ana_mult3d, **attic_wrappers()}
