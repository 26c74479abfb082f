"""Matrix-free variable-coefficient Poisson operator and smoothers.

PyTorch counterpart of `waterlily_tpu.ops.poisson` (reference
src/Poisson.jl), f32/f64, dense and banded levels.  The system is
``Ax = [L+D+L']x = z`` with face coefficients ``L`` (the BDIM zeroth
moments) and the derived diagonal ``D[I] = -Σᵢ(L[I,i]+L[I+δᵢ,i])``.

As in the JAX package, the PCG smoother's early exits are a monotone
``dead`` flag held in 0-d tensors, so a smooth never synchronises with the
host.  ``r``, ``z`` and every ``mult`` output are zero in the ghost cells,
so whole-array dots equal the reference's interior dots.

Three module flags route the PCG iteration of blocked levels through the
kernels of `ops.attic`, as the JAX package's ``KDOT``/``KAXPY`` and its
`attic.pcg_blocked` dispatch do, and a fourth, ``STREAM``, their operator
through its carried-rows kernels.  All four are off by default: they are
seams for A/B runs (`chip_smoke.py` phase 6.4), not the default path.
``BF16_OP`` (off, as in JAX) is the default of the bf16 operator shadows
(`PoissonLevel.L16`, ``Simulation(op_bf16=)``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..grid import (interior_view, mask_interior, inside_count, field_dot,
                    pad_interior, axis_coord, box_slices)
from .bc import bc_scalar_periodic
from . import stencil_kernels as sk
from . import pcg_kernel as pk
from . import attic as at

__all__ = ["PoissonLevel", "make_level", "mult", "residual", "increment",
           "pressure_grad_interior", "jacobi", "fdot", "pcg", "smooth",
           "poisson_solve", "operator_shadows", "KDOT", "KAXPY",
           "PCG_BLOCKED", "STREAM", "BF16_OP"]

# Default of `make_level`'s ``op_bf16``: bf16 shadows of the operator
# coefficients on blocked levels (the JAX package's flag of that name, off
# there too: on the TPU the rounded operator cost iterations, pois_n about
# (3,3) against (2,2) at 256³).
BF16_OP = False

# Solver dots of blocked levels (`fdot`, PCG's rho) by the `attic.dot3d`
# kernel instead of `grid.field_dot` (the JAX package's flag of that name).
KDOT = False
# PCG's axpy pair and next rho on blocked levels in one `attic.pcg_axpy`
# sweep (the JAX package's flag of that name).
KAXPY = False
# `smooth` of a blocked, non-periodic, non-banded level by the two-sweep
# fused iteration `attic.pcg_blocked` (the dispatch the JAX package's
# scripts/ab_pcgiter.py makes).
PCG_BLOCKED = False
# A·x (with and without the dot) and r − A·eps of blocked levels by the
# carried-rows kernels `attic.mult3d_stream`/`increment3d_stream` instead
# of the halo-row `mult3d`/`increment3d` (the JAX package keeps them but
# dispatches them nowhere).
STREAM = False


def _off(D, i, v):
    return tuple(v if d == i else 0 for d in range(D))


@dataclass(frozen=True)
class PoissonLevel:
    """One multigrid level: face coefficients and derived (inverse) diagonal.

    ``blocked`` selects the stencil kernels (`stencil_kernels.use_blocked`:
    big 3D f32 levels on a CUDA device).

    ``bf16_eps`` (blocked levels only) stores the smoother's search
    direction in bf16: every ``eps`` is rounded before it is used, and x, r
    and ``z = A·eps`` stay f32, computed from the same rounded direction
    that updates x, so ``r == rhs − A·x`` holds to f32 precision.

    ``L16``, ``D16``, ``iD16`` (blocked f32 levels built with ``op_bf16``)
    are bf16 shadows of the operator: ``L16`` is L rounded to bf16, ``D16``
    the f32 diagonal derived from the rounded taps (rounding D itself breaks
    the exact zero row sums and the smoother diverges), ``iD16`` the bf16
    of its guarded inverse.  The blocked branches of `mult`, `residual`,
    `increment` and the smoothers apply the rounded operator in f32 and
    precondition with ``iD16``; L, D and iD stay f32 for the projection,
    the restriction and the dead-cell masks.  A shadowed level has f32
    search directions (``bf16_eps`` False): the two roundings together
    lifted JAX's multigrid convergence floor above ``tol`` at 256³.

    ``banded`` selects the sparse immersed-boundary operator: away from the
    body band the face coefficients are exactly the constant ``c`` (μ₀ is
    exactly 1 there and each restriction scales it by 2^(D-2)), zero on
    the wall faces, so the operator reads coefficients only inside the
    window of extents ``box_shape`` at corner ``box_start`` (host ints, the
    `grid.box_slices` convention).  Equal to the dense operator bit for
    bit."""
    L: torch.Tensor      # (D, *S) lower face coefficients
    D: torch.Tensor      # (*S) diagonal, zero in ghosts
    iD: torch.Tensor     # (*S) guarded inverse diagonal (0 inside bodies)
    blocked: bool = False
    bf16_eps: bool = False
    perdir: tuple = ()
    banded: bool = False
    c: float = 1.0
    box_shape: tuple | None = None
    box_start: tuple | None = None
    L16: torch.Tensor | None = None
    D16: torch.Tensor | None = None
    iD16: torch.Tensor | None = None


def _diag(L: torch.Tensor) -> torch.Tensor:
    """D[I] = -Σᵢ (L[I,i] + L[I+δᵢ,i]) on the interior, zero ghosts."""
    D = L.shape[0]
    s = None
    for i in range(D):
        t = interior_view(L[i], D) + interior_view(L[i], D, _off(D, i, +1))
        s = t if s is None else s + t
    return pad_interior(-s)


def _guarded_inverse(Dd: torch.Tensor) -> torch.Tensor:
    """1/D, zero where D·D < 2 eps (cells inside bodies)."""
    guard = Dd * Dd < 2 * torch.finfo(Dd.dtype).eps
    return torch.where(guard, 0.0, 1.0 / torch.where(guard, 1.0, Dd))


def operator_shadows(L: torch.Tensor) -> tuple:
    """``(L16, D16, iD16)`` of f32 face coefficients ``L``: L rounded to
    bf16, the f32 diagonal of the ROUNDED taps (sums of bf16 values in f32
    are exact, so the rows of the rounded operator sum to zero) and the
    bf16 of its guarded inverse."""
    L16 = L.to(torch.bfloat16)
    D16 = _diag(L16.to(L.dtype))
    return L16, D16, _guarded_inverse(D16).to(torch.bfloat16)


def make_level(L: torch.Tensor, perdir: tuple = (), banded: bool = False,
               c: float = 1.0, box_shape=None, box_start=None, Dd=None,
               iD=None, bf16_eps: bool = False, op_bf16: bool | None = None,
               L16=None, D16=None, iD16=None) -> PoissonLevel:
    """Build a level from face coefficients (reference ``set_diag!``).
    ``bf16_eps`` takes effect on blocked levels only, as in JAX (where it
    is the default, on TPU blocked levels); the port's default is f32
    search directions.  ``op_bf16`` (None: the module default `BF16_OP`)
    builds the operator shadows ``L16``/``D16``/``iD16`` on blocked f32
    levels, as JAX's `make_level` does, and forces ``bf16_eps`` off there.
    A banded level (``banded`` with a ``box_shape``) is never blocked.
    ``Dd`` and ``iD``, and the shadows where given, are taken as they are
    (a level carried across, `convert.py`)."""
    if Dd is None:
        Dd = _diag(L)
        iD = _guarded_inverse(Dd).to(L.dtype)
    if banded and box_shape is not None:
        banded = True
        box_shape = tuple(int(b) for b in box_shape)
        box_start = tuple(int(b) for b in box_start)
    else:
        banded, box_shape, box_start = False, None, None
    blocked = (not banded) and sk.use_blocked(tuple(L.shape[1:]), L.dtype,
                                              L.device)
    f32blk = blocked and L.dtype == torch.float32
    shadow = f32blk and (BF16_OP if op_bf16 is None else bool(op_bf16))
    if shadow and L16 is None:
        L16, D16, iD16 = operator_shadows(L)
    elif not shadow:
        L16 = D16 = iD16 = None
    return PoissonLevel(L=L, D=Dd, iD=iD, blocked=blocked,
                        bf16_eps=bool(bf16_eps) and f32blk and not shadow,
                        perdir=tuple(perdir), banded=banded, c=float(c),
                        box_shape=box_shape, box_start=box_start,
                        L16=L16, D16=D16, iD16=iD16)


def _opLD(lev: PoissonLevel):
    """(L, D) of the blocked stencil kernels: the bf16 shadow and its f32
    diagonal where the level has them, the f32 arrays otherwise."""
    if lev.L16 is not None:
        return lev.L16, lev.D16
    return lev.L, lev.D


def _iDk(lev: PoissonLevel) -> torch.Tensor:
    """The preconditioner the smoothers read: ``iD16`` where the level has
    it, ``iD`` otherwise."""
    return lev.iD16 if lev.iD16 is not None else lev.iD


def _ax(lev: PoissonLevel, x: torch.Tensor, with_dot: bool = False):
    """A·x of a blocked level (with ⟨A·x, x⟩ under ``with_dot``): the
    halo-row `mult3d`, or under ``STREAM`` the carried-rows
    `attic.mult3d_stream`, on the level's operator (`_opLD`)."""
    mult3d = at.mult3d_stream if STREAM else sk.mult3d
    return mult3d(*_opLD(lev), x, with_dot=with_dot)


def _mult_interior_arrays(L, Dd, x) -> torch.Tensor:
    """Interior of A·x from coefficient arrays (the slice form whose
    association the stencil kernels reproduce)."""
    D = L.shape[0]
    s = interior_view(x, D) * interior_view(Dd, D)
    for i in range(D):
        lo, hi = _off(D, i, -1), _off(D, i, +1)
        s = (s + interior_view(x, D, lo) * interior_view(L[i], D)
             + interior_view(x, D, hi) * interior_view(L[i], D, hi))
    return s


# --- banded (sparse immersed-boundary) operator -----------------------------
#
# The far-field coefficients are the constant ``c`` with zeros on the
# non-periodic wall faces, and the far-field diagonal is minus their sum.
# The expressions below repeat the dense expression tree with those
# constants (so the results are bitwise the dense ones) and then overwrite
# the body window with the true-coefficient compute.  The constant fields
# are built as per-axis vectors that broadcast, not as full grids.


def _wall_coeffs(S, i, perdir, dtype, c, device):
    """(lower, upper) face coefficients along axis ``i`` on the interior,
    broadcastable to the interior shape."""
    Si = tuple(s - 2 for s in S)
    if i in perdir:
        cc = torch.full((1,) * len(S), c, dtype=dtype, device=device)
        return cc, cc
    k = axis_coord(Si, i, device)
    lo = torch.where(k != 0, c, 0.0).to(dtype)
    hi = torch.where(k != Si[i] - 1, c, 0.0).to(dtype)
    return lo, hi


def _ana_D_interior(S, perdir, dtype, c, device):
    """Interior of the far-field diagonal −Σ(face coeffs), in the dense
    add order."""
    s = None
    for i in range(len(S)):
        lo, hi = _wall_coeffs(S, i, perdir, dtype, c, device)
        t = lo + hi
        s = t if s is None else s + t
    return -s


def _win(lev: PoissonLevel, a: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """The body window of ``a``: the box and a one-cell halo (a view)."""
    return a[box_slices(lev.box_start, lev.box_shape, lead, halo=1)]


def _box_update(lev: PoissonLevel, interior_field: torch.Tensor,
                box_values: torch.Tensor) -> torch.Tensor:
    """Overwrite the box cells of an interior-shaped field the caller owns
    (in place) and return it."""
    interior_field[tuple(slice(s, s + w) for s, w in
                         zip(lev.box_start, lev.box_shape))] = box_values
    return interior_field


def _box_ax(lev: PoissonLevel, x: torch.Tensor) -> torch.Tensor:
    """True-coefficient A·x on the box cells."""
    return _mult_interior_arrays(_win(lev, lev.L, 1), _win(lev, lev.D),
                                 _win(lev, x))


def _banded_mult_interior(lev: PoissonLevel, x: torch.Tensor) -> torch.Tensor:
    S, D, dt_, dev = tuple(x.shape), x.ndim, x.dtype, x.device
    s = interior_view(x, D) * _ana_D_interior(S, lev.perdir, dt_, lev.c, dev)
    for i in range(D):
        clo, chi = _wall_coeffs(S, i, lev.perdir, dt_, lev.c, dev)
        s = (s + interior_view(x, D, _off(D, i, -1)) * clo
             + interior_view(x, D, _off(D, i, +1)) * chi)
    return _box_update(lev, s, _box_ax(lev, x))


def _banded_ax(lev: PoissonLevel, x: torch.Tensor, with_dot: bool = False):
    """Ghost-zero A·x of a banded level (and ⟨A·x, x⟩ with ``with_dot``):
    the `ana_mult3d` kernel plus a window fix-up where the stencil-kernel
    gate holds, the plain far-field form elsewhere."""
    D = x.ndim
    if sk.use_blocked(tuple(x.shape), x.dtype, x.device):
        zw = _box_ax(lev, x)
        box = box_slices(lev.box_start, lev.box_shape)
        if with_dot:
            z, dot = sk.ana_mult3d(x, lev.c, lev.perdir, with_dot=True)
            # the window overwrite changes the dot by <zw - z_far, x> there
            dot = dot + field_dot(zw - z[box], interior_view(_win(lev, x), D))
            z[box] = zw
            return z, dot
        z = sk.ana_mult3d(x, lev.c, lev.perdir)
        z[box] = zw
        return z
    z = pad_interior(_banded_mult_interior(lev, x))
    return (z, field_dot(z, x)) if with_dot else z


def _rid(lev: PoissonLevel, r: torch.Tensor) -> torch.Tensor:
    """r * iD, the Jacobi-preconditioned residual (a shadowed level's bf16
    iD16 upcast by the product's promotion; its zeros, the dead-cell guard,
    are exact).  Banded far field: 1/D of the far-field diagonal (the
    dead-cell guard only trips inside the body, which lies in the box)."""
    if not lev.banded:
        return r * _iDk(lev)
    D = r.ndim
    iD_far = 1.0 / _ana_D_interior(tuple(r.shape), lev.perdir, r.dtype,
                                   lev.c, r.device)
    s = interior_view(r, D) * iD_far.to(r.dtype)
    ew = interior_view(_win(lev, r), D) * interior_view(_win(lev, lev.iD), D)
    return pad_interior(_box_update(lev, s, ew))


def mult(lev: PoissonLevel, x: torch.Tensor) -> torch.Tensor:
    """z = A x with zero ghosts (reference ``mult!``)."""
    x = bc_scalar_periodic(x, lev.perdir)
    if lev.banded:
        return _banded_ax(lev, x)
    if lev.blocked:
        return _ax(lev, x)
    return pad_interior(_mult_interior_arrays(lev.L, lev.D, x))


def residual(lev: PoissonLevel, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """r = z - Ax, zeroed inside bodies and mean-corrected for solvability
    (reference ``residual!``)."""
    D = x.ndim
    xb = bc_scalar_periodic(x, lev.perdir)
    if lev.banded:
        # the iD == 0 dead-cell mask only trips inside the body (the box)
        r_int = interior_view(z, D) - interior_view(_banded_ax(lev, xb), D)
        rw = torch.where(interior_view(_win(lev, lev.iD), D) == 0, 0.0,
                         interior_view(_win(lev, z), D) - _box_ax(lev, xb))
        r_int = _box_update(lev, r_int, rw)
    else:
        if lev.blocked:
            ax = interior_view(_ax(lev, xb), D)
        else:
            ax = _mult_interior_arrays(lev.L, lev.D, xb)
        r_int = torch.where(interior_view(lev.iD, D) == 0, 0.0,
                            interior_view(z, D) - ax)
    s = torch.sum(r_int) / inside_count(tuple(x.shape))
    eps = torch.finfo(x.dtype).eps
    corr = torch.where(torch.abs(s) <= 2 * eps, 0.0, s).to(x.dtype)
    return pad_interior(r_int - corr)


def increment(lev: PoissonLevel, x, r, eps):
    """(x + eps, r − A eps) (reference ``increment!``).  ``eps`` must be
    zero in non-periodic ghosts; on a `bf16_eps` level it is rounded to
    bf16 first (Jacobi's r∘iD and the V-cycle's correction too), so x and
    r see the same rounded eps.  Blocked levels: `increment3d` (under
    ``STREAM`` `attic.increment3d_stream`) on the level's operator."""
    if lev.blocked:
        if lev.bf16_eps:
            eps = eps.to(torch.bfloat16)
        eps = bc_scalar_periodic(eps, lev.perdir)
        inc = at.increment3d_stream if STREAM else sk.increment3d
        return inc(*_opLD(lev), eps, x, r)
    return x + eps, r - mult(lev, eps)


def pressure_grad_arrays(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Interior of ``L∘∇x`` stacked over components."""
    D = L.shape[0]
    iv = lambda a, off=None: interior_view(a, D, off)
    return torch.stack([iv(L[i]) * (iv(x) - iv(x, _off(D, i, -1)))
                        for i in range(D)], dim=0)


def pressure_grad_interior(lev: PoissonLevel, x: torch.Tensor) -> torch.Tensor:
    """Interior of the μ₀-weighted pressure gradient used by the projection
    (banded levels: the far-field L is the wall-masked constant)."""
    if not lev.banded:
        return pressure_grad_arrays(lev.L, x)
    D = x.ndim
    iv = lambda a, off=None: interior_view(a, D, off)
    xw, Lw = _win(lev, x), _win(lev, lev.L, 1)
    comps = []
    for i in range(D):
        clo, _ = _wall_coeffs(tuple(x.shape), i, lev.perdir, x.dtype, lev.c,
                              x.device)
        far = clo * (iv(x) - iv(x, _off(D, i, -1)))
        w = iv(Lw[i]) * (iv(xw) - iv(xw, _off(D, i, -1)))
        comps.append(_box_update(lev, far, w))
    return torch.stack(comps, dim=0)


def jacobi(lev: PoissonLevel, x, r, it: int = 1):
    """Jacobi smoother, the V-cycle's pre-smoother."""
    for _ in range(it):
        x, r = increment(lev, x, r, _rid(lev, r))
    return x, r


def fdot(lev: PoissonLevel, a, b) -> torch.Tensor:
    """Solver dot product (ghost-zero operands): the `attic.dot3d` kernel
    on blocked levels under ``KDOT``, `grid.field_dot` otherwise."""
    if KDOT and lev.blocked:
        return at.dot3d(a, b)
    return field_dot(a, b)


def _rho_rid(lev: PoissonLevel, r, z) -> torch.Tensor:
    """⟨r, r∘iD⟩ for PCG's rho given ``z = r∘iD``; under ``KDOT`` on a
    blocked level the kernel re-reads r and iD (iD16 where the level has
    it) instead of taking z."""
    if KDOT and lev.blocked:
        return at.dot3d(r, _iDk(lev), mode="rid")
    return field_dot(r, z)


def pcg(lev: PoissonLevel, x, r, it: int = 6):
    """Jacobi-preconditioned conjugate gradient smoother (reference
    src/Poisson.jl:123-143), early exits as a monotone ``dead`` mask held on
    the device; the plain version of `pcg_kernel.pcg_fused`.  A `bf16_eps`
    level rounds each new direction to bf16 and upcasts it wherever it
    meets an f32 scalar (JAX's promotion); a shadowed level applies L16/D16
    and preconditions with iD16; ``KAXPY`` and ``KDOT`` route a blocked
    level's axpy pair and dots through `ops.attic`."""
    dt = x.dtype
    teneps = 10 * torch.finfo(dt).eps
    z = _rid(lev, r)
    eps = z.to(torch.bfloat16) if lev.bf16_eps else z
    rho = _rho_rid(lev, r, z)
    dead = torch.abs(rho) < teneps
    for i in range(it):
        eps = bc_scalar_periodic(eps, lev.perdir)
        if lev.banded:
            z, denom = _banded_ax(lev, eps, with_dot=True)
        elif lev.blocked:
            z, denom = _ax(lev, eps, with_dot=True)
        else:
            z = mult(lev, eps)
            denom = field_dot(z, eps)
        alpha = torch.where(dead | (denom == 0), 0.0,
                            rho / torch.where(denom == 0, 1.0, denom)).to(dt)
        dead = dead | (torch.abs(alpha) < 1e-2) | (torch.abs(alpha) > 1e2)
        upd = torch.where(dead, 0.0, alpha).to(dt)
        last = i == it - 1
        if KAXPY and lev.blocked and not last:
            x, r, rho2 = at.pcg_axpy(x, r, eps, z, _iDk(lev), upd)
            z2 = _rid(lev, r)
        else:
            x = x + upd * sk._wide(eps)
            r = r - upd * z
            if last:
                break
            z2 = _rid(lev, r)
            rho2 = _rho_rid(lev, r, z2)
        dead = dead | (torch.abs(rho2) < teneps)
        beta = torch.where(dead, 0.0,
                           rho2 / torch.where(rho == 0, 1.0, rho)).to(dt)
        eps = mask_interior(beta * sk._wide(eps) + z2)
        if lev.bf16_eps:
            eps = eps.to(torch.bfloat16)
        rho = torch.where(dead, rho, rho2)
    return x, r


def smooth(lev: PoissonLevel, x, r, it: int = 6):
    """Default smoother (reference ``smooth! = pcg!``): the one-launch PCG
    kernel on small CUDA levels (never on a level with operator shadows:
    it applies the f32 operator, and one solve must not mix the two, as
    in JAX), `attic.pcg_blocked` on blocked dense non-periodic levels under
    ``PCG_BLOCKED``, `pcg` elsewhere."""
    if (lev.L16 is None
            and pk.use_pcg_fused(tuple(x.shape), x.dtype, x.device)):
        return pk.pcg_fused(lev, x, r, it)
    if PCG_BLOCKED and lev.blocked and not lev.perdir and not lev.banded:
        return at.pcg_blocked(lev, x, r, it)
    return pcg(lev, x, r, it)


def poisson_solve(lev: PoissonLevel, x, z, tol=1e-4, itmx=1000,
                  smoother=smooth):
    """Single-level iterative solve (reference ``solver!``): at least one
    smoothing pass, then until ``r·r < tol``, ``itmx`` passes, or a pass
    that doubles ``r·r`` (divergence safeguard).  Syncs the host once per
    pass.  Returns ``(x, r, n_iters)``."""
    r = residual(lev, x, z)
    r2 = fdot(lev, r, r)
    n, go = 0, True
    while go:
        x, r = smoother(lev, x, r)
        r2p, r2 = r2, fdot(lev, r, r)
        n += 1
        go = n < itmx and bool((r2 >= tol) & ~(r2 > 2.0 * r2p))
    x = bc_scalar_periodic(x, lev.perdir)
    return x, r, n
