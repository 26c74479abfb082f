"""Matrix-free variable-coefficient Poisson operator and smoothers.

PyTorch counterpart of `waterlily_tpu.ops.poisson` (reference
src/Poisson.jl), f32/f64, dense and banded levels.  The system is
``Ax = [L+D+L']x = z`` with face coefficients ``L`` (the BDIM zeroth
moments) and the derived diagonal ``D[I] = -Σᵢ(L[I,i]+L[I+δᵢ,i])``.

As in the JAX package, the PCG smoother's early exits are a monotone
``dead`` flag held in 0-d tensors, so a smooth never synchronises with the
host.  ``r``, ``z`` and every ``mult`` output are zero in the ghost cells,
so whole-array dots equal the reference's interior dots.

`smooth` sends a blocked, non-periodic, non-banded level whose kernels
take it to `attic.pcg_blocked`, the smooth as two hand-written sweeps an
iteration with the scalar step inside them, and counts its route in
``smooth.routes``.  Two module flags route the plain `pcg`'s dots and axpy
pair on blocked levels through the kernels of `ops.attic`, as the JAX
package's ``KDOT``/``KAXPY`` do, and a third, ``STREAM``, their operator
through its carried-rows kernels.  All three are off by default: they are
seams for A/B runs (`chip_smoke.py` phase 6.4), not the default path.
Under `torch.func.vmap` alone (an ensemble) each seam opens as the default
path's level branches do (`_open`), to its kernels' member forms.
``BF16_OP`` (off, as in JAX) is the default of the bf16 operator shadows
(`PoissonLevel.L16`, ``Simulation(op_bf16=)``).

A blocked level whose coefficients or operands autograd tracks
(`stencil_kernels.ad_tracked`: a ``fixed_iters`` solve under
``torch.autograd``, a `torch.func` transform) runs the kernels' plain
versions on its own device, the same function in the same association;
the kernels, which have no derivatives, see only untracked tensors.
"""
from __future__ import annotations

import collections
import dataclasses
from dataclasses import dataclass

import torch

from ..grid import (interior_view, mask_interior, inside_count, field_dot,
                    pad_interior, axis_coord, window, put_window)
from .bc import bc_scalar_periodic
from . import stencil_kernels as sk
from . import pcg_kernel as pk
from . import attic as at
from ..utils.perf import host_read

__all__ = ["PoissonLevel", "make_level", "mult", "residual", "increment",
           "pressure_grad_interior", "jacobi", "fdot", "pcg", "smooth",
           "poisson_solve", "operator_shadows", "level_tensors",
           "with_level_tensors", "adaptive_members", "KDOT", "KAXPY",
           "STREAM", "BF16_OP"]

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
# A·x (with and without the dot) and r − A·eps of blocked levels by the
# carried-rows wrappers `attic.mult3d_stream`/`increment3d_stream` instead
# of `mult3d`/`increment3d` (the JAX package keeps them but dispatches them
# nowhere).  `mult3d` launches `mult3d_stream`'s kernel, so the seam now
# changes only the increment's kernel, and which wrapper counts A·x.
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
    window of extents ``box_shape`` at corner ``box_start`` (the
    `grid.band_box_start` convention): host ints in a single run, a ``(D,)``
    int64 tensor where each member of a `torch.func.vmap` ensemble has its
    own (read and written by `grid.window`/`put_window`, and carried with
    the level's tensors, `level_tensors`).  Equal to the dense operator
    bit for bit."""
    L: torch.Tensor      # (D, *S) lower face coefficients
    D: torch.Tensor      # (*S) diagonal, zero in ghosts
    iD: torch.Tensor     # (*S) guarded inverse diagonal (0 inside bodies)
    blocked: bool = False
    bf16_eps: bool = False
    perdir: tuple = ()
    banded: bool = False
    c: float = 1.0
    box_shape: tuple | None = None
    box_start: tuple | torch.Tensor | None = None
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
    A banded level (``banded`` with a ``box_shape``) is never blocked; its
    ``box_start`` stays a tensor where it is given one (a member's own
    corner under `torch.func.vmap`).  ``Dd`` and ``iD``, and the shadows
    where given, are taken as they are (a level carried across,
    `convert.py`)."""
    if Dd is None:
        Dd = _diag(L)
        iD = _guarded_inverse(Dd).to(L.dtype)
    if banded and box_shape is not None:
        banded = True
        box_shape = tuple(int(b) for b in box_shape)
        box_start = (box_start.to(torch.int64)
                     if isinstance(box_start, torch.Tensor)
                     else tuple(int(b) for b in box_start))
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


def _tracked(lev: PoissonLevel, *fields) -> bool:
    """True where autograd tracks the level's coefficients or ``fields``:
    its kernels' plain versions run instead of the kernels."""
    return sk.ad_tracked(lev.L, lev.D, *fields)


def _open(lev: PoissonLevel, *fields) -> bool:
    """True where a blocked level's kernels (`mult3d`, `increment3d` and
    the seams' `ops.attic` wrappers) take the level and ``fields``:
    nothing tracks them, or `vmap` alone does (their member forms)."""
    return sk.tracked_by(lev.L, lev.D, *_opLD(lev), *fields) <= {"vmap"}


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
    """A·x of a blocked level (with ⟨A·x, x⟩ under ``with_dot``):
    `mult3d`, or under ``STREAM`` `attic.mult3d_stream` (the same kernel),
    on the level's operator (`_opLD`); their plain version where autograd
    tracks the level or ``x``, and under `vmap` alone their member form."""
    if not _open(lev, x):
        return sk._mult3d_plain(*_opLD(lev), x, with_dot)
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
    """The body window of ``a``: the box and a one-cell halo (a view where
    the corner is host ints)."""
    return window(a, lev.box_start, tuple(w + 2 for w in lev.box_shape),
                  lead, off=0)


def _box_update(lev: PoissonLevel, interior_field: torch.Tensor,
                box_values: torch.Tensor) -> torch.Tensor:
    """Overwrite the box cells of an interior-shaped field the caller owns
    (in place where the corner is host ints) and return it."""
    return put_window(interior_field, lev.box_start, lev.box_shape,
                      box_values, off=0)


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
    gate holds (its member form under `vmap` alone, each member's window
    at its own corner), the plain far-field form elsewhere."""
    D = x.ndim
    if sk.members_ok(tuple(x.shape), x.dtype, x.device, x, lev.L):
        zw = _box_ax(lev, x)
        start, W = lev.box_start, lev.box_shape
        if with_dot:
            z, dot = sk.ana_mult3d(x, lev.c, lev.perdir, with_dot=True)
            # the window overwrite changes the dot by <zw - z_far, x> there
            dot = dot + field_dot(zw - window(z, start, W),
                                  interior_view(_win(lev, x), D))
            return put_window(z, start, W, zw), dot
        return put_window(sk.ana_mult3d(x, lev.c, lev.perdir), start, W, zw)
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
    ``STREAM`` `attic.increment3d_stream`) on the level's operator, their
    plain version where autograd tracks the level or an operand, and under
    `vmap` alone their member form."""
    if lev.blocked:
        if lev.bf16_eps:
            eps = eps.to(torch.bfloat16)
        eps = bc_scalar_periodic(eps, lev.perdir)
        inc = at.increment3d_stream if STREAM else sk.increment3d
        if not _open(lev, eps, x, r):
            inc = sk._increment3d_plain
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
    on blocked levels under ``KDOT`` (its member form under `vmap` alone),
    `grid.field_dot` otherwise and where autograd tracks an operand."""
    if KDOT and lev.blocked and _open(lev, a, b):
        return at.dot3d(a, b)
    return field_dot(a, b)


def _rho_rid(lev: PoissonLevel, r, z) -> torch.Tensor:
    """⟨r, r∘iD⟩ for PCG's rho given ``z = r∘iD``; under ``KDOT`` on a
    blocked level the kernel re-reads r and iD (iD16 where the level has
    it) instead of taking z (its member form under `vmap` alone)."""
    if KDOT and lev.blocked and _open(lev, r, _iDk(lev)):
        return at.dot3d(r, _iDk(lev), mode="rid")
    return field_dot(r, z)


def pcg(lev: PoissonLevel, x, r, it: int = 6):
    """Jacobi-preconditioned conjugate gradient smoother (reference
    src/Poisson.jl:123-143), early exits as a monotone ``dead`` mask held on
    the device; the plain version of `pcg_kernel.pcg_fused`.  A `bf16_eps`
    level rounds each new direction to bf16 and upcasts it wherever it
    meets an f32 scalar (JAX's promotion); a shadowed level applies L16/D16
    and preconditions with iD16; ``KAXPY`` and ``KDOT`` route a blocked
    level's axpy pair and dots through `ops.attic` (their member forms
    under `vmap` alone)."""
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
        if KAXPY and lev.blocked and not last and _open(
                lev, x, r, eps, z, upd, _iDk(lev)):
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
    """Default smoother (reference ``smooth! = pcg!``), routed by what the
    level shows: the one-launch PCG kernel `pcg_kernel.pcg_fused` on small
    CUDA levels (never on a level with operator shadows: it applies the
    f32 operator, and one solve must not mix the two, as in JAX);
    `attic.pcg_blocked`, two sweeps an iteration with the scalar step in
    them, on blocked, non-periodic, non-banded levels (bf16 directions and
    operator shadows in its forms of them); `pcg` elsewhere (periodic and
    banded levels, the CPU) and wherever autograd tracks the level, ``x``
    or ``r``.  Under `torch.func.vmap` alone (an ensemble,
    `stencil_kernels.vmap_only`) the small CUDA levels still take
    `pcg_fused`, whose `vmap` rule smooths the members in one launch a
    chunk of them, and the blocked levels `pcg_blocked`, whose two sweeps
    take their member forms.  Each call counts its route and the level's
    shape in ``smooth.routes``."""
    S = tuple(x.shape)
    if (lev.L16 is None
            and pk.use_pcg_fused(S, x.dtype, x.device)
            and (not _tracked(lev, x, r)
                 or sk.vmap_only(lev.L, lev.D, lev.iD, x, r))):
        smooth.routes["pcg_fused", S] += 1
        return pk.pcg_fused(lev, x, r, it)
    if (lev.blocked and not lev.perdir and not lev.banded
            and _open(lev, x, r, _iDk(lev))):
        smooth.routes["pcg_blocked", S] += 1
        return at.pcg_blocked(lev, x, r, it)
    smooth.routes["pcg", S] += 1
    return pcg(lev, x, r, it)


# (route, level shape) -> calls of `smooth`: "pcg_fused", "pcg_blocked" or
# "pcg", kept like the kernel wrappers' ``.shapes``
smooth.routes = collections.Counter()


# --- the adaptive loops under torch.func.vmap -------------------------------
#
# `poisson_solve` and `multigrid.ml_solve` stop when a host read of the
# residual says so, which `vmap` cannot trace.  Under `vmap` both hand their
# loop to `_Adaptive`, whose `vmap` rules fold every `vmap` level into one
# member axis and run it with that axis in the open: each iteration is one
# `vmap` of the solver's iteration over every member, a member that has
# stopped keeps its values (`torch.where`, bit for bit), and the loop ends
# when every member has stopped, with one host read an iteration.  JAX's
# batched `while_loop` does the same.  The level tensors are arguments of
# the rule, so it sees which carry the member axis and which every member
# shares.
#
# Forward mode (`jvp` of the batched loop, in either order of `vmap` and
# `jvp`) is `_Adaptive`'s `jvp` rule, as JAX's `jvp` of a `while_loop`: a
# second loop, through the same rules, carries each member's primal and
# tangent, each iteration the `jvp` of one iteration, and runs each member
# for the count its primal loop took.  Reverse mode raises, as JAX's does
# for a `while_loop`.

# tensor fields of a level, in the order `level_tensors` flattens them (a
# banded level's corner where it is a tensor: each member's own)
_LEVEL_TENSORS = ("L", "D", "iD", "L16", "D16", "iD16", "box_start")


def level_tensors(levels: tuple) -> tuple:
    """``(spec, tensors)``: the level stack with its tensor fields taken
    out (None) and those tensors, flat, for `with_level_tensors`."""
    spec, flat = [], []
    for lev in levels:
        have = tuple(isinstance(getattr(lev, f), torch.Tensor)
                     for f in _LEVEL_TENSORS)
        flat += [getattr(lev, f) for f, h in zip(_LEVEL_TENSORS, have) if h]
        spec.append((dataclasses.replace(
            lev, **{f: None for f, h in zip(_LEVEL_TENSORS, have) if h}),
            have))
    return tuple(spec), tuple(flat)


def with_level_tensors(spec: tuple, tensors) -> tuple:
    """The level stack of `level_tensors`' ``spec`` with ``tensors`` put
    back."""
    it = iter(tensors)
    return tuple(dataclasses.replace(lev, **{
        f: next(it) for f, h in zip(_LEVEL_TENSORS, have) if h})
        for lev, have in spec)


def _go_on(n, itmx, r2, r2p, tol):
    """The adaptive loops' test to go on: fewer than ``itmx`` iterations,
    ``r·r >= tol`` and no iteration that doubled ``r·r``."""
    return (n < itmx) & (r2 >= tol) & ~(r2 > 2.0 * r2p)


def adaptive_members(step, carry: tuple, r2, tol, itmx: int, rows=None,
                     counts=None):
    """The adaptive loop over the members of ``carry`` (tensors with the
    member axis first) and their ``r·r`` ``r2`` (``(M,)``): ``step(carry)
    -> (carry, r2)`` is one iteration of every member; each member stops by
    its own test (`_go_on`) after at least one iteration and keeps its
    values from then on (`torch.where`); the loop ends when all have
    stopped.  With ``counts`` (``(M,)``, each at least 1) member m instead
    runs exactly ``counts[m]`` iterations (``r2`` and ``tol`` unread: the
    tangent loop of `_Adaptive`'s `jvp` rule).  Returns ``(carry, n)``,
    ``n`` the ``(M,)`` int64 counts, and with ``rows`` (``carry -> (M,
    k)``, the residual trace's rows) also the ``(M, itmx+1, k)`` trace: row
    0 of the initial carry, row ``i+1`` after each member's iteration
    ``i``, zeros after its last."""
    M = carry[0].shape[0]
    dev = carry[0].device
    n = torch.zeros(M, dtype=torch.int64, device=dev)
    active = torch.ones(M, dtype=torch.bool, device=dev)
    if rows is not None:
        first = rows(carry)
        tr = torch.zeros((M, itmx + 1) + tuple(first.shape[1:]),
                         dtype=first.dtype, device=first.device)
        tr[:, 0] = first
        slot = torch.arange(itmx + 1, device=dev)
    r2p = r2
    while True:
        new, r2n = step(carry)

        def keep(a, b):
            return torch.where(active.reshape((M,) + (1,) * (a.ndim - 1)),
                               a, b)
        carry = tuple(keep(a, b) for a, b in zip(new, carry))
        if counts is None:
            r2p, r2 = keep(r2, r2p), keep(r2n, r2)
        if rows is not None:
            at_row = active[:, None] & (slot[None, :] == n[:, None] + 1)
            tr = torch.where(at_row[..., None], rows(carry)[:, None], tr)
        n = n + active
        active = active & (n < counts if counts is not None
                           else _go_on(n, itmx, r2, r2p, tol))
        with host_read("members"):
            going = bool(active.any())
        if not going:
            break
    return (carry, n) if rows is None else (carry, n, tr)


class _Adaptive(torch.autograd.Function):
    """An adaptive loop for `torch.func.vmap`: ``loop(dims, *args)`` runs
    it on ``args`` (the carry, with a member axis first, then the level
    tensors, those whose ``dims`` is 0 with a member axis too; None where
    an argument is shared by every member or absent) and returns
    member-axis outputs.  The `vmap` rule folds its batch axis into the
    member axis (`pcg_kernel.fold_members`) and applies the Function again,
    so that nested `vmap` levels fold one by one and the loop runs once,
    over the members of all of them.  The `jvp` rule runs the loop's
    tangent loop (`_Loop.tangent_loop`) through the same Function; the
    backward raises."""

    @staticmethod
    def forward(loop, dims, *args):
        return loop(dims, *args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        loop, dims, *args = inputs
        ctx.loop, ctx.dims = loop, dims
        if loop.primal:
            ctx.none = tuple(a is None for a in args)
            ctx.save_for_forward(output[2],
                                 *[a for a in args if a is not None])

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the adaptive pressure solve under torch.func.vmap has no "
            "reverse-mode derivative, as in the JAX package (JAX raises "
            "'Reverse-mode differentiation does not work for "
            "lax.while_loop'): differentiate a fixed_iters solve, or use "
            "implicit_diff (one adjoint solve), for reverse mode; forward "
            "mode (torch.func.jvp) runs through it")

    @staticmethod
    def jvp(ctx, _loop, _dims, *tangents):
        n, *kept = ctx.saved_tensors
        it = iter(kept)
        args = [None if none else next(it) for none in ctx.none]
        x, r, _r2, *ops = args
        xd, rd, _r2d, *dots = tangents
        xd = torch.zeros_like(x) if xd is None else xd
        rd = torch.zeros_like(r) if rd is None else rd
        dims = ctx.dims[3:]
        out = _Adaptive.apply(ctx.loop.tangent_loop(),
                              (0,) * 5 + dims + dims,
                              n, x, r, xd, rd, *ops, *dots)
        return (out[0], out[1], None) + tuple(out[2:])

    @staticmethod
    def vmap(info, in_dims, loop, dims, *args):
        # the first argument (x, or the tangent loop's counts) always
        # carries the member axis
        B = info.batch_size
        M = args[0].shape[1 if in_dims[2] == 0 else 0]
        folded = [t if t is None else
                  pk.fold_members(t, d, m is not None, B, M)
                  for t, d, m in zip(args, in_dims[2:], dims)]
        dims = tuple(None if m is None and d is None else 0
                     for m, d in zip(dims, in_dims[2:]))
        out = _Adaptive.apply(loop, dims, *folded)
        return (tuple(o.reshape((B, M) + tuple(o.shape[1:])) for o in out),
                (0,) * len(out))


class _Loop:
    """The adaptive loop of a solver for `_Adaptive`: ``one(levels, x, r)
    -> (x, r)`` its iteration on the level stack of layout ``spec``
    (`level_tensors`), ``tol`` and ``itmx`` its stopping test, ``row``
    (``(x, r) -> [max|r|, r·r]``, or None) the residual trace's row.
    Called as the primal loop on ``(x, r, r2, *ops)``, it returns ``(x, r,
    n)`` (and the trace); its `tangent_loop` on ``(n, x, r, xd, rd, *ops,
    *dots)`` (``dots`` the level tensors' tangents, None where a tensor has
    none) returns the tangents ``(xd, rd)`` (and the trace's).  With
    ``plain`` (the loop is differentiated) the primal loop runs the plain
    forms (`stencil_kernels.plain_forms`), as its tangent loop and each
    member's own `jvp` do, so that both take one route and the counts."""

    primal = True

    def __init__(self, spec, one, tol, itmx, row, plain=False):
        self.spec, self.one, self.tol, self.itmx, self.row = (
            spec, one, tol, itmx, row)
        self.plain = plain

    def __call__(self, dims, x, r, r2, *ops):
        if self.plain:
            with sk.plain_forms():
                return self.run(dims, x, r, r2, *ops)
        return self.run(dims, x, r, r2, *ops)

    def run(self, dims, x, r, r2, *ops):
        spec, one, row = self.spec, self.one, self.row

        def it(x, r, *ops):
            lv = with_level_tensors(spec, ops)
            x, r = one(lv, x, r)
            return (x, r), fdot(lv[0], r, r)
        step = torch.func.vmap(it, in_dims=(0, 0) + tuple(dims[3:]))
        rows = (None if row is None
                else lambda c: torch.func.vmap(row)(*c))
        out = adaptive_members(lambda c: step(*c, *ops), (x, r), r2,
                               self.tol, self.itmx, rows)
        return out[0] + out[1:]

    def tangent_loop(self):
        return _TangentLoop(self)


class _TangentLoop:
    """`_Loop`'s tangent loop (`_Adaptive`'s `jvp` rule): the carry is
    each member's primal and tangent, each iteration the `torch.func.jvp`
    of one iteration, member m run for ``n[m]`` iterations, the count of
    its primal loop."""

    primal = False

    def __init__(self, loop: _Loop):
        self.loop = loop

    def __call__(self, dims, n, x, r, xd, rd, *rest):
        spec, one, row = self.loop.spec, self.loop.one, self.loop.row
        k = len(rest) // 2
        ops, dots = rest[:k], rest[k:]
        live = [i for i, d in enumerate(dots) if d is not None]

        def it(x, r, xd, rd, *a):
            o, do = a[:k], a[k:]

            def f(x, r, *moving):
                full = list(o)
                for i, t in zip(live, moving):
                    full[i] = t
                return one(with_level_tensors(spec, full), x, r)
            (x, r), (xd, rd) = torch.func.jvp(
                f, (x, r) + tuple(o[i] for i in live), (xd, rd) + tuple(do))
            return (x, r, xd, rd), x.new_zeros(())
        step = torch.func.vmap(it, in_dims=(0,) * 4 + tuple(dims[5:5 + k])
                               + tuple(dims[5 + k + i] for i in live))
        moving = [dots[i] for i in live]

        def rows(c):
            return torch.func.vmap(lambda x, r, xd, rd: torch.func.jvp(
                row, (x, r), (xd, rd))[1])(*c)
        out = adaptive_members(lambda c: step(*c, *ops, *moving),
                               (x, r, xd, rd), None, None, self.loop.itmx,
                               None if row is None else rows, counts=n)
        return out[0][2:] + out[2:]


def members_solve(levels: tuple, one, x, r, r2, tol, itmx: int, row=None):
    """The adaptive loop of a solver under `torch.func.vmap`: ``one(levels,
    x, r) -> (x, r)`` is its iteration, ``r2`` the members' ``r·r``, each
    member stopped by its own test (`adaptive_members`) and the loop run
    with the member axis in the open through `_Adaptive`'s `vmap` rule
    (and, under `torch.func.jvp`, its `jvp` rule).  Returns ``(x, r, n)``,
    with ``row`` (``(x, r) -> [max|r|, r·r]``) also the residual trace,
    each member's as `adaptive_members` gives it."""
    spec, ops = level_tensors(levels)
    plain = "ad" in sk.tracked_by(x, r, *ops)
    out = _Adaptive.apply(_Loop(spec, one, tol, itmx, row, plain),
                          (0, 0, 0) + (None,) * len(ops), x[None], r[None],
                          r2[None], *ops)
    return tuple(o[0] for o in out)


def vmap_loop(levels: tuple, *values) -> bool:
    """True where an adaptive loop must run with the member axis in the
    open (`_Adaptive`): ``values`` or the tensors of ``levels`` carry
    `vmap` levels (and perhaps derivatives: forward mode runs through the
    loop's `jvp` rule, reverse mode raises in its backward, as JAX's)."""
    return "vmap" in sk.tracked_by(*values, *(
        getattr(lv, f) for lv in levels for f in _LEVEL_TENSORS))


def poisson_solve(lev: PoissonLevel, x, z, tol=1e-4, itmx=1000,
                  smoother=smooth):
    """Single-level iterative solve (reference ``solver!``): at least one
    smoothing pass, then until ``r·r < tol``, ``itmx`` passes, or a pass
    that doubles ``r·r`` (divergence safeguard).  Syncs the host once per
    pass.  Returns ``(x, r, n_iters)``, ``n_iters`` a host int, or under
    `torch.func.vmap` each member's count (`adaptive_members`), a tensor."""
    r = residual(lev, x, z)
    r2 = fdot(lev, r, r)
    if vmap_loop((lev,), x, z):
        x, r, n = members_solve((lev,), lambda lv, x, r: smoother(lv[0], x, r),
                                x, r, r2, tol, itmx)
        return bc_scalar_periodic(x, lev.perdir), r, n
    n, go = 0, True
    while go:
        x, r = smoother(lev, x, r)
        r2p, r2 = r2, fdot(lev, r, r)
        n += 1
        go = n < itmx
        if go:
            with host_read("solve_check"):
                go = bool((r2 >= tol) & ~(r2 > 2.0 * r2p))
    x = bc_scalar_periodic(x, lev.perdir)
    return x, r, n
