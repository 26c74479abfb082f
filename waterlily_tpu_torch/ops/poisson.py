"""Matrix-free variable-coefficient Poisson operator and smoothers.

PyTorch counterpart of `waterlily_tpu.ops.poisson` (reference
src/Poisson.jl), dense and f32/f64.  The system is ``Ax = [L+D+L']x = z``
with face coefficients ``L`` (the BDIM zeroth moments) and the derived
diagonal ``D[I] = -Σᵢ(L[I,i]+L[I+δᵢ,i])``.

As in the JAX package, the PCG smoother's early exits are a monotone
``dead`` flag held in 0-d tensors, so a smooth never synchronises with the
host.  ``r``, ``z`` and every ``mult`` output are zero in the ghost cells,
so whole-array dots equal the reference's interior dots.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..grid import (interior_view, mask_interior, inside_count, field_dot,
                    pad_interior)
from .bc import bc_scalar_periodic
from . import stencil_kernels as sk
from . import pcg_kernel as pk

__all__ = ["PoissonLevel", "make_level", "mult", "residual", "increment",
           "pressure_grad_interior", "jacobi", "fdot", "pcg", "smooth",
           "poisson_solve"]


def _off(D, i, v):
    return tuple(v if d == i else 0 for d in range(D))


@dataclass(frozen=True)
class PoissonLevel:
    """One multigrid level: face coefficients and derived (inverse) diagonal.

    ``blocked`` selects the stencil kernels (`stencil_kernels.use_blocked`:
    big 3D f32 levels on a CUDA device)."""
    L: torch.Tensor      # (D, *S) lower face coefficients
    D: torch.Tensor      # (*S) diagonal, zero in ghosts
    iD: torch.Tensor     # (*S) guarded inverse diagonal (0 inside bodies)
    blocked: bool = False
    perdir: tuple = ()


def _diag(L: torch.Tensor) -> torch.Tensor:
    """D[I] = -Σᵢ (L[I,i] + L[I+δᵢ,i]) on the interior, zero ghosts."""
    D = L.shape[0]
    s = None
    for i in range(D):
        t = interior_view(L[i], D) + interior_view(L[i], D, _off(D, i, +1))
        s = t if s is None else s + t
    return pad_interior(-s)


def make_level(L: torch.Tensor, perdir: tuple = ()) -> PoissonLevel:
    """Build a level from face coefficients (reference ``set_diag!``).
    f32 search directions throughout: the JAX package's bf16 directions are
    a TPU-only option (ROADMAP B9)."""
    Dd = _diag(L)
    eps = torch.finfo(L.dtype).eps
    guard = Dd * Dd < 2 * eps
    iD = torch.where(guard, 0.0, 1.0 / torch.where(guard, 1.0, Dd)).to(L.dtype)
    blocked = sk.use_blocked(tuple(L.shape[1:]), L.dtype, L.device)
    return PoissonLevel(L=L, D=Dd, iD=iD, blocked=blocked,
                        perdir=tuple(perdir))


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


def _rid(lev: PoissonLevel, r: torch.Tensor) -> torch.Tensor:
    """r * iD, the Jacobi-preconditioned residual."""
    return r * lev.iD


def mult(lev: PoissonLevel, x: torch.Tensor) -> torch.Tensor:
    """z = A x with zero ghosts (reference ``mult!``)."""
    x = bc_scalar_periodic(x, lev.perdir)
    if lev.blocked:
        return sk.mult3d(lev.L, lev.D, x)
    return pad_interior(_mult_interior_arrays(lev.L, lev.D, x))


def residual(lev: PoissonLevel, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """r = z - Ax, zeroed inside bodies and mean-corrected for solvability
    (reference ``residual!``)."""
    D = x.ndim
    xb = bc_scalar_periodic(x, lev.perdir)
    if lev.blocked:
        ax = interior_view(sk.mult3d(lev.L, lev.D, xb), D)
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
    zero in non-periodic ghosts."""
    if lev.blocked:
        eps = bc_scalar_periodic(eps, lev.perdir)
        return sk.increment3d(lev.L, lev.D, eps, x, r)
    return x + eps, r - mult(lev, eps)


def pressure_grad_arrays(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Interior of ``L∘∇x`` stacked over components."""
    D = L.shape[0]
    iv = lambda a, off=None: interior_view(a, D, off)
    return torch.stack([iv(L[i]) * (iv(x) - iv(x, _off(D, i, -1)))
                        for i in range(D)], dim=0)


def pressure_grad_interior(lev: PoissonLevel, x: torch.Tensor) -> torch.Tensor:
    """Interior of the μ₀-weighted pressure gradient used by the projection."""
    return pressure_grad_arrays(lev.L, x)


def jacobi(lev: PoissonLevel, x, r, it: int = 1):
    """Jacobi smoother, the V-cycle's pre-smoother."""
    for _ in range(it):
        x, r = increment(lev, x, r, _rid(lev, r))
    return x, r


def fdot(lev: PoissonLevel, a, b) -> torch.Tensor:
    """Solver dot product (ghost-zero operands)."""
    return field_dot(a, b)


def pcg(lev: PoissonLevel, x, r, it: int = 6):
    """Jacobi-preconditioned conjugate gradient smoother (reference
    src/Poisson.jl:123-143), early exits as a monotone ``dead`` mask held on
    the device; the plain version of `pcg_kernel.pcg_fused`."""
    dt = x.dtype
    teneps = 10 * torch.finfo(dt).eps
    z = _rid(lev, r)
    eps = z
    rho = field_dot(r, z)
    dead = torch.abs(rho) < teneps
    for i in range(it):
        eps = bc_scalar_periodic(eps, lev.perdir)
        if lev.blocked:
            z, denom = sk.mult3d(lev.L, lev.D, eps, with_dot=True)
        else:
            z = mult(lev, eps)
            denom = field_dot(z, eps)
        alpha = torch.where(dead | (denom == 0), 0.0,
                            rho / torch.where(denom == 0, 1.0, denom)).to(dt)
        dead = dead | (torch.abs(alpha) < 1e-2) | (torch.abs(alpha) > 1e2)
        upd = torch.where(dead, 0.0, alpha).to(dt)
        x = x + upd * eps
        r = r - upd * z
        if i == it - 1:
            break
        z2 = _rid(lev, r)
        rho2 = field_dot(r, z2)
        dead = dead | (torch.abs(rho2) < teneps)
        beta = torch.where(dead, 0.0,
                           rho2 / torch.where(rho == 0, 1.0, rho)).to(dt)
        eps = mask_interior(beta * eps + z2)
        rho = torch.where(dead, rho, rho2)
    return x, r


def smooth(lev: PoissonLevel, x, r, it: int = 6):
    """Default smoother (reference ``smooth! = pcg!``): the one-launch PCG
    kernel on small CUDA levels, `pcg` elsewhere."""
    if pk.use_pcg_fused(tuple(x.shape), x.dtype, x.device):
        return pk.pcg_fused(lev, x, r, it)
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
