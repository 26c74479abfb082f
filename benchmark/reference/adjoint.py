"""Plain reference gradient of one step, its pressure solves differentiated
implicitly, in eager PyTorch.

`reverse_step` takes one step of the plain reference (`solver.mom_step`,
the solver's own code) from a state it is handed, with the initial
velocity and the viscosity as leaves, and back-propagates a scalar loss of
the new velocity by ``torch.autograd``.  Every operation of the step but
the pressure solve is differentiated as it is written; each multigrid
solve is an `autograd.Function` around the reference's own `ml_solve`
(`solver.ml_solve`), whose backward pass is one more `ml_solve` on the
same levels.  It imports no module of the measured program.

WaterLily differentiates its solver in forward mode, dual numbers carried
through every iteration (test/maintests.jl:254-278, d KE / d Re).  This
reference departs from that:

- reverse mode, and the derivative of the converged solution rather than
  of the iterates: with ``A x* = P z`` at convergence (``A`` the level's
  symmetric operator, ``P`` the residual's dead-cell mask and mean
  correction), the cotangent of ``z`` is ``λ = A⁻¹ P x̄``, one adjoint
  solve from a zero start with the same tolerance and iteration cap;
- the adjoint's right-hand side is scaled to unit norm and ``λ`` scaled
  back: the stopping test ``r·r < tol`` is absolute and ``x̄`` grows with
  the loss;
- the cotangent of a periodic ghost of ``x*`` is folded onto the interior
  cell it copies (the transpose of `solver.bc_scalar`); the ghosts of
  ``z`` and the dead cells (``iD = 0``) get none;
- the warm start gets no cotangent (a converged solve does not depend on
  it), and the operator none: the body is fixed and its ``μ₀`` is no
  leaf here;
- the convection-diffusion tendency is recomputed in the backward pass
  (`torch.utils.checkpoint`), so that a 256³ step's reverse pass fits on
  one card; recomputing changes no number.
"""
from __future__ import annotations

import contextlib
from dataclasses import replace

import torch
from torch.utils.checkpoint import checkpoint

from . import solver as rsolver

__all__ = ["ke_total", "reverse_step"]

# the reference's own solve and tendency, whatever `_implicit` swaps in
_ML_SOLVE = rsolver.ml_solve
_CONV_DIFF = rsolver.conv_diff


def ke_total(u):
    """Total kinetic energy ``Σ 0.125·Σᵢ(uᵢ[I]+uᵢ[I+δᵢ])²`` over the
    interior cells (WaterLily Metrics.jl ``ke``, summed)."""
    D = u.shape[0]
    s = None
    for i in range(D):
        t = torch.sum((rsolver.iv(u[i], D)
                       + rsolver.iv(u[i], D, rsolver._off(D, i, 1))) ** 2)
        s = t if s is None else s + t
    return 0.125 * s


def _fold(xbar, perdir):
    """``xbar``, the cotangent of ``bc_scalar(x, perdir)``, taken back to
    ``x``."""
    if not perdir:
        return xbar
    x = torch.zeros_like(xbar, requires_grad=True)
    with torch.enable_grad():
        (out,) = torch.autograd.grad(rsolver.bc_scalar(x, perdir), x, xbar)
    return out


class _Solve(torch.autograd.Function):
    """``x*`` of `solver.ml_solve`, differentiable in ``z`` by one adjoint
    solve; ``counts`` receives the forward's and the adjoint's
    iteration counts."""

    @staticmethod
    def forward(ctx, z, x0, levels, tol, itmx, counts):
        x, n = _ML_SOLVE(levels, x0.detach(), z.detach(), tol, itmx)
        counts["forward"].append(n)
        ctx.levels, ctx.tol, ctx.itmx, ctx.counts = levels, tol, itmx, counts
        return x

    @staticmethod
    def backward(ctx, xbar):
        fine = ctx.levels[0]
        D = xbar.ndim
        xbar = _fold(xbar.detach(), fine.perdir)
        s = torch.sqrt(rsolver.dot(xbar, xbar))
        safe = torch.where(s > 0, s, 1.0).to(xbar.dtype)
        lam, n = _ML_SOLVE(ctx.levels, torch.zeros_like(xbar), xbar / safe,
                           ctx.tol, ctx.itmx)
        ctx.counts["adjoint"].append(n)
        lam = torch.where(s > 0, lam * safe, 0.0)
        zbar = torch.where(rsolver.iv(fine.iD, D) == 0, 0.0,
                           rsolver.iv(lam, D))
        return rsolver.pad(zbar), None, None, None, None, None


@contextlib.contextmanager
def _implicit(counts):
    """`solver.mom_step` with each pressure solve a `_Solve` and the
    tendency recomputed in the backward pass, for the block."""
    def ml_solve(levels, x, z, tol, itmx):
        x = _Solve.apply(z, x, levels, tol, itmx, counts)
        return x, counts["forward"][-1]

    def conv_diff(u, nu, perdir=(), limiter=rsolver.quick):
        return checkpoint(_CONV_DIFF, u, nu, perdir, limiter,
                          use_reentrant=False)

    rsolver.ml_solve, rsolver.conv_diff = ml_solve, conv_diff
    try:
        yield
    finally:
        rsolver.ml_solve, rsolver.conv_diff = _ML_SOLVE, _CONV_DIFF


def reverse_step(cfg: rsolver.Config, levels, st: rsolver.State,
                 loss_fn=ke_total):
    """One reference step from ``st`` and the gradient of
    ``loss_fn(new u)`` in ``st.u`` and in ``cfg.nu``.  Returns ``(loss,
    g_u, g_nu, new state, counts)``, ``counts`` the predictor's and
    corrector's forward iteration counts, then their adjoint solves'
    (the predictor's first): ``[n1, n2, a1, a2]``."""
    dtype, dev = st.u.dtype, st.u.device
    u0 = st.u.detach().requires_grad_()
    nu = torch.tensor(float(cfg.nu), dtype=dtype, device=dev,
                      requires_grad=True)
    counts = {"forward": [], "adjoint": []}
    with torch.enable_grad(), _implicit(counts):
        new, n = rsolver.mom_step(replace(cfg, nu=nu), levels,
                                  replace(st, u=u0))
        loss = loss_fn(new.u)
        g_u, g_nu = torch.autograd.grad(loss, (u0, nu))
    new = replace(new, u=new.u.detach(), p=new.p.detach(),
                  dt=new.dt.detach(), t=new.t.detach())
    return (loss.detach(), g_u, g_nu, new,
            list(n) + counts["adjoint"][::-1])
