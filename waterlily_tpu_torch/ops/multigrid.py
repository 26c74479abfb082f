"""Geometric multigrid over nested Poisson levels.

PyTorch counterpart of `waterlily_tpu.ops.multigrid` (reference
src/MultiLevelPoisson.jl), dense single-device path.  Grid transfers
(0-based): coarse interior cell ``c`` has fine children ``{2c-1, 2c}`` per
axis.  A level of ghost-padded size ``S`` coarsens to ``1 + S//2`` while
every ``S`` is even and >4, with at most 10 coarsenings and at least 3
levels.
"""
from __future__ import annotations

import torch

from ..grid import interior_view, pad_interior
from .bc import bc_vector, bc_scalar_periodic
from .poisson import make_level, residual, jacobi, smooth, increment, fdot

__all__ = ["n_levels", "coarse_shape", "restrict", "restrict_L", "prolongate",
           "build_levels", "vcycle", "ml_solve"]

MAX_LEVELS = 10


def _divisible(s: int) -> bool:
    return s % 2 == 0 and s > 4


def coarse_shape(S: tuple) -> tuple:
    return tuple(1 + s // 2 for s in S)


def n_levels(S: tuple) -> int:
    """Level count for ghost-padded shape S."""
    n = 1
    while all(_divisible(s) for s in S) and n <= MAX_LEVELS:
        S = coarse_shape(S)
        n += 1
    if n <= 2:
        raise ValueError(
            "MultiLevelPoisson requires interior size = a*2^n with n>2 "
            f"(got ghost-padded shape {S})")
    return n


def restrict(b: torch.Tensor) -> torch.Tensor:
    """Sum-of-children restriction of a scalar; coarse ghosts are zero."""
    D = b.ndim
    S = b.shape
    v = interior_view(b, D)
    for d in range(D):
        M = (S[d] - 2) // 2
        v = v.reshape(v.shape[:d] + (M, 2) + v.shape[d + 1:]).sum(dim=d + 1)
    return pad_interior(v)


def restrict_L(L: torch.Tensor, perdir: tuple = ()) -> torch.Tensor:
    """Face-coefficient restriction: component ``i`` sums the 2^(D-1)
    transverse children of the lower child face, halves, and the vector BC
    zeroes the wall-normal ghosts."""
    D = L.shape[0]
    S = L.shape[1:]
    comps = []
    for i in range(D):
        v = interior_view(L[i], D)
        for d in range(D):
            M = (S[d] - 2) // 2
            if d == i:
                # lower child only: fine interior indices 0, 2, 4, ...
                v = v[(slice(None),) * d + (slice(0, 2 * M, 2),)]
            else:
                v = v.reshape(v.shape[:d] + (M, 2) + v.shape[d + 1:]).sum(
                    dim=d + 1)
        comps.append(pad_interior(0.5 * v))
    a = torch.stack(comps, dim=0)
    return bc_vector(a, (0.0,) * D, save_exit=False, perdir=perdir)


def prolongate(x_coarse: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant injection coarse -> fine; fine ghosts are zero."""
    D = x_coarse.ndim
    v = interior_view(x_coarse, D)
    for d in range(D):
        v = torch.repeat_interleave(v, 2, dim=d)
    return pad_interior(v)


def build_levels(mu0: torch.Tensor, perdir: tuple = ()) -> tuple:
    """The level stack from the fine face coefficients: the fine ``L`` is
    the BDIM zeroth moment ``μ₀``, each coarse ``L`` its restriction."""
    nlev = n_levels(tuple(mu0.shape[1:]))
    levels = []
    L = mu0
    for li in range(nlev):
        levels.append(make_level(L, perdir))
        if li < nlev - 1:
            L = restrict_L(L, perdir)
    return tuple(levels)


def vcycle(levels: tuple, l: int, x, r):
    """One V-cycle from level ``l``: Jacobi pre-smooth, restrict the
    residual, recurse, PCG-smooth the coarse level, prolongate, increment."""
    fine, coarse = levels[l], levels[l + 1]
    x, r = jacobi(fine, x, r)
    rc = restrict(r)
    xc = torch.zeros_like(coarse.D)
    if l + 1 < len(levels) - 1:
        xc, rc = vcycle(levels, l + 1, xc, rc)
    xc, rc = smooth(coarse, xc, rc)
    eps = prolongate(xc)
    return increment(fine, x, r, eps)


def ml_solve(levels: tuple, x, z, tol=1e-4, itmx=32, fixed=None):
    """Multigrid pressure solve (reference ``solver!``): V-cycle plus
    fine-level PCG per outer iteration, at least one iteration, until
    ``r·r < tol``, ``itmx`` iterations, or an iteration that doubles ``r·r``
    (divergence safeguard).  The adaptive loop syncs the host once per
    outer iteration; ``fixed=k`` runs exactly ``k`` iterations without a
    sync.  Returns ``(x, r, n)``."""
    fine = levels[0]
    r = residual(fine, x, z)
    if fixed is not None:
        for _ in range(fixed):
            x, r = vcycle(levels, 0, x, r)
            x, r = smooth(fine, x, r)
        return bc_scalar_periodic(x, fine.perdir), r, int(fixed)
    r2 = fdot(fine, r, r)
    n, go = 0, True
    while go:
        x, r = vcycle(levels, 0, x, r)
        x, r = smooth(fine, x, r)
        r2p, r2 = r2, fdot(fine, r, r)
        n += 1
        go = n < itmx and bool((r2 >= tol) & ~(r2 > 2.0 * r2p))
    return bc_scalar_periodic(x, fine.perdir), r, n
