"""Geometric multigrid over nested Poisson levels.

PyTorch counterpart of `waterlily_tpu.ops.multigrid` (reference
src/MultiLevelPoisson.jl), single device, dense and banded levels.  Grid transfers
(0-based): coarse interior cell ``c`` has fine children ``{2c-1, 2c}`` per
axis.  A level of ghost-padded size ``S`` coarsens to ``1 + S//2`` while
every ``S`` is even and >4, with at most 10 coarsenings and at least 3
levels.
"""
from __future__ import annotations

import math

import torch

from ..grid import interior_view, pad_interior
from .bc import bc_vector, bc_scalar_periodic
from .poisson import make_level, residual, jacobi, smooth, increment, fdot

__all__ = ["n_levels", "coarse_shape", "restrict", "restrict_L", "prolongate",
           "build_levels", "update_levels", "vcycle", "ml_solve"]

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


def _band_ok(S, box_shape) -> bool:
    """Banded dispatch pays only while the box is a small fraction of the
    level and its halo'd window fits."""
    return (all(b + 2 <= s for b, s in zip(box_shape, S))
            and 4 * math.prod(box_shape) <= math.prod(S))


def _coarsen_box(box_start, box_shape, S_coarse):
    """Map a band box down one level (fine cell f -> coarse (f+1)//2),
    keeping the one in-box margin cell below the band; host ints."""
    shape_c = tuple(b // 2 + 4 for b in box_shape)
    start_c = tuple(min(max((s + 3) // 2 - 2, 0), Sc - b - 2)
                    for s, Sc, b in zip(box_start, S_coarse, shape_c))
    return start_c, shape_c


def build_levels(mu0: torch.Tensor, perdir: tuple = (), box_shape=None,
                 box_start=None, bf16_eps: bool = False,
                 op_bf16: bool | None = None) -> tuple:
    """The level stack from the fine face coefficients: the fine ``L`` is
    the BDIM zeroth moment ``μ₀``, each coarse ``L`` its restriction.
    ``box_shape``/``box_start`` (the body band window) make the levels on
    which it pays banded; the box coarsens with the grid and the far-field
    coefficient scales by 2^(D-2) per level.  ``bf16_eps`` stores the
    smoother's search direction in bf16 on every blocked level, ``op_bf16``
    (None: `poisson.BF16_OP`) gives every blocked level bf16 operator
    shadows, which exclude bf16 directions (`poisson.make_level`)."""
    S = tuple(mu0.shape[1:])
    nlev = n_levels(S)
    have_box = box_shape is not None and box_start is not None
    levels = []
    L, c = mu0, 1.0
    for li in range(nlev):
        banded = have_box and _band_ok(tuple(L.shape[1:]), box_shape)
        levels.append(make_level(L, perdir, banded=banded, c=c,
                                 box_shape=box_shape if banded else None,
                                 box_start=box_start if banded else None,
                                 bf16_eps=bf16_eps, op_bf16=op_bf16))
        if li == nlev - 1:
            break
        L = restrict_L(L, perdir)
        c *= 2.0 ** (len(S) - 2)
        if have_box:
            box_start, box_shape = _coarsen_box(box_start, box_shape,
                                                tuple(L.shape[1:]))
    return tuple(levels)


def update_levels(levels: tuple, mu0: torch.Tensor, box_start=None) -> tuple:
    """Re-restrict the coefficients after body motion (reference
    ``update!``), keeping the fine level's window (moved to ``box_start``
    when given), its search-direction precision and, as JAX does, its
    operator shadows: present or absent where the level could carry them
    (blocked), the module default otherwise."""
    fine = levels[0]
    op16 = (fine.L16 is not None) if fine.blocked else None
    return build_levels(mu0, fine.perdir, fine.box_shape,
                        box_start if box_start is not None
                        else fine.box_start, bf16_eps=fine.bf16_eps,
                        op_bf16=op16)


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
