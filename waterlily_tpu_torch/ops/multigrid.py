"""Geometric multigrid over nested Poisson levels.

PyTorch counterpart of `waterlily_tpu.ops.multigrid` (reference
src/MultiLevelPoisson.jl), single device, dense and banded levels.  Grid transfers
(0-based): coarse interior cell ``c`` has fine children ``{2c-1, 2c}`` per
axis.  A level of ghost-padded size ``S`` coarsens to ``1 + S//2`` while
every ``S`` is even and >4, with at most 10 coarsenings and at least 3
levels.
"""
from __future__ import annotations

import collections
import math

import torch

from ..grid import interior_view, pad_interior, field_dot
from ..utils.perf import host_read, span, spanned
from .bc import bc_vector, bc_scalar_periodic
from .poisson import (make_level, residual, jacobi, smooth, increment, fdot,
                      _mult_interior_arrays, level_tensors, with_level_tensors,
                      members_solve, vmap_loop)

__all__ = ["n_levels", "coarse_shape", "restrict", "restrict_L", "prolongate",
           "build_levels", "update_levels", "vcycle", "ml_solve",
           "ml_solve_implicit"]

MAX_LEVELS = 10
# the span of each level's V-cycle, by the level's index in the stack
_LEVEL_SPANS = tuple(f"wl.mg.l{k}" for k in range(MAX_LEVELS + 1))


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
    return bc_vector(a, (0.0,) * D, save_exit=False, perdir=perdir,
                     inplace=True)


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
    keeping the one in-box margin cell below the band: ``clip((s+3)//2 -
    2, 0, S_coarse - shape - 2)``, on host ints or, for a corner that is a
    tensor (a member's own under `torch.func.vmap`), on the device, as
    JAX's ``jnp.clip``."""
    shape_c = tuple(b // 2 + 4 for b in box_shape)
    lim = tuple(Sc - b - 2 for Sc, b in zip(S_coarse, shape_c))
    if isinstance(box_start, torch.Tensor):
        hi = torch.tensor(lim, dtype=box_start.dtype,
                          device=box_start.device)
        return torch.minimum(torch.clamp_min(
            (box_start + 3) // 2 - 2, 0), hi), shape_c
    start_c = tuple(min(max((s + 3) // 2 - 2, 0), m)
                    for s, m in zip(box_start, lim))
    return start_c, shape_c


def build_levels(mu0: torch.Tensor, perdir: tuple = (), box_shape=None,
                 box_start=None, bf16_eps: bool = False,
                 op_bf16: bool | None = None) -> tuple:
    """The level stack from the fine face coefficients: the fine ``L`` is
    the BDIM zeroth moment ``μ₀``, each coarse ``L`` its restriction.
    ``box_shape``/``box_start`` (the body band window) make the levels on
    which it pays banded; the box coarsens with the grid and the far-field
    coefficient scales by 2^(D-2) per level.  ``box_start`` is host ints,
    or a ``(D,)`` integer tensor (each member's own corner under
    `torch.func.vmap`), which every banded level keeps as its own.
    ``bf16_eps`` stores the smoother's search direction in bf16 on every
    blocked level, ``op_bf16`` (None: `poisson.BF16_OP`) gives every
    blocked level bf16 operator shadows, which exclude bf16 directions
    (`poisson.make_level`)."""
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
    with span(_LEVEL_SPANS[l]):
        fine, coarse = levels[l], levels[l + 1]
        x, r = jacobi(fine, x, r)
        rc = restrict(r)
        xc = torch.zeros_like(coarse.D)
        if l + 1 < len(levels) - 1:
            xc, rc = vcycle(levels, l + 1, xc, rc)
        xc, rc = smooth(coarse, xc, rc)
        eps = prolongate(xc)
        return increment(fine, x, r, eps)


@spanned("wl.solve.smooth")
def _smooth_fine(levels: tuple, x, r):
    """The fine level's PCG smooth that ends each outer iteration."""
    return smooth(levels[0], x, r)


def _log_row(r, dtype):
    """One row of the residual trace: ``[max|r|, ⟨r, r⟩]``."""
    return torch.stack([torch.max(torch.abs(r)), field_dot(r, r)]).to(dtype)


@spanned("wl.solve")
def ml_solve(levels: tuple, x, z, tol=1e-4, itmx=32, fixed=None,
             trace=False):
    """Multigrid pressure solve (reference ``solver!``): V-cycle plus
    fine-level PCG per outer iteration, at least one iteration, until
    ``r·r < tol``, ``itmx`` iterations, or an iteration that doubles ``r·r``
    (divergence safeguard).  The adaptive loop syncs the host once per
    outer iteration; ``fixed=k`` runs exactly ``k`` iterations without a
    sync.  Returns ``(x, r, n)``, and with ``trace=True`` also the
    residual trace (reference ``@log``): an ``(itmx+1, 2)`` (``(fixed+1,
    2)``) tensor on the device of ``x``, row 0 ``[max|r|, ⟨r, r⟩]`` of the
    initial residual, row ``k+1`` after iteration ``k``, zeros after the
    last iteration (no host sync of its own).

    Under `torch.func.vmap` (an ensemble) the adaptive loop runs every
    member at once through a `vmap` rule (`poisson.adaptive_members`):
    each member stops by its own test and keeps its values from then on,
    and ``n`` is each member's count, a tensor.  `torch.func.jvp` and
    `vmap` compose in either order (the loop's `jvp` rule: each member's
    tangent carried beside its primal, for its primal's count);
    `torch.func.grad` of the batched loop raises `NotImplementedError`, as
    JAX's reverse mode of a ``while_loop`` does (use ``fixed`` or
    `ml_solve_implicit`)."""
    fine = levels[0]
    with span("wl.solve.residual"):
        r = residual(fine, x, z)
    rows = [_log_row(r, x.dtype)] if trace else None

    def finish(x, r, n):
        out = (bc_scalar_periodic(x, fine.perdir), r, n)
        if not trace:
            return out
        # the trace's rows, zeros after the last iteration (built out of
        # place, as `vmap` needs)
        tr = torch.stack(rows)
        pad = (itmx if fixed is None else fixed) + 1 - tr.shape[0]
        return out + (torch.cat([tr, tr.new_zeros((pad, 2))]),)

    if fixed is not None:
        for k in range(fixed):
            x, r = vcycle(levels, 0, x, r)
            x, r = _smooth_fine(levels, x, r)
            if trace:
                rows.append(_log_row(r, x.dtype))
        return finish(x, r, int(fixed))
    r2 = fdot(fine, r, r)
    if vmap_loop(levels, x, z):
        out = members_solve(
            levels, lambda lv, x, r: _smooth_fine(lv, *vcycle(lv, 0, x, r)),
            x, r, r2, tol, itmx,
            (lambda x, r: _log_row(r, x.dtype)) if trace else None)
        return (bc_scalar_periodic(out[0], fine.perdir),) + tuple(out[1:])
    n, go = 0, True
    while go:
        x, r = vcycle(levels, 0, x, r)
        x, r = _smooth_fine(levels, x, r)
        r2p, r2 = r2, fdot(fine, r, r)
        if trace:
            rows.append(_log_row(r, x.dtype))
        n += 1
        go = n < itmx
        if go:
            with host_read("solve_check"):
                go = bool((r2 >= tol) & ~(r2 > 2.0 * r2p))
    return finish(x, r, n)


# --- implicit differentiation (the adjoint pressure solve) ------------------
#
# Reverse mode through `ml_solve(fixed=k)` keeps every smoother iterate of
# every level for the backward pass.  At convergence the solution satisfies
# A(L)·x* = P z (P: the residual's dead-cell mask and mean correction), so
# the implicit-function theorem gives the cotangents from ONE more solve
# with the same operator (A is symmetric) and the vjp of the operator:
#
#   λ = A⁻¹ P x̄             the adjoint solve, on the same level stack
#   z̄ = mask(λ)             x* does not depend on z in dead cells
#   (L̄, D̄) = ∂(−A·x*)ᵀ λ    A·x* is linear in (L, D)
#   x̄₀ = 0                  the warm start does not move a converged solve
#
# Both solves run on a detached view of the level stack, so the kernels see
# untracked tensors.  With a body the residual's mean correction makes the
# solution map slightly non-symmetric; gradients of gauge-invariant outputs
# (forces, kinetic energy: anything built from ∇p or the velocity) are
# exact, as the JAX package notes (`waterlily_tpu.ops.multigrid`).


def _fold_periodic(xs, xbar, perdir):
    """The cotangent ``xbar`` of ``bc_scalar_periodic(xs, perdir)`` taken
    back to its argument: each periodic ghost's cotangent folded onto the
    interior cell it copies (the transpose of the ghost fill)."""
    if not perdir:
        return xbar
    _, pull = torch.func.vjp(lambda v: bc_scalar_periodic(v, perdir), xs)
    return pull(xbar)[0]


def _counts(n):
    """Iteration counts to keep on the host: a host int as it is, a count
    tensor (each member's, under `torch.func.vmap`) as a list."""
    if not isinstance(n, torch.Tensor):
        return n
    while torch._C._functorch.is_functorch_wrapped_tensor(n):
        n = torch._C._functorch.get_unwrapped(n)
    return n.tolist()


class _ImplicitSolve(torch.autograd.Function):
    """``(x*, n)`` of the adaptive `ml_solve`, differentiable in the fine
    level's ``L`` and ``D`` and in ``z`` by the adjoint solve.  The level
    stack passes as its tensors (``ops``, `poisson.level_tensors`) and
    their layout (``spec``), so that `torch.func.vmap` sees which carry the
    member axis; its `vmap` rule is generated: the forward and the adjoint
    solve run batched, and each reaches `ml_solve`'s own `vmap` rule."""

    generate_vmap_rule = True

    @staticmethod
    def forward(L, Dd, x, z, spec, tol, itmx, *ops):
        levels = with_level_tensors(spec, [t.detach() for t in ops])
        xs, _r, n = ml_solve(levels, x.detach(), z.detach(), tol=tol,
                             itmx=itmx)
        return xs, n

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.spec, ctx.tol, ctx.itmx = inputs[4:7]
        ctx.save_for_backward(output[0], *inputs[7:])

    @staticmethod
    def backward(ctx, xbar, _nbar):
        # the adjoint is not differentiated again: the kernels' solve
        # takes detached operands
        xs, *ops = (t.detach() for t in ctx.saved_tensors)
        levels = with_level_tensors(ctx.spec, ops)
        fine = levels[0]
        D = xs.ndim
        xbar = _fold_periodic(xs, xbar.detach().contiguous(), fine.perdir)
        # the stopping test r·r >= tol is absolute and the cotangent scales
        # with the loss: solve for the unit-norm right-hand side
        with span("wl.solve.adjoint"):
            s = torch.sqrt(field_dot(xbar, xbar))
            safe = torch.where(s > 0, s, 1.0).to(xbar.dtype)
            lam, _r, n = ml_solve(levels, torch.zeros_like(xs), xbar / safe,
                                  tol=ctx.tol, itmx=ctx.itmx)
            ml_solve_implicit.adjoint_n.append(_counts(n))
            lam = torch.where(s > 0, lam * safe, 0.0)
        lam_int = torch.where(interior_view(fine.iD, D) == 0, 0.0,
                              interior_view(lam, D))
        xb = bc_scalar_periodic(xs, fine.perdir)
        _, pull = torch.func.vjp(
            lambda L, Dd: _mult_interior_arrays(L, Dd, xb), fine.L, fine.D)
        Lbar, Dbar = pull(-lam_int)
        return ((Lbar, Dbar, None, pad_interior(lam_int), None, None, None)
                + (None,) * len(ops))

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(
            "ml_solve_implicit has no forward mode (as in the JAX package): "
            "differentiate forward through the adaptive solve "
            "(implicit_diff=False) or a fixed_iters one")


def ml_solve_implicit(levels: tuple, x, z, tol=1e-4, itmx=32):
    """Multigrid pressure solve whose gradient is one adjoint solve.

    The primal is the adaptive `ml_solve` (kernels and all) on a detached
    view of ``levels``; ``torch.autograd`` takes the gradient by the
    implicit-function theorem: one adjoint `ml_solve` on the same stack
    (the kernels again) and the vjp of the plain fine-level operator, so
    memory does not grow with the iterations as a ``fixed=`` unroll's
    does.  Cotangents reach ``z`` and the fine level's ``L`` and ``D``
    (and through them `build_levels`' inputs: μ₀, a body's parameters);
    the warm start ``x`` and the coarse levels get none.  Gradients
    assume a converged solve (a tight ``tol`` for a sensitive loss).
    Forward mode (`torch.func.jvp`, dual tensors) raises: use the adaptive
    solve or ``fixed=``.  Returns ``(x, n)``, ``n`` the forward's
    iteration count (host int; under `torch.func.vmap` each member's, a
    tensor).  ``ml_solve_implicit.adjoint_n`` keeps the iteration counts
    of the last 1024 adjoint solves, oldest first (under `vmap` a list of
    the members' counts a solve), a caller clearing it before the backward
    pass it reads, as the kernel wrappers keep their launch counts."""
    fine = levels[0]
    spec, ops = level_tensors(levels)
    return _ImplicitSolve.apply(fine.L, fine.D, x, z, spec, float(tol),
                                int(itmx), *ops)


ml_solve_implicit.adjoint_n = collections.deque(maxlen=1024)
