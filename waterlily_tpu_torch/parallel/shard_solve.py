"""The multigrid pressure solve on the shards' blocks.

PyTorch counterpart of `waterlily_tpu.parallel.shard_solve` (JAX's one
shard_map region for the whole `ml_solve`):

- the fine level is sharded: each shard's block runs the operator and the
  PCG smoother of `parallel.shard_smooth`, with halo planes and psum'd
  dots;
- every coarser level is replicated, which in one process means computed
  once, by the dense operators (`replicate_level`: on a CUDA device the
  dense ``mult3d``, ``increment3d`` and ``pcg_fused`` kernels);
- the transfers are exact: restriction sums each coarse cell's children on
  the one shard that holds its lower child (the upper child is local or
  the first halo plane), gathers every shard's owned window, scatters each
  into a zero coarse array and sums the arrays in the psum's order (adding
  zeros), so the replicated coarse residual equals the dense restriction
  bit for bit; prolongation reads
  the replicated coarse correction (a slice and a repeat per axis).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..ops import stencil_kernels as sk
from .halo import halo_exchange, ghost_mask_local, per_fill_local
from .mesh import ShardMesh, ordered_sum
from .shard_smooth import (can_shardmap, prep_local_op, pcg_local,
                           increment_local, residual_local, _auto_pallas)

__all__ = ["shardmap_ml_solve", "can_shard_solve", "replicate_level",
           "ml_solve_local", "ml_solve_local_implicit",
           "restrict_replicated", "prolongate_local"]


def can_shard_solve(mesh: ShardMesh | None, levels) -> bool:
    """Gate: a mesh that divides the fine level evenly (`can_shardmap`)."""
    fine = levels[0]
    return can_shardmap(mesh, tuple(fine.D.shape), fine.perdir)


def replicate_level(lev):
    """A coarse level as the replicated copy the sharded solve runs: dense
    dispatch (no band), f32 directions, no operator shadows, and the
    kernel gate decided again for the level's shape."""
    S = tuple(lev.D.shape)
    return dataclasses.replace(
        lev, blocked=sk.use_blocked(S, lev.D.dtype, lev.D.device),
        banded=False, bf16_eps=False, box_shape=None, box_start=None,
        L16=None, D16=None, iD16=None)


def _clamp(start: int, size: int, n: int) -> int:
    """A start index clamped so that ``size`` entries fit in ``n``, as
    ``jax.lax.dynamic_slice`` and ``dynamic_update_slice`` clamp."""
    return min(max(start, 0), n - size)


def _first_owned(b: int) -> int:
    """The first coarse row a block whose first fine row is ``b`` owns
    (the coarse cell whose lower child is the block's first odd row)."""
    return b // 2 + 1


def _restrict_axis_local(v, d, b, Bf, M):
    """Pair-sum axis ``d`` of a halo-extended block down one level.

    ``v`` holds rows [b-1, b+Bf] along ``d`` (``b`` the block's first
    global row); coarse interior cell ``c`` sums fine rows ``2c-1, 2c``
    (reference ``restrict``).  This shard owns the coarse cells whose lower
    child lies in its block.  Returns the owned rows (``Bf//2 + 1``, the
    entries past the owned count or the coarse interior ``M`` zeroed) and
    the first owned coarse row."""
    nmax = Bf // 2 + 1
    if Bf % 2:
        # odd blocks: the window can overrun the halo'd extent by a row
        v = torch.nn.functional.pad(
            v, (0, 0) * (v.ndim - 1 - d) + (0, 1))
        o0 = 2 - (b % 2)                  # local index of the first odd row
        npair = Bf // 2 + (b % 2) * (Bf % 2)
    else:
        o0 = 2
        npair = Bf // 2
    c0 = _first_owned(b)
    w = v.narrow(d, _clamp(o0, 2 * nmax, v.shape[d]), 2 * nmax)
    s = w.reshape(w.shape[:d] + (nmax, 2) + w.shape[d + 1:]).sum(dim=d + 1)
    view = [1] * s.ndim
    view[d] = nmax
    i = torch.arange(nmax, device=v.device).reshape(view)
    valid = (i < npair) & (c0 + i <= M)
    return torch.where(valid, s, 0.0).to(v.dtype), c0


def restrict_replicated(mesh: ShardMesh, S, r_l: list) -> torch.Tensor:
    """The dense-order restriction of a sharded fine residual, replicated:
    each shard's owned pair sums (its window, ``Bf//2 + 1`` rows an axis)
    gathered from every shard, scattered into zero coarse arrays and the
    arrays summed in the psum's order (JAX psums the scattered arrays:
    the same sums, a window's bytes moved instead of a coarse array's)."""
    D = r_l[0].ndim
    Sc = tuple(1 + s // 2 for s in S)
    vh = halo_exchange(r_l, mesh, D)
    wins = []
    for s, v in zip(mesh.local_shards, vh):
        base = mesh.base(s, S)
        for d in range(D):
            v, _c0 = _restrict_axis_local(v, d, base[d], S[d] // mesh.k(d),
                                          Sc[d] - 2)
        wins.append(v)
    outs = []
    for s, v in enumerate(mesh.all_gather(wins)):
        c0s = [_first_owned(b) for b in mesh.base(s, S)]
        out = torch.zeros(Sc, dtype=v.dtype, device=v.device)
        out[tuple(slice(st, st + n) for st, n in
                  ((_clamp(c, v.shape[d], Sc[d]), v.shape[d])
                   for d, c in enumerate(c0s)))] = v
        outs.append(out)
    return ordered_sum(outs)


def prolongate_local(mesh: ShardMesh, S, xc: torch.Tensor,
                     masks=None) -> list:
    """Each shard's block of the piecewise-constant injection of the
    replicated coarse correction ``xc``: per axis, the owned coarse window,
    repeated twice and aligned by the block's parity; the global ghost ring
    zeroed."""
    D = xc.ndim
    loc = tuple(S[d] // mesh.k(d) for d in range(D))
    if masks is None:
        masks = ghost_mask_local(mesh, S, loc)
    xc = mesh.pbroadcast(xc)
    out = []
    for m, s in zip(masks, mesh.local_shards):
        base = mesh.base(s, S)
        v = xc
        for d in range(D):
            Bf, b = loc[d], base[d]
            c0 = (b + 1) // 2
            ncr = Bf // 2 + 1
            w = v.narrow(d, _clamp(c0, ncr, v.shape[d]), ncr)
            w = torch.repeat_interleave(w, 2, dim=d)
            v = w.narrow(d, _clamp(b + 1 - 2 * c0, Bf, w.shape[d]), Bf)
        out.append(torch.where(m, v, 0.0).to(xc.dtype))
    return out


def ml_solve_local(mesh: ShardMesh, S, fL, fD, fiD, coarse, x_l, z_l,
                   tol=1e-4, itmx=32, fixed=None, pallas="off",
                   it_smooth=6, op=None, perdir=(), masks=None,
                   trace=False, fill=True):
    """`ops.multigrid.ml_solve` on the shards' fine blocks (``fL``, ``fD``,
    ``fiD``) with the replicated coarser levels ``coarse``
    (`replicate_level`): a V-cycle and the fine PCG smooth per outer
    iteration, at least one, until ``r·r < tol``, ``itmx`` iterations or
    an iteration that doubles ``r·r`` (the host reads r·r once an
    iteration, as the dense solve does); ``fixed=k`` runs exactly ``k``
    with no host read, and a tracked block takes it through
    ``torch.autograd`` (``pallas="off"``: the plain forms).  ``op``
    shares `prep_local_op`'s streams with the caller.  Returns ``(x_l,
    r_l, n)``, ``x_l``'s periodic ghosts filled (unless ``fill=False``);
    with ``trace=True`` also the residual trace of `ops.multigrid.ml_solve`
    (an ``(itmx+1, 2)``, under ``fixed`` a ``(fixed+1, 2)``, tensor every
    shard holds alike: rows ``[max|r|, ⟨r, r⟩]``, the max a pmax and the
    dot a psum, zeros after the last iteration)."""
    from ..ops.multigrid import vcycle
    from ..ops.poisson import smooth

    D = x_l[0].ndim
    if masks is None:
        masks = ghost_mask_local(mesh, S, tuple(x_l[0].shape))
    if op is None:
        op = prep_local_op(mesh, fL, fD, D, pallas)
    kw = dict(op=op, perdir=perdir, masks=masks)

    def vcycle_local(x_l, r_l):
        # the Jacobi pre-smooth of the fine level
        x_l, r_l = increment_local(mesh, S, fL, fD, x_l, r_l,
                                   [r * iD for r, iD in zip(r_l, fiD)],
                                   pallas, **kw)
        rc = restrict_replicated(mesh, S, r_l)
        xc = torch.zeros_like(coarse[0].D)
        if len(coarse) > 1:
            xc, rc = vcycle(coarse, 0, xc, rc)
        xc, rc = smooth(coarse[0], xc, rc, it_smooth)
        eps_l = prolongate_local(mesh, S, xc, masks)
        return increment_local(mesh, S, fL, fD, x_l, r_l, eps_l, pallas,
                               **kw)

    def outer(x_l, r_l):
        x_l, r_l = vcycle_local(x_l, r_l)
        return pcg_local(mesh, S, fL, fD, fiD, x_l, r_l, it_smooth, pallas,
                         **kw)

    def gdot2(r_l):
        return mesh.psum([torch.sum(r * r) for r in r_l])

    rows = []

    def log_row(r_l, r2=None):
        if trace:
            r2 = gdot2(r_l) if r2 is None else r2
            rows.append(torch.stack([
                mesh.pmax([torch.max(torch.abs(r)) for r in r_l]),
                r2]).to(x_l[0].dtype))

    r_l = residual_local(mesh, S, fL, fD, fiD, x_l, z_l, pallas, **kw)
    if fixed is not None:
        log_row(r_l)
        for _ in range(fixed):
            x_l, r_l = outer(x_l, r_l)
            log_row(r_l)
        n = int(fixed)
    else:
        r2 = gdot2(r_l)
        log_row(r_l, r2)
        n, go = 0, True
        while go:
            x_l, r_l = outer(x_l, r_l)
            r2p, r2 = r2, gdot2(r_l)
            log_row(r_l, r2)
            n += 1
            # divergence safeguard: see ops.multigrid.ml_solve
            go = n < itmx and bool((r2 >= tol) & ~(r2 > 2.0 * r2p))
    if perdir and fill:
        x_l = per_fill_local(x_l, mesh, S, perdir)
    if not trace:
        return x_l, r_l, n
    tr = torch.stack(rows)
    pad = (itmx if fixed is None else fixed) + 1 - tr.shape[0]
    return x_l, r_l, n, torch.cat([tr, tr.new_zeros((pad, 2))])


# --- implicit differentiation on the blocks ----------------------------------
#
# `ops.multigrid.ml_solve_implicit` on the shards: at convergence A(L)·x* =
# P z, so the cotangents are one adjoint solve on the same blocks and
# replicated coarse levels, λ = A⁻¹ P x̄, and the vjp of the plain local
# operator (`shard_smooth.local_mult`, linear in L and D):
#
#   z̄ = mask(λ),   D̄ = −λ∘x*,   L̄ᵢ = −(λ∘x*[I−δᵢ] + λ[I−δᵢ]∘x*),
#
# the shifted values one halo round each.  Both solves run on detached
# blocks, so the kernel forms run where the gate allows.


class _ImplicitLocal(torch.autograd.Function):
    """``(*x*, n)`` of the adaptive `ml_solve_local` on the blocks,
    unfilled (the caller fills the periodic ghosts, whose derivative is
    then the halo moves'); differentiable in the fine blocks' ``L`` and
    ``D`` and in ``z``.  On a process mesh it is one collective of the
    backward chain (`parallel.dist`): its backward's exchanges keep their
    place among the others'."""

    @staticmethod
    def forward(ctx, mesh, tok, cfg, *blocks):
        nb = len(mesh.local_shards)
        fL, fD, x, z = ([t.detach() for t in blocks[i * nb:(i + 1) * nb]]
                        for i in range(4))
        op = cfg["op"] or prep_local_op(mesh, fL, fD, x[0].ndim,
                                        cfg["pallas"])
        xs, _r, n = ml_solve_local(
            mesh, cfg["S"], fL, fD, cfg["fiD"], cfg["coarse"], x, z,
            tol=cfg["tol"], itmx=cfg["itmx"], pallas=cfg["pallas"], op=op,
            perdir=cfg["perdir"], masks=cfg["masks"], fill=False)
        ctx.mesh, ctx.cfg, ctx.op = mesh, cfg, op
        ctx.chained = tok is not None
        ctx.save_for_backward(*xs, *fL, *fD)
        return (*xs, n) + ((tok.new_zeros(()),) if tok is not None else ())

    @staticmethod
    def backward(ctx, *grads):
        from ..ops.multigrid import ml_solve_implicit
        mesh, cfg = ctx.mesh, ctx.cfg
        nb = len(mesh.local_shards)
        saved = ctx.saved_tensors
        xs, fL, fD = saved[:nb], saved[nb:2 * nb], saved[2 * nb:]
        S, perdir, masks = cfg["S"], cfg["perdir"], cfg["masks"]
        D = xs[0].ndim
        with (mesh._backward() if mesh.distributed
              else contextlib.nullcontext()):
            xbar = [g.contiguous() for g in grads[:nb]]
            # the stopping test r·r >= tol is absolute and the cotangent
            # scales with the loss: solve for the unit-norm right-hand side
            s = torch.sqrt(mesh.psum([torch.sum(g * g) for g in xbar]))
            safe = torch.where(s > 0, s, 1.0).to(xs[0].dtype)
            lam, _r, n = ml_solve_local(
                mesh, S, fL, fD, cfg["fiD"], cfg["coarse"],
                [torch.zeros_like(x) for x in xs], [g / safe for g in xbar],
                tol=cfg["tol"], itmx=cfg["itmx"], pallas=cfg["pallas"],
                op=ctx.op, perdir=perdir, masks=masks, fill=False)
            ml_solve_implicit.adjoint_n.append(n)
            zbar = [torch.where(m & (iD != 0), torch.where(s > 0, lm * safe,
                                                           0.0), 0.0)
                    for m, iD, lm in zip(masks, cfg["fiD"], lam)]
            xf = per_fill_local(list(xs), mesh, S, perdir) if perdir \
                else list(xs)
            c = [-zb for zb in zbar]
            xh = halo_exchange(xf, mesh, D)
            ch = halo_exchange(c, mesh, D)
        loc = tuple(xs[0].shape)

        def below(a, i):
            return a[tuple(slice(1 - (k == i), 1 - (k == i) + loc[k])
                           for k in range(D))]

        Lbar = [torch.stack([cs * below(xhs, i) + below(chs, i) * x
                             for i in range(D)])
                for cs, xhs, chs, x in zip(c, xh, ch, xf)]
        Dbar = [cs * x for cs, x in zip(c, xf)]
        tok = torch.zeros((), device=mesh.device) if ctx.chained else None
        return (None, tok, None, *Lbar, *Dbar, *(None,) * nb, *zbar)


def ml_solve_local_implicit(mesh: ShardMesh, S, fL, fD, fiD, coarse, x_l,
                            z_l, tol=1e-4, itmx=32, pallas="off", op=None,
                            perdir=(), masks=None):
    """`ops.multigrid.ml_solve_implicit` on the shards' fine blocks: the
    adaptive `ml_solve_local` (the kernel forms where ``pallas`` says, on
    detached blocks; ``op`` the streams of those blocks, or None) whose
    gradient is one adjoint `ml_solve_local` on the same blocks and
    replicated coarse levels and the vjp of the plain local operator
    (module comment).  Cotangents reach ``z_l`` and the blocks ``fL`` and
    ``fD`` (and through them μ₀ and a body's parameters); the warm start
    and the coarse levels get none, as in the dense Function.  Returns
    ``(x_l, n)``, ``x_l``'s periodic ghosts filled;
    ``ml_solve_implicit.adjoint_n`` records the adjoint solves' counts."""
    from ..ops.poisson import level_tensors, with_level_tensors
    if masks is None:
        masks = ghost_mask_local(mesh, S, tuple(x_l[0].shape))
    spec, ts = level_tensors(coarse)
    cfg = {"S": tuple(S), "tol": float(tol), "itmx": int(itmx),
           "pallas": pallas, "op": op, "perdir": tuple(perdir),
           "masks": masks, "fiD": [t.detach() for t in fiD],
           "coarse": with_level_tensors(spec, [t.detach() for t in ts])}
    blocks = (*fL, *fD, *x_l, *z_l)
    if mesh.distributed and torch.is_grad_enabled() and any(
            t.requires_grad for t in blocks):
        out = mesh._chained(_ImplicitLocal, cfg, *blocks)
    else:
        out = _ImplicitLocal.apply(mesh, None, cfg, *blocks)
    *x_l, n = out
    if perdir:
        x_l = per_fill_local(x_l, mesh, S, perdir)
    return x_l, n


def shardmap_ml_solve(mesh: ShardMesh, levels, x, z, tol=1e-4, itmx=32,
                      fixed=None, pallas=None):
    """`ops.multigrid.ml_solve` of global arrays on the shards (see the
    module doc): split, `ml_solve_local`, assemble.  Returns ``(x, r,
    n)``; the dots differ from the dense solve's only in the order of the
    sum, the transfers are exact."""
    fine = levels[0]
    S = tuple(x.shape)
    coarse = tuple(replicate_level(lev) for lev in levels[1:])
    if pallas is None:
        pallas = _auto_pallas(mesh, S, x.dtype)
    x_l, r_l, n = ml_solve_local(
        mesh, S, mesh.split(fine.L, 1), mesh.split(fine.D),
        mesh.split(fine.iD), coarse, mesh.split(x), mesh.split(z), tol=tol,
        itmx=itmx, fixed=fixed, pallas=pallas, perdir=fine.perdir)
    return mesh.assemble(x_l), mesh.assemble(r_l), n
