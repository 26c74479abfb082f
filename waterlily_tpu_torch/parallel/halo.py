"""Halo exchange and the other neighbour moves of a shard's local block.

PyTorch counterpart of `waterlily_tpu.parallel.halo`.  A sharded field is
a list of local blocks (`parallel.mesh`: one per shard of
``mesh.local_shards``); each function maps over them and moves the planes a shard needs from its neighbours with the
mesh's `ShardMesh.ppermute`.  The grid must shard evenly (`mesh_for`
guarantees it): a block then holds ``S[d] / shards[d]`` planes of the
ghost-padded global array, the global ghost ring lies inside the first and
last blocks, and a 7-point stencil needs one received plane per face.
"""
from __future__ import annotations

import functools

import torch

from .mesh import ShardMesh

__all__ = ["halo_exchange", "per_fill_local", "ghost_mask_local",
           "shift_up", "shardmap_mult"]


def shift_up(blocks: list, d: int, mesh: ShardMesh) -> list:
    """a_global[j+1] along axis ``d`` of each block: its planes 1.. and one
    received plane (the next shard's first; zeros on the last shard and on
    unsharded axes, where it only feeds masked global-ghost outputs).  The
    upper-face coefficient of the stencil: the only communication of L."""
    k = mesh.k(d)
    if k > 1:
        recv = mesh.ppermute([b.narrow(d, 0, 1) for b in blocks], d,
                             [((i + 1) % k, i) for i in range(k)])
        idx = mesh.axis_index(d)
    out = []
    for s, b in enumerate(blocks):
        top = (recv[s] if k > 1 and idx[s] != k - 1
               else torch.zeros_like(b.narrow(d, 0, 1)))
        out.append(torch.cat([b.narrow(d, 1, b.shape[d] - 1), top], dim=d))
    return out


@functools.lru_cache(maxsize=64)
def _ghost_mask(S, loc_shape, base, device) -> torch.Tensor:
    m = None
    for d in range(len(S)):
        view = [1] * len(S)
        view[d] = loc_shape[d]
        g = (torch.arange(loc_shape[d], device=device) + base[d]).reshape(
            view)
        md = (g >= 1) & (g <= S[d] - 2)
        m = md if m is None else m & md
    return m.expand(loc_shape)


def ghost_mask_local(mesh: ShardMesh, S, loc_shape) -> list:
    """Each local shard's mask of the cells of its block NOT in the global
    ghost ring (cached: a mask a shard and shape)."""
    return [_ghost_mask(tuple(S), tuple(loc_shape), mesh.base(s, S),
                        mesh.device) for s in mesh.local_shards]


def halo_exchange(blocks: list, mesh: ShardMesh, D: int, width: int = 1,
                  perdir=()) -> list:
    """Grow every spatial axis of each local block by ``width`` planes on
    both sides, axis after axis (so the corners are the diagonal
    neighbours' cells).

    Sharded axes receive the neighbouring shards' edge planes; unsharded
    axes and domain edges get zeros, which is safe because the global ghost
    ring lies inside the first and last blocks, so edge halos are never
    read for interior outputs.  ``width=2`` serves the QUICK stencil.

    ``perdir`` axes get MODULAR wrap halos that skip the two-plane ghost
    band: global position ``-m`` holds interior plane ``S-2-m`` and
    ``S-1+m`` holds plane ``1+m``.  With periodic-filled ghost planes
    (`per_fill_local`, the step's BC) every flux tap of a periodic axis then
    reads the value the reference's ϕuP wrap and top-face flux copy would
    (see `ops.convect.conv_core`'s ``modular``)."""
    lead = blocks[0].ndim - D
    for k_ax in range(D):
        k = mesh.k(k_ax)
        axis = lead + k_ax
        n = blocks[0].shape[axis]
        periodic = k_ax in perdir
        if k > 1:
            idx = mesh.axis_index(k_ax)
            below = mesh.ppermute([b.narrow(axis, n - width, width)
                                   for b in blocks], k_ax,
                                  [(i, (i + 1) % k) for i in range(k)])
            above = mesh.ppermute([b.narrow(axis, 0, width) for b in blocks],
                                  k_ax, [((i + 1) % k, i) for i in range(k)])
            if periodic:
                # the wrap planes skip the ghost band: the top shard sends
                # its planes [n-2-width, n-2) to shard 0, shard 0 its
                # planes [2, 2+width) to the top shard (blocks of at least
                # 2 + width planes: `shard_smooth.can_shardmap`)
                wlo = mesh.ppermute([b.narrow(axis, n - 2 - width, width)
                                     for b in blocks], k_ax, [(k - 1, 0)])
                whi = mesh.ppermute([b.narrow(axis, 2, width)
                                     for b in blocks], k_ax, [(0, k - 1)])
                below = [wlo[i] if c == 0 else below[i]
                         for i, c in enumerate(idx)]
                above = [whi[i] if c == k - 1 else above[i]
                         for i, c in enumerate(idx)]
            else:
                below = [None if c == 0 else below[i]
                         for i, c in enumerate(idx)]
                above = [None if c == k - 1 else above[i]
                         for i, c in enumerate(idx)]
        elif periodic:
            below = [b.narrow(axis, n - 2 - width, width) for b in blocks]
            above = [b.narrow(axis, 2, width) for b in blocks]
        else:
            below = above = [None] * len(blocks)
        zero = lambda b: torch.zeros_like(b.narrow(axis, 0, width))
        blocks = [torch.cat([lo if lo is not None else zero(b), b,
                             hi if hi is not None else zero(b)], dim=axis)
                  for b, lo, hi in zip(blocks, below, above)]
    return blocks


def per_fill_local(blocks: list, mesh: ShardMesh, S, perdir,
                   lead: int = 0) -> list:
    """Periodic ghost fill of each local block (reference ``perBC!``, the
    counterpart of `ops.bc.bc_scalar_periodic`): for each axis in
    ``perdir``, global ghost plane 0 := plane S-2 and plane S-1 := plane 1,
    the planes moving between the first and last shards of a sharded axis.
    Axis by axis on the current values, as the dense fill, so the ghost
    corners agree exactly."""
    for d in perdir:
        k = mesh.k(d)
        axis = lead + d
        n = blocks[0].shape[axis]
        if k > 1:
            idx = mesh.axis_index(d)
            # plane S-2 lies on the top shard (local n-2), ghost 0 on shard
            # 0; plane 1 on shard 0, ghost S-1 on the top shard
            recv0 = mesh.ppermute([b.narrow(axis, n - 2, 1) for b in blocks],
                                  d, [(k - 1, 0)])
            recvN = mesh.ppermute([b.narrow(axis, 1, 1) for b in blocks],
                                  d, [(0, k - 1)])
            rows = [(recv0[s] if idx[s] == 0 else b.narrow(axis, 0, 1),
                     recvN[s] if idx[s] == k - 1 else b.narrow(axis, n - 1, 1))
                    for s, b in enumerate(blocks)]
        else:
            rows = [(b.narrow(axis, n - 2, 1), b.narrow(axis, 1, 1))
                    for b in blocks]
        blocks = [torch.cat([r0, b.narrow(axis, 1, n - 2), rN], dim=axis)
                  for b, (r0, rN) in zip(blocks, rows)]
    return blocks


def shardmap_mult(mesh: ShardMesh, L, Dd, x) -> torch.Tensor:
    """z = A·x of global arrays through the local blocks (matches
    `ops.poisson.mult` for non-periodic levels): split, one halo round per
    sharded axis, the slice-form stencil on each block, assemble."""
    D = x.ndim
    S = tuple(x.shape)
    for d in range(D):
        if S[d] % mesh.k(d):
            raise ValueError(f"axis {d}: size {S[d]} not divisible by "
                             f"{mesh.k(d)} shards (build the mesh with "
                             f"mesh_for)")
    L_l, Dd_l, x_l = mesh.split(L, 1), mesh.split(Dd), mesh.split(x)
    loc = tuple(x_l[0].shape)
    xh = halo_exchange(x_l, mesh, D)
    up = [shift_up([Ls[i] for Ls in L_l], i, mesh) for i in range(D)]
    masks = ghost_mask_local(mesh, S, loc)

    def sl(a, d, off):
        return a[tuple(slice(1 + (off if k == d else 0),
                             1 + (off if k == d else 0) + loc[k])
                       for k in range(D))]

    out = []
    for s, m in enumerate(masks):
        z = x_l[s] * Dd_l[s]
        for i in range(D):
            z = (z + sl(xh[s], i, -1) * L_l[s][i]
                 + sl(xh[s], i, +1) * up[i][s])
        out.append(torch.where(m, z, 0.0))
    return mesh.assemble(out)
