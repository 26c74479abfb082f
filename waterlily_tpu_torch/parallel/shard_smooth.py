"""The Poisson operator, PCG smoother and conv_diff on a shard's block.

PyTorch counterpart of the local functions of
`waterlily_tpu.parallel.shard_smooth`: each takes the local blocks of a
sharded field (`parallel.mesh`) and returns blocks, with halo planes
moved by `parallel.halo` and the PCG dots as per-shard partial sums plus
`ShardMesh.psum` (so they differ from the dense smoother's only in the
order of the sum).

``pallas`` picks the per-shard dispatch as in JAX: ``"off"`` runs the
plain local slice forms; any other value (``"kernels"``) runs the kernel
forms on halo-extended blocks (`ops.stencil_kernels`' ``mult3d`` and the
shard-local ``conv_diff3d``), which on CPU tensors are their plain
versions (JAX's ``"interpret"``).  `_auto_pallas` chooses the kernels on
a CUDA device when the halo-extended block passes the kernel gate.

The standalone one-call wrappers (`shardmap_pcg`, `shardmap_increment`,
`shardmap_residual`, `shardmap_conv_diff`) take global arrays and return
global arrays on either mesh (on a process mesh every rank gets them):
split, the local function, assemble.
"""
from __future__ import annotations

import torch

from ..grid import inside_count
from ..ops import stencil_kernels as sk
from .halo import halo_exchange, ghost_mask_local, shift_up, per_fill_local
from .mesh import ShardMesh, _spatial_names, _local_shape

__all__ = ["can_shardmap", "prep_local_op", "local_mult", "pcg_local",
           "increment_local", "residual_local", "conv_diff_local",
           "shardmap_pcg", "shardmap_increment", "shardmap_residual",
           "shardmap_conv_diff", "PALLAS"]

# Override of the per-shard dispatch (None: `_auto_pallas`'s rule): "off"
# or "kernels", for every region of the step.  JAX's `CONV_PALLAS` plays
# this part for its conv regions.
PALLAS: str | None = None


def can_shardmap(mesh: ShardMesh | None, S: tuple, perdir: tuple) -> bool:
    """Gate of the shard-local paths: a mesh whose shard counts divide the
    level shape evenly; a sharded periodic axis also needs blocks of at
    least 4 planes (the width-2 wrap windows stay clear of the ghost
    band)."""
    if mesh is None or not _spatial_names(mesh):
        return False
    for k in range(len(S)):
        n_sh = mesh.k(k)
        if S[k] % n_sh != 0:
            return False
        if k in perdir and n_sh > 1 and S[k] // n_sh < 4:
            return False
    return True


def _auto_pallas(mesh: ShardMesh, S: tuple, dtype, extra: int = 2) -> str:
    """The per-shard dispatch: the kernel forms where the halo-extended
    block passes `stencil_kernels.use_blocked` (big 3D f32 blocks on a
    CUDA device), the plain local forms elsewhere; `PALLAS` overrides."""
    if PALLAS is not None:
        return PALLAS
    loc = _local_shape(mesh, S)
    return ("kernels" if sk.use_blocked(tuple(s + extra for s in loc), dtype,
                                        mesh.device)
            else "off")


def prep_local_op(mesh: ShardMesh, L_l: list, Dd_l: list, D: int,
                  pallas: str):
    """The operator's local streams, built once per step and shared by
    every matvec.  Kernel forms: the halo-extended L (its upper halo plane
    is the neighbour's first plane, the ``L[I+δ]`` the kernel reads at the
    block's top row) and the zero-padded diagonal, per shard.  Plain forms:
    the upper-face coefficients, ``op[i][s]`` (`halo.shift_up`)."""
    if pallas != "off":
        Lh = halo_exchange(L_l, mesh, D)
        Dh = [torch.nn.functional.pad(d, (1, 1) * D) for d in Dd_l]
        return (Lh, Dh)
    return [shift_up([L[i] for L in L_l], i, mesh) for i in range(D)]


def local_mult(mesh: ShardMesh, S, L_l, Dd_l, op, x_l, masks, pallas="off",
               perdir=()) -> list:
    """A·x on each shard's block after one halo round, the global ghost
    ring zeroed.  Periodic axes fill the global ghost planes first (the
    dense `mult`'s `bc_scalar_periodic`); the zero edge halos are then
    never read.  The kernel form launches ``mult3d`` on the halo-extended
    block, which is a ghost-padded grid for it."""
    D = x_l[0].ndim
    if perdir:
        x_l = per_fill_local(x_l, mesh, S, perdir)
    xh = halo_exchange(x_l, mesh, D)
    inner = (slice(1, -1),) * D
    if pallas != "off":
        Lh, Dh = op
        return [torch.where(m, sk.mult3d(Lh[s], Dh[s], xh[s])[inner], 0.0)
                for s, m in enumerate(masks)]
    loc = tuple(x_l[0].shape)

    def sl(a, d, off):
        return a[tuple(slice(1 + (off if k == d else 0),
                             1 + (off if k == d else 0) + loc[k])
                       for k in range(D))]

    out = []
    for s, m in enumerate(masks):
        z = x_l[s] * Dd_l[s]
        for i in range(D):
            z = z + sl(xh[s], i, -1) * L_l[s][i] + sl(xh[s], i, +1) * op[i][s]
        out.append(torch.where(m, z, 0.0))
    return out


def _gdot(mesh, a, b) -> torch.Tensor:
    return mesh.psum([torch.sum(x * y) for x, y in zip(a, b)])


def pcg_local(mesh: ShardMesh, S, L_l, Dd_l, iD_l, x_l, r_l, it: int,
              pallas: str, op=None, perdir=(), masks=None):
    """The PCG smoother on the local blocks: `ops.poisson.pcg`'s algebra
    with its dead-mask early exits held in device scalars, f32 directions,
    dots as per-shard partials plus psum (the step sizes entering the
    blocks through `ShardMesh.pbroadcast`)."""
    D = x_l[0].ndim
    dt = x_l[0].dtype
    teneps = 10 * torch.finfo(dt).eps
    if masks is None:
        masks = ghost_mask_local(mesh, S, tuple(x_l[0].shape))
    if op is None:
        op = prep_local_op(mesh, L_l, Dd_l, D, pallas)
    z = [r * iD for r, iD in zip(r_l, iD_l)]
    eps = z
    rho = _gdot(mesh, r_l, z)
    dead = torch.abs(rho) < teneps
    for i in range(it):
        if perdir:
            # filled before the axpy too, as the dense pcg's x += alpha*eps
            # uses the filled eps
            eps = per_fill_local(eps, mesh, S, perdir)
        z = local_mult(mesh, S, L_l, Dd_l, op, eps, masks, pallas)
        denom = _gdot(mesh, z, eps)
        alpha = torch.where(dead | (denom == 0), 0.0,
                            rho / torch.where(denom == 0, 1.0, denom)).to(dt)
        dead = dead | (torch.abs(alpha) < 1e-2) | (torch.abs(alpha) > 1e2)
        upd = mesh.pbroadcast(torch.where(dead, 0.0, alpha).to(dt))
        x_l = [x + upd * e for x, e in zip(x_l, eps)]
        r_l = [r - upd * zz for r, zz in zip(r_l, z)]
        if i == it - 1:
            break
        z2 = [r * iD for r, iD in zip(r_l, iD_l)]
        rho2 = _gdot(mesh, r_l, z2)
        dead = dead | (torch.abs(rho2) < teneps)
        beta = mesh.pbroadcast(torch.where(
            dead, 0.0, rho2 / torch.where(rho == 0, 1.0, rho)).to(dt))
        eps = [torch.where(m, beta * e + zz, 0.0)
               for m, e, zz in zip(masks, eps, z2)]
        rho = torch.where(dead, rho, rho2)
    return x_l, r_l


def increment_local(mesh: ShardMesh, S, L_l, Dd_l, x_l, r_l, eps_l,
                    pallas: str, op=None, perdir=(), masks=None):
    """``x += eps; r -= A·eps`` on the local blocks."""
    D = x_l[0].ndim
    if masks is None:
        masks = ghost_mask_local(mesh, S, tuple(x_l[0].shape))
    if op is None:
        op = prep_local_op(mesh, L_l, Dd_l, D, pallas)
    ae = local_mult(mesh, S, L_l, Dd_l, op, eps_l, masks, pallas, perdir)
    return ([x + e for x, e in zip(x_l, eps_l)],
            [r - a for r, a in zip(r_l, ae)])


def residual_local(mesh: ShardMesh, S, L_l, Dd_l, iD_l, x_l, z_l,
                   pallas: str, op=None, perdir=(), masks=None) -> list:
    """Body-masked, mean-corrected ``r = z - A·x`` on the local blocks
    (reference ``residual!``), the mean a psum."""
    D = x_l[0].ndim
    dt = x_l[0].dtype
    cnt = inside_count(tuple(S))
    teps = 2 * torch.finfo(dt).eps
    if masks is None:
        masks = ghost_mask_local(mesh, S, tuple(x_l[0].shape))
    if op is None:
        op = prep_local_op(mesh, L_l, Dd_l, D, pallas)
    ax = local_mult(mesh, S, L_l, Dd_l, op, x_l, masks, pallas, perdir)
    r_int = [torch.where(m & (iD != 0), z - a, 0.0).to(dt)
             for m, iD, z, a in zip(masks, iD_l, z_l, ax)]
    s = mesh.psum([torch.sum(r) for r in r_int]) / cnt
    corr = mesh.pbroadcast(torch.where(torch.abs(s) <= teps, 0.0, s).to(dt))
    return [torch.where(m, r - corr, 0.0).to(dt)
            for m, r in zip(masks, r_int)]


def conv_diff_local(mesh: ShardMesh, S, u_l, nu, limiter, pallas: str,
                    perdir=()) -> list:
    """The conv_diff tendency of each shard's block: width-2 halos (modular
    wraps on periodic axes) and flux evaluation with global-index boundary
    variants and support.  The ghost planes of ``u_l`` must be
    periodic-filled on entry (the step's BC keeps them so); a tensor
    ``nu`` comes through `ShardMesh.pbroadcast`.  Kernel form:
    ``conv_diff3d`` in its base (and modular) form on the halo-extended
    block, trimmed."""
    from ..ops.convect import conv_core
    D = u_l[0].shape[0]
    loc = tuple(u_l[0].shape[1:])
    uh = halo_exchange(u_l, mesh, D, width=2, perdir=perdir)
    out = []
    for s, b in zip(mesh.local_shards, uh):
        base = mesh.base(s, S)
        if pallas != "off":
            r = sk.conv_diff3d(b, nu, limiter, perdir, S_glob=tuple(S),
                               base=tuple(g - 2 for g in base),
                               modular=True)
            out.append(r[(slice(None),) + (slice(2, -2),) * D])
        else:
            out.append(conv_core(b, loc, nu, perdir, limiter,
                                 S_glob=tuple(S), base=base, modular=True))
    return out


def _level_blocks(mesh: ShardMesh, lev):
    return mesh.split(lev.L, 1), mesh.split(lev.D), mesh.split(lev.iD)


def _pallas_for(mesh: ShardMesh, S, dtype, pallas):
    return _auto_pallas(mesh, tuple(S), dtype) if pallas is None else pallas


def shardmap_pcg(mesh: ShardMesh, lev, x, r, it: int = 6,
                 pallas: str | None = None):
    """The Jacobi-preconditioned CG smoother of global arrays on the
    shards' blocks (JAX's `shardmap_pcg`): `ops.poisson.pcg`'s algebra
    with its dead-mask exits, f32 search directions (the sharded solve's),
    dots as per-shard partials and a psum."""
    S = tuple(x.shape)
    L_l, Dd_l, iD_l = _level_blocks(mesh, lev)
    x_l, r_l = pcg_local(mesh, S, L_l, Dd_l, iD_l, mesh.split(x),
                         mesh.split(r), it,
                         _pallas_for(mesh, S, x.dtype, pallas),
                         perdir=lev.perdir)
    return mesh.assemble(x_l), mesh.assemble(r_l)


def shardmap_increment(mesh: ShardMesh, lev, x, r, eps,
                       pallas: str | None = None):
    """``x += eps; r -= A·eps`` of global arrays on the shards' blocks
    (JAX's `shardmap_increment`).  ``eps`` must be ghost-zero; periodic
    ghosts are filled by the matvec, as the dense `increment` does."""
    S = tuple(x.shape)
    L_l, Dd_l, _iD = _level_blocks(mesh, lev)
    x_l, r_l = increment_local(mesh, S, L_l, Dd_l, mesh.split(x),
                               mesh.split(r), mesh.split(eps),
                               _pallas_for(mesh, S, x.dtype, pallas),
                               perdir=lev.perdir)
    return mesh.assemble(x_l), mesh.assemble(r_l)


def shardmap_residual(mesh: ShardMesh, lev, x, z, pallas: str | None = None):
    """Body-masked, mean-corrected ``r = z - A·x`` of global arrays on the
    shards' blocks (JAX's `shardmap_residual`; reference ``residual!``),
    the mean a psum."""
    S = tuple(x.shape)
    L_l, Dd_l, iD_l = _level_blocks(mesh, lev)
    r_l = residual_local(mesh, S, L_l, Dd_l, iD_l, mesh.split(x),
                         mesh.split(z), _pallas_for(mesh, S, x.dtype, pallas),
                         perdir=lev.perdir)
    return mesh.assemble(r_l)


def shardmap_conv_diff(mesh: ShardMesh, u, nu, limiter,
                       pallas: str | None = None, perdir=()):
    """The conv_diff tendency of a global velocity on the shards' blocks
    (JAX's `shardmap_conv_diff`): width-2 halos, modular wraps on periodic
    axes (``u``'s ghosts periodic-filled, as the step's BC keeps them), the
    flux with global-index boundary variants; ``pallas=None`` takes the
    kernel form where the width-2 halo-extended block passes the gate."""
    S = tuple(u.shape[1:])
    if pallas is None:
        pallas = _auto_pallas(mesh, S, u.dtype, extra=4)
    r_l = conv_diff_local(mesh, S, mesh.split(u, 1), mesh.pbroadcast(nu),
                          limiter, pallas, tuple(perdir))
    return mesh.assemble(r_l, 1)
