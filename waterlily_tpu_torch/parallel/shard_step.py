"""The whole momentum step on the shards' blocks, and the per-phase
conv + BDIM region.

PyTorch counterpart of `waterlily_tpu.parallel.shard_step`.  The whole
step (JAX's one shard_map region per time step, `shardmap_mom_step`):
conv_diff, BDIM, the boundary conditions, the outlet, both projections
with their solves and the CFL reduction all run on the local blocks, with
halo planes and global-index masks:

- conv_diff and the solve are `shard_smooth.conv_diff_local` and
  `shard_solve.ml_solve_local`;
- BDIM blends the halo-exchanged force field locally;
- the BC applies the reference's sequential stages as global-index
  selects: every ghost's source lies in the same shard (blocks are at
  least two cells wide), so it moves nothing but periodic planes;
- the outlet's mass-flux mean is a psum, the CFL a local max and a pmax.

On the in-process mesh the state stays global, as in JAX: the step
splits it into blocks at entry and assembles it at exit (the region's
``in_specs`` and ``out_specs``).  On a process mesh
(`parallel.dist.ProcessMesh`) the state is the rank's blocks, taken and
returned as they are (`ShardMesh.from_state`/``to_state``): no global
field is built in a step.  With the kernel forms (``pallas``) the
projection head and tail run ``div3d`` and ``project3d`` in their
shard-local forms on the halo-extended blocks.

The whole step also takes ``fixed_iters`` (the solves unrolled, no host
read), ``log`` (each solve's residual trace, a pmax and a psum a row)
and ``implicit_diff`` (`shard_solve.ml_solve_local_implicit`: one
adjoint solve on the blocks a projection), and it is differentiable
across ranks (`parallel.dist`'s rules; a tracked step runs the plain
local forms).  A `Simulation` on a process mesh steps these options
here.

`shardmap_conv_bdim` is JAX's per-phase region: conv_diff, accelerate
and the BDIM blend (optionally the boundary conditions after it) on the
blocks, global arrays in and out; `flow.mom_step` runs it under an
in-process mesh for ``log``, ``fixed_iters`` and ``implicit_diff`` (as
JAX routes them), the rest of that step dense.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import stencil_kernels as sk
from .halo import halo_exchange, ghost_mask_local, per_fill_local
from .mesh import ShardMesh
from .shard_smooth import (can_shardmap, conv_diff_local, prep_local_op,
                           _auto_pallas)
from .shard_solve import (ml_solve_local, ml_solve_local_implicit,
                          replicate_level)

__all__ = ["shardmap_mom_step", "can_shard_step", "bc_vector_local",
           "exit_bc_local", "shardmap_conv_bdim", "local_levels"]


def can_shard_step(cfg, mesh: ShardMesh | None, levels) -> bool:
    """Gate of the whole-step region: a mesh that divides the fine level
    evenly (`shard_smooth.can_shardmap`).  On the in-process mesh also no
    fixed solver iteration count, no residual-trace capture (``cfg.log``)
    and no ``implicit_diff``: JAX keeps these on its per-phase path
    (`flow.mom_step` with `shardmap_conv_bdim`), which needs the dense
    state a process-mesh rank does not hold; there the whole-step region
    takes them."""
    fine = levels[0]
    per_phase = (cfg.fixed_iters is not None or cfg.log
                 or cfg.implicit_diff)
    return (mesh is not None and (mesh.distributed or not per_phase)
            and can_shardmap(mesh, tuple(fine.D.shape), fine.perdir))


def local_levels(mesh: ShardMesh, levels):
    """A dense level stack in the form a Simulation on ``mesh`` keeps it:
    unchanged on the in-process mesh; on a process mesh the fine level's
    L, D and iD as the rank's blocks, the coarse levels whole (the sharded
    solve replicates them)."""
    if not mesh.distributed:
        return levels
    fine = levels[0]
    (L,), (Dd,), (iD,) = (mesh.split(fine.L, 1), mesh.split(fine.D),
                          mesh.split(fine.iD))
    return (dataclasses.replace(fine, L=L, D=Dd, iD=iD),) + tuple(levels[1:])


def _gidx(mesh: ShardMesh, S, loc_shape, d, s, device):
    """Global index along axis ``d`` of every cell of shard ``s``'s block
    (broadcastable to ``loc_shape``)."""
    view = [1] * len(loc_shape)
    view[d] = loc_shape[d]
    return (torch.arange(loc_shape[d], device=device)
            + mesh.base(s, S)[d]).reshape(view)


def bc_vector_local(mesh: ShardMesh, S, u_l: list, A, save_exit=False,
                    pallas="off", perdir=()) -> list:
    """Reference ``BC!`` on the local blocks, equal to `ops.bc.bc_vector`
    bit for bit.

    ``pallas != "off"`` (3D, non-periodic): ``bc3d`` in its shard-local
    form on each block (its ghost sources are the block's planes 1 and
    S-2, which hold the global boundary planes on the shards that own the
    ghosts).  Otherwise the sequential stages (component-major,
    direction-minor, each on the previous stage's values) as global-index
    selects, `torch.roll` giving the one-cell sources (never selected
    across the roll's wrap); periodic axes fill their ghost planes with
    `halo.per_fill_local` in the dense chain's stage position."""
    D = u_l[0].shape[0]
    loc = tuple(u_l[0].shape[1:])
    shards = mesh.local_shards
    if pallas != "off" and D == 3 and not perdir:
        return [sk.bc3d(u.contiguous(), A, save_exit, S_glob=tuple(S),
                        base=mesh.base(s, S))
                for s, u in zip(shards, u_l)]
    dev = u_l[0].device
    comps = []
    for i in range(D):
        v = [u[i] for u in u_l]
        for j in range(D):
            if j in perdir:
                v = per_fill_local(v, mesh, S, (j,))
                continue
            new = []
            for s, vs in zip(shards, v):
                g = _gidx(mesh, S, loc, j, s, dev)
                if i == j:
                    hi = g == S[j] - 1
                    if save_exit and i == 0:
                        hi = torch.zeros_like(hi)
                    vs = torch.where((g <= 1) | hi, A[i], vs)
                else:
                    up = torch.roll(vs, -1, dims=j)  # source at +1 (ghost 0)
                    dn = torch.roll(vs, +1, dims=j)  # source at -1 (ghost S-1)
                    vs = torch.where(g == 0, up,
                                     torch.where(g == S[j] - 1, dn, vs))
                new.append(vs)
            v = new
        comps.append(v)
    return [torch.stack([c[i] for c in comps], dim=0)
            for i in range(len(u_l))]


def exit_bc_local(mesh: ShardMesh, S, u_l: list, u0_l: list, U, dt) -> list:
    """Reference ``exitBC!`` on the local blocks: the convective outlet on
    the high-x ghost plane of component 0, shifted so that the mean outflow
    equals ``U[0]`` (the mean a psum).  ``U`` and ``dt`` as every shard
    holds them (the blocks take them through `ShardMesh.pbroadcast`)."""
    D = u_l[0].shape[0]
    loc = tuple(u_l[0].shape[1:])
    dev = u_l[0].device
    cnt = 1.0
    for d in range(1, D):
        cnt = cnt * (S[d] - 2)
    masks, news = [], []
    udt = mesh.pbroadcast(U[0] * dt)
    for s, u0 in zip(mesh.local_shards, u0_l):
        m = _gidx(mesh, S, loc, 0, s, dev) == S[0] - 1
        for d in range(1, D):
            gd = _gidx(mesh, S, loc, d, s, dev)
            m = m & (gd >= 1) & (gd <= S[d] - 2)
        u0c = u0[0]
        um = torch.roll(u0c, +1, dims=0)            # u0 at x-1 (same shard)
        masks.append(m)
        news.append(u0c - udt * (u0c - um))
    flux = mesh.pbroadcast(mesh.psum([torch.sum(torch.where(m, n, 0.0))
                                      for m, n in zip(masks, news)]) / cnt
                           - U[0])
    return [torch.cat([torch.where(m, n - flux, u[0])[None], u[1:]], dim=0)
            for m, n, u in zip(masks, news, u_l)]


def _sl(a, loc, d, off, lead=1):
    """The block's cells shifted by ``off`` along ``d`` from a width-1
    halo-extended array."""
    return a[(slice(None),) * lead + tuple(
        slice(1 + (off if k == d else 0), 1 + (off if k == d else 0) + loc[k])
        for k in range(len(loc)))]


def _bdim_blend_local(mesh: ShardMesh, S, u0_l, r_l, V_l, mu0_l, mu1_l,
                      dt) -> list:
    """The BDIM blend on every local cell (reference BDIM!): ``f = u⁰ +
    dt·r − V``, then ``½Σⱼ μ₁[:,j](f[+δⱼ]−f[−δⱼ]) + V + μ₀∘f``, the
    first-moment term from one halo round of ``f``."""
    D = u0_l[0].shape[0]
    loc = tuple(u0_l[0].shape[1:])
    f = [u0 + dt * r - V for u0, r, V in zip(u0_l, r_l, V_l)]
    fh = halo_exchange(f, mesh, D)
    out = []
    for s in range(len(f)):
        m = None
        for j in range(D):
            t = mu1_l[s][:, j] * (_sl(fh[s], loc, j, +1)
                                  - _sl(fh[s], loc, j, -1))
            m = t if m is None else m + t
        out.append(0.5 * m + V_l[s] + mu0_l[s] * f[s])
    return out


def _div_local(mesh: ShardMesh, S, u_l, masks) -> list:
    """Cell divergence of each block, global ghosts zero."""
    D = u_l[0].shape[0]
    loc = tuple(u_l[0].shape[1:])
    uh = halo_exchange(u_l, mesh, D)
    out = []
    for s, u in enumerate(u_l):
        acc = None
        for i in range(D):
            t = _sl(uh[s][i], loc, i, +1, lead=0) - u[i]
            acc = t if acc is None else acc + t
        out.append(torch.where(masks[s], acc, 0.0))
    return out


def _pressure_correct_local(mesh: ShardMesh, S, fL, x_l, u_l,
                            masks) -> list:
    """u −= L∘∇x on the interior of each block (the `project!` tail)."""
    D = u_l[0].shape[0]
    loc = tuple(u_l[0].shape[1:])
    xh = halo_exchange(x_l, mesh, D)
    out = []
    for s, (L, x, u) in enumerate(zip(fL, x_l, u_l)):
        upd = torch.stack([L[i] * (x - _sl(xh[s], loc, i, -1, lead=0))
                           for i in range(D)], dim=0)
        out.append(torch.where(masks[s][None], u - upd, u))
    return out


def _cfl_local(mesh: ShardMesh, S, u_l, nu, masks, dt_max=10.0):
    """Adaptive time step (reference ``CFL``): a local interior max of the
    flux-out sum, then a pmax."""
    D = u_l[0].shape[0]
    loc = tuple(u_l[0].shape[1:])
    uh = halo_exchange(u_l, mesh, D)
    mx = []
    for s, u in enumerate(u_l):
        acc = None
        for i in range(D):
            t = (torch.clamp_min(_sl(uh[s][i], loc, i, +1, lead=0), 0.0)
                 + torch.clamp_min(-u[i], 0.0))
            acc = t if acc is None else acc + t
        mx.append(torch.max(torch.where(masks[s], acc, -torch.inf)))
    return torch.clamp_max(1.0 / (mesh.pmax(mx) + 5 * nu), dt_max)


def shardmap_conv_bdim(cfg, u_in, u0, V, mu0, mu1, dt, t_eff, scale,
                       pallas: str | None = None, bc=None):
    """conv_diff + accelerate + the BDIM blend as one region over the
    blocks of ``cfg.mesh`` (JAX's `shardmap_conv_bdim`): the tendency of
    ``u_in`` at time ``t_eff`` (`shard_smooth.conv_diff_local`), the blend
    from one halo round of ``f`` (`_bdim_blend_local`).

    ``scale=None`` is the predictor (the reference's ``scale_u!(a, 0)``
    and BDIM: interior := blend, ghosts keep ``u0``); ``scale=0.5`` the
    corrector (interior := 0.5·(u_in + blend)).  ``bc=U`` also applies the
    boundary conditions after the blend in the region (`bc_vector_local`,
    and with ``cfg.exitBC`` in the predictor `exit_bc_local`).  Fields are
    in the form the mesh keeps state in (`ShardMesh.from_state`: global
    arrays on the in-process mesh).  ``pallas`` overrides the per-shard
    dispatch; ``"off"`` keeps the plain forms (a field autograd tracks)."""
    from ..ops.convect import accelerate
    mesh = cfg.mesh
    D, S, dtype = cfg.D, tuple(cfg.S), cfg.dtype
    if pallas is None:
        pallas = _auto_pallas(mesh, S, dtype, extra=4)
    u0_l = mesh.from_state(u0, 1)
    u_l = u0_l if u_in is u0 else mesh.from_state(u_in, 1)
    r = conv_diff_local(mesh, S, u_l, mesh.pbroadcast(cfg.nu), cfg.limiter,
                        pallas, cfg.perdir)
    r = [accelerate(rs, t_eff, cfg.g, cfg.U, dtype) for rs in r]
    blend = _bdim_blend_local(mesh, S, u0_l, r, mesh.from_state(V, 1),
                              mesh.from_state(mu0, 1),
                              mesh.from_state(mu1, 2), mesh.pbroadcast(dt))
    masks = ghost_mask_local(mesh, S, tuple(u0_l[0].shape[1:]))
    if scale is None:
        un = [torch.where(m[None], b, u) for m, b, u in zip(masks, blend,
                                                             u0_l)]
    else:
        un = [torch.where(m[None], scale * (u + b), u)
              for m, b, u in zip(masks, blend, u_l)]
    if bc is not None:
        un = bc_vector_local(mesh, S, un, bc, cfg.exitBC, perdir=cfg.perdir)
        if cfg.exitBC and scale is None:
            un = exit_bc_local(mesh, S, un, u0_l, bc, dt)
    return mesh.to_state(un, 1)


def shardmap_mom_step(cfg, mesh: ShardMesh, levels, state, pallas=None):
    """One predictor/corrector time step (reference ``mom_step!``) on the
    shards' blocks: the phases of `flow.mom_step` in its order, with its
    time conventions.  Returns ``(state, aux)`` as `flow.mom_step` does
    (``aux["res_trace"]`` under ``cfg.log``).  ``state`` and the fine
    level are in the form ``mesh`` keeps them (`ShardMesh.from_state`,
    `local_levels`: global on the in-process mesh, the rank's blocks on a
    process mesh); the coarse levels are whole.  ``pallas`` overrides the
    per-shard dispatch (`shard_smooth`): "off" or "kernels".

    The step is differentiable on either mesh (`parallel.dist`): a step
    whose inputs autograd tracks runs the plain local forms, with
    ``cfg.fixed_iters`` solves unrolled; ``cfg.implicit_diff`` solves by
    `shard_solve.ml_solve_local_implicit`, whose forward and adjoint
    solves keep the kernel forms.  Every value all shards hold alike
    (``dt``, ``t``, the BC velocity) enters the blocks through
    `ShardMesh.pbroadcast`."""
    from ..flow import bc_tuple
    from ..ops.convect import accelerate

    fine = levels[0]
    D, S, dtype = cfg.D, tuple(cfg.S), cfg.dtype
    coarse = tuple(replicate_level(lev) for lev in levels[1:])
    if pallas is None:
        pallas = _auto_pallas(mesh, S, dtype)
    u0 = mesh.from_state(state.u, 1)
    p = mesh.from_state(state.p)
    V, mu0 = mesh.from_state(state.V, 1), mesh.from_state(state.mu0, 1)
    mu1 = mesh.from_state(state.mu1, 2)
    fL, fD, fiD = (mesh.from_state(fine.L, 1), mesh.from_state(fine.D),
                   mesh.from_state(fine.iD))
    dt, t = state.dt, state.t
    U = bc_tuple(cfg.U, t + dt, D, dtype)
    # a tracked field takes the plain forms (the kernels have no
    # derivative); the implicit solves see detached blocks
    solve_pallas = pallas
    if sk.ad_tracked(u0, p, V, mu0, mu1, fL, fD, dt, t, cfg.nu, U):
        pallas = "off"
    kern = pallas != "off"
    loc = tuple(p[0].shape)
    masks = ghost_mask_local(mesh, S, loc)
    # the operator's streams, for the solves and project3d (an implicit
    # solve of a tracked step builds its own of detached blocks)
    op = (prep_local_op(mesh, fL, fD, D, pallas)
          if kern or not cfg.implicit_diff else None)
    # the halo-extended blocks' cell 0, a plane below each block's
    base_ext = [tuple(b - 1 for b in mesh.base(s, S))
                for s in mesh.local_shards]
    inner = (slice(1, -1),) * D
    pad1 = (1, 1) * D
    # the invariant values, once each a step, as the blocks take them
    dt_v, nu_v = mesh.pbroadcast(dt), mesh.pbroadcast(cfg.nu)
    U_v = tuple(mesh.pbroadcast(a) for a in U)
    timed = cfg.g is not None or callable(cfg.U)     # accelerate reads t
    traces = []

    def solve(x, z):
        kw = dict(tol=cfg.tol, itmx=cfg.itmx, perdir=cfg.perdir,
                  masks=masks)
        if cfg.implicit_diff:
            return ml_solve_local_implicit(
                mesh, S, fL, fD, fiD, coarse, x, z, pallas=solve_pallas,
                op=op, **kw)
        out = ml_solve_local(mesh, S, fL, fD, fiD, coarse, x, z,
                             fixed=cfg.fixed_iters, pallas=pallas, op=op,
                             trace=cfg.log, **kw)
        if cfg.log:
            traces.append(out[3])
        return out[0], out[2]

    def solve_project(u, p, dt_eff):
        if kern:
            uh = halo_exchange(u, mesh, D)
            zx = [sk.div3d(uh[i], torch.nn.functional.pad(p[i], pad1),
                           dt_eff, S_glob=S, base=b)
                  for i, b in enumerate(base_ext)]
            z = [zz[inner] for zz, _x in zx]
            x = [xx[inner] for _z, xx in zx]
        else:
            z = _div_local(mesh, S, u, masks)
            x = [ps * dt_eff for ps in p]
        x, n = solve(x, z)
        if kern:
            Lh, _Dh = op
            xh = halo_exchange(x, mesh, D)
            up = [sk.project3d(Lh[i], xh[i],
                               torch.nn.functional.pad(u[i], pad1), dt_eff,
                               S_glob=S, base=b)
                  for i, b in enumerate(base_ext)]
            return ([un[(slice(None),) + inner] for un, _p in up],
                    [pn[inner] for _u, pn in up], n)
        u = _pressure_correct_local(mesh, S, fL, x, u, masks)
        return u, [xs / dt_eff for xs in x], n

    def bc(u):
        return bc_vector_local(mesh, S, u, U_v, cfg.exitBC, perdir=cfg.perdir)

    def tendency(u, t_r):
        r = conv_diff_local(mesh, S, u, nu_v, cfg.limiter, pallas,
                            cfg.perdir)
        t_r = mesh.pbroadcast(t_r) if timed else t_r
        return [accelerate(rs, t_r, cfg.g, cfg.U, dtype) for rs in r]

    # predictor u -> u'
    r = tendency(u0, t)
    blend = _bdim_blend_local(mesh, S, u0, r, V, mu0, mu1, dt_v)
    u1 = bc([torch.where(m[None], b, u) for m, b, u in zip(masks, blend, u0)])
    if cfg.exitBC:
        u1 = exit_bc_local(mesh, S, u1, u0, U, dt)
    u1, p, n1 = solve_project(u1, p, dt_v)
    u1 = bc(u1)

    # corrector u -> u¹
    r = tendency(u1, t + dt)
    blend = _bdim_blend_local(mesh, S, u0, r, V, mu0, mu1, dt_v)
    u2 = bc([torch.where(m[None], 0.5 * (a + b), a)
             for m, a, b in zip(masks, u1, blend)])
    u2, p, n2 = solve_project(u2, p, 0.5 * dt_v)
    u2 = bc(u2)

    dt_new = _cfl_local(mesh, S, u2, cfg.nu, masks)
    new = state.replace(u=mesh.to_state(u2, 1), p=mesh.to_state(p),
                        dt=dt_new, t=t + dt)
    aux = {"pois_n": [n1, n2], "dt": dt_new}
    if cfg.log:
        aux["res_trace"] = torch.stack(traces)
    return new, aux
