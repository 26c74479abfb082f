"""Flow state and the momentum step (predictor/corrector + projection).

PyTorch counterpart of `waterlily_tpu.flow` (reference src/Flow.jl),
single device, with the dense and the band-windowed BDIM blend.  `mom_step(cfg, levels, state) -> (state, aux)` runs
eagerly; the only host synchronisations are the pressure solver's
convergence checks (one per outer multigrid iteration).

The step is differentiable: ``torch.autograd`` through a
``cfg.fixed_iters`` step or an ``cfg.implicit_diff`` step (one adjoint
pressure solve a projection, `ops.multigrid.ml_solve_implicit`), and
``torch.func.jvp`` through the adaptive or the ``fixed_iters`` step.  A
field that autograd tracks takes the plain forms (`ops.stencil_kernels.
kernel_ok`); the pressure solve of ``implicit_diff`` runs the kernels in
its forward and its adjoint solve.

Under an in-process mesh (``cfg.mesh``, the per-phase sharded path that
`Simulation` takes for ``log``, ``fixed_iters`` and ``implicit_diff``,
as JAX routes them) conv_diff, accelerate and the BDIM blend run as one
region over the shards' blocks (`parallel.shard_step.shardmap_conv_bdim`),
the rest of the step dense, as JAX's `mom_step` does with its mesh.  A
process mesh's rank holds only its blocks: there these options take the
whole step on the blocks (`parallel.shard_step.shardmap_mom_step`),
differentiable across ranks (`parallel.dist`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from .grid import (interior_view, interior_mask, apply_field, pad_interior,
                   window, put_window)
from .ops.bc import bc_vector, exit_bc
from .ops.convect import conv_diff, accelerate, quick
from .ops.multigrid import ml_solve, ml_solve_implicit
from .ops.poisson import pressure_grad_interior
from .ops import stencil_kernels as sk
from .parallel import shard_step
from .parallel.shard_smooth import can_shardmap
from .utils.perf import span, spanned

__all__ = ["FlowState", "FlowConfig", "bc_tuple", "div", "bdim",
           "bdim_banded", "project", "cfl", "cfl_flux_max", "mom_step",
           "flow_init"]


@dataclass(frozen=True)
class FlowState:
    """Simulation state (reference `Flow` fields, src/Flow.jl:92-122)."""
    u: torch.Tensor     # (D, *S) velocity
    p: torch.Tensor     # (*S) pressure
    V: torch.Tensor     # (D, *S) body velocity (BDIM)
    mu0: torch.Tensor   # (D, *S) zeroth kernel moment (= Poisson face coeffs)
    mu1: torch.Tensor   # (D, D, *S) first kernel moment × normal
    dt: torch.Tensor    # 0-d: the time step to take next
    t: torch.Tensor     # 0-d: accumulated time
    # body-band window corner (banded): host ints, or a (D,) int64 tensor
    # that stays on the device (each member's own under torch.func.vmap)
    bbox: tuple | torch.Tensor | None = None

    def replace(self, **kw) -> "FlowState":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FlowConfig:
    """Static configuration of the step."""
    D: int
    S: tuple                       # ghost-padded spatial shape
    device: Any = "cuda"           # torch device of every field
    nu: Any = 0.0                  # a number, or a 0-d tensor to differentiate
    U: Any = None                  # tuple of BC velocities or callable (i,t)->u_i
    g: Callable | None = None      # body force g(i,t)
    perdir: tuple = ()
    exitBC: bool = False
    dtype: Any = torch.float32
    limiter: Callable = quick
    tol: float = 1e-4
    itmx: int = 32
    fixed_iters: int | None = None   # exactly k solver iterations, no host
    # sync: reverse mode through the unrolled solve (and jvp)
    bbox_shape: tuple | None = None  # body-band box extents (banded BDIM)
    log: bool = False              # capture the solver's residual traces
    implicit_diff: bool = False      # reverse mode by one adjoint solve a
    # projection instead of the unroll (ops.multigrid.ml_solve_implicit)
    mesh: Any = None                 # an in-process parallel.ShardMesh: the
    # conv + BDIM region on its blocks (parallel.shard_step)


def bc_tuple(U, t, D, dtype):
    """The BC velocity at time ``t`` (reference `BCTuple`): Python numbers
    for a constant ``U``; for a callable, 0-d tensors on the device of
    ``t`` (a tensor time), whether a component is a number or a tensor, so
    that the kernels take them with no host synchronisation.  A tensor
    component of a constant ``U`` is kept as it is (it may be
    differentiated)."""
    if callable(U):
        dev = t.device if isinstance(t, torch.Tensor) else None
        return tuple(torch.as_tensor(U(i, t), dtype=dtype, device=dev)
                     for i in range(D))
    return tuple(Ui if isinstance(Ui, torch.Tensor) else float(Ui)
                 for Ui in U)


def _off(D, i, v):
    return tuple(v if d == i else 0 for d in range(D))


def div(u: torch.Tensor) -> torch.Tensor:
    """Cell divergence Σᵢ u[I+δᵢ,i]-u[I,i] on the interior, zero ghosts."""
    D = u.shape[0]
    s = None
    for i in range(D):
        t = interior_view(u[i], D, _off(D, i, +1)) - interior_view(u[i], D)
        s = t if s is None else s + t
    return pad_interior(s)


def _bdim_blend(u0, r, V, mu0, mu1, dt):
    """Interior BDIM update: ``f = u⁰ + dt·r - V``, then
    ``½Σⱼ μ₁[:,j](f[+δⱼ]-f[-δⱼ]) + V + μ₀∘f``."""
    D = u0.shape[0]
    f = u0 + dt * r - V
    iv = lambda a, off=None: interior_view(a, D, off)
    m = None
    for j in range(D):
        t = iv(mu1[:, j]) * (iv(f, _off(D, j, +1)) - iv(f, _off(D, j, -1)))
        m = t if m is None else m + t
    return 0.5 * m + iv(V) + iv(mu0) * iv(f)


def bdim(u, u0, r, V, mu0, mu1, dt):
    """BDIM velocity blend (reference `BDIM!`)."""
    return u + pad_interior(_bdim_blend(u0, r, V, mu0, mu1, dt), lead=1)


def bdim_banded(cfg: FlowConfig, bbox, u, u0, r, V, mu0, mu1, dt,
                scale=None):
    """Band-windowed BDIM blend.  Outside the kernel band μ₁ = 0, V = 0
    and μ₀ = 1 exactly, so the blend reduces to ``u + u⁰ + dt·r`` there;
    the full blend runs only on the ``cfg.bbox_shape + 2`` window at corner
    ``bbox``.  Equal to `bdim` (with the scalings around it) up to the sign
    of zero.

    ``u=None`` is the predictor form: interior from the blend alone, ghosts
    from ``u0`` (the reference's ``scale_u!(a, 0)`` folded in); ``scale``
    folds the corrector's ``scale_u!(a, 0.5)``.  ``bbox`` is host ints
    (slices, and writes into the step's own fields) or a ``(D,)`` tensor
    (each member's own corner under `torch.func.vmap`: gathers and
    ``index_put``, `grid.window`/`put_window`)."""
    D, W = cfg.D, cfg.bbox_shape
    win = lambda a, lead: window(a, bbox, tuple(w + 2 for w in W), lead,
                                 off=0)
    blend = _bdim_blend(win(u0, 1), win(r, 1), win(V, 1), win(mu0, 1),
                        win(mu1, 2), dt)
    f_far = u0 + dt * r                  # V = 0 away from the body
    imask = interior_mask(cfg.S, u0.device)
    if u is None:
        return put_window(torch.where(imask, f_far, u0), bbox, W, blend, 1)
    upd_far = u + f_far
    w_val = interior_view(win(u, 1), D) + blend
    if scale is not None:
        upd_far, w_val = scale * upd_far, scale * w_val
    return put_window(torch.where(imask, upd_far, u), bbox, W, w_val, 1)


@spanned("wl.flow.project")
def project(levels, u, p, dt_eff, cfg: FlowConfig):
    """Pressure projection (reference `project!`): the Poisson unknown is
    the dt-scaled pressure, warm-started from the last step; the velocity
    loses the μ₀-weighted pressure gradient.  Returns ``(u, p, (n, tr))``,
    ``tr`` the solver's residual trace under ``cfg.log`` (None
    otherwise).  ``cfg.implicit_diff`` solves by `ml_solve_implicit` with
    the unfused divergence and correction around it, as JAX does."""
    lev = levels[0]
    fused = (not lev.banded and not cfg.implicit_diff
             and sk.members_ok(tuple(p.shape), p.dtype, p.device, u, p,
                               dt_eff, lev.L))
    if fused:
        z, x = sk.div3d(u, p, dt_eff)
    else:
        z = div(u)
        x = p * dt_eff
    if cfg.implicit_diff:
        x, n = ml_solve_implicit(levels, x, z, tol=cfg.tol, itmx=cfg.itmx)
        tr = None
    else:
        out = ml_solve(levels, x, z, tol=cfg.tol, itmx=cfg.itmx,
                       fixed=cfg.fixed_iters, trace=cfg.log)
        x, n = out[0], out[2]
        tr = out[3] if cfg.log else None
    if fused:
        u, p = sk.project3d(lev.L, x, u, dt_eff)
    else:
        u = u - pad_interior(pressure_grad_interior(lev, x), lead=1)
        p = x / dt_eff
    return u, p, (n, tr)


def cfl_flux_max(u: torch.Tensor) -> torch.Tensor:
    """Interior max of Σᵢ max(0,uᵢ[I+δᵢ]) + max(0,−uᵢ[I]) (0-d tensor)."""
    D = u.shape[0]
    s = None
    for i in range(D):
        t = (torch.clamp_min(interior_view(u[i], D, _off(D, i, +1)), 0.0)
             + torch.clamp_min(-interior_view(u[i], D), 0.0))
        s = t if s is None else s + t
    return torch.max(s)


@spanned("wl.flow.cfl")
def cfl(u, nu, dt_max=10.0):
    """Adaptive time step (reference `CFL`/`flux_out`) as a 0-d tensor; a
    ``u`` that autograd tracks takes `cfl_flux_max` (the max's
    subgradient, as JAX's)."""
    S = tuple(u.shape[1:])
    if u.shape[0] == 3 and sk.members_ok(S, u.dtype, u.device, u):
        mx = sk.cfl3d(u)
    else:
        mx = cfl_flux_max(u)
    return torch.clamp_max(1.0 / (mx + 5 * nu), dt_max)


@spanned("wl.flow.mom_step")
def mom_step(cfg: FlowConfig, levels, state: FlowState):
    """One predictor/corrector time step (reference `mom_step!`).

    Returns the advanced state and ``aux`` with the pressure-solver
    iteration counts ``pois_n = [predictor, corrector]`` (host ints; under
    `torch.func.vmap` with an adaptive solve each member's, a (2,)
    tensor), the
    next ``dt`` and, under ``cfg.log``, ``res_trace``: the predictor's and
    corrector's residual traces stacked, ``(2, itmx+1, 2)``.  Nothing of
    ``state`` is updated in place: ``state.u`` is read again by the
    corrector's BDIM blend and by the outlet BC; the boundary conditions
    fill in place only the fields the step itself has just made, and
    none that autograd tracks (a write into a tensor autograd saved would
    fail its version check)."""
    D, dtype = cfg.D, cfg.dtype
    u0, p, dt, t = state.u, state.p, state.dt, state.t
    U = bc_tuple(cfg.U, t + dt, D, dtype)
    imask = interior_mask(cfg.S, cfg.device)
    banded = cfg.bbox_shape is not None

    @spanned("wl.flow.bc")
    def bc(u):
        # in place on a field the step has just made, where autograd does
        # not track it; under vmap alone where the BC values are every
        # member's (a batched value cannot go into an unbatched field)
        return bc_vector(u, U, cfg.exitBC, cfg.perdir,
                         inplace=not sk.ad_tracked(u) or (
                             sk.vmap_only(u) and not sk.vmapped(U)))

    # the sharded conv + BDIM region (JAX's per-phase path); a field that
    # autograd tracks, or an implicit_diff step, takes the plain forms
    shard_cb = (cfg.mesh is not None and not banded
                and not cfg.mesh.distributed
                and can_shardmap(cfg.mesh, tuple(cfg.S), cfg.perdir))

    def conv_bdim(u, t_r, scale):
        pallas = ("off" if cfg.implicit_diff or sk.ad_tracked(u) else None)
        return shard_step.shardmap_conv_bdim(cfg, u, u0, state.V, state.mu0,
                                             state.mu1, dt, t_r, scale,
                                             pallas=pallas)

    # predictor u -> u'
    if shard_cb:
        u = conv_bdim(u0, t, None)
    else:
        with span("wl.flow.conv_diff"):
            r = conv_diff(u0, cfg.nu, cfg.perdir, cfg.limiter)
        r = accelerate(r, t, cfg.g, cfg.U, dtype)
        with span("wl.flow.bdim"):
            if banded:
                u = bdim_banded(cfg, state.bbox, None, u0, r, state.V,
                                state.mu0, state.mu1, dt)
            else:
                u = torch.where(imask, 0.0, u0)         # scale_u!(a, 0)
                u = bdim(u, u0, r, state.V, state.mu0, state.mu1, dt)
    u = bc(u)
    if cfg.exitBC:
        with span("wl.flow.bc"):
            u = exit_bc(u, u0, U, dt)
    u, p, (n1, tr1) = project(levels, u, p, dt, cfg)
    u = bc(u)

    # corrector u -> u¹
    if shard_cb:
        u = conv_bdim(u, t + dt, 0.5)
    else:
        with span("wl.flow.conv_diff"):
            r = conv_diff(u, cfg.nu, cfg.perdir, cfg.limiter)
        r = accelerate(r, t + dt, cfg.g, cfg.U, dtype)
        with span("wl.flow.bdim"):
            if banded:
                u = bdim_banded(cfg, state.bbox, u, u0, r, state.V,
                                state.mu0, state.mu1, dt, scale=0.5)
            else:
                u = bdim(u, u0, r, state.V, state.mu0, state.mu1, dt)
                u = torch.where(imask, 0.5 * u, u)      # scale_u!(a, 0.5)
    u = bc(u)
    u, p, (n2, tr2) = project(levels, u, p, 0.5 * dt, cfg)
    u = bc(u)

    dt_new = cfl(u, cfg.nu)
    new = state.replace(u=u, p=p, dt=dt_new, t=t + dt)
    # a count is a tensor under torch.func.vmap (each member's own)
    pois_n = ([n1, n2] if isinstance(n1, int) and isinstance(n2, int)
              else torch.stack([torch.as_tensor(n1), torch.as_tensor(n2)]))
    aux = {"pois_n": pois_n, "dt": dt_new}
    if cfg.log:
        aux["res_trace"] = torch.stack([tr1, tr2])
    return new, aux


def flow_init(cfg: FlowConfig, ulam=None, dt0=0.25) -> FlowState:
    """Initial state (reference `Flow` constructor, src/Flow.jl:110-121)."""
    D, S, dtype, dev = cfg.D, cfg.S, cfg.dtype, cfg.device
    if ulam is None:
        U0t = bc_tuple(cfg.U, torch.zeros((), dtype=dtype, device=dev), D,
                       dtype)
        u = torch.stack([torch.full(S, 0.0, dtype=dtype, device=dev) + U0t[i]
                         for i in range(D)])
    else:
        u = apply_field(ulam, (D,) + S, dtype, vector=True, device=dev)
    U0 = bc_tuple(cfg.U, torch.zeros((), dtype=dtype, device=dev), D, dtype)
    u = bc_vector(u, U0, cfg.exitBC, cfg.perdir, inplace=True)
    u = exit_bc(u, u, U0, 0.0)      # always applied at init (Flow.jl:115)
    p = torch.zeros(S, dtype=dtype, device=dev)
    V = torch.zeros((D,) + S, dtype=dtype, device=dev)
    mu0 = bc_vector(torch.ones((D,) + S, dtype=dtype, device=dev), (0.0,) * D,
                    False, cfg.perdir, inplace=True)
    mu1 = torch.zeros((D, D) + S, dtype=dtype, device=dev)
    return FlowState(u=u, p=p, V=V, mu0=mu0, mu1=mu1,
                     dt=torch.tensor(dt0, dtype=dtype, device=dev),
                     t=torch.zeros((), dtype=dtype, device=dev))
