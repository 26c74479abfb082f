"""User-facing Simulation API.

PyTorch counterpart of `waterlily_tpu.simulation` (reference
src/WaterLily.jl:59-121), dense and banded paths, and the spatial
decomposition of `parallel` (``mesh=``).  A
`Simulation` couples the velocity and length scales, the flow state, the
body and the multigrid level stack; every field lives on its ``device``.
Steps run eagerly (the JAX package's jit, scan and unroll machinery has no
counterpart here).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .convert import to_numpy
from .body import (NoBody, measure_fields, measure_fields_banded,
                   band_box_shape)
from .flow import FlowConfig, flow_init, mom_step
from .grid import put_window
from .ops.convect import quick
from .ops.multigrid import build_levels, ml_solve_implicit
from .utils.perf import STEP_SPAN, host_read, span, spanned

__all__ = ["Simulation", "sim_time", "BANDED_MIN_CELLS"]

# Interior cell count from which a body's BDIM blend and remeasure run on a
# window around the body (the banded path), as in the JAX package: below
# it the window's extra ops cost more than the traffic they save.
BANDED_MIN_CELLS = 600_000


class Simulation:
    """Immersed-boundary incompressible flow simulation.

    Arguments follow the JAX package (and the reference constructor):
    ``dims`` interior grid dimensions; ``u_BC`` domain boundary velocity
    (tuple, or a function ``f(i,t)``); ``L`` length scale; ``U`` velocity
    scale (default ``|u_BC|``); ``dt`` initial time step; ``nu`` kinematic
    viscosity; ``g`` body acceleration ``g(i,t)``; ``epsilon`` BDIM kernel
    width; ``perdir`` periodic directions; ``exitBC`` convective outlet;
    ``ulam`` initial velocity ``uλ(i,x)``; ``body`` immersed geometry;
    ``dtype``; ``limiter``; ``tol``/``itmx`` pressure-solver tolerance and
    iteration cap; ``device`` where every field lives (default
    ``"cuda"``).

    ``fixed_iters=k`` runs exactly ``k`` pressure iterations a solve, with
    no host synchronisation, instead of the adaptive loop: the whole step
    is then differentiable in reverse mode (``torch.autograd`` through
    `flow.mom_step`, every iterate of every level kept for the backward
    pass) as well as forward (`torch.func.jvp`, which the adaptive step
    also takes), beyond the reference's forward-only scope
    (maintests.jl:254-278).

    ``implicit_diff=True`` differentiates in reverse mode by the
    implicit-function theorem instead: the solve keeps its adaptive loop
    and its kernels, and the backward pass costs one adjoint Poisson solve
    on the same level stack a projection
    (`ops.multigrid.ml_solve_implicit`), so memory does not grow with the
    iterations.  Gradients assume converged solves (tighten ``tol`` for a
    sensitive loss); forward mode through it raises.  It excludes
    ``fixed_iters`` and ``log``, refuses ``op_bf16=True`` (the adjoint
    differentiates the f32 operator) and turns the module default of the
    shadows off.

    Hand-written kernels have no derivatives: a field that autograd tracks
    takes the plain forms on its device (`ops.stencil_kernels.kernel_ok`),
    except in the ``implicit_diff`` solves, which see detached tensors.

    ``bbox``: a body on a grid of at least `BANDED_MIN_CELLS` interior
    cells takes the banded path: the BDIM blend and the remeasure run on a
    static-shape window (sized at t=0, plus a margin of 3 cells, or
    ``bbox`` cells when it is an int) that follows the body.  ``False``
    keeps the dense path (equal results); ``"force"`` takes the banded path
    at any size.  ``banded_levels=True`` also runs the Poisson levels on
    which the window pays as banded operators (`ops.poisson`).

    ``smoother_bf16=True`` stores the pressure smoother's search direction
    in bf16 on the blocked levels (big 3D f32 levels on a CUDA device;
    `PoissonLevel.bf16_eps`), as the JAX package does by default on its
    TPU blocked levels.  The port's default is ``False``: f32 directions
    everywhere, until a benchmark decides otherwise.  It has no effect on
    the CPU, where no level is blocked.

    ``op_bf16=True`` gives the blocked levels bf16 shadows of the Poisson
    operator (`PoissonLevel.L16`/``D16``/``iD16``): the smoothers apply the
    bf16-rounded operator in f32, reading half the coefficient bytes.
    ``None`` (the default) follows `ops.poisson.BF16_OP` (False), as in the
    JAX package.  It excludes ``smoother_bf16``: a shadowed level keeps f32
    search directions (the two roundings together lifted JAX's multigrid
    convergence floor above ``tol`` at 256³).  Like ``smoother_bf16`` it has
    no effect on the CPU.

    ``mesh`` (a `parallel.ShardMesh`, e.g. ``parallel.mesh_for(S, 8,
    device)`` for the padded shape ``S``): the step runs on the mesh's
    shards, `parallel.shard_step.shardmap_mom_step`, whenever the mesh
    divides the grid (`can_shard_step`; otherwise the dense step, which
    gives the same result).  The state stays global.  As in JAX, a
    sharded layout keeps the dense BDIM blend and dense Poisson levels (a
    body still gets the narrow-band measurement), and its coarse levels
    are replicated.  ``log``, ``fixed_iters`` and ``implicit_diff`` take
    JAX's per-phase path instead: `flow.mom_step` with conv_diff and the
    BDIM blend as one region over the blocks
    (`parallel.shard_step.shardmap_conv_bdim`), the rest of the step
    dense; the derivatives flow through the region.

    ``mesh`` may also be a `parallel.dist.ProcessMesh` (one block a
    `torch.distributed` rank, e.g. ``parallel.dist.dist_mesh_for(S)``;
    every rank of the mesh constructs the Simulation and steps it alike).
    Construction and a remeasure build the dense fields on every rank and
    keep the rank's blocks; between them a rank holds its blocks of the
    state and of the fine level and the whole coarse levels.  ``flow``
    then holds the rank's blocks; `global_flow` assembles the global
    fields on every rank (differentiable: a loss of them, computed alike
    on every rank, is one to call ``backward`` on, every rank alike).  The
    mesh must divide the grid (`ValueError` otherwise).  ``log``,
    ``fixed_iters`` and ``implicit_diff`` step on the rank's blocks
    (`parallel.shard_step.shardmap_mom_step`); gradients cross the ranks
    by JAX's shard_map rules (`parallel.dist`): each rank's gradient of a
    leaf every rank holds alike (ν, a body's radius) is the whole
    gradient.

    ``log=True`` captures the pressure solver's residual traces (reference
    ``@log``): `step` and `steps` append one ``(2, itmx+1, 2)`` numpy
    array a step to ``res_log`` (predictor, corrector; rows ``[max|r|,
    ⟨r, r⟩]``, zeros after the last iteration); `write_log` writes them in
    the reference's log format.
    """

    def __init__(self, dims, u_BC, L, dt=0.25, nu=0.0, g=None, U=None,
                 epsilon=1.0, perdir=(), ulam=None, exitBC=False, body=None,
                 dtype=torch.float32, limiter=quick, tol=1e-4, itmx=32,
                 bbox=True, fixed_iters=None, banded_levels=False,
                 smoother_bf16=False, op_bf16=None, device="cuda",
                 mesh=None, log=False, implicit_diff=False):
        D = len(dims)
        if implicit_diff and fixed_iters is not None:
            raise ValueError("implicit_diff and fixed_iters are mutually "
                             "exclusive reverse-mode paths; pick one")
        if implicit_diff and log:
            raise ValueError("implicit_diff does not capture residual "
                             "traces; use log=False (or fixed_iters)")
        if implicit_diff and op_bf16:
            raise ValueError("op_bf16 and implicit_diff are incompatible: "
                             "the adjoint differentiates the f32 operator")
        dev = torch.device(device)
        if mesh is not None and (mesh.device.type != dev.type or None not in (
                mesh.device.index, dev.index) and mesh.device.index != dev.index):
            raise ValueError(f"the mesh's device {mesh.device} is not the "
                             f"simulation's {device}")
        if callable(u_BC) and callable(ulam):
            raise ValueError("u_BC and ulam cannot both be functions")
        if callable(u_BC) and U is None:
            raise ValueError("U must be specified when u_BC is a function")
        self.U = float(U) if U is not None else math.sqrt(
            sum(v * v for v in u_BC))
        self.L = float(L)
        self.epsilon = float(epsilon)
        self.body = NoBody() if body is None else body
        self.device = torch.device(device)
        self._dims = tuple(dims)
        self.mesh = mesh
        self._bbox_arg = bbox
        self._banded_levels = bool(banded_levels)
        self.cfg = FlowConfig(
            D=D, S=tuple(n + 2 for n in dims), device=self.device,
            nu=nu if isinstance(nu, torch.Tensor) else float(nu), U=u_BC,
            g=g, perdir=tuple(perdir),
            exitBC=bool(exitBC), dtype=dtype, limiter=limiter,
            tol=float(tol), itmx=int(itmx),
            fixed_iters=None if fixed_iters is None else int(fixed_iters),
            log=bool(log), implicit_diff=bool(implicit_diff), mesh=mesh)
        self._size_window(0.0)
        self._sharded = None
        self._smoother_bf16 = bool(smoother_bf16)
        self._op_bf16 = None if op_bf16 is None else bool(op_bf16)
        if implicit_diff:
            # the module default BF16_OP must not turn the shadows on
            self._op_bf16 = False
        self.flow = flow_init(self.cfg, ulam, dt)
        self.levels = None
        self.measure(0.0)
        if self._distributed:
            # the velocity and pressure as the rank's blocks too
            (u,), (p,) = mesh.split(self.flow.u, 1), mesh.split(self.flow.p)
            self.flow = self.flow.replace(u=u, p=p)
        # host-side histories of flow.Δt, the solver iteration counts,
        # (under log) the solver's residual traces and (`reverse_step`) the
        # adjoint solves' iteration counts
        self.dts = [float(dt)]
        self.pois_n = []
        self.res_log = []
        self.adjoint_n = []

    def _size_window(self, t0):
        """Size the body's band window at time ``t0`` and set ``cfg``: a
        body on a grid of at least `BANDED_MIN_CELLS` interior cells (or
        ``bbox="force"``) gets the static window shape of
        `band_box_shape` (margin 3, or ``bbox`` cells); a sharded layout
        measures on the window but blends densely."""
        bbox = self._bbox_arg
        big = math.prod(self._dims) >= BANDED_MIN_CELLS or bbox == "force"
        shape = None
        if bbox and big and not isinstance(self.body, NoBody):
            margin = (bbox if isinstance(bbox, int)
                      and not isinstance(bbox, bool) else 3)
            shape = band_box_shape(self.body, self.cfg.S, float(t0),
                                   self.epsilon, self.cfg.dtype,
                                   margin=margin, device=self.device)
        self._measure_box = shape
        bbox_shape = None if self.mesh is not None else shape
        self.cfg = dataclasses.replace(self.cfg, bbox_shape=bbox_shape)
        # the window of the banded Poisson levels (None: dense levels)
        self._lv_box = bbox_shape if self._banded_levels else None

    def set_body(self, body):
        """Replace the immersed geometry: the band window is sized again
        for the new body at the time of the next step, then the body is
        measured there and the levels rebuilt (reference ``measure!(sim)``
        semantics; with no body the fields stay as they were, as in
        JAX)."""
        self.body = NoBody() if body is None else body
        self._size_window(float(self.flow.t) + float(self.flow.dt))
        if not isinstance(self.body, NoBody):
            self.measure()
        return self

    @property
    def _distributed(self) -> bool:
        return getattr(self.mesh, "distributed", False)

    def global_flow(self):
        """The state with global fields: ``flow`` itself, or on a process
        mesh its blocks assembled on every rank (differentiable: each
        rank's block takes its own part of a loss's cotangent)."""
        if not self._distributed:
            return self.flow
        mesh, f = self.mesh, self.flow
        return f.replace(u=mesh.assemble([f.u], 1), p=mesh.assemble([f.p]),
                         V=mesh.assemble([f.V], 1),
                         mu0=mesh.assemble([f.mu0], 1),
                         mu1=mesh.assemble([f.mu1], 2))

    # -- observability -----------------------------------------------------

    @property
    def time(self) -> float:
        """Accumulated simulation time (sum of completed steps)."""
        return float(self.flow.t)

    @property
    def sim_time(self) -> float:
        """Dimensionless time t·U/L."""
        return self.time * self.U / self.L

    # -- stepping ----------------------------------------------------------

    def _measure_all(self, t):
        """``(V, μ₀, μ₁, d_center, corner)``: narrow-band measurement and
        its window corner (host ints) when the body window is on (the
        reference's d² < (2+ε)² gate), dense measurement and None
        otherwise."""
        cfg = self.cfg
        if self._measure_box is not None:
            return measure_fields_banded(self.body, cfg.S, t, self.epsilon,
                                         cfg.perdir, cfg.exitBC, cfg.dtype,
                                         self._measure_box, cfg.device)
        return (*measure_fields(self.body, cfg.S, t, self.epsilon, cfg.perdir,
                                cfg.exitBC, cfg.dtype, cfg.device), None)

    def _band_covered(self, d_center, bb) -> bool:
        """True iff every band cell lies inside the static window (the
        window's shape is sized at t=0; a band that grows past it would get
        far-field constants outside it)."""
        if bb is None:
            return True
        outside = d_center < (2.0 + self.epsilon)
        put_window(outside, bb, self._measure_box, False)
        with host_read("band_check"):
            return not bool(outside.any())

    _BAND_ERR = ("body band outgrew its static window: the d<2+eps region "
                 "is no longer covered by cfg.bbox_shape (sized at t=0). "
                 "Widen the margin (Simulation(bbox=<margin cells>)) or "
                 "disable the banded path (bbox=False). Steps taken after "
                 "the band escaped ran on truncated physics — the current "
                 "state is NOT trustworthy; restart from a checkpoint.")

    @spanned("wl.body.measure")
    def measure(self, t=None):
        """Re-measure the body and rebuild the Poisson levels (reference
        `measure!(sim)`), at ``t`` (default: the time of the next step).
        All or nothing: a band that outgrew the window raises
        `RuntimeError` and leaves the state and levels as they were.  On a
        process mesh the dense fields and levels are built, then the rank
        keeps its blocks (`parallel.shard_step.local_levels`)."""
        if t is None:
            t = self.flow.t + self.flow.dt
        V, m0, m1, dc, bb = self._measure_all(t)
        if not self._band_covered(dc, bb):
            raise RuntimeError(self._BAND_ERR)
        with span("wl.body.levels"):
            levels = build_levels(m0, self.cfg.perdir, self._lv_box, bb,
                                  bf16_eps=self._smoother_bf16,
                                  op_bf16=self._op_bf16)
        if self.mesh is not None:
            from .parallel.shard_step import can_shard_step, local_levels
            self._sharded = can_shard_step(self.cfg, self.mesh, levels)
            if self._distributed:
                if not self._sharded:
                    raise ValueError(f"{self.mesh} does not divide the grid "
                                     f"{self.cfg.S}")
                mesh = self.mesh
                (V,), (m0,) = mesh.split(V, 1), mesh.split(m0, 1)
                (m1,) = mesh.split(m1, 2)
                levels = local_levels(mesh, levels)
        self.levels = levels
        self.flow = self.flow.replace(V=V, mu0=m0, mu1=m1, bbox=bb)
        return self

    def _take(self, flow):
        """One step of ``flow`` by the simulation's route (the sharded or
        the single-device step): ``(new flow, aux)``."""
        if self._sharded:
            from .parallel.shard_step import shardmap_mom_step
            return shardmap_mom_step(self.cfg, self.mesh, self.levels, flow)
        return mom_step(self.cfg, self.levels, flow)

    def _advance(self, remeasure: bool):
        if remeasure and not isinstance(self.body, NoBody):
            self.measure()
        self.flow, aux = self._take(self.flow)
        self.pois_n.append(aux["pois_n"])
        return aux

    @spanned(STEP_SPAN)
    def step(self, remeasure=True):
        """Advance one time step (reference `sim_step!(sim)`)."""
        aux = self._advance(remeasure)
        with host_read("dt"):
            self.dts.append(float(aux["dt"]))
        if self.cfg.log:
            with host_read("log"):
                self.res_log.append(aux["res_trace"].detach().cpu().numpy())
        return self

    @spanned(STEP_SPAN)
    def reverse_step(self, loss_fn, wrt=()):
        """One step differentiated in reverse mode: the unit of a training
        loop through the solver (one-step gradients) or of an adjoint
        sensitivity.  From the current state, with the velocity ``u₀`` a
        fresh leaf, it takes one step by `step`'s own route (the same
        gates, kernels and plain forms), evaluates ``loss_fn(flow)`` (a 0-d
        tensor) on the new state and back-propagates it by
        ``torch.autograd``, one adjoint pressure solve a projection
        (``implicit_diff``, which it requires).

        Returns ``(loss, grads)``: the loss as a float, read back with the
        new dt in the unit's one host read of its own, and the gradients
        in ``u₀`` and in each leaf of ``wrt`` (e.g. a 0-d ν made with
        ``requires_grad`` and passed as ``nu``), in that order.  The
        simulation is left at the new state, detached; ``dts``,
        ``pois_n`` and ``adjoint_n`` (the two adjoint solves' iteration
        counts, the predictor's first; ``ml_solve_implicit.adjoint_n`` is
        cleared for them) get the step's entries; the body is not measured
        again.  Under a profiler the unit is a `STEP_SPAN` root holding
        ``wl.grad.forward`` and ``wl.grad.backward``."""
        if not self.cfg.implicit_diff:
            raise ValueError("reverse_step differentiates an implicit_diff "
                             "step: construct Simulation(implicit_diff=True)")
        adjoint_n = ml_solve_implicit.adjoint_n
        adjoint_n.clear()
        with torch.enable_grad():
            with span("wl.grad.forward"):
                u0 = self.flow.u.detach().requires_grad_()
                new, aux = self._take(self.flow.replace(u=u0))
                loss = loss_fn(new)
            with span("wl.grad.backward"):
                grads = torch.autograd.grad(loss, (u0, *wrt))
        with host_read("loss"):
            value, dt = torch.stack([loss.detach().double(),
                                     aux["dt"].detach().double()]).tolist()
        self.flow = new.replace(u=new.u.detach(), p=new.p.detach(),
                                dt=new.dt.detach(), t=new.t.detach())
        self.pois_n.append(aux["pois_n"])
        self.adjoint_n.append(list(adjoint_n)[::-1])
        self.dts.append(dt)
        return value, grads

    def sim_step(self, t_end=None, remeasure=True, max_steps=None,
                 verbose=False):
        """Integrate to dimensionless time ``t_end`` (one step if None)."""
        if t_end is None:
            return self.step(remeasure)
        n = 0
        while self.sim_time < t_end and (max_steps is None or n < max_steps):
            self.step(remeasure)
            n += 1
            if verbose:
                print(f"tU/L={self.sim_time:.4f}, Δt={self.dts[-1]:.3f}")
        return self

    def steps(self, n, remeasure=True):
        """Advance ``n`` steps, reading the dt history (and, under ``log``,
        the residual traces) back once at the end (the solver's
        convergence checks still sync once per outer iteration)."""
        n = int(n)
        auxs = []
        for k in range(n):
            with span(STEP_SPAN):
                auxs.append(self._advance(remeasure))
                if k == n - 1:
                    self._read_back(auxs)
        return self

    def _read_back(self, auxs):
        """Append the dts (and, under ``log``, the residual traces) of the
        steps ``auxs`` to the histories, read back at once."""
        with host_read("dt"):
            self.dts.extend(torch.stack([a["dt"] for a in auxs]).tolist())
        if self.cfg.log:
            with host_read("log"):
                self.res_log.extend(torch.stack(
                    [a["res_trace"] for a in auxs]).detach().cpu().numpy())

    def run_until(self, t_end, chunk=50, remeasure=True):
        """Integrate to dimensionless time ``t_end`` in `steps` chunks; the
        last chunk may overshoot by up to ``chunk-1`` steps."""
        while self.sim_time < t_end:
            self.steps(chunk, remeasure=remeasure)
        return self

    def run_record(self, t_end, every=0.5, fields=None, remeasure=True):
        """Integrate to ``t_end`` sampling diagnostics every ``every``
        tU/L.  ``fields`` maps names to callables ``fn(sim) -> value``;
        each sample is kept as a numpy array.  Returns ``{"t": [...],
        name: [...], ...}``.

        The steps run in `steps` chunks, each sized for at most half the
        rest of the interval at the current dt and doubling from 1 across
        the run (JAX's chunk ramp, so that both packages sample at the same
        steps): a growing dt cannot jump past a sample."""
        fields = fields or {}
        out = {"t": []}
        for name in fields:
            out[name] = []
        ramp = 1
        while self.sim_time < t_end:
            target = min(self.sim_time + every, t_end)
            while self.sim_time < target:
                dt_nd = float(self.flow.dt) * self.U / self.L
                n = max(1, min(ramp, int(0.5 * (target - self.sim_time)
                                         / max(dt_nd, 1e-9))))
                ramp = 2 * ramp
                self.steps(n, remeasure=remeasure)
            out["t"].append(self.sim_time)
            for name, fn in fields.items():
                out[name].append(to_numpy(fn(self)))
        return out

    def write_log(self, fname="WaterLily.log"):
        """Write the captured residual traces in the reference's log format
        (src/util.jl:16-24): the header ``p/c, iter, r∞, r₂``, then per step
        a ``p`` and a ``c`` line each followed by ``, it, r∞, r₂`` rows up to
        the first zero row."""
        if not self.cfg.log:
            raise ValueError("construct Simulation(log=True) to capture "
                             "traces")
        with open(fname, "w") as f:
            f.write("p/c, iter, r∞, r₂\n")
            for step_tr in self.res_log:
                for phase, tr in zip("pc", step_tr):
                    f.write(f"{phase}\n")
                    for it, (linf_, r2) in enumerate(tr):
                        if it > 0 and linf_ == 0 and r2 == 0:
                            break
                        f.write(f", {it}, {linf_}, {r2}\n")


def sim_time(sim: Simulation) -> float:
    return sim.sim_time
