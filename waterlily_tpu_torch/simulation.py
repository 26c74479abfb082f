"""User-facing Simulation API.

PyTorch counterpart of `waterlily_tpu.simulation` (reference
src/WaterLily.jl:59-121), single device, dense and banded paths.  A
`Simulation` couples the velocity and length scales, the flow state, the
body and the multigrid level stack; every field lives on its ``device``.
Steps run eagerly (the JAX package's jit, scan and unroll machinery has no
counterpart here).
"""
from __future__ import annotations

import math

import torch

from .body import (NoBody, measure_fields, measure_fields_banded,
                   band_box_shape)
from .flow import FlowConfig, flow_init, mom_step
from .grid import box_slices
from .ops.convect import quick
from .ops.multigrid import build_levels

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
    iteration cap; ``fixed_iters`` a fixed number of solver iterations;
    ``device`` where every field lives (default ``"cuda"``).

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
    """

    def __init__(self, dims, u_BC, L, dt=0.25, nu=0.0, g=None, U=None,
                 epsilon=1.0, perdir=(), ulam=None, exitBC=False, body=None,
                 dtype=torch.float32, limiter=quick, tol=1e-4, itmx=32,
                 bbox=True, fixed_iters=None, banded_levels=False,
                 smoother_bf16=False, op_bf16=None, device="cuda"):
        D = len(dims)
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
        S = tuple(n + 2 for n in dims)
        big = math.prod(self._dims) >= BANDED_MIN_CELLS or bbox == "force"
        bbox_shape = None
        if bbox and big and not isinstance(self.body, NoBody):
            margin = (bbox if isinstance(bbox, int)
                      and not isinstance(bbox, bool) else 3)
            bbox_shape = band_box_shape(self.body, S, 0.0, self.epsilon,
                                        dtype, margin=margin,
                                        device=self.device)
        self.cfg = FlowConfig(
            D=D, S=S, device=self.device,
            nu=float(nu), U=u_BC, g=g, perdir=tuple(perdir),
            exitBC=bool(exitBC), dtype=dtype, limiter=limiter,
            tol=float(tol), itmx=int(itmx),
            fixed_iters=None if fixed_iters is None else int(fixed_iters),
            bbox_shape=bbox_shape)
        # the window of the banded Poisson levels (None: dense levels)
        self._lv_box = bbox_shape if banded_levels else None
        self._smoother_bf16 = bool(smoother_bf16)
        self._op_bf16 = None if op_bf16 is None else bool(op_bf16)
        self.flow = flow_init(self.cfg, ulam, dt)
        self.levels = None
        self.measure(0.0)
        # host-side histories of flow.Δt and the solver iteration counts
        self.dts = [float(dt)]
        self.pois_n = []

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
        if cfg.bbox_shape is not None:
            return measure_fields_banded(self.body, cfg.S, t, self.epsilon,
                                         cfg.perdir, cfg.exitBC, cfg.dtype,
                                         cfg.bbox_shape, cfg.device)
        return (*measure_fields(self.body, cfg.S, t, self.epsilon, cfg.perdir,
                                cfg.exitBC, cfg.dtype, cfg.device), None)

    def _band_covered(self, d_center, bb) -> bool:
        """True iff every band cell lies inside the static window (the
        window's shape is sized at t=0; a band that grows past it would get
        far-field constants outside it)."""
        if bb is None:
            return True
        outside = d_center < (2.0 + self.epsilon)
        outside[box_slices(bb, self.cfg.bbox_shape)] = False
        return not bool(outside.any())

    _BAND_ERR = ("body band outgrew its static window: the d<2+eps region "
                 "is no longer covered by cfg.bbox_shape (sized at t=0). "
                 "Widen the margin (Simulation(bbox=<margin cells>)) or "
                 "disable the banded path (bbox=False). Steps taken after "
                 "the band escaped ran on truncated physics — the current "
                 "state is NOT trustworthy; restart from a checkpoint.")

    def measure(self, t=None):
        """Re-measure the body and rebuild the Poisson levels (reference
        `measure!(sim)`), at ``t`` (default: the time of the next step).
        All or nothing: a band that outgrew the window raises
        `RuntimeError` and leaves the state and levels as they were."""
        if t is None:
            t = self.flow.t + self.flow.dt
        V, m0, m1, dc, bb = self._measure_all(t)
        if not self._band_covered(dc, bb):
            raise RuntimeError(self._BAND_ERR)
        self.levels = build_levels(m0, self.cfg.perdir, self._lv_box, bb,
                                   bf16_eps=self._smoother_bf16,
                                   op_bf16=self._op_bf16)
        self.flow = self.flow.replace(V=V, mu0=m0, mu1=m1, bbox=bb)
        return self

    def _advance(self, remeasure: bool):
        if remeasure and not isinstance(self.body, NoBody):
            self.measure()
        self.flow, aux = mom_step(self.cfg, self.levels, self.flow)
        self.pois_n.append(aux["pois_n"])
        return aux["dt"]

    def step(self, remeasure=True):
        """Advance one time step (reference `sim_step!(sim)`)."""
        self.dts.append(float(self._advance(remeasure)))
        return self

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
        """Advance ``n`` steps, reading the dt history back once at the
        end (the solver's convergence checks still sync once per outer
        iteration)."""
        dts = [self._advance(remeasure) for _ in range(int(n))]
        if dts:
            self.dts.extend(torch.stack(dts).tolist())
        return self

    def run_until(self, t_end, chunk=50, remeasure=True):
        """Integrate to dimensionless time ``t_end`` in `steps` chunks; the
        last chunk may overshoot by up to ``chunk-1`` steps."""
        while self.sim_time < t_end:
            self.steps(chunk, remeasure=remeasure)
        return self


def sim_time(sim: Simulation) -> float:
    return sim.sim_time
