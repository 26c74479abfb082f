"""User-facing Simulation API.

PyTorch counterpart of `waterlily_tpu.simulation` (reference
src/WaterLily.jl:59-121), dense single-device path.  A `Simulation` couples
the velocity and length scales, the flow state, the body and the multigrid
level stack; every field lives on the ``device`` it is given.  Steps run
eagerly (the JAX package's jit, scan and unroll machinery has no
counterpart here).
"""
from __future__ import annotations

import math

import torch

from .body import NoBody, measure_fields
from .flow import FlowConfig, flow_init, mom_step
from .ops.convect import quick
from .ops.multigrid import build_levels

__all__ = ["Simulation", "sim_time", "BANDED_MIN_CELLS"]

# Interior cell count from which the JAX package runs a body's BDIM blend and
# remeasure on a band window (its `bbox` path), not ported yet (ROADMAP A12).
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
    iteration cap; ``fixed_iters`` a fixed number of solver iterations.

    ``device`` is required: nothing is placed implicitly.

    ``bbox``: the JAX package switches a body on a grid of at least
    `BANDED_MIN_CELLS` interior cells to its banded BDIM path unless
    ``bbox=False``.  That path is not ported, so such a configuration
    raises `NotImplementedError` instead of silently computing something
    else; pass ``bbox=False`` for the dense path (equal results).
    """

    def __init__(self, dims, u_BC, L, dt=0.25, nu=0.0, g=None, U=None,
                 epsilon=1.0, perdir=(), ulam=None, exitBC=False, body=None,
                 dtype=torch.float32, limiter=quick, tol=1e-4, itmx=32,
                 bbox=True, fixed_iters=None, *, device):
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
        big = math.prod(self._dims) >= BANDED_MIN_CELLS
        if bbox and big and not isinstance(self.body, NoBody):
            raise NotImplementedError(
                f"a body on a {self._dims} grid takes the JAX package's banded "
                "BDIM path, which is not ported yet (ROADMAP A12); pass "
                "bbox=False for the dense path, which gives the same results")
        self.cfg = FlowConfig(
            D=D, S=tuple(n + 2 for n in dims), device=self.device,
            nu=float(nu), U=u_BC, g=g, perdir=tuple(perdir),
            exitBC=bool(exitBC), dtype=dtype, limiter=limiter,
            tol=float(tol), itmx=int(itmx),
            fixed_iters=None if fixed_iters is None else int(fixed_iters))
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

    def _fields(self, t):
        cfg = self.cfg
        V, m0, m1, _ = measure_fields(self.body, cfg.S, t, self.epsilon,
                                      cfg.perdir, cfg.exitBC, cfg.dtype,
                                      cfg.device)
        return V, m0, m1, build_levels(m0, cfg.perdir)

    def measure(self, t=None):
        """Re-measure the body and rebuild the Poisson levels (reference
        `measure!(sim)`), at ``t`` (default: the time of the next step)."""
        if t is None:
            t = self.flow.t + self.flow.dt
        V, m0, m1, self.levels = self._fields(t)
        self.flow = self.flow.replace(V=V, mu0=m0, mu1=m1)
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
