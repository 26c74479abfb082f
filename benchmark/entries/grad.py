"""The timed entry ``grad``: one `Simulation.reverse_step`, the unit of a
training loop through the solver or of an adjoint sensitivity.

The program is a `Simulation(implicit_diff=True)` built as `entries/step.py`
builds one, its viscosity a 0-d leaf.  A unit steps the flow once with its
velocity and viscosity tracked, takes the loss ``Σ ke(u)`` (the total
kinetic energy, the quantity WaterLily's own derivative test
differentiates) and back-propagates it to ``d loss / d u₀`` (a whole
field) and ``d loss / d ν``; the simulation goes on from the new state.
The contract of an entry is `entries/step.py`'s docstring.

``counts`` holds one entry a unit, ``[pred, corr, adj_1, adj_2]``: the
predictor's and the corrector's pressure-solve iterations, then those of
their adjoint solves (the predictor's first).  ``failed()`` counts the
units whose loss or gradients were not finite (the gradients' test stays
on the device until it is asked).

Two units are judged, as `step` judges two steps: ``first``, set-up's
first unit, against the reference's own initial state, and ``last``, one
more unit after the window, from the program's state at its close
(velocity, pressure, time step and time).  The reference
(`reference/adjoint.py`) takes its own step from that state and its own
gradient, on the device, once the program is dropped.  Numbers, each of
``first`` and ``last``:

- ``dg``: max |g - g_ref| / max |g_ref| of ``d loss / d u₀`` over the
  interior cells;
- ``eg``: the root mean square of ``g - g_ref`` over that of ``g_ref``,
  over the interior;
- ``dnu``: |g_ν - g_ν,ref| / |g_ν,ref|;
- ``dloss``: the relative difference of the losses, and ``dna`` the
  adjoint solves' iteration counts' summed difference;
- `check.numbers` of the new state (``du``, ``dp``, ``eu``, ``ep``,
  ``ddt``, ``dn``).
"""
from __future__ import annotations

import math

import torch

from benchmark import check
from benchmark.reference import adjoint as radjoint
from benchmark.reference import solver as rsolver
from waterlily_tpu_torch.body import AutoBody
from waterlily_tpu_torch.metrics import ke
from waterlily_tpu_torch.simulation import Simulation


def _loss(flow):
    return torch.sum(ke(flow.u))


class _Units:
    """`Simulation.reverse_step` as the timed unit."""

    def __init__(self, sim, nu, cells: int):
        self.sim, self.nu, self.cells = sim, nu, cells
        self.losses = []
        self.bad = torch.zeros((), dtype=torch.int64, device=sim.device)
        self.kept = {}

    @property
    def counts(self):
        return [list(n) + list(a)
                for n, a in zip(self.sim.pois_n, self.sim.adjoint_n)]

    def _unit(self):
        loss, (g_u, g_nu) = self.sim.reverse_step(_loss, wrt=(self.nu,))
        self.losses.append(loss)
        self.bad += ~(torch.isfinite(g_u).all() & torch.isfinite(g_nu))
        return loss, g_u, g_nu

    def _host(self, loss, g_u, g_nu) -> dict:
        sim = self.sim
        return {"u": sim.flow.u.cpu(), "p": sim.flow.p.cpu(),
                "dt": sim.dts[-1], "pois": list(sim.pois_n[-1]),
                "adj": list(sim.adjoint_n[-1]), "loss": loss,
                "g_u": g_u.cpu(), "g_nu": float(g_nu)}

    def advance(self):
        if self.kept:
            self._unit()
            return
        # the first unit, judged from the initial dt
        self.kept["dt0"] = float(self.sim.flow.dt)
        self.kept["first"] = self._host(*self._unit())

    def failed(self) -> int:
        return (sum(1 for v in self.losses if not math.isfinite(v))
                + int(self.bad))

    def finish(self) -> dict:
        before = self.sim.flow
        last = self._host(*self._unit())
        kept, self.kept = self.kept, {}
        kept.update(last=last, state=(
            before.u.detach(), before.p.detach(), before.dt.detach(),
            before.t.detach()))
        return kept


def build(setup, cfg, mix, ulam, dtype, device, options):
    if mix["remeasure"] or mix.get("motion"):
        raise ValueError("the grad entry steps a fixed body")
    if not hasattr(Simulation, "reverse_step"):
        raise RuntimeError("the program has no Simulation.reverse_step")
    body = setup["body"]
    nu = torch.tensor(setup["nu"], dtype=dtype, device=device,
                      requires_grad=True)
    sim = Simulation(
        setup["dims"], setup["u_BC"], setup["L"], U=setup["U"], nu=nu,
        perdir=setup["perdir"], ulam=ulam,
        body=None if body is None else AutoBody(*body),
        epsilon=float(cfg["epsilon"]), tol=float(cfg["tol"]),
        itmx=int(cfg["itmx"]), dtype=dtype, device=device,
        implicit_diff=True, **(options or {}))
    return _Units(sim, nu, math.prod(setup["dims"]))


def _rms(a):
    return math.sqrt(float(torch.mean(a.to(torch.float64) ** 2)))


def numbers(tag: str, prog: dict, loss, g_u, g_nu, new, counts,
            U: float) -> dict:
    """The compared numbers of one judged unit: ``prog`` the program's
    output, the rest the reference's (`reference.adjoint.reverse_step`)."""
    D = g_u.shape[0]
    g = rsolver.iv(prog["g_u"].to(g_u.device, g_u.dtype), D)
    r = rsolver.iv(g_u, D)
    out = {f"dg_{tag}": float(torch.max(torch.abs(g - r))
                              / torch.max(torch.abs(r))),
           f"eg_{tag}": _rms(g - r) / _rms(r),
           f"dnu_{tag}": abs(prog["g_nu"] - float(g_nu)) / abs(float(g_nu)),
           f"dloss_{tag}": abs(prog["loss"] - float(loss)) / abs(float(loss)),
           f"dna_{tag}": float(sum(abs(a - b) for a, b in
                                   zip(prog["adj"], counts[2:])))}
    out.update(check.numbers(tag, prog, new, counts[:2], U, False))
    return out


def judge(kept, setup, cfg, mix, ulam, dtype, device):
    ref = check.Reference(setup, cfg, False, ulam, dtype, device)
    zero = torch.zeros((), dtype=dtype, device=device)
    V, m0, m1 = ref.fields(zero)
    levels = rsolver.build_levels(m0, ref.cfg.perdir)

    def unit(u, p, dt, t):
        st = rsolver.State(u=u, p=p, V=V, mu0=m0, mu1=m1, dt=dt, t=t)
        return radjoint.reverse_step(ref.cfg, levels, st)

    u = rsolver.init_velocity(ulam, ref.S, ref.cfg.U, ref.cfg.perdir,
                              dtype, device)
    got = unit(u, torch.zeros(ref.S, dtype=dtype, device=device),
               torch.tensor(kept["dt0"], dtype=dtype, device=device), zero)
    nums = numbers("first", kept["first"], *got, setup["U"])
    del got, u
    got = unit(*kept.pop("state"))
    nums.update(numbers("last", kept["last"], *got, setup["U"]))
    return nums
