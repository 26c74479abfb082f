"""The timed entry ``step``: one `Simulation.step`, the entry of every
configuration that names none.

An entry is a module ``entries/<name>.py``, named by a configuration's
``"entry"`` key.  It owns everything of a run that touches the program:
its construction, its unit of work and the judgement of that work.  The
harness keeps the rest: the clock, the closed loop, the traced sessions,
the peak memory, the metric readers and the limits.  An entry provides two
functions.

``build(setup, cfg, mix, ulam, dtype, device, options)``
    The cell's program on ``device``.  ``setup`` is the kind's
    (``kinds/<kind>.py``), ``ulam`` the seeded initial velocity and
    ``options`` extra arguments of the program (a control run's lower
    precision), passed on unchanged.  The harness has loaded the kernel
    library before, and times this call, ended by a synchronise, as
    ``construct_s``.  It returns an object with:

    ``cells``
        the interior cells one unit advances, which ``mlups`` multiplies
        by the units of the window: the grid's cells for one step, the
        members times the cells for an ensemble;
    ``advance()``
        one timed unit, ending in its own host read; set-up's first call
        is its first unit;
    ``counts``
        the solver's iteration counts of every unit so far, one entry a
        unit, or None where the entry has none (``pois_iters`` and the
        per-iteration metrics are then left out);
    ``failed()``
        how many units so far gave a result that is not finite;
    ``finish()``
        after the window: one more unit, judged.  It returns what
        ``judge`` reads, the host copies of the judged units' outputs and
        the state the reference follows from, and the program holds none
        of it.

``judge(kept, setup, cfg, mix, ulam, dtype, device)``
    The compared numbers of ``kept`` (name to float), worked out by the
    entry's plain reference once the harness has dropped the program and
    emptied the device's cache.  A number that ``limits/<cell>.json``
    names is held to its limit; the others are printed as diagnostics.

This entry judges two steps of `Simulation.step`, the window's own call
at the cell's size.  The trajectory is chaotic and hundreds of steps
long, so the reference (`check.Reference`) follows the program step by
step from the program's state, as a served model's reference reads the
served tokens:

- ``first``: the first step of set-up, from the initial state.  The
  reference builds that state itself from the configuration and the seed
  (the disturbed initial velocity, the body measured at its own time) and
  steps it; this checks construction, which following the program skips.
- ``last``: one more step after the window closes, from the program's
  state at the close.  The reference takes only the velocity, pressure,
  time step and time from the program; it measures the body again itself
  (at the step's time, where the mix remeasures), builds its own
  multigrid levels and steps.

`check.numbers` says which numbers each judged step gives.
"""
from __future__ import annotations

import math

from benchmark import check
from waterlily_tpu_torch.body import AutoBody
from waterlily_tpu_torch.simulation import Simulation


def _host(flow, pois) -> dict:
    """The judged outputs of one program step, copied off the device."""
    return {"u": flow.u.detach().cpu(), "p": flow.p.detach().cpu(),
            "dt": float(flow.dt), "pois": list(pois)}


class _Steps:
    """`Simulation.step` as the timed unit; the mix's ``remeasure``
    measures the body again before each step."""

    def __init__(self, sim, remeasure: bool, cells: int):
        self.sim, self.remeasure, self.cells = sim, remeasure, cells
        self.kept = {}

    @property
    def counts(self):
        return self.sim.pois_n

    def advance(self):
        if self.kept:
            self.sim.step(self.remeasure)
            return
        # the first step, judged from the initial dt
        self.kept["dt0"] = float(self.sim.flow.dt)
        self.sim.step(self.remeasure)
        self.kept["first"] = _host(self.sim.flow, self.sim.pois_n[-1])

    def failed(self) -> int:
        return sum(1 for d in self.sim.dts if not math.isfinite(d))

    def finish(self) -> dict:
        sim = self.sim
        before = sim.flow
        sim.step(self.remeasure)
        last = _host(sim.flow, sim.pois_n[-1])
        if self.remeasure:
            last.update(V=sim.flow.V.detach().cpu(),
                        mu0=sim.flow.mu0.detach().cpu(),
                        mu1=sim.flow.mu1.detach().cpu())
        kept, self.kept = self.kept, {}
        kept.update(last=last, state=(
            before.u.detach(), before.p.detach(), before.dt.detach(),
            before.t.detach()))
        return kept


def build(setup, cfg, mix, ulam, dtype, device, options):
    body = setup["body"]
    sim = Simulation(
        setup["dims"], setup["u_BC"], setup["L"], U=setup["U"],
        nu=setup["nu"], perdir=setup["perdir"], ulam=ulam,
        body=None if body is None else AutoBody(*body),
        epsilon=float(cfg["epsilon"]), tol=float(cfg["tol"]),
        itmx=int(cfg["itmx"]), dtype=dtype, device=device,
        **(options or {}))
    return _Steps(sim, bool(mix["remeasure"]), math.prod(setup["dims"]))


def judge(kept, setup, cfg, mix, ulam, dtype, device):
    remeasure = bool(mix["remeasure"])
    ref = check.Reference(setup, cfg, remeasure, ulam, dtype, device)
    r1, n1 = ref.first(kept["dt0"])
    nums = check.numbers("first", kept["first"], r1, n1, setup["U"], False)
    del r1
    rN, nN = ref.step(*kept.pop("state"))
    nums.update(check.numbers("last", kept["last"], rN, nN, setup["U"],
                              remeasure))
    return nums
