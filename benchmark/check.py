"""The plain reference of the ``step`` entry and the numbers it compares.

`Reference` steps a cell's flow from a state it is handed, or from its
own initial state, with no object of the program; `numbers` compares one
judged step of the program with it.  Which steps are judged, and from
which state the reference follows, is the entry's (`entries/step.py`).

Numbers (velocities in units of ``U``, pressure of ``U²``):
``du`` = max |u - u_ref|, ``dp`` = max |p - p_ref|, ``eu`` and ``ep``
the root mean square of ``u - u_ref`` and ``p - p_ref`` over the grid
(rounding moves a few cells, a lower precision every cell), ``ddt`` = |dt -
dt_ref| / dt_ref, ``dn`` = the two solves' iteration counts' summed
difference; where the body is measured in the step, also ``dV``,
``dmu0``, ``dmu1`` (max abs).  A number that a cell's limit file names is
compared with its limit; the others are printed as diagnostics.
"""
from __future__ import annotations

import torch

from .reference import measure as rmeasure
from .reference import solver as rsolver

__all__ = ["Reference", "numbers"]


class Reference:
    """The plain reference of one cell: its configuration and geometry,
    with no object of the program."""

    def __init__(self, setup: dict, cfg: dict, remeasure: bool, ulam,
                 dtype, device):
        self.setup, self.remeasure = setup, remeasure
        self.S = tuple(n + 2 for n in setup["dims"])
        self.cfg = rsolver.Config(S=self.S, nu=setup["nu"],
                                  U=tuple(setup["u_BC"]),
                                  perdir=tuple(setup["perdir"]),
                                  tol=float(cfg["tol"]),
                                  itmx=int(cfg["itmx"]))
        self.eps = float(cfg["epsilon"])
        self.ulam, self.dtype, self.device = ulam, dtype, device
        self._fixed = None

    def fields(self, t):
        """``(V, μ₀, μ₁)`` at time ``t`` (a fixed body's once)."""
        body = self.setup["body"]
        sdf, map = body if body is not None else (None, None)
        if self.remeasure or self._fixed is None:
            got = rmeasure.measure(sdf, map, self.S, t, self.eps,
                                   self.cfg.perdir, self.dtype, self.device)
            if self.remeasure:
                return got
            self._fixed = got
        return self._fixed

    def step(self, u, p, dt, t):
        """One reference step from ``(u, p, dt, t)``: the state, the
        fields it stepped with and the iteration counts."""
        t_meas = t + dt if self.remeasure else torch.zeros_like(t)
        V, m0, m1 = self.fields(t_meas)
        levels = rsolver.build_levels(m0, self.cfg.perdir)
        st = rsolver.State(u=u, p=p, V=V, mu0=m0, mu1=m1, dt=dt, t=t)
        new, n = rsolver.mom_step(self.cfg, levels, st)
        return new, n

    def first(self, dt0: float):
        """The reference's own initial state, stepped once."""
        u = rsolver.init_velocity(self.ulam, self.S, self.cfg.U,
                                  self.cfg.perdir, self.dtype, self.device)
        p = torch.zeros(self.S, dtype=self.dtype, device=self.device)
        dt = torch.tensor(dt0, dtype=self.dtype, device=self.device)
        t = torch.zeros((), dtype=self.dtype, device=self.device)
        return self.step(u, p, dt, t)


def _max(a, b) -> float:
    return float(torch.max(torch.abs(a.to(b.device, b.dtype) - b)))


def _rms(a, b) -> float:
    d = a.to(b.device, torch.float64) - b.to(torch.float64)
    return float(torch.sqrt(torch.mean(d * d)))


def numbers(tag: str, prog: dict, ref, n_ref, U: float,
            with_fields: bool) -> dict:
    """The compared numbers of one judged step: ``prog`` the program's
    output (``u``, ``p``, ``dt``, ``pois``, and with ``with_fields``
    ``V``, ``mu0``, ``mu1``), ``ref`` the reference's state and ``n_ref``
    its counts."""
    out = {f"du_{tag}": _max(prog["u"], ref.u) / U,
           f"dp_{tag}": _max(prog["p"], ref.p) / (U * U),
           f"eu_{tag}": _rms(prog["u"], ref.u) / U,
           f"ep_{tag}": _rms(prog["p"], ref.p) / (U * U),
           f"ddt_{tag}": abs(float(prog["dt"]) - float(ref.dt))
           / float(ref.dt),
           f"dn_{tag}": float(sum(abs(a - b) for a, b in
                                  zip(prog["pois"], n_ref)))}
    if with_fields:
        out[f"dV_{tag}"] = _max(prog["V"], ref.V) / U
        out[f"dmu0_{tag}"] = _max(prog["mu0"], ref.mu0)
        out[f"dmu1_{tag}"] = _max(prog["mu1"], ref.mu1)
    return out
