"""The one generator of the benchmark's traffic mixes.

A mix is a JSON file under ``traffic/`` of parameters, which this module
reads:

- ``remeasure``: measure the body again before every step (a moving body);
- ``motion``: null for a fixed body, or ``{"axis", "amp_radii", "St"}``,
  the body moved along ``axis`` by ``A sin(2 pi f t)`` with ``A =
  amp_radii * radius`` and ``f = St * U / (2 A)``;
- ``perturb``: ``{"amp", "modes", "kmax"}``, the seeded disturbance of the
  initial velocity: ``modes`` Fourier modes a component, integer
  wavenumbers 1..``kmax`` over the box along each axis, random phases,
  amplitudes uniform in ``[-amp, amp] * U / sqrt(modes)``;
- ``warmup_steps``: steps in set-up, which take the flow past its
  impulsive start;
- ``trace_skip``, ``trace_steps``: the steps of a traced window before the
  profiler starts, and the steps it records.

Every seed gets the same mix of sizes and work; the seed draws only the
disturbance, on the device, and the same tensor-valued closure is handed
to the program and to the reference.
"""
from __future__ import annotations

import math

import torch

__all__ = ["perturbation", "initial_velocity"]


def perturbation(mix: dict, seed: int, dims: tuple, device, dtype):
    """``pert(i, x)``: the seeded disturbance of component ``i`` at points
    ``x`` of shape ``(..., D)``."""
    p = mix["perturb"]
    M, kmax, amp = int(p["modes"]), int(p["kmax"]), float(p["amp"])
    D = len(dims)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    k = torch.randint(1, kmax + 1, (M, D), generator=g, device=device)
    k = k.to(dtype) * torch.tensor([2 * math.pi / n for n in dims],
                                   dtype=dtype, device=device)
    phase = torch.rand((M, D), generator=g, device=device,
                       dtype=dtype) * (2 * math.pi)
    a = (torch.rand((M, D), generator=g, device=device, dtype=dtype) * 2
         - 1) * (amp / math.sqrt(M))

    def pert(i, x):
        ph = torch.sum(x[..., None, :] * k, dim=-1) + phase[:, i]
        return torch.sum(a[:, i] * torch.sin(ph), dim=-1)
    return pert


def initial_velocity(base, pert, U: float):
    """``ulam(i, x)``: the configuration's initial field plus ``U`` times
    the disturbance."""
    return lambda i, x: base(i, x) + U * pert(i, x)
