"""Canonical simulation cases, with sdf closures written in torch ops.

Counterpart of `waterlily_tpu.models.cases`; each constructor returns a
ready-to-run `Simulation` on the ``device`` it is given.
"""
from __future__ import annotations

import torch

from ..body import AutoBody
from ..simulation import Simulation

__all__ = ["sphere_3d"]


def _norm2(x):
    return torch.sqrt(torch.sum(x * x))


def sphere_3d(n=96, m=64, Re=100, U=1, dtype=torch.float32, *, device, **kw):
    """Flow past a 3D sphere (reference README.md:118-125).

    ``sphere_3d(3*2**5, 2**6)`` is the reference's 1.3M-DOF GPU benchmark
    configuration, a (96, 64, 64) grid."""
    radius, center = m / 8, m / 2 - 1
    body = AutoBody(lambda x, t: _norm2(x - center) - radius)
    return Simulation((n, m, m), (U, 0, 0), 2 * radius,
                      nu=U * 2 * radius / Re, body=body, dtype=dtype,
                      device=device, **kw)
