"""Canonical simulation cases, with sdf closures written in torch ops.

Counterpart of `waterlily_tpu.models.cases`; each constructor returns a
ready-to-run `Simulation` on ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import math

import torch

from ..body import AutoBody
from ..simulation import Simulation

__all__ = ["sphere_3d", "heaving_sphere_3d"]


def _norm2(x):
    return torch.sqrt(torch.sum(x * x))


def sphere_3d(n=96, m=64, Re=100, U=1, dtype=torch.float32, device="cuda",
              **kw):
    """Flow past a 3D sphere (reference README.md:118-125).

    ``sphere_3d(3*2**5, 2**6)`` is the reference's 1.3M-DOF GPU benchmark
    configuration, a (96, 64, 64) grid."""
    radius, center = m / 8, m / 2 - 1
    body = AutoBody(lambda x, t: _norm2(x - center) - radius)
    return Simulation((n, m, m), (U, 0, 0), 2 * radius,
                      nu=U * 2 * radius / Re, body=body, dtype=dtype,
                      device=device, **kw)


def heaving_sphere_3d(radius=8, amp=None, St=0.3, Re=250, U=1,
                      dtype=torch.float32, device="cuda", **kw):
    """Heaving sphere: a moving body on a (4·radius)³ grid, re-measured
    every step through a time-dependent map.  ``radius=64`` is the 256³
    moving-body configuration."""
    amp = radius if amp is None else amp
    f = St * U / (2 * amp)
    center = 2 * radius

    def sdf(x, t):
        return _norm2(x) - radius

    def map(x, t):
        y = amp * torch.sin(2 * math.pi * f * t)
        c = torch.full_like(y, center)
        return x - torch.stack([c, c + y, c]).to(x.dtype)

    body = AutoBody(sdf, map)
    return Simulation((4 * radius, 4 * radius, 4 * radius), (U, 0, 0),
                      2 * radius, nu=U * 2 * radius / Re, body=body,
                      dtype=dtype, device=device, **kw)
