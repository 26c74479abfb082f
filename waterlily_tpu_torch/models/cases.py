"""Canonical simulation cases, with sdf, map and initial-velocity closures
written in torch ops.

Counterpart of `waterlily_tpu.models.cases`, with the same arguments and
defaults; each constructor returns a ready-to-run `Simulation` on
``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import math

import torch

from ..body import AutoBody
from ..simulation import Simulation

__all__ = ["circle_2d", "tgv_2d", "tgv_3d", "sphere_3d", "donut_3d",
           "oscillating_plate_2d", "heaving_sphere_3d"]


def _norm2(x):
    return torch.sqrt(torch.sum(x * x))


def circle_2d(n=96, m=64, Re=100, U=1, dtype=torch.float32, device="cuda",
              **kw):
    """Flow past a 2D circle (reference README.md:41-51); ``circle_2d(96,
    64)`` is the reference's own 2D benchmark grid."""
    radius, center = m / 8, m / 2 - 1
    body = AutoBody(lambda x, t: _norm2(x - center) - radius)
    return Simulation((n, m), (U, 0), 2 * radius, nu=U * 2 * radius / Re,
                      body=body, dtype=dtype, device=device, **kw)


def tgv_2d(L=64, Re=1e5, dtype=torch.float32, device="cuda", **kw):
    """2D Taylor-Green vortex, fully periodic (reference
    maintests.jl:232-243)."""
    kappa = 2 * math.pi / L
    nu = 1 / (kappa * Re)

    def ulam(i, x):
        xs, ys = x[0] * kappa, x[1] * kappa
        if i == 0:
            return -torch.sin(xs) * torch.cos(ys)
        return torch.cos(xs) * torch.sin(ys)

    return Simulation((L, L), (0, 0), L, U=1, nu=nu, perdir=(0, 1),
                      ulam=ulam, dtype=dtype, device=device, **kw)


def tgv_3d(L=32, Re=1600, dtype=torch.float32, device="cuda", **kw):
    """3D Taylor-Green vortex, fully periodic: the transition-to-turbulence
    benchmark; ``tgv_3d(256)`` is the 256³ periodic configuration."""
    kappa = 2 * math.pi / L
    nu = 1 / (kappa * Re)

    def ulam(i, x):
        xs, ys, zs = x[0] * kappa, x[1] * kappa, x[2] * kappa
        if i == 0:
            return torch.sin(xs) * torch.cos(ys) * torch.cos(zs)
        if i == 1:
            return -torch.cos(xs) * torch.sin(ys) * torch.cos(zs)
        return torch.zeros_like(xs)

    return Simulation((L, L, L), (0, 0, 0), L, U=1, nu=nu, perdir=(0, 1, 2),
                      ulam=ulam, dtype=dtype, device=device, **kw)


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


def donut_3d(n=64, Re=1e3, U=1, dtype=torch.float32, device="cuda", **kw):
    """Flow through a 3D torus (WaterLily-Examples donut) on a (2n, n, n)
    grid."""
    center, R, r = n / 2 - 1, n / 4, n / 16

    def sdf(x, t):
        y = x - center
        q = torch.sqrt(y[1] ** 2 + y[2] ** 2) - R
        return torch.sqrt(q ** 2 + y[0] ** 2) - r

    return Simulation((2 * n, n, n), (U, 0, 0), R, nu=U * R / Re,
                      body=AutoBody(sdf), dtype=dtype, device=device, **kw)


def oscillating_plate_2d(L=32, amp=None, St=0.3, Re=250, U=1,
                         dtype=torch.float32, device="cuda", **kw):
    """Heaving flat plate: the 2D moving-body case, re-measured every step
    on a (4L, 4L) grid."""
    amp = L / 2 if amp is None else amp
    f = St * U / (2 * amp)

    def sdf(x, t):
        c = torch.clamp(x[0], -L / 2 + 2, L / 2 - 2)
        return _norm2(x - torch.stack([c, torch.zeros_like(c)])) - 2

    def map(x, t):
        y = amp * torch.sin(2 * math.pi * f * t)
        return x - torch.stack([torch.full_like(y, 2 * L),
                                2 * L + y]).to(x.dtype)

    body = AutoBody(sdf, map)
    return Simulation((4 * L, 4 * L), (U, 0), L, nu=U * L / Re, body=body,
                      dtype=dtype, device=device, **kw)
