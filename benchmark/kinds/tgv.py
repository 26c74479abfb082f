"""The 3D Taylor-Green vortex: a fully periodic cube of ``dims`` cells, no
body, ``u = (sin x cos y cos z, -cos x sin y cos z, 0)`` in units of
``kappa = 2 pi / L``, ``Re = 1 / (kappa nu)`` (``U = 1``).

The initial field is point-wise (``x`` of shape ``(..., D)``), so the
program evaluates it under `torch.func.vmap` and the reference on the
whole grid.
"""
from __future__ import annotations

import math

import torch


def setup(cfg: dict, motion) -> dict:
    if motion:
        raise ValueError("the Taylor-Green vortex has no body to move")
    L = float(cfg["dims"][0])
    kappa = 2 * math.pi / L

    def base(i, x):
        xs, ys, zs = (x[..., d] * kappa for d in range(3))
        if i == 0:
            return torch.sin(xs) * torch.cos(ys) * torch.cos(zs)
        if i == 1:
            return -torch.cos(xs) * torch.sin(ys) * torch.cos(zs)
        return torch.zeros_like(xs)

    return {"dims": tuple(cfg["dims"]), "u_BC": (0.0, 0.0, 0.0), "L": L,
            "U": 1.0, "nu": 1 / (kappa * float(cfg["Re"])),
            "perdir": (0, 1, 2), "body": None, "base": base}
