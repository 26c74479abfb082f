"""Flow past a sphere (WaterLily README.md:118-125): uniform inflow ``U``
along x on a box of ``dims`` interior cells, a sphere of ``radius`` cells
at ``center``, ``Re = U * 2 * radius / nu``.  A traffic mix's ``motion``
translates the sphere along one axis as ``A * sin(2 pi f t)``.

The closures are point-wise (``x`` of shape ``(..., D)``): the program
measures them under `torch.func.vmap`, the plain reference on the same
points.
"""
from __future__ import annotations

import math

import torch


def setup(cfg: dict, motion) -> dict:
    """The simulation's arguments and its body's ``(sdf, map)``."""
    U, r = float(cfg["U"]), float(cfg["radius"])
    center = torch.tensor([float(c) for c in cfg["center"]])
    D = len(cfg["dims"])

    def sdf(x, t):
        return torch.sqrt(torch.sum(x * x, dim=-1)) - r

    def map(x, t):
        c = center.to(x.device, x.dtype)
        if not motion:
            return x - c
        amp = float(motion["amp_radii"]) * r
        f = float(motion["St"]) * U / (2 * amp)
        y = amp * torch.sin(2 * math.pi * f * t)
        axis = int(motion["axis"])
        shift = torch.stack([c[d] + y if d == axis else c[d] + 0 * y
                             for d in range(D)])
        return x - shift.to(x.dtype)

    def base(i, x):
        return torch.full_like(x[..., 0], U if i == 0 else 0.0)

    return {"dims": tuple(cfg["dims"]), "u_BC": (U,) + (0.0,) * (D - 1),
            "L": 2 * r, "U": U, "nu": U * 2 * r / float(cfg["Re"]),
            "perdir": (), "body": (sdf, map), "base": base}
