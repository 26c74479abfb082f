"""Derived flow fields and body forces.

PyTorch counterpart of `waterlily_tpu.metrics` (reference src/Metrics.jl):
the kinetic energy, the velocity-gradient and rate-of-strain tensors, the
BDIM surface normal field and the pressure, viscous and total body forces
with ``sampling="center"`` (the reference's semantics).  Each is a
whole-array expression on the device of its input; a force is a (D,)
tensor reduced on that device.  ``sampling="surface"``/``"extrap"`` need
`grid.interp` and `lambda2`, `curl`, `omega*` and `pressure_moment` are not
ported yet (ROADMAP A14).
"""
from __future__ import annotations

import torch

from .body import _chunked_vmap, kern, measure
from .grid import interior, interior_view, loc_grid, shift

__all__ = ["ke", "grad_tensor", "strain_rate", "nds", "pressure_force",
           "viscous_force", "total_force"]


def ke(u, U=None):
    """Cell-centred kinetic energy ``½‖u-U‖²`` (reference `ke`,
    Metrics.jl:19-21): ``0.125·Σᵢ(uᵢ[I]+uᵢ[I+δᵢ]-2Uᵢ)²`` on the interior,
    zero ghosts."""
    D = u.shape[0]
    s = torch.zeros(u.shape[1:], dtype=u.dtype, device=u.device)
    for i in range(D):
        Ui = 0.0 if U is None else U[i]
        s = s + (u[i] + shift(u[i], i, +1) - 2.0 * Ui) ** 2
    out = torch.zeros_like(s)
    out[interior(D)] = 0.125 * s[interior(D)]
    return out


def _dudx(i, j, u):
    """∂uᵢ/∂xⱼ at cell centres (reference `∂(i,j,I,u)`, Metrics.jl:28-30):
    the compact staggered difference inline, the 4-point average across."""
    if i == j:
        return shift(u[i], i, +1) - u[i]
    return (shift(u[i], j, +1) + shift(shift(u[i], j, +1), i, +1)
            - shift(u[i], j, -1) - shift(shift(u[i], j, -1), i, +1)) / 4.0


def grad_tensor(u):
    """Velocity gradient ∂uᵢ/∂xⱼ as a (D, D, *S) field."""
    D = u.shape[0]
    return torch.stack([torch.stack([_dudx(i, j, u) for j in range(D)])
                        for i in range(D)])


def strain_rate(u):
    """Rate-of-strain tensor ``∂ᵢuⱼ+∂ⱼuᵢ`` (reference `∇²u`,
    Metrics.jl:107-108)."""
    g = grad_tensor(u)
    return g + g.transpose(0, 1)


def _band_measure(body, S, t, dtype, device):
    """Kernel weight ``w`` and outward normal ``n`` of every cell centre,
    flat ``(Ncells,)`` and ``(Ncells, D)``.  `body.measure` leaves the
    normal 0 outside ``d² = 1``, where ``kern(±1) = 0`` anyway."""
    D = len(S)
    pts = loc_grid(S, None, dtype, device).reshape(-1, D)
    t_ = torch.as_tensor(t, dtype=dtype, device=device)
    d, n, _ = _chunked_vmap(lambda x: measure(body, x, t_, 1.0), pts)
    w = kern(torch.clamp(d, -1, 1))
    return w, n


def nds(body, S, t=0.0, dtype=torch.float32, device=None):
    """BDIM-masked surface normal field ``n̂·kern(clamp(d,-1,1))`` at cell
    centres (reference `nds`, Metrics.jl:84-87), shape (D, *S)."""
    D = len(S)
    w, n = _band_measure(body, tuple(S), t, dtype, device)
    return torch.movedim((n * w[:, None]).reshape(tuple(S) + (D,)), -1,
                         0).to(dtype)


def _center_only(sampling):
    if sampling != "center":
        raise NotImplementedError(
            f"sampling={sampling!r} needs grid.interp, which is not ported "
            "yet (ROADMAP A14); sampling='center' is the reference's")


def pressure_force(p, body, t=0.0, sampling="center"):
    """Σ p·n̂ ds over the body surface (reference Metrics.jl:94-100), the
    integrand at the band-cell centres."""
    _center_only(sampling)
    S = tuple(p.shape)
    D = len(S)
    nd = nds(body, S, t, p.dtype, p.device)
    return torch.stack([torch.sum(interior_view(p * nd[i], D))
                        for i in range(D)])


def viscous_force(u, nu, body, t=0.0, sampling="center"):
    """Σ -ν(∇u+∇uᵀ)·n̂ ds over the surface (reference Metrics.jl:114-120),
    the strain rate at the band-cell centres."""
    _center_only(sampling)
    D = u.shape[0]
    S = tuple(u.shape[1:])
    sr = strain_rate(u)
    nd = nds(body, S, t, u.dtype, u.device)
    out = []
    for i in range(D):
        tot = torch.zeros(S, dtype=u.dtype, device=u.device)
        for j in range(D):
            tot = tot + sr[i, j] * nd[j]
        out.append(-nu * torch.sum(interior_view(tot, D)))
    return torch.stack(out)


def total_force(u, p, nu, body, t=0.0, sampling="center"):
    """Pressure plus viscous force (reference Metrics.jl:127); the drag
    and lift coefficients are ``2·force / (U²·L)``."""
    return (pressure_force(p, body, t, sampling=sampling)
            + viscous_force(u, nu, body, t, sampling=sampling))
