"""Plain reference of WaterLily's BDIM measurement (Body.jl measure!,
AutoBody.jl): the body velocity ``V`` and the kernel moments ``μ₀``,
``μ₁`` of an implicit body given by point-wise ``sdf(x, t)`` and
``map(x, t)`` closures.

At each face of a cell whose centre lies in the band ``d² < (2+ε)²`` the
distance, the normal (``∇sdf``) and the velocity ``-J⁻¹ ∂map/∂t`` come from
`torch.func` autodiff; a face whose own raw distance lies outside the band
keeps its raw distance with no normal and no velocity; every other cell
takes the far-field constants (``μ₀ = 1``, 0 deep inside the body).
"""
from __future__ import annotations

import math

import torch

from .solver import bc_vector, face_points, pad, iv

__all__ = ["measure", "d_center"]

CHUNK = 1 << 20


def _kern0(d):
    return 0.5 + 0.5 * d + 0.5 * torch.sin(math.pi * d) / math.pi


def _kern1(d):
    return (0.25 * (1 - d * d)
            - 0.5 * (d * torch.sin(math.pi * d)
                     + (1 + torch.cos(math.pi * d)) / math.pi) / math.pi)


def _mu0(d, eps):
    return _kern0(torch.clamp(d / eps, -1, 1))


def _mu1(d, eps):
    return eps * _kern1(torch.clamp(d / eps, -1, 1))


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _solve(J, b):
    """J v = b for D = 2, 3 by cofactors (NaN where J is singular)."""
    nan = torch.full_like(b[0], math.nan)
    if b.shape[-1] == 2:
        det = J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
        det = torch.where(det == 0, nan, det)
        return torch.stack([(b[0] * J[1, 1] - b[1] * J[0, 1]) / det,
                            (J[0, 0] * b[1] - J[1, 0] * b[0]) / det])
    c0 = _cross(J[:, 1], J[:, 2])
    det = torch.sum(J[:, 0] * c0)
    det = torch.where(det == 0, nan, det)
    return torch.stack([torch.sum(b * c0) / det,
                        torch.sum(b * _cross(J[:, 2], J[:, 0])) / det,
                        torch.sum(b * _cross(J[:, 0], J[:, 1])) / det])


def _point(sdf, map, x, t, fastd2):
    """``(d, n, V)`` at one point."""
    f = lambda y, tt: sdf(map(y, tt), tt)
    d_raw = f(x, t)
    n = torch.func.grad(lambda y: f(y, t))(x)
    isnan = torch.any(torch.isnan(n))
    n = torch.where(torch.isnan(n), 0.0, n)
    m = torch.sqrt(torch.sum(n * n))
    m = torch.where(m == 0, 1.0, m)
    J = torch.func.jacfwd(lambda y: map(y, t))(x)
    _, mdot = torch.func.jvp(lambda tt: map(x, tt), (t,), (torch.ones_like(t),))
    V = -_solve(J, mdot.to(x.dtype))
    V = torch.where(torch.isnan(V), 0.0, V)
    zero = torch.zeros_like(x)
    d = torch.where(isnan, d_raw, d_raw / m)
    n = torch.where(isnan, zero, n / m)
    V = torch.where(isnan, zero, V)
    fast = d_raw * d_raw > fastd2
    return (torch.where(fast, d_raw, d), torch.where(fast, zero, n),
            torch.where(fast, zero, V))


def _vmapped(fn, pts):
    outs = [torch.func.vmap(fn)(pts[i:i + CHUNK])
            for i in range(0, pts.shape[0], CHUNK)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def d_center(sdf, map, S, t, dtype, device):
    """The distance at every cell centre."""
    pts = face_points(S, None, dtype, device).reshape(-1, len(S))
    return _vmapped(lambda x: sdf(map(x, t), t), pts).reshape(S).to(dtype)


def measure(sdf, map, S, t, eps, perdir, dtype, device):
    """``(V, μ₀, μ₁)`` on the whole padded grid at time ``t`` (a 0-d
    tensor), vector BCs applied; ``sdf=None`` is no body."""
    D = len(S)
    if sdf is None:
        V = torch.zeros((D,) + S, dtype=dtype, device=device)
        m0 = bc_vector(torch.ones((D,) + S, dtype=dtype, device=device),
                       (0.0,) * D, perdir)
        return V, m0, torch.zeros((D, D) + S, dtype=dtype, device=device)
    t = torch.as_tensor(t, dtype=dtype, device=device)
    dc = d_center(sdf, map, S, t, dtype, device)
    fastd2 = (2.0 + eps) ** 2
    near = dc * dc < fastd2
    idx = torch.nonzero(near.reshape(-1)).squeeze(1)
    V = torch.zeros((D,) + S, dtype=dtype, device=device)
    m0 = torch.where(dc < 0, 0.0, 1.0).to(dtype).expand((D,) + S).clone()
    m1 = torch.zeros((D, D) + S, dtype=dtype, device=device)
    for i in range(D):
        pts = face_points(S, i, dtype, device).reshape(-1, D)[idx]
        d, n, Vi = _vmapped(lambda x: _point(sdf, map, x, t, fastd2), pts)
        d, n, Vi = d.to(dtype), n.to(dtype), Vi.to(dtype)
        m0[i].view(-1)[idx] = _mu0(d, eps)
        V[i].view(-1)[idx] = Vi[:, i]
        w = _mu1(d, eps)
        for j in range(D):
            m1[i, j].view(-1)[idx] = w * n[:, j]
    m1 = pad(iv(m1, D), lead=2)
    V = pad(iv(V, D), lead=1)
    m0 = bc_vector(m0, (0.0,) * D, perdir)
    V = bc_vector(V, (0.0,) * D, perdir)
    return V, m0, m1
