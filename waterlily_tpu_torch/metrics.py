"""Derived flow fields and body forces and moments.

PyTorch counterpart of `waterlily_tpu.metrics` (reference src/Metrics.jl):
the kinetic energy, the velocity-gradient and rate-of-strain tensors, the
λ₂ vortex criterion, the vorticity (edge `curl`, centre `omega` and its
magnitude and azimuthal part), the BDIM surface normal field and the
pressure, viscous and total body forces and the pressure moment.  Each is
a whole-array expression on the device of its input; a force is a (D,)
tensor reduced on that device.  The forces sample their integrand at the
band-cell centres (``sampling="center"``, the reference's semantics), at
the surface projection (``"surface"``) or extrapolated to the surface from
outside the band (``"extrap"``), through `grid.interp` at the band cells.
"""
from __future__ import annotations

import math

import torch

from .body import _chunked_vmap, kern, measure, sdf
from .grid import interior, interior_view, loc_grid, shift, interp
from .ops.stencil_kernels import vmapped

__all__ = ["ke", "grad_tensor", "strain_rate", "lambda2", "curl", "omega",
           "omega_mag", "omega_theta", "nds", "pressure_force",
           "viscous_force", "total_force", "pressure_moment"]


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


def _sym3_eigvals_mid(A):
    """Middle eigenvalue of a symmetric 3×3 matrix field ``A`` (3, 3, *S),
    in closed form (the trigonometric method).

    Where ``p³`` underflows (entries of ~1e-16 in f32: the weak gradients
    far from a body a few steps after the start) JAX's ``det(B)/(2p³)`` is
    0/0 and its λ₂ NaN; here that ratio is 0 (the three eigenvalues are
    ``q`` to within ``p`` there).  Everywhere else the result is JAX's."""
    q = (A[0, 0] + A[1, 1] + A[2, 2]) / 3.0
    B00, B11, B22 = A[0, 0] - q, A[1, 1] - q, A[2, 2] - q
    p2 = (B00 ** 2 + B11 ** 2 + B22 ** 2
          + 2.0 * (A[0, 1] ** 2 + A[0, 2] ** 2 + A[1, 2] ** 2))
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 0.0))
    psafe = torch.where(p == 0, 1.0, p)
    detB = (B00 * (B11 * B22 - A[1, 2] ** 2)
            - A[0, 1] * (A[0, 1] * B22 - A[1, 2] * A[0, 2])
            + A[0, 2] * (A[0, 1] * A[1, 2] - B11 * A[0, 2]))
    rr = torch.clamp(torch.nan_to_num(detB / (2.0 * psafe ** 3), nan=0.0),
                     -1.0, 1.0)
    phi = torch.arccos(rr) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return 3.0 * q - e1 - e3


def lambda2(u):
    """λ₂ vortex criterion (reference Metrics.jl:40-44): the middle
    eigenvalue of S²+Ω² from the velocity-gradient tensor, zero ghosts.
    3D only."""
    g = grad_tensor(u)
    S = 0.5 * (g + g.transpose(0, 1))
    O = 0.5 * (g - g.transpose(0, 1))
    M = (torch.einsum("ik...,kj...->ij...", S, S)
         + torch.einsum("ik...,kj...->ij...", O, O))
    out = _sym3_eigvals_mid(M)
    z = torch.zeros_like(out)
    z[interior(u.shape[0])] = out[interior(u.shape[0])]
    return z


def curl(i, u):
    """Edge vorticity component ``i`` (reference `curl`, Metrics.jl:54):
    ``ω_i = ∂ⱼu_k - ∂_k u_j`` from backward differences of the face
    velocities; in 2D only ``i=2`` (the z-component)."""
    D = u.shape[0]
    if D == 2:
        if i != 2:
            raise ValueError("2D vorticity is the z-component (i=2)")
        j, k = 0, 1
    else:
        j, k = (i + 1) % 3, (i + 2) % 3
    return (u[k] - shift(u[k], j, -1)) - (u[j] - shift(u[j], k, -1))


def omega(u):
    """Centre vorticity vector (reference `ω`, Metrics.jl:60) from the
    centre-gradient stencil, (3, *S)."""
    assert u.shape[0] == 3
    comps = []
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        comps.append(_dudx(k, j, u) - _dudx(j, k, u))
    return torch.stack(comps)


def omega_mag(u):
    """‖ω‖ at cell centres (reference Metrics.jl:66)."""
    w = omega(u)
    return torch.sqrt(torch.sum(w * w, dim=0))


def omega_theta(u, z_axis, center):
    """Azimuthal vorticity ω·θ̂ around the axis ``z_axis`` through
    ``center`` (reference Metrics.jl:73-77); 0 on the axis."""
    assert u.shape[0] == 3
    S = tuple(u.shape[1:])
    x = torch.movedim(loc_grid(S, None, u.dtype, u.device), -1, 0)
    view = (3,) + (1,) * len(S)
    z = torch.as_tensor(z_axis, dtype=u.dtype, device=u.device).reshape(view)
    c = torch.as_tensor(center, dtype=u.dtype, device=u.device).reshape(view)
    theta = torch.linalg.cross(z.expand_as(x), x - c, dim=0)
    n = torch.sqrt(torch.sum(theta * theta, dim=0))
    dot = torch.sum(theta * omega(u), dim=0)
    return torch.where(n <= torch.finfo(u.dtype).eps, 0.0,
                       dot / torch.where(n == 0, 1.0, n))


def _band_measure(body, S, t, dtype, device):
    """Kernel weight ``w``, outward normal ``n`` and surface projection
    ``xs = x - d·n̂`` of every cell centre, flat ``(Ncells,)``,
    ``(Ncells, D)``, ``(Ncells, D)``.

    `body.measure` (``fastd2=1``) returns ``(d, 0, 0)`` wherever ``d² > 1``,
    where ``kern(±1) = 0``; so only the cells with ``d² <= 1`` (one host
    read to find them) are measured with autodiff, the others keep the
    sdf of a cheap pass.  The result is the whole-grid measurement's.
    Under `torch.func.vmap` (an ensemble of bodies: the distances carry
    the member axis) the band differs by member and no host read can
    find it, so every cell is measured, as JAX measures."""
    D = len(S)
    pts = loc_grid(S, None, dtype, device).reshape(-1, D)
    t_ = torch.as_tensor(t, dtype=dtype, device=device)
    d = _chunked_vmap(lambda x: sdf(body, x, t_), pts).to(dtype)
    if vmapped(d):
        d, n, _ = _chunked_vmap(lambda x: measure(body, x, t_, 1.0), pts)
        d = d.to(dtype)
        w = kern(torch.clamp(d, -1, 1))
        return w, n, pts - d[:, None] * n
    n = torch.zeros_like(pts)
    near = torch.nonzero(~(d * d > 1.0)).reshape(-1)
    if near.numel():
        d[near], n[near], _ = _chunked_vmap(
            lambda x: measure(body, x, t_, 1.0), pts[near])
    w = kern(torch.clamp(d, -1, 1))
    return w, n, pts - d[:, None] * n


def nds(body, S, t=0.0, dtype=torch.float32, device="cuda"):
    """BDIM-masked surface normal field ``n̂·kern(clamp(d,-1,1))`` at cell
    centres (reference `nds`, Metrics.jl:84-87), shape (D, *S)."""
    D = len(S)
    w, n, _ = _band_measure(body, tuple(S), t, dtype, device)
    return torch.movedim((n * w[:, None]).reshape(tuple(S) + (D,)), -1,
                         0).to(dtype)


def _band_sampler(sampling, n, xs, w):
    """``(band, sample)``: the flat indices of the band cells (``w != 0``;
    every other cell adds an exact zero to a force) and a function that
    samples a cell-centred scalar field there per ``sampling``:
    ``"surface"`` interpolates at the surface projection ``xs``,
    ``"extrap"`` extrapolates linearly to the surface from probes one and
    two cells outside it along the normal (``2·f(xs+n̂) − f(xs+2n̂)``), so
    that no sample reads the BDIM-smeared band.  Under `torch.func.vmap`
    the band is every cell (its weight zero off the band)."""
    if sampling not in ("surface", "extrap"):
        raise ValueError(f"unknown sampling {sampling!r}")
    if vmapped(w):
        band = torch.arange(w.shape[0], device=w.device)
    else:
        band = torch.nonzero(w != 0).reshape(-1)
    nb, xb = n[band], xs[band]
    if sampling == "surface":
        return band, lambda f: interp(xb, f)
    return band, lambda f: 2.0 * interp(xb + nb, f) - interp(xb + 2.0 * nb, f)


def _scatter(vals, band, ncells):
    """A flat field of ``ncells`` zeros with ``vals`` at ``band``."""
    out = torch.zeros((ncells,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_put((band,), vals)


def pressure_force(p, body, t=0.0, sampling="center"):
    """Σ p·n̂ ds over the body surface (reference Metrics.jl:94-100), the
    integrand at the band-cell centres (``"center"``), at the surface
    projection ``x − d·n̂`` (``"surface"``) or extrapolated to the surface
    from probes ``+1h``/``+2h`` outside it (``"extrap"``, which assumes
    the body is at least 2 cells from the domain boundary: `grid.interp`
    wraps a probe below index 0 and clamps one past the end)."""
    S = tuple(p.shape)
    D = len(S)
    if sampling == "center":
        nd = nds(body, S, t, p.dtype, p.device)
        return torch.stack([torch.sum(interior_view(p * nd[i], D))
                            for i in range(D)])
    w, n, xs = _band_measure(body, S, t, p.dtype, p.device)
    band, sample = _band_sampler(sampling, n, xs, w)
    pw = _scatter(sample(p) * w[band], band, w.shape[0]).reshape(S)
    nd = torch.movedim(n.reshape(S + (D,)), -1, 0)
    return torch.stack([torch.sum(interior_view(pw * nd[i], D))
                        for i in range(D)])


def viscous_force(u, nu, body, t=0.0, sampling="center"):
    """Σ -ν(∇u+∇uᵀ)·n̂ ds over the surface (reference Metrics.jl:114-120),
    the strain rate sampled as in `pressure_force`."""
    D = u.shape[0]
    S = tuple(u.shape[1:])
    sr = strain_rate(u)
    if sampling == "center":
        nd = nds(body, S, t, u.dtype, u.device)
        out = []
        for i in range(D):
            tot = torch.zeros(S, dtype=u.dtype, device=u.device)
            for j in range(D):
                tot = tot + sr[i, j] * nd[j]
            out.append(-nu * torch.sum(interior_view(tot, D)))
        return torch.stack(out)
    w, n, xs = _band_measure(body, S, t, u.dtype, u.device)
    band, sample = _band_sampler(sampling, n, xs, w)
    srs = torch.stack([torch.stack([sample(sr[i, j]) for j in range(D)])
                       for i in range(D)])                  # (D, D, Nband)
    tot = torch.einsum("ijc,cj->ci", srs, n[band]) * w[band][:, None]
    totg = torch.movedim(_scatter(tot, band, w.shape[0]).reshape(S + (D,)),
                         -1, 0)
    return torch.stack([torch.sum(interior_view(-nu * totg[i], D))
                        for i in range(D)])


def total_force(u, p, nu, body, t=0.0, sampling="center"):
    """Pressure plus viscous force (reference Metrics.jl:127); the drag
    and lift coefficients are ``2·force / (U²·L)``."""
    return (pressure_force(p, body, t, sampling=sampling)
            + viscous_force(u, nu, body, t, sampling=sampling))


def pressure_moment(x0, p, body, t=0.0):
    """Pressure moment about ``x0`` (reference Metrics.jl:135-141): a 0-d
    tensor (the z-moment) in 2D, a 3-vector in 3D."""
    S = tuple(p.shape)
    D = len(S)
    nd = nds(body, S, t, p.dtype, p.device)
    x = torch.movedim(loc_grid(S, None, p.dtype, p.device), -1, 0)
    rel = x - torch.as_tensor(x0, dtype=p.dtype, device=p.device).reshape(
        (D,) + (1,) * D)
    if D == 2:
        return torch.sum(interior_view(p * (rel[0] * nd[1] - rel[1] * nd[0]),
                                       D))
    cr = torch.linalg.cross(rel, nd, dim=0)
    return torch.stack([torch.sum(interior_view(p * cr[i], D))
                        for i in range(D)])
