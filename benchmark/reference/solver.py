"""Plain reference of one WaterLily time step, in eager PyTorch.

A frozen, self-contained copy of the plain forms of the measured program's
dense single-device path (WaterLily src/Flow.jl, Poisson.jl,
MultiLevelPoisson.jl, util.jl): the QUICK convection-diffusion flux, the
dense BDIM blend, the domain boundary conditions, the projection with its
multigrid pressure solve (V-cycle, Jacobi pre-smoother, PCG smoother,
adaptive stopping test ``r·r < tol``) and the CFL time step.  No kernel, no
window, no dispatch: every operation is a whole-array tensor expression, so
it runs on any device and in any float dtype.

Conventions: a scalar field has the ghost-padded shape ``S = N + 2``, a
vector field ``(D, *S)``; the centre of cell ``I`` sits at ``I - 0.5``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

__all__ = ["Config", "State", "Level", "init_velocity", "build_levels",
           "mom_step", "conv_diff", "bc_vector", "ml_solve", "cfl"]


@dataclass(frozen=True)
class Config:
    """What a step needs besides the state."""
    S: tuple                 # ghost-padded shape
    nu: float
    U: tuple                 # domain boundary velocity (constant)
    perdir: tuple = ()
    tol: float = 1e-4
    itmx: int = 32


@dataclass(frozen=True)
class State:
    u: torch.Tensor          # (D, *S)
    p: torch.Tensor          # (*S)
    V: torch.Tensor          # (D, *S) body velocity
    mu0: torch.Tensor        # (D, *S)
    mu1: torch.Tensor        # (D, D, *S)
    dt: torch.Tensor         # 0-d: the step to take next
    t: torch.Tensor          # 0-d: accumulated time


# --- index helpers -----------------------------------------------------------

def _off(D, i, v):
    return tuple(v if d == i else 0 for d in range(D))


def iv(a, D, off=None):
    """Interior of the trailing ``D`` axes, shifted by ``off`` (|off| <= 1)."""
    off = (0,) * D if off is None else off
    lead = (slice(None),) * (a.ndim - D)
    return a[lead + tuple(slice(1 + o, a.shape[a.ndim - D + d] - 1 + o)
                          for d, o in enumerate(off))]


def pad(v, lead=0):
    return torch.nn.functional.pad(v, (1, 1) * (v.ndim - lead))


def _coord(S, d, device):
    view = [1] * len(S)
    view[d] = S[d]
    return torch.arange(S[d], device=device).reshape(view)


def interior_mask(S, device):
    m = None
    for d in range(len(S)):
        k = _coord(S, d, device)
        md = (k >= 1) & (k <= S[d] - 2)
        m = md if m is None else m & md
    return m.expand(S)


def face_points(S, i, dtype, device):
    """Coordinates ``(*S, D)`` of cell centres (``i=None``) or of the lower
    face of component ``i``."""
    axes = []
    for d in range(len(S)):
        c = torch.arange(S[d], dtype=dtype, device=device) - 0.5
        if i == d:
            c = c - 0.5
        axes.append(c)
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


# --- boundary conditions (util.jl BC!, perBC!, exitBC!) ----------------------

def _plane(D, j, k, lead=0):
    return (slice(None),) * lead + tuple(
        slice(k, k + 1) if d == j else slice(None) for d in range(D))


def bc_vector(u, A, perdir=()):
    """Ghost cells of a vector field, on a copy: a periodic axis copies the
    opposite interior plane; the normal component is ``A[i]`` on the low
    ghost and first interior plane and on the high ghost plane; tangential
    components copy the adjacent plane.  Component-major, axis-minor."""
    D, S = u.shape[0], u.shape[1:]
    u = u.clone()
    for i in range(D):
        c = lambda j, k: (slice(i, i + 1),) + _plane(D, j, k)
        for j in range(D):
            if j in perdir:
                u[c(j, 0)] = u[c(j, S[j] - 2)]
                u[c(j, S[j] - 1)] = u[c(j, 1)]
            elif i == j:
                u[c(j, 0)] = A[i]
                u[c(j, 1)] = A[i]
                u[c(j, S[j] - 1)] = A[i]
            else:
                u[c(j, 0)] = u[c(j, 1)]
                u[c(j, S[j] - 1)] = u[c(j, S[j] - 2)]
    return u


def bc_scalar(a, perdir):
    """Periodic ghost fill of a scalar field (a copy where anything is
    periodic)."""
    if not perdir:
        return a
    D, S = a.ndim, a.shape
    a = a.clone()
    for j in perdir:
        a[_plane(D, j, 0)] = a[_plane(D, j, S[j] - 2)]
        a[_plane(D, j, S[j] - 1)] = a[_plane(D, j, 1)]
    return a


def exit_bc_init(u, U):
    """The constructor's outlet fix (Flow.jl:115, dt = 0): the high-x ghost
    plane of component 0 loses its mean excess over ``U[0]``."""
    D, S = u.shape[0], u.shape[1:]
    tr = tuple(slice(1, -1) for _ in range(D - 1))
    ex = (0, slice(S[0] - 1, S[0])) + tr
    new = u[ex].clone()
    u = u.clone()
    u[ex] = new - (torch.mean(new) - U[0])
    return u


def init_velocity(ulam, S, U, perdir, dtype, device):
    """Initial velocity (Flow constructor): ``ulam(i, x)`` at each face
    (``x`` of shape ``(*S, D)``, a whole-grid function), then the BCs."""
    D = len(S)
    u = torch.stack([ulam(i, face_points(S, i, dtype, device)).to(dtype)
                     for i in range(D)])
    return exit_bc_init(bc_vector(u, U, perdir), U)


# --- convection-diffusion (Flow.jl conv_diff!) -------------------------------

def median3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def quick(u, c, d):
    """QUICK upwind interpolation with median limiter (Flow.jl:4)."""
    num = 5.0 * c + 2.0 * d - u
    six = torch.full((), 6.0, dtype=num.dtype, device=num.device)
    return median3(num / six, c, median3(10.0 * c - 9.0 * u, c, d))


def conv_diff(u, nu, perdir=(), limiter=quick):
    """Tendency r = -div(convective flux) + nu*laplacian in gather form:
    each axis ``j`` takes the flux through the lower face of every cell,
    ``r[k] = F[k] - F[k+1]`` on the write support (1..S-2 along j, 1..S-1
    across); wall faces take the central value of incoming flux, periodic
    axes wrap face 1's far-upwind point and copy its flux to the top."""
    S = tuple(u.shape[1:])
    D = len(S)
    up = torch.nn.functional.pad(u, (2, 2) * D)
    dev = u.device
    A = slice(None)

    def cells(c, offs=None):
        offs = offs or {}
        return up[(c,) + tuple(slice(2 + offs.get(d, 0),
                                     2 + S[d] + offs.get(d, 0))
                               for d in range(D))]

    def face_flux(j, s, periodic):
        f = cells(A, {j: s})
        fm1 = cells(A, {j: s - 1})
        fm2 = cells(A, {j: s - 2})
        fp1 = cells(A, {j: s + 1})
        w = torch.stack([
            0.5 * (cells(j, {j: s}) + cells(j, {j: s, i: -1})) if i != j
            else 0.5 * (cells(j, {j: s}) + cells(j, {j: s - 1}))
            for i in range(D)], dim=0)
        kf = _coord(S, j, dev) + s
        cd = 0.5 * (f + fm1)
        if periodic:
            wrap = tuple(slice(S[d] - 3, S[d] - 2) if d == j else A
                         for d in range(D))
            fm2 = torch.where(kf == 1, u[(A,) + wrap], fm2)
            pos = limiter(fm2, fm1, f)
            neg = limiter(fp1, f, fm1)
        else:
            pos = torch.where(kf == 1, cd, limiter(fm2, fm1, f))
            neg = torch.where(kf == S[j] - 1, cd, limiter(fp1, f, fm1))
        return torch.where(w > 0, w * pos, w * neg) - nu * (f - fm1)

    r = torch.zeros(u.shape, dtype=u.dtype, device=dev)
    for j in range(D):
        periodic = j in perdir
        Fk = face_flux(j, 0, periodic)
        Fk1 = face_flux(j, 1, periodic)
        if periodic:
            face1 = tuple(slice(1, 2) if d == j else A for d in range(D))
            Fk1 = torch.where(_coord(S, j, dev) + 1 == S[j] - 1,
                              Fk[(A,) + face1], Fk1)
        m = None
        for d in range(D):
            kd = _coord(S, d, dev)
            md = (kd >= 1) & (kd <= S[d] - 2) if d == j else (kd >= 1)
            m = md if m is None else m & md
        r = r + torch.where(m, Fk - Fk1, 0.0)
    return r


# --- BDIM (Flow.jl BDIM!) ----------------------------------------------------

def bdim(u, u0, r, V, mu0, mu1, dt):
    """``u`` plus, on the interior, ``½Σⱼ μ₁[:,j](f[+δⱼ]-f[-δⱼ]) + V + μ₀∘f``
    with ``f = u⁰ + dt·r - V``."""
    D = u0.shape[0]
    f = u0 + dt * r - V
    m = None
    for j in range(D):
        t = iv(mu1[:, j], D) * (iv(f, D, _off(D, j, 1))
                                - iv(f, D, _off(D, j, -1)))
        m = t if m is None else m + t
    return u + pad(0.5 * m + iv(V, D) + iv(mu0, D) * iv(f, D), lead=1)


# --- Poisson operator and smoothers (Poisson.jl) -----------------------------

@dataclass(frozen=True)
class Level:
    L: torch.Tensor          # (D, *S) lower face coefficients
    Dg: torch.Tensor         # (*S) diagonal
    iD: torch.Tensor         # (*S) guarded inverse diagonal
    perdir: tuple = ()


def _diag(L):
    D = L.shape[0]
    s = None
    for i in range(D):
        t = iv(L[i], D) + iv(L[i], D, _off(D, i, 1))
        s = t if s is None else s + t
    return pad(-s)


def make_level(L, perdir):
    Dg = _diag(L)
    guard = Dg * Dg < 2 * torch.finfo(Dg.dtype).eps
    iD = torch.where(guard, 0.0, 1.0 / torch.where(guard, 1.0, Dg))
    return Level(L=L, Dg=Dg, iD=iD.to(L.dtype), perdir=tuple(perdir))


def _ax_interior(L, Dg, x):
    D = L.shape[0]
    s = iv(x, D) * iv(Dg, D)
    for i in range(D):
        lo, hi = _off(D, i, -1), _off(D, i, 1)
        s = s + iv(x, D, lo) * iv(L[i], D) + iv(x, D, hi) * iv(L[i], D, hi)
    return s


def mult(lev, x):
    return pad(_ax_interior(lev.L, lev.Dg, bc_scalar(x, lev.perdir)))


def dot(a, b):
    return torch.sum(a * b)


def residual(lev, x, z):
    """r = z - Ax, zero where iD = 0, less its interior mean."""
    D = x.ndim
    xb = bc_scalar(x, lev.perdir)
    r = torch.where(iv(lev.iD, D) == 0, 0.0,
                    iv(z, D) - _ax_interior(lev.L, lev.Dg, xb))
    s = torch.sum(r) / math.prod(n - 2 for n in x.shape)
    eps = torch.finfo(x.dtype).eps
    corr = torch.where(torch.abs(s) <= 2 * eps, 0.0, s).to(x.dtype)
    return pad(r - corr)


def increment(lev, x, r, eps):
    return x + eps, r - mult(lev, eps)


def jacobi(lev, x, r):
    return increment(lev, x, r, r * lev.iD)


def _mask(a):
    return torch.where(interior_mask(a.shape, a.device), a, 0.0)


def pcg(lev, x, r, it=6):
    """Jacobi-preconditioned conjugate gradient (Poisson.jl:123-143) with
    its early exits held as a monotone ``dead`` flag."""
    dt = x.dtype
    teneps = 10 * torch.finfo(dt).eps
    z = r * lev.iD
    eps = z
    rho = dot(r, z)
    dead = torch.abs(rho) < teneps
    for i in range(it):
        eps = bc_scalar(eps, lev.perdir)
        z = mult(lev, eps)
        denom = dot(z, eps)
        alpha = torch.where(dead | (denom == 0), 0.0,
                            rho / torch.where(denom == 0, 1.0, denom)).to(dt)
        dead = dead | (torch.abs(alpha) < 1e-2) | (torch.abs(alpha) > 1e2)
        upd = torch.where(dead, 0.0, alpha).to(dt)
        x = x + upd * eps
        r = r - upd * z
        if i == it - 1:
            break
        z2 = r * lev.iD
        rho2 = dot(r, z2)
        dead = dead | (torch.abs(rho2) < teneps)
        beta = torch.where(dead, 0.0,
                           rho2 / torch.where(rho == 0, 1.0, rho)).to(dt)
        eps = _mask(beta * eps + z2)
        rho = torch.where(dead, rho, rho2)
    return x, r


# --- multigrid (MultiLevelPoisson.jl) ----------------------------------------

def _restrict(b):
    D, S = b.ndim, b.shape
    v = iv(b, D)
    for d in range(D):
        M = (S[d] - 2) // 2
        v = v.reshape(v.shape[:d] + (M, 2) + v.shape[d + 1:]).sum(dim=d + 1)
    return pad(v)


def _restrict_L(L, perdir):
    D, S = L.shape[0], L.shape[1:]
    comps = []
    for i in range(D):
        v = iv(L[i], D)
        for d in range(D):
            M = (S[d] - 2) // 2
            if d == i:
                v = v[(slice(None),) * d + (slice(0, 2 * M, 2),)]
            else:
                v = v.reshape(v.shape[:d] + (M, 2) + v.shape[d + 1:]).sum(
                    dim=d + 1)
        comps.append(pad(0.5 * v))
    return bc_vector(torch.stack(comps), (0.0,) * D, perdir)


def _prolongate(xc):
    v = iv(xc, xc.ndim)
    for d in range(xc.ndim):
        v = torch.repeat_interleave(v, 2, dim=d)
    return pad(v)


def build_levels(mu0, perdir=()):
    """Fine level from μ₀, each coarser one its restriction, while every
    padded size is even and > 4 (at most 10 coarsenings)."""
    L = mu0
    levels = [make_level(L, perdir)]
    while (all(s % 2 == 0 and s > 4 for s in L.shape[1:])
           and len(levels) <= 10):
        L = _restrict_L(L, perdir)
        levels.append(make_level(L, perdir))
    if len(levels) <= 2:
        raise ValueError(f"too few multigrid levels for {tuple(mu0.shape)}")
    return tuple(levels)


def _vcycle(levels, l, x, r):
    fine, coarse = levels[l], levels[l + 1]
    x, r = jacobi(fine, x, r)
    rc = _restrict(r)
    xc = torch.zeros_like(coarse.Dg)
    if l + 1 < len(levels) - 1:
        xc, rc = _vcycle(levels, l + 1, xc, rc)
    xc, rc = pcg(coarse, xc, rc)
    return increment(fine, x, r, _prolongate(xc))


def ml_solve(levels, x, z, tol, itmx):
    """V-cycle plus fine-level PCG per iteration, at least one, until
    ``r·r < tol``, ``itmx`` iterations, or an iteration that doubles
    ``r·r``.  Returns ``(x, n)``."""
    fine = levels[0]
    r = residual(fine, x, z)
    r2 = dot(r, r)
    n = 0
    while True:
        x, r = _vcycle(levels, 0, x, r)
        x, r = pcg(fine, x, r)
        r2p, r2 = r2, dot(r, r)
        n += 1
        if not (n < itmx and bool((r2 >= tol) & ~(r2 > 2.0 * r2p))):
            break
    return bc_scalar(x, fine.perdir), n


# --- projection, CFL and the step (Flow.jl) ----------------------------------

def _div(u):
    D = u.shape[0]
    s = None
    for i in range(D):
        t = iv(u[i], D, _off(D, i, 1)) - iv(u[i], D)
        s = t if s is None else s + t
    return pad(s)


def project(levels, u, p, dt, cfg):
    """Solve for the dt-scaled pressure, warm-started from the last step,
    and take its μ₀-weighted gradient from the velocity."""
    lev = levels[0]
    D = u.shape[0]
    x, n = ml_solve(levels, p * dt, _div(u), cfg.tol, cfg.itmx)
    grad = torch.stack([iv(lev.L[i], D) * (iv(x, D) - iv(x, D, _off(D, i, -1)))
                        for i in range(D)])
    return u - pad(grad, lead=1), x / dt, n


def cfl(u, nu, dt_max=10.0):
    D = u.shape[0]
    s = None
    for i in range(D):
        t = (torch.clamp_min(iv(u[i], D, _off(D, i, 1)), 0.0)
             + torch.clamp_min(-iv(u[i], D), 0.0))
        s = t if s is None else s + t
    return torch.clamp_max(1.0 / (torch.max(s) + 5 * nu), dt_max)


def mom_step(cfg: Config, levels, st: State):
    """One predictor/corrector step (Flow.jl mom_step!).  Returns the new
    state and the two solves' iteration counts."""
    u0, dt = st.u, st.dt
    imask = interior_mask(cfg.S, u0.device)
    bc = lambda v: bc_vector(v, cfg.U, cfg.perdir)
    r = conv_diff(u0, cfg.nu, cfg.perdir)
    u = bdim(torch.where(imask, 0.0, u0), u0, r, st.V, st.mu0, st.mu1, dt)
    u, p, n1 = project(levels, bc(u), st.p, dt, cfg)
    u = bc(u)
    r = conv_diff(u, cfg.nu, cfg.perdir)
    u = bdim(u, u0, r, st.V, st.mu0, st.mu1, dt)
    u = bc(torch.where(imask, 0.5 * u, u))
    u, p, n2 = project(levels, u, p, 0.5 * dt, cfg)
    u = bc(u)
    return replace(st, u=u, p=p, dt=cfl(u, cfg.nu), t=st.t + dt), (n1, n2)
