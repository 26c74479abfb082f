"""Convection-diffusion fluxes in gather form.

PyTorch counterpart of `waterlily_tpu.ops.convect` (reference
``conv_diff!``, src/Flow.jl:36-60).  Each sweep axis ``j`` evaluates the
flux through the lower face ``k`` of every cell (``k = 1..S-1``) and the
tendency is the gathered difference ``r[k] = F[k] - F[k+1]`` on the
reference's write support (``1..S-2`` along ``j``, ``1..S-1`` across it);
every other cell of ``r`` is exactly zero.

Boundary variants: QUICK/van Leer upwinding in the interior, the central
value for incoming flux on the wall faces ``k=1`` (ϕuL) and ``k=S-1``
(ϕuR); periodic axes wrap face 1's far-upwind point to plane ``S-3`` (ϕuP)
and copy face 1's flux to the top face.

Big 3D f32 fields on a CUDA device run the `stencil_kernels.conv_diff3d`
kernel with any limiter: QUICK and van Leer are compiled in, and a
user-defined one is traced into the kernel at its first launch
(`kernels.limiter`), as JAX traces it into its Pallas kernel.
"""
from __future__ import annotations

import torch

from ..grid import axis_coord
from . import stencil_kernels as sk

__all__ = ["median3", "quick", "vanleer", "KERNEL_LIMITERS", "conv_core",
           "conv_diff", "accelerate"]


def median3(a, b, c):
    """Median of three tensors, elementwise."""
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def quick(u, c, d):
    """QUICK upwind interpolation with median limiter (src/Flow.jl:4);
    ``u`` far upwind, ``c`` upwind, ``d`` downwind."""
    num = 5.0 * c + 2.0 * d - u
    # a true division, as in JAX and the conv kernel: on CUDA, dividing by
    # a Python scalar multiplies by its rounded reciprocal instead
    six = torch.full((), 6.0, dtype=num.dtype, device=num.device)
    return median3(num / six, c, median3(10.0 * c - 9.0 * u, c, d))


def vanleer(u, c, d):
    """van Leer flux limiter (src/Flow.jl:5), division-guarded."""
    denom = torch.where(d == u, 1.0, d - u)
    lim = c + (d - c) * (c - u) / denom
    keep = (c <= torch.minimum(u, d)) | (c >= torch.maximum(u, d))
    return torch.where(keep, c, lim)


# the limiters the conv_diff3d kernel has compiled in, in the order of its
# limiter codes (`stencil_kernels._limiter_code`)
KERNEL_LIMITERS = (quick, vanleer)


def conv_core(up, S: tuple, nu, perdir: tuple, limiter,
              u_wrap=None, S_glob=None, base=None,
              modular: bool = False) -> torch.Tensor:
    """Gather-form tendency on the whole grid from ``up``, the velocity
    padded by 2 cells on every spatial axis (zeros; a shard's halos in the
    shard-local form); ``u_wrap`` (the unpadded velocity) supplies the
    periodic far-upwind wraps.

    ``S_glob``/``base`` (host ints): the output's ``S`` cells are a window
    of a grid of sizes ``S_glob`` whose cell 0 sits at global index
    ``base``, and the wall-face variants and the write support test global
    positions (the shard-local form of `waterlily_tpu.parallel`).
    ``modular``: ``up``'s planes beyond the window hold the modular wrap
    values of the periodic axes (global plane -m is interior plane
    ``S_glob-2-m``, ``S_glob-1+m`` is ``1+m``), so a periodic face takes the
    uniform periodic formula with no wrap read and no top-face copy: it
    then equals the wrapped flux bit for bit."""
    D = len(S)
    A = slice(None)
    device = up.device
    S_glob = tuple(S) if S_glob is None else tuple(S_glob)

    def gidx(d):
        k = axis_coord(S, d, device)
        return k if base is None else k + base[d]

    def cells(c, offs=None):
        """Component(s) ``c`` on the cell grid shifted by ``offs[d]``
        (|off| <= 2) along axis d: a slice of ``up``."""
        offs = offs or {}
        sl = tuple(slice(2 + offs.get(d, 0), 2 + S[d] + offs.get(d, 0))
                   for d in range(D))
        return up[(c,) + sl]

    def face_flux(j, s, periodic):
        """Flux through face ``k+s`` of every cell ``k``, all components."""
        f = cells(A, {j: s})
        fm1 = cells(A, {j: s - 1})
        fm2 = cells(A, {j: s - 2})
        fp1 = cells(A, {j: s + 1})
        w = torch.stack([
            0.5 * (cells(j, {j: s}) + cells(j, {j: s, i: -1})) if i != j
            else 0.5 * (cells(j, {j: s}) + cells(j, {j: s - 1}))
            for i in range(D)], dim=0)
        kf = gidx(j) + s
        cd = 0.5 * (f + fm1)
        if periodic and modular:
            pos = limiter(fm2, fm1, f)
            neg = limiter(fp1, f, fm1)
        elif periodic:
            wrap = tuple(slice(S[d] - 3, S[d] - 2) if d == j else slice(None)
                         for d in range(D))
            fm2 = torch.where(kf == 1, u_wrap[(A,) + wrap], fm2)
            pos = limiter(fm2, fm1, f)
            neg = limiter(fp1, f, fm1)
        else:
            pos = torch.where(kf == 1, cd, limiter(fm2, fm1, f))    # ϕuL
            neg = torch.where(kf == S_glob[j] - 1, cd,
                              limiter(fp1, f, fm1))                 # ϕuR
        return torch.where(w > 0, w * pos, w * neg) - nu * (f - fm1)

    r = torch.zeros(up.shape[:1] + tuple(S), dtype=up.dtype, device=device)
    for j in range(D):
        periodic = j in perdir
        Fk = face_flux(j, 0, periodic)
        Fk1 = face_flux(j, 1, periodic)
        if periodic and not modular:
            # the top face flux (face S-1) copies face 1's flux (Flow.jl:60)
            face1 = tuple(slice(1, 2) if d == j else slice(None)
                          for d in range(D))
            Fk1 = torch.where(gidx(j) + 1 == S_glob[j] - 1,
                              Fk[(A,) + face1], Fk1)
        m = None
        for d in range(D):
            kd = gidx(d)
            md = (kd >= 1) & (kd <= S_glob[d] - 2) if d == j else (kd >= 1)
            m = md if m is None else m & md
        r = r + torch.where(m, Fk - Fk1, 0.0)
    return r


def conv_diff(u: torch.Tensor, nu, perdir: tuple = (),
              limiter=quick) -> torch.Tensor:
    """Momentum tendency r = -div(convective flux) + nu*laplacian, zero
    wherever the reference never writes (the BDIM first-moment stencil
    reads those cells).  ``nu`` may be a 0-d tensor; a ``u`` or ``nu``
    that autograd tracks takes the plain form, one under `vmap` alone the
    kernel's member form (`stencil_kernels.members_ok`)."""
    S = tuple(u.shape[1:])
    if u.shape[0] == 3 and sk.members_ok(S, u.dtype, u.device, u, nu):
        return sk.conv_diff3d(u, nu, limiter, perdir)
    up = torch.nn.functional.pad(u, (2, 2) * len(S))
    return conv_core(up, S, nu, perdir, limiter, u_wrap=u)


def accelerate(r: torch.Tensor, t, g, U, dtype) -> torch.Tensor:
    """Add the uniform body force ``g(i,t)`` plus ``dU_i/dt`` when the
    domain velocity ``U`` is a function of time (reference
    ``accelerate!``; the derivative by `torch.func.grad`)."""
    if g is None and not callable(U):
        return r
    D = r.shape[0]
    tt = torch.as_tensor(t, dtype=dtype, device=r.device)
    terms = []
    for i in range(D):
        a = torch.zeros((), dtype=dtype, device=r.device)
        if g is not None:
            a = a + g(i, tt)
        if callable(U):
            a = a + torch.func.grad(
                lambda tau, i=i: torch.as_tensor(U(i, tau), dtype=dtype,
                                                 device=r.device))(tt)
        terms.append(a)
    return r + torch.stack(terms).reshape((D,) + (1,) * (r.ndim - 1)).to(r.dtype)
