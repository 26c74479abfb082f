"""Ghost-cell boundary conditions.

PyTorch counterpart of `waterlily_tpu.ops.bc` (reference ``BC!``,
``exitBC!`` and ``perBC!``).  The plain form applies the reference's
sequential plane updates to a copy of the field (or, asked to, to the
field itself); big 3D f32 fields on a CUDA device dispatch to the kernel
`stencil_kernels.bc3d`, which composes the same stages per cell.
"""
from __future__ import annotations

import torch

from . import stencil_kernels as sk

__all__ = ["bc_vector", "bc_vector_planes", "bc_scalar_periodic", "exit_bc"]


def _pl(D: int, j: int, lo: int, lead: int = 0) -> tuple:
    """Width-1 slice selecting plane ``axis j == lo``."""
    return (slice(None),) * lead + tuple(
        slice(lo, lo + 1) if d == j else slice(None) for d in range(D))


def bc_vector(u: torch.Tensor, A, save_exit: bool = False,
              perdir: tuple = (), inplace: bool = False) -> torch.Tensor:
    """Apply domain BCs to the ghost cells of a vector field ``u`` (D,*S)
    and return a new tensor; with ``inplace=True`` it may write into ``u``
    instead and returns it (for a caller that reads ``u`` no more).

    Fields that pass `stencil_kernels.members_ok` go through the kernel
    (in place, it writes only the ghost faces and Dirichlet planes; under
    `vmap` alone its member form); a field or BC value that autograd
    tracks takes the plain form.  Semantics (reference src/util.jl:192-210):
    periodic direction ``j`` copies the opposite interior plane; the normal
    component (``i==j``) is Dirichlet ``A[i]`` on the low ghost *and* first
    interior plane and on the high ghost plane (the high plane is kept for
    ``i==0`` when ``save_exit``); tangential components copy the adjacent
    plane.  Updates run component-major, direction-minor, so ghost corners
    match the reference exactly.
    """
    S = tuple(u.shape[1:])
    if u.shape[0] == 3 and sk.members_ok(S, u.dtype, u.device, u, A):
        return sk.bc3d(u, A, save_exit, perdir, inplace)
    return bc_vector_planes(u, A, save_exit, perdir, inplace)


def bc_vector_planes(u: torch.Tensor, A, save_exit: bool = False,
                     perdir: tuple = (), inplace: bool = False,
                     S_glob=None, base=None) -> torch.Tensor:
    """The sequential plane-update form of `bc_vector` (the plain version
    of the `bc3d` kernel): on a copy of ``u``, or with ``inplace`` on
    ``u`` itself.

    With ``S_glob`` and ``base`` (host ints; walls and the outlet only)
    ``u`` is one shard's block of a grid of sizes ``S_glob`` whose cell 0
    sits at global index ``base``: only the global ghost planes (and
    Dirichlet plane 1) that fall in the block are updated, from its planes
    1 and S-2 (the shard-local form of `waterlily_tpu.parallel`)."""
    D = u.shape[0]
    S = u.shape[1:]
    lo = hi = (True,) * D
    if base is not None:
        lo = tuple(b == 0 for b in base)
        hi = tuple(b + s == g for b, s, g in zip(base, S, S_glob))
    if not inplace:
        u = u.clone()
    cpl = lambda i, j, lo: (slice(i, i + 1),) + _pl(D, j, lo)
    for i in range(D):
        for j in range(D):
            if j in perdir:
                u[cpl(i, j, 0)] = u[cpl(i, j, S[j] - 2)]
                u[cpl(i, j, S[j] - 1)] = u[cpl(i, j, 1)]
            elif i == j:
                if lo[j]:
                    u[cpl(i, j, 0)] = A[i]
                    u[cpl(i, j, 1)] = A[i]
                if hi[j] and not (save_exit and i == 0):
                    u[cpl(i, j, S[j] - 1)] = A[i]
            else:
                if lo[j]:
                    u[cpl(i, j, 0)] = u[cpl(i, j, 1)]
                if hi[j]:
                    u[cpl(i, j, S[j] - 1)] = u[cpl(i, j, S[j] - 2)]
    return u


def bc_scalar_periodic(a: torch.Tensor, perdir: tuple,
                       D: int | None = None) -> torch.Tensor:
    """Periodic ghost fill for a scalar field (reference ``perBC!``);
    returns ``a`` itself when nothing is periodic, a new tensor otherwise."""
    if not perdir:
        return a
    D = a.ndim if D is None else D
    lead = a.ndim - D
    S = a.shape[lead:]
    a = a.clone()
    for j in perdir:
        a[_pl(D, j, 0, lead)] = a[_pl(D, j, S[j] - 2, lead)]
        a[_pl(D, j, S[j] - 1, lead)] = a[_pl(D, j, 1, lead)]
    return a


def exit_bc(u: torch.Tensor, u0: torch.Tensor, U, dt) -> torch.Tensor:
    """1D convective outlet on the high-x ghost plane plus a global flux fix
    (reference ``exitBC!``, src/util.jl:216-222); returns a new tensor."""
    D = u.shape[0]
    S = u.shape[1:]
    tr = tuple(slice(1, -1) for _ in range(D - 1))
    ex = (0, slice(S[0] - 1, S[0])) + tr
    exm = (0, slice(S[0] - 2, S[0] - 1)) + tr
    new = u0[ex] - U[0] * dt * (u0[ex] - u0[exm])
    flux = torch.mean(new) - U[0]
    u = u.clone()
    u[ex] = new - flux
    return u
