"""Helpers of the port's parity tests: the same numpy inputs go to the JAX
package and to its PyTorch port, and the outputs are compared as numpy."""
import numpy as np
import jax.numpy as jnp
import torch

torch.set_num_threads(1)

F32, F64 = np.float32, np.float64
TORCH = {F32: torch.float32, F64: torch.float64}
JAX = {F32: jnp.float32, F64: jnp.float64}

# relative tolerance of the slice-form stencils, per dtype (a kernel with
# another association than the XLA form rounds differently in the last bits)
STENCIL_RTOL = {F32: 1e-6, F64: 1e-12}


def normal(seed, shape, dtype=F32, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(dtype)


def uniform(seed, shape, lo=0.0, hi=1.0, dtype=F32):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(dtype)


def interior_only(a):
    """Copy of ``a`` with zero ghost cells on every axis (scalar field)."""
    out = np.zeros_like(a)
    out[tuple(slice(1, -1) for _ in a.shape)] = a[
        tuple(slice(1, -1) for _ in a.shape)]
    return out


def tt(a):
    """numpy -> torch (CPU), same dtype."""
    return torch.from_numpy(np.array(a, copy=True))


def jj(a):
    """numpy -> jax, same dtype."""
    return jnp.asarray(a)


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_rel(a, ref, rtol):
    """max|a - ref| <= rtol * max(|ref|, tiny): a relative tolerance on the
    field's scale."""
    a, ref = npy(a), npy(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), np.finfo(ref.dtype).tiny)
    err = float(np.max(np.abs(a.astype(np.float64) - ref.astype(np.float64))))
    assert err <= rtol * scale, f"max err {err} > {rtol} * {scale}"


def assert_exact(a, ref):
    a, ref = npy(a), npy(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    assert a.dtype == ref.dtype, (a.dtype, ref.dtype)
    assert np.array_equal(a, ref), float(np.max(np.abs(a - ref)))


def bc_coeffs(seed, S, dtype=F32):
    """Positive face coefficients with the wall-normal ghosts zeroed (the
    shape of a BDIM μ₀), same array for both packages."""
    from waterlily_tpu_torch.ops.bc import bc_vector_planes
    L = uniform(seed, (len(S),) + tuple(S), 0.5, 1.5, dtype)
    return npy(bc_vector_planes(tt(L), (0.0,) * len(S)))


def march_ownership(S, planes, tile):
    """A numpy emulation of the cell ownership of a plane march
    (``csrc/march.cuh``): the grid of blocks, each a ``tile`` (axis 1,
    axis 2) of interior columns from (1, 1) marching a chunk of ``planes``
    interior planes, every interior column writing its cells of its chunk
    and, through `march_ghosts`, the ghost cells beside them, the first and
    last chunks also the ghost planes.  Returns the per-cell counts of
    writes and of dot terms (one an interior cell of a column's chunk),
    and the grid's block count."""
    S0, S1, S2 = S
    gx = -(-(S2 - 2) // tile[1])
    gy = -(-(S1 - 2) // tile[0])
    gz = -(-(S0 - 2) // planes)
    # every thread of one chunk's blocks: its column (j, k) (march_column)
    ty, tx = np.meshgrid(np.arange(tile[0]), np.arange(tile[1]),
                         indexing="ij")
    by, bx = np.meshgrid(np.arange(gy), np.arange(gx), indexing="ij")
    j = (1 + by[..., None, None] * tile[0] + ty).ravel()
    k = (1 + bx[..., None, None] * tile[1] + tx).ravel()
    keep = (j <= S1 - 2) & (k <= S2 - 2)   # Column.in
    j, k = j[keep], k[keep]
    cell = j * S2 + k
    jl, jh, kl, kh = j == 1, j == S1 - 2, k == 1, k == S2 - 2
    # march_ghosts: (which columns, offset in the plane)
    ring = ((jl, -S2), (jl & kl, -S2 - 1), (jl & kh, -S2 + 1),
            (jh, S2), (jh & kl, S2 - 1), (jh & kh, S2 + 1),
            (kl, -1), (kh, 1))
    P = S1 * S2
    writes = np.zeros((S0, P), np.int32)
    terms = np.zeros((S0, P), np.int32)

    def plane(i):   # the column's cell of plane i and its ghost ring
        idx = np.concatenate([cell] + [cell[m] + o for m, o in ring])
        writes[i] += np.bincount(idx, minlength=P)

    for bz in range(gz):
        i0 = 1 + bz * planes
        i1 = min(i0 + planes, S0 - 1)
        if i0 == 1:
            plane(0)
        for i in range(i0, i1):
            plane(i)
            terms[i] += np.bincount(cell, minlength=P)
        if i1 == S0 - 1:
            plane(S0 - 1)
    return writes.reshape(S), terms.reshape(S), gx * gy * gz
