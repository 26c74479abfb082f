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
