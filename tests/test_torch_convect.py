"""Port parity: convection-diffusion (torch vs JAX, and the conv kernel's
plain version vs the Pallas kernel in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.ops import convect as jc
from waterlily_tpu.ops.bc import bc_vector as jbc_vector
from waterlily_tpu.ops.pallas_stencil import conv_diff3d_pallas
from waterlily_tpu_torch.ops import convect as tc
from waterlily_tpu_torch.ops import stencil_kernels as sk

from _torch_parity import (F32, F64, STENCIL_RTOL, normal, tt, jj,
                           assert_exact, assert_rel)

S3 = (14, 12, 10)
LIMITERS = {"quick": (jc.quick, tc.quick), "vanleer": (jc.vanleer, tc.vanleer)}


@pytest.mark.parametrize("name", ["quick", "vanleer"])
def test_limiters(name):
    jl, tl = LIMITERS[name]
    u, c, d = (normal(s, (400,)) for s in (1, 2, 3))
    d[:20] = u[:20]   # exercise the van Leer division guard
    assert_exact(tl(tt(u), tt(c), tt(d)), jl(jj(u), jj(c), jj(d)))
    assert_exact(tc.median3(tt(u), tt(c), tt(d)),
                 jc.median3(jj(u), jj(c), jj(d)))


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name", ["quick", "vanleer"])
def test_conv_diff_vs_jax(dtype, name):
    jl, tl = LIMITERS[name]
    u = normal(4, (3,) + S3, dtype)
    rj = jc.conv_diff(jj(u), 0.05, (), jl)
    rt = tc.conv_diff(tt(u), 0.05, (), tl)
    assert_rel(rt, rj, STENCIL_RTOL[dtype])
    # cells the reference never writes (index 0 on any axis) are exactly
    # zero; the top ghost planes are written by the transverse sweeps
    for ax in (1, 2, 3):
        assert bool((rt.select(ax, 0) == 0).all())
    assert bool((rt[0, -1] != 0).any())


@pytest.mark.parametrize("S", [(14, 12, 10), (18, 14, 18)])
@pytest.mark.parametrize("name", ["quick", "vanleer"])
def test_conv_diff3d_plain_vs_pallas(S, name):
    """The kernel's plain version against the Pallas conv kernel (merged
    all-component form, interpret mode); the Pallas kernel accumulates its
    sweeps in another order, hence a relative tolerance."""
    jl, tl = LIMITERS[name]
    u = normal(5, (3,) + S)
    rj = conv_diff3d_pallas(jj(u), 0.05, jl, S, interpret=True)
    rt = sk.conv_diff3d(tt(u), 0.05, tl)
    assert_rel(rt, rj, 1e-6)


@pytest.mark.parametrize("perdir", [(0,), (1,), (0, 2)])
def test_conv_core_periodic(perdir):
    """Periodic flux variants (ϕuP wrap, top-face copy) of the plain form."""
    u = normal(6, (3,) + S3)
    u = np.asarray(jbc_vector(jj(u), (0.0, 0.0, 0.0), False, perdir))
    rj = jc.conv_diff(jj(u), 0.05, perdir, jc.quick)
    rt = tc.conv_diff(tt(u), 0.05, perdir, tc.quick)
    assert_rel(rt, rj, 1e-6)


def test_accelerate():
    r = normal(7, (3,) + S3)
    g = lambda i, t: 0.1 * (i + 1) * t
    Uj = lambda i, t: jnp.sin(t) * (i == 0)
    Ut = lambda i, t: torch.sin(t) * (i == 0)
    aj = jc.accelerate(jj(r), jnp.float32(0.3), g, Uj, jnp.float32)
    at = tc.accelerate(tt(r), 0.3, g, Ut, torch.float32)
    assert_rel(at, aj, 1e-6)
    assert tc.accelerate(tt(r), 0.3, None, (1.0, 0.0, 0.0),
                         torch.float32) is not None


def test_conv_diff3d_limiter_codes():
    assert sk._limiter_code(tc.quick) == 0
    assert sk._limiter_code(tc.vanleer) == 1
    with pytest.raises(NotImplementedError):
        sk._limiter_code(lambda u, c, d: c)
