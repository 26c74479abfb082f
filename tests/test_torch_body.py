"""Port parity: immersion kernels, point measurement and BDIM
rasterization (torch vs JAX)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import body as jb
from waterlily_tpu_torch import body as tb

from _torch_parity import F32, F64, TORCH, JAX, normal, tt, jj, npy, assert_rel

RADIUS, CENTER = 3.0, np.array([7.0, 5.5, 4.0])


def _spheres(dtype):
    cj = jnp.asarray(CENTER, JAX[dtype])
    ct = torch.tensor(CENTER, dtype=TORCH[dtype])
    sj = jb.AutoBody(lambda x, t: jnp.sqrt(jnp.sum((x - cj) ** 2)) - RADIUS)
    st = tb.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ct) ** 2)) - RADIUS)
    return sj, st


def _heaving(dtype):
    """A sphere on a time-dependent map: exercises jacfwd and the jvp."""
    def mj(x, t):
        return x - jnp.stack([jnp.asarray(7.0, x.dtype),
                              5.5 + 2.0 * jnp.sin(0.3 * t),
                              jnp.asarray(4.0, x.dtype)])

    def mt(x, t):
        return x - torch.stack([torch.tensor(7.0, dtype=x.dtype),
                                5.5 + 2.0 * torch.sin(0.3 * t),
                                torch.tensor(4.0, dtype=x.dtype)])
    sj = jb.AutoBody(lambda x, t: jnp.sqrt(jnp.sum(x * x)) - RADIUS, mj)
    st = tb.AutoBody(lambda x, t: torch.sqrt(torch.sum(x * x)) - RADIUS, mt)
    return sj, st


@pytest.mark.parametrize("dtype", [F32, F64])
def test_kernel_moments(dtype):
    d = np.linspace(-3, 3, 61).astype(dtype)
    for f in ("kern", "kern0", "kern1"):
        assert_rel(getattr(tb, f)(tt(d)), getattr(jb, f)(jj(d)),
                   1e-6 if dtype is F32 else 1e-12)
    for f in ("mu0", "mu1"):
        assert_rel(getattr(tb, f)(tt(d), 1.5), getattr(jb, f)(jj(d), 1.5),
                   1e-6 if dtype is F32 else 1e-12)


@pytest.mark.parametrize("make", [_spheres, _heaving])
def test_measure_points(make):
    sj, st = make(F64)
    pts = normal(1, (64, 3), F64, 4.0) + CENTER
    pts[0] = CENTER if make is _spheres else pts[0]   # NaN-gradient guard
    t = 1.3
    dj, nj, Vj = jax.vmap(lambda x: jb.measure(sj, x, t, 9.0))(jj(pts))
    dt_, nt, Vt = torch.func.vmap(lambda x: tb.measure(st, x, t, 9.0))(tt(pts))
    for a, b in ((dt_, dj), (nt, nj), (Vt, Vj)):
        np.testing.assert_allclose(npy(a), npy(b), atol=1e-12)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("make", [_spheres, _heaving])
def test_measure_fields(dtype, make):
    S = (16, 13, 10)
    sj, st = make(dtype)
    outj = jb.measure_fields(sj, S, 0.7, 1.0, dtype=JAX[dtype])
    outt = tb.measure_fields(st, S, 0.7, 1.0, dtype=TORCH[dtype])
    atol = 1e-6 if dtype is F32 else 1e-12
    for a, b in zip(outt, outj):
        assert a.dtype == TORCH[dtype]
        np.testing.assert_allclose(npy(a), npy(b), atol=atol)
    # the near-body band carries moving-body velocity for the heaving map
    if make is _heaving:
        assert float(outt[0].abs().max()) > 0


def test_measure_fields_chunked(monkeypatch):
    """Chunked evaluation gives the same fields as one batch."""
    S = (12, 10, 8)
    _, st = _spheres(F32)
    whole = tb.measure_fields(st, S, 0.0, 1.0)
    monkeypatch.setattr(tb, "CHUNK", 97)
    chunked = tb.measure_fields(st, S, 0.0, 1.0)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_nobody_fields():
    S = (10, 9, 8)
    outj = jb.measure_fields(jb.NoBody(), S)
    outt = tb.measure_fields(tb.NoBody(), S)
    for a, b in zip(outt, outj):
        assert np.array_equal(npy(a), npy(b))
