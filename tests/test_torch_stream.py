"""Port parity of the carried-rows operator (`ops.attic.mult3d_stream`,
`increment3d_stream`) and the bandwidth probes (`kernels.probes`): the
plain versions against the JAX package's carried-rows Pallas kernels in
interpret mode (f32 and bf16 L, at a dividing block and at JAX's
indivisible-slab fallback), the ``STREAM`` seam against the halo-row path,
and the probes against the ``jnp`` expressions of
``scripts/bench_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.ops import attic as ja
from waterlily_tpu_torch.kernels import probes
from waterlily_tpu_torch.ops import attic as ta
from waterlily_tpu_torch.ops import multigrid as tmg
from waterlily_tpu_torch.ops import poisson as tp
from waterlily_tpu_torch.ops import stencil_kernels as sk

from _torch_parity import (F32, STENCIL_RTOL, normal, interior_only, tt, jj,
                           npy, assert_rel, bc_coeffs)

S = (34, 34, 34)     # the JAX package's own test shape (tests/test_attic.py)
SB = (20, 18, 22)    # a blocked level of the seam tests (gate patched)


def _operator(L, op16):
    """(L, D) as the port and as JAX take them: f32, or the shadows."""
    Lt = tt(L)
    if not op16:
        lev = tp.make_level(Lt)
        return (lev.L, lev.D), (jj(L), jj(npy(lev.D)))
    L16, D16, _ = tp.operator_shadows(Lt)
    return ((L16, D16), (jnp.asarray(L16.float().numpy()).astype(
        jnp.bfloat16), jj(npy(D16))))


@pytest.mark.parametrize("op16", [False, True])
@pytest.mark.parametrize("block", [2, 5])
def test_mult3d_stream_plain_vs_jax(block, op16):
    """z = A·x with and without the dot (block 5 does not divide 34 rows:
    JAX falls back to its halo-row kernel); f32 L and the bf16 L16 with
    the f32 D16."""
    (Lt, Dt), (Lj, Dj) = _operator(bc_coeffs(0, S), op16)
    x = normal(1, S)
    zj, dj = ja.mult3d_stream(Lj, Dj, jj(x), S, interpret=True, block=block,
                              with_dot=True)
    zt, dt = ta.mult3d_stream(Lt, Dt, tt(x), with_dot=True)
    assert zt.dtype == torch.float32
    assert_rel(zt, zj, STENCIL_RTOL[F32])
    assert abs(float(dt) - float(dj)) <= 1e-5 * abs(float(dj))
    z0 = ta.mult3d_stream(Lt, Dt, tt(x))
    assert torch.equal(z0, zt)
    assert torch.equal(z0, sk.mult3d(Lt, Dt, tt(x)))


@pytest.mark.parametrize("op16", [False, True])
@pytest.mark.parametrize("block", [2, 5])
def test_increment3d_stream_plain_vs_jax(block, op16):
    """(x + eps, r − A·eps), x exactly, r within the stencil tolerance."""
    (Lt, Dt), (Lj, Dj) = _operator(bc_coeffs(2, S), op16)
    x, r = normal(3, S), interior_only(normal(4, S))
    eps = interior_only(normal(5, S, scale=0.1))
    xj, rj = ja.increment3d_stream(Lj, Dj, jj(eps), jj(x), jj(r), S,
                                   interpret=True, block=block)
    xt, rt = ta.increment3d_stream(Lt, Dt, tt(eps), tt(x), tt(r))
    assert xt.dtype == rt.dtype == torch.float32
    assert np.array_equal(npy(xt), np.asarray(xj))
    assert_rel(rt, rj, STENCIL_RTOL[F32])


# --- the STREAM seam ----------------------------------------------------------

@pytest.fixture
def port_blocked(monkeypatch):
    monkeypatch.setattr(sk, "use_blocked", lambda S_, dt_, dev:
                        len(S_) == 3 and min(S_) >= 18)


def _spy(monkeypatch, mod, name):
    calls = []
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: (calls.append(1),
                                                    orig(*a, **k))[1])
    return calls


@pytest.mark.parametrize("op16", [False, True])
def test_stream_seam_pcg_same_as_halo_rows(op16, port_blocked, monkeypatch):
    """``STREAM`` routes a blocked level's A·x (with the dot) and increment
    through the carried-rows functions, whose plain versions are the
    halo-row ones: `pcg`, `residual` and `increment` equal bit for bit, and
    the halo-row wrappers are not called."""
    lev = tp.make_level(tt(bc_coeffs(6, SB)), op_bf16=op16)
    assert lev.blocked and (lev.L16 is not None) == op16
    x, z = tt(normal(7, SB)), tt(interior_only(normal(8, SB, scale=0.1)))
    eps = tt(interior_only(normal(9, SB, scale=0.1)))

    def run():
        r = tp.residual(lev, x, z)
        return (r, *tp.pcg(lev, x, r), *tp.increment(lev, x, r, eps))

    ref = run()
    streams = (_spy(monkeypatch, ta, "mult3d_stream"),
               _spy(monkeypatch, ta, "increment3d_stream"))
    halo = (_spy(monkeypatch, sk, "mult3d"),
            _spy(monkeypatch, sk, "increment3d"))
    monkeypatch.setattr(tp, "STREAM", True)
    out = run()
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert (len(streams[0]), len(streams[1])) == (7, 1)
    assert not halo[0] and not halo[1]


def test_stream_seam_ml_solve_same(port_blocked, monkeypatch):
    """A multigrid solve with ``STREAM`` equals the one without: the same
    iteration count and solution."""
    L = tt(bc_coeffs(10, (34, 18, 26)))
    z = interior_only(normal(11, (34, 18, 26), scale=0.1))
    z = tt(z - interior_only(np.full(z.shape, z.sum() / (32 * 16 * 24), F32)))
    levels = tmg.build_levels(L)
    assert levels[0].blocked
    x0 = torch.zeros_like(z)
    xa, ra, na = tmg.ml_solve(levels, x0, z, tol=1e-6)
    calls = _spy(monkeypatch, ta, "mult3d_stream")
    monkeypatch.setattr(tp, "STREAM", True)
    xb, rb, nb = tmg.ml_solve(levels, x0, z, tol=1e-6)
    assert calls and na == nb
    assert torch.equal(xa, xb) and torch.equal(ra, rb)


# --- the bandwidth probes -----------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 9, 13), (5, 8, 8)])
def test_probes_plain_vs_jnp(shape):
    """``C·x`` and ``C·(x + 1e-30·(four wrapped in-plane rolls))``, exactly
    the expressions of the TPU probes' kernel bodies."""
    x = normal(12, shape)
    a = jj(x)
    C = jnp.float32(probes.C)
    copy_j = a * C
    roll_j = C * (a + 1e-30 * (
        jnp.roll(a, 1, axis=-2) + jnp.roll(a, -1, axis=-2)
        + jnp.roll(a, 1, axis=-1) + jnp.roll(a, -1, axis=-1)))
    assert np.array_equal(npy(probes.copy_probe(tt(x))), np.asarray(copy_j))
    assert np.array_equal(npy(probes.roll_probe(tt(x))), np.asarray(roll_j))
    # a spike in a corner of each plane reaches its four neighbours, two of
    # them across the wrap
    t = torch.zeros(shape)
    t[:, 0, 0] = 1e20
    o = probes.roll_probe(t)
    for j, k in ((1, 0), (shape[1] - 1, 0), (0, 1), (0, shape[2] - 1)):
        assert torch.all(o[:, j, k] == np.float32(probes.C) * np.float32(
            np.float32(1e-30) * np.float32(1e20)))
    assert int(torch.count_nonzero(o)) == 5 * shape[0]
