"""Port parity: Poisson operator, PCG smoother and multigrid (torch vs JAX,
and the kernels' plain versions vs the Pallas kernels in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.ops import poisson as jp
from waterlily_tpu.ops import multigrid as jmg
from waterlily_tpu.ops.pallas_stencil import mult3d_pallas, increment3d_pallas
from waterlily_tpu.ops.pallas_kernels import pcg_pallas
from waterlily_tpu_torch.ops import poisson as tp
from waterlily_tpu_torch.ops import multigrid as tmg
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.ops import pcg_kernel as pk

from _torch_parity import (F32, F64, STENCIL_RTOL, normal, interior_only,
                           tt, jj, npy, assert_exact, assert_rel, bc_coeffs)

S3 = (14, 12, 10)


def _levels(S, dtype, seed=0):
    L = bc_coeffs(seed, S, dtype)
    return L, jp.make_level(jj(L), bf16_eps=False), tp.make_level(tt(L))


@pytest.mark.parametrize("dtype", [F32, F64])
def test_make_level(dtype):
    L, lj, lt = _levels(S3, dtype)
    assert_rel(lt.D, lj.D, STENCIL_RTOL[dtype])
    assert_rel(lt.iD, lj.iD, STENCIL_RTOL[dtype])
    assert not lt.blocked   # the kernel tier is CUDA-only


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("with_dot", [False, True])
def test_mult3d_plain_vs_jax(dtype, with_dot):
    L, lj, lt = _levels(S3, dtype)
    x = normal(1, S3, dtype)
    zj = jp.mult(lj, jj(x))
    out = sk.mult3d(lt.L, lt.D, tt(x), with_dot=with_dot)
    z = out[0] if with_dot else out
    assert_rel(z, zj, STENCIL_RTOL[dtype])
    assert_exact(z, tp.mult(lt, tt(x)))
    if with_dot:
        assert_rel(out[1], jnp.sum(zj * jj(x)), 1e-5)


@pytest.mark.parametrize("S", [(14, 12, 10), (13, 10, 12)])
@pytest.mark.parametrize("with_dot", [False, True])
def test_mult3d_plain_vs_pallas(S, with_dot):
    """Against the Pallas kernel in interpret mode; 13 rows at block 2
    leave a ragged tail slab."""
    L, lj, lt = _levels(S, F32, seed=2)
    x = normal(3, S)
    ref = mult3d_pallas(jj(L), lj.D, jj(x), S, interpret=True,
                        with_dot=with_dot, block=2)
    out = sk.mult3d(lt.L, lt.D, tt(x), with_dot=with_dot)
    if with_dot:
        assert_rel(out[0], ref[0], 1e-6)
        assert_rel(out[1], ref[1], 1e-5)
    else:
        assert_rel(out, ref, 1e-6)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_increment3d_plain_vs_jax(dtype):
    L, lj, lt = _levels(S3, dtype)
    x = normal(4, S3, dtype)
    r = interior_only(normal(5, S3, dtype))
    eps = interior_only(normal(6, S3, dtype, 0.1))
    xj, rj = jp.increment(lj, jj(x), jj(r), jj(eps))
    xt, rt = sk.increment3d(lt.L, lt.D, tt(eps), tt(x), tt(r))
    assert_exact(xt, xj)
    assert_rel(rt, rj, STENCIL_RTOL[dtype])


def test_increment3d_plain_vs_pallas():
    S = (13, 10, 12)
    L, lj, lt = _levels(S, F32, seed=7)
    x = normal(8, S)
    r = interior_only(normal(9, S))
    eps = interior_only(normal(10, S, scale=0.1))
    xj, rj = increment3d_pallas(jj(L), lj.D, jj(eps), jj(x), jj(r), S,
                                interpret=True, block=2)
    xt, rt = sk.increment3d(lt.L, lt.D, tt(eps), tt(x), tt(r))
    assert_exact(xt, xj)
    assert_rel(rt, rj, 1e-6)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_residual_mean_corrected(dtype):
    L, lj, lt = _levels(S3, dtype)
    x = normal(11, S3, dtype)
    z = interior_only(normal(12, S3, dtype))
    rj = jp.residual(lj, jj(x), jj(z))
    rt = tp.residual(lt, tt(x), tt(z))
    assert_rel(rt, rj, 1e-5 if dtype is F32 else 1e-12)
    assert abs(float(rt.sum())) < 1e-3


def _pcg_inputs(S, seed):
    L, lj, lt = _levels(S, F32, seed)
    z = interior_only(normal(seed + 1, S, scale=0.1))
    x0 = np.zeros(S, F32)
    r = npy(tp.residual(lt, tt(x0), tt(z)))
    return L, lj, lt, x0, r


@pytest.mark.parametrize("S", [(14, 12, 10), (10, 10, 10)])
def test_pcg_plain_vs_jax(S):
    L, lj, lt, x0, r = _pcg_inputs(S, 13)
    xj, rj = jp.pcg(lj, jj(x0), jj(r))
    xt, rt = tp.pcg(lt, tt(x0), tt(r))
    np.testing.assert_allclose(npy(xt), npy(xj), atol=1e-5)
    np.testing.assert_allclose(npy(rt), npy(rj), atol=1e-5)


@pytest.mark.parametrize("S", [(14, 12, 10), (10, 10, 10)])
def test_pcg_fused_plain_vs_pallas(S):
    """The one-launch PCG's plain version against the Pallas whole-smooth
    kernel in interpret mode (atol of tests/test_pallas.py)."""
    L, lj, lt, x0, r = _pcg_inputs(S, 17)
    xj, rj = pcg_pallas(lj, jj(x0), jj(r), interpret=True)
    xt, rt = pk.pcg_fused(lt, tt(x0), tt(r))
    np.testing.assert_allclose(npy(xt), npy(xj), atol=1e-5)
    np.testing.assert_allclose(npy(rt), npy(rj), atol=1e-5)


def test_pcg_dead_exit():
    """rho below 10·eps marks the smoother dead: x and r come back
    unchanged, as in JAX."""
    L, lj, lt = _levels(S3, F32)
    x = normal(20, S3)
    r = np.zeros(S3, F32)
    xt, rt = tp.pcg(lt, tt(x), tt(r))
    xj, rj = jp.pcg(lj, jj(x), jj(r))
    assert_exact(xt, xj)
    assert_exact(rt, rj)


def test_pcg_gate():
    cuda, f32 = torch.device("cuda"), torch.float32
    assert pk.use_pcg_fused((50, 34, 34), f32, cuda)        # 57,800 cells
    assert not pk.use_pcg_fused((98, 66, 66), f32, cuda)    # fine level
    assert pk.use_pcg_fused((34, 34, 34), f32, cuda)        # 258³'s level 3
    assert not pk.use_pcg_fused((66, 66, 66), f32, cuda)
    assert not pk.use_pcg_fused((50, 34, 34), f32, torch.device("cpu"))
    assert not pk.use_pcg_fused((50, 34, 34), torch.float64, cuda)


# (level, blocks, cells a thread) at the shapes the paths launch pcg_fused
# at: 258³'s 34³ and smaller levels (the sphere's and tgv_3d(256)'s), the
# (96,64,64) sphere's (50,34,34) and smaller, the 2D cases' levels
@pytest.mark.parametrize("S,blocks,k", [
    ((50, 34, 34), 226, 1), ((34, 34, 34), 154, 1), ((26, 18, 18), 33, 1),
    ((18, 18, 18), 23, 1), ((14, 10, 10), 1, 2), ((10, 10, 10), 1, 1),
    ((8, 6, 6), 1, 1), ((6, 6, 6), 1, 1), ((130, 130), 67, 1),
    ((98, 66), 26, 1), ((66, 66), 18, 1), ((50, 34), 1, 2), ((34, 34), 1, 2),
    ((18, 18), 1, 1), ((10, 10), 1, 1)])
def test_pcg_grid_rule(S, blocks, k):
    """The kernel's grid: up to PCG_ONE_BLOCK_MAX cells one block of
    PCG_ONE_BLOCK_THREADS threads with the fewest cells a thread that cover
    the level; above it one cell a thread over as many blocks of
    PCG_THREADS as cover it; every cell owned by one thread."""
    n = int(np.prod(S))
    assert pk.pcg_grid(n) == (blocks, k)
    one = n <= pk.PCG_ONE_BLOCK_MAX
    assert (blocks == 1) == one
    t = pk.PCG_ONE_BLOCK_THREADS if one else pk.PCG_THREADS
    assert (blocks - 1) * k * t < n <= blocks * k * t
    assert one or k == pk.PCG_GRID_CELLS


def test_pcg_grid_rule_caps():
    """A grid larger than the card holds at once doubles the cells a thread;
    a level no launch covers raises."""
    assert pk.pcg_grid(57_800, lambda k: 264) == (226, 1)
    assert pk.pcg_grid(57_800, lambda k: 200) == (113, 2)
    with pytest.raises(ValueError, match="covers"):
        pk.pcg_grid(57_800, lambda k: 64)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_restrict_prolongate(dtype):
    S = (18, 14, 10)
    b = normal(21, S, dtype)
    assert_rel(tmg.restrict(tt(b)), jmg.restrict(jj(b)), 1e-12)
    xc = normal(22, tmg.coarse_shape(S), dtype)
    assert_exact(tmg.prolongate(tt(xc)), jmg.prolongate(jj(xc), S))
    L = bc_coeffs(23, S, dtype)
    assert_exact(tmg.restrict_L(tt(L)), jmg.restrict_L(jj(L)))


@pytest.mark.parametrize("S", [(18, 14, 10), (34, 18, 18), (66, 34)])
def test_level_counts(S):
    assert tmg.n_levels(S) == jmg.n_levels(S)
    assert tmg.coarse_shape(S) == jmg.coarse_shape(S)


def _solve_inputs(S, dtype, seed):
    L = bc_coeffs(seed, S, dtype)
    z = interior_only(normal(seed + 1, S, dtype, 0.1))
    z = z - interior_only(np.full(S, z.sum() / np.prod([s - 2 for s in S]),
                                  dtype))
    return L, z


@pytest.mark.parametrize("dtype", [F32, F64])
def test_ml_solve(dtype):
    S = (34, 18, 18)
    L, z = _solve_inputs(S, dtype, 24)
    levj = jmg.build_levels(jj(L), bf16_eps=False)
    levt = tmg.build_levels(tt(L))
    assert len(levj) == len(levt)
    for a, b in zip(levt, levj):
        assert_rel(a.D, b.D, STENCIL_RTOL[dtype])
    x0 = np.zeros(S, dtype)
    xj, rj, nj = jmg.ml_solve(levj, jj(x0), jj(z), tol=1e-6)
    xt, rt, nt = tmg.ml_solve(levt, tt(x0), tt(z), tol=1e-6)
    assert nt == int(nj)
    tol = 1e-4 if dtype is F32 else 1e-10
    assert_rel(xt, xj, tol)
    xf, _, nf = tmg.ml_solve(levt, tt(x0), tt(z), fixed=nt)
    assert nf == nt and torch.equal(xf, xt)


def test_poisson_solve():
    S = (18, 14, 10)
    L, z = _solve_inputs(S, F64, 25)
    lj = jp.make_level(jj(L), bf16_eps=False)
    lt = tp.make_level(tt(L))
    x0 = np.zeros(S, F64)
    xj, rj, nj = jp.poisson_solve(lj, jj(x0), jj(z), tol=1e-8)
    xt, rt, nt = tp.poisson_solve(lt, tt(x0), tt(z), tol=1e-8)
    assert nt == int(nj)
    assert_rel(xt, xj, 1e-9)
