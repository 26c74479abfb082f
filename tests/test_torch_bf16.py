"""Port parity of bf16 search directions (`PoissonLevel.bf16_eps`,
``Simulation(smoother_bf16=True)``): the bf16 forms of the stencil
kernels' plain versions against the Pallas kernels in interpret mode, a
bf16-direction level's `pcg`, `increment` and `jacobi` and a multigrid
solve against the JAX package's, the defaults, and `convert` carrying the
flag.  A level is made blocked on the port side by `dataclasses.replace`
or the kernel gate patched, on the JAX side as its own tests do it
(`tests/test_pallas_stencil.py`: `use_blocked` patched, the kernels in
interpret mode)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.ops import multigrid as jmg
from waterlily_tpu.ops import poisson as jp
from waterlily_tpu.ops import pallas_stencil as ps
from waterlily_tpu_torch.convert import levels_from_numpy, levels_to
from waterlily_tpu_torch.ops import multigrid as tmg
from waterlily_tpu_torch.ops import poisson as tp
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.simulation import Simulation

from _torch_parity import (F32, STENCIL_RTOL, normal, interior_only, tt, jj,
                           npy, assert_rel, bc_coeffs)

S = (20, 18, 22)
SM = (34, 18, 26)   # a multigrid shape: three levels, the finest blocked
bf16 = torch.bfloat16


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _max_err(a, ref):
    return float(np.max(np.abs(_f32(a) - _f32(ref))))


@pytest.fixture
def jax_blocked(monkeypatch):
    """JAX's gate makes levels of 18+ cells a side blocked, and its stencil
    kernels run in interpret mode."""
    monkeypatch.setattr(ps, "use_blocked", lambda S_, dt_, sharded=False:
                        (not sharded) and min(S_) >= 18)
    for name in ("mult3d_pallas", "increment3d_pallas"):
        orig = getattr(ps, name)
        monkeypatch.setattr(ps, name, lambda *a, _o=orig, **k: _o(
            *a, **{**k, "interpret": True}))


@pytest.fixture
def port_blocked(monkeypatch):
    """The port's kernel gate makes the same levels blocked on the CPU
    (the wrappers then run their plain versions)."""
    monkeypatch.setattr(sk, "use_blocked", lambda S_, dt_, dev:
                        len(S_) == 3 and min(S_) >= 18)


def _levels(seed=0):
    L = bc_coeffs(seed, S)
    lj = jp.make_level(jj(L), bf16_eps=False).replace(blocked=True,
                                                       bf16_eps=True)
    lt = dataclasses.replace(tp.make_level(tt(L)), blocked=True,
                             bf16_eps=True)
    return lj, lt


def _residual(lt, seed):
    rhs = interior_only(normal(seed, S, scale=0.1))
    return npy(tp.residual(lt, torch.zeros(S), tt(rhs)))


# --- the bf16 forms of mult3d / increment3d ---------------------------------

@pytest.mark.parametrize("with_dot", [False, True])
def test_mult3d_bf16_plain_vs_pallas(with_dot):
    """A bf16 x upcast and the operator applied in f32 (z and the dot f32),
    against `mult3d_pallas` with the same bf16 x; 20 rows at block 3 leave
    a ragged tail slab."""
    L = bc_coeffs(1, S)
    lj = jp.make_level(jj(L), bf16_eps=False)
    lt = tp.make_level(tt(L))
    x = normal(2, S)
    ref = ps.mult3d_pallas(jj(L), lj.D, jj(x).astype(jnp.bfloat16), S,
                           interpret=True, block=3, with_dot=with_dot)
    out = sk.mult3d(lt.L, lt.D, tt(x).to(bf16), with_dot=with_dot)
    z, zj = (out[0], ref[0]) if with_dot else (out, ref)
    assert z.dtype == torch.float32
    assert_rel(z, zj, STENCIL_RTOL[F32])
    assert torch.equal(z, sk.mult3d(lt.L, lt.D, tt(x).to(bf16).float()))
    if with_dot:
        assert_rel(out[1], ref[1], 1e-5)


def test_increment3d_bf16_plain_vs_pallas():
    L = bc_coeffs(3, S)
    lj = jp.make_level(jj(L), bf16_eps=False)
    lt = tp.make_level(tt(L))
    x, r = normal(4, S), interior_only(normal(5, S))
    eps = interior_only(normal(6, S, scale=0.1))
    xj, rj = ps.increment3d_pallas(jj(L), lj.D, jj(eps).astype(jnp.bfloat16),
                                   jj(x), jj(r), S, interpret=True, block=2)
    xt, rt = sk.increment3d(lt.L, lt.D, tt(eps).to(bf16), tt(x), tt(r))
    assert xt.dtype == rt.dtype == torch.float32
    assert np.array_equal(npy(xt), np.asarray(xj))
    assert_rel(rt, rj, STENCIL_RTOL[F32])


# --- a bf16-direction level against JAX's ----------------------------------

def _bf16_promoted_update(lt, x, r):
    """The first PCG update with the f32 step times the bf16 direction
    left to PyTorch's promotion (a 0-d f32 tensor times a bf16 tensor is
    bf16; JAX's product is f32): the fault the parity test must catch."""
    z = r * lt.iD
    eps = z.to(bf16)
    zz, denom = sk.mult3d(lt.L, lt.D, eps, with_dot=True)
    upd = (torch.sum(r * z) / denom).to(torch.float32)
    return x + upd * eps


def test_pcg_bf16_one_iteration_vs_jax(jax_blocked):
    """One iteration: both packages round the same r∘iD, so x and r agree
    to f32 rounding (1e-6); with the step times the bf16 direction rounded
    to bf16 the x update moves by ~2^-9 of itself and fails."""
    lj, lt = _levels()
    x, r = normal(7, S), _residual(lt, 8)
    xj, rj = jp.pcg(lj, jj(x), jj(r), it=1)
    xt, rt = tp.pcg(lt, tt(x), tt(r), it=1)
    assert xt.dtype == rt.dtype == torch.float32
    assert _max_err(xt, xj) <= 1e-6
    assert _max_err(rt, rj) <= 1e-6
    assert _max_err(_bf16_promoted_update(lt, tt(x), tt(r)), xj) > 1e-5


def test_pcg_bf16_vs_jax(jax_blocked):
    """Three iterations.  From the second direction on, JAX's f32 value
    (other sum order in beta, FMA contraction) can round to the
    neighbouring bf16 value at a few cells, so x and r are held on their
    mean difference (2e-6) and their largest (one bf16 ulp of a direction
    spread by A: 2e-3); a bf16-promoted product fails the mean."""
    lj, lt = _levels()
    x, r = normal(7, S), _residual(lt, 8)
    xj, rj = jp.pcg(lj, jj(x), jj(r), it=3)
    xt, rt = tp.pcg(lt, tt(x), tt(r), it=3)
    for a, ref in ((xt, xj), (rt, rj)):
        assert float(np.mean(np.abs(_f32(a) - _f32(ref)))) <= 2e-6
        assert _max_err(a, ref) <= 2e-3


def test_increment_and_jacobi_bf16_vs_jax(jax_blocked):
    """`increment` rounds its eps (an f32 correction, as the V-cycle hands
    it) and `jacobi` its r∘iD to bf16 before x and r are updated."""
    lj, lt = _levels()
    x, r = normal(9, S), _residual(lt, 10)
    eps = interior_only(normal(11, S, scale=0.1))
    xj, rj = jp.increment(lj, jj(x), jj(r), jj(eps))
    xt, rt = tp.increment(lt, tt(x), tt(r), tt(eps))
    assert np.array_equal(npy(xt), np.asarray(xj))
    assert_rel(rt, rj, STENCIL_RTOL[F32])
    assert not np.array_equal(npy(xt), x + eps)    # eps was rounded
    xj, rj = jp.jacobi(lj, jj(x), jj(r))
    xt, rt = tp.jacobi(lt, tt(x), tt(r))
    assert np.array_equal(npy(xt), np.asarray(xj))
    assert_rel(rt, rj, STENCIL_RTOL[F32])


def test_ml_solve_bf16_vs_jax(jax_blocked, port_blocked):
    """A multigrid solve on levels built with ``bf16_eps=True`` (the
    finest blocked): the same iteration count as JAX's and solutions within
    1e-4 relative."""
    L = bc_coeffs(12, SM)
    z = interior_only(normal(13, SM, scale=0.1))
    z = z - interior_only(np.full(SM, z.sum() / np.prod([s - 2 for s in SM]),
                                  F32))
    levj = jmg.build_levels(jj(L), bf16_eps=True)
    levt = tmg.build_levels(tt(L), bf16_eps=True)
    assert [l.bf16_eps for l in levt] == [l.bf16_eps for l in levj] \
        == [True] + [False] * (len(levt) - 1)
    x0 = np.zeros(SM, F32)
    xj, rj, nj = jmg.ml_solve(levj, jj(x0), jj(z), tol=1e-6)
    xt, rt, nt = tmg.ml_solve(levt, tt(x0), tt(z), tol=1e-6)
    assert nt == int(nj)
    assert_rel(xt, xj, 1e-4)


# --- defaults and carrying the flag across ----------------------------------

def test_defaults_are_f32_directions_and_seams_off(port_blocked):
    assert tp.KDOT is False and tp.KAXPY is False and tp.PCG_BLOCKED is False
    dims = (16, 16, 16)
    for flag, want in ((None, False), (False, False), (True, True)):
        kw = {} if flag is None else {"smoother_bf16": flag}
        sim = Simulation(dims, (1.0, 0.0, 0.0), 8.0, device="cpu", **kw)
        assert sim.levels[0].blocked
        assert [l.bf16_eps for l in sim.levels] == \
            [want and l.blocked for l in sim.levels]
        assert tmg.update_levels(sim.levels, sim.flow.mu0)[0].bf16_eps is want


def test_no_blocked_level_on_the_cpu():
    """Without the patched gate no CPU level is blocked, so
    ``smoother_bf16=True`` changes nothing there."""
    sim = Simulation((16, 16, 16), (1.0, 0.0, 0.0), 8.0, device="cpu",
                     smoother_bf16=True)
    assert not any(l.blocked or l.bf16_eps for l in sim.levels)


def test_convert_carries_bf16_eps(jax_blocked, port_blocked, monkeypatch):
    """JAX levels built with ``bf16_eps`` come back with it through
    `levels_from_numpy` and keep it through `levels_to`; where the port's
    gate leaves a copy unblocked, the flag goes with the blocking."""
    levj = jmg.build_levels(jj(bc_coeffs(14, SM)), bf16_eps=True)
    dicts = [{"L": np.asarray(l.L), "D": np.asarray(l.D),
              "iD": np.asarray(l.iD), "bf16_eps": l.bf16_eps} for l in levj]
    want = [l.bf16_eps for l in levj]
    assert want[0]
    levt = levels_from_numpy(dicts, "cpu")
    assert [l.bf16_eps for l in levt] == want
    assert [l.bf16_eps for l in levels_to(levt, "cpu")] == want
    monkeypatch.setattr(sk, "use_blocked", lambda S_, dt_, dev: False)
    assert not any(l.bf16_eps for l in levels_to(levt, "cpu"))
