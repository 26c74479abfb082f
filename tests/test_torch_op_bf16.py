"""Port parity of the bf16 operator shadows (`PoissonLevel.L16`/``D16``/
``iD16``, ``Simulation(op_bf16=True)``): `make_level`'s shadows bit for
bit against the JAX package's, the plain bf16-L operator against the Pallas
kernels in interpret mode, a shadowed level's `_rid`, `residual`,
`increment`, `jacobi`, `pcg` (with the ``KDOT``/``KAXPY`` seams) and
`attic.pcg_blocked` and a multigrid solve against JAX's, and the shadows
kept by `update_levels`, `convert` and `Simulation`.  A level is made
blocked on the JAX side as its own tests do it (`use_blocked` patched, the
kernels in interpret mode), on the port's side by patching
`stencil_kernels.use_blocked`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.ops import attic as ja
from waterlily_tpu.ops import multigrid as jmg
from waterlily_tpu.ops import pallas_stencil as ps
from waterlily_tpu.ops import poisson as jp
from waterlily_tpu_torch.convert import levels_from_numpy, levels_to
from waterlily_tpu_torch.ops import attic as ta
from waterlily_tpu_torch.ops import multigrid as tmg
from waterlily_tpu_torch.ops import poisson as tp
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.simulation import Simulation

from _torch_parity import (F32, STENCIL_RTOL, normal, interior_only, tt, jj,
                           npy, assert_rel, bc_coeffs)

S = (20, 18, 22)
bf16 = torch.bfloat16


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(a, ref, atol):
    err = float(np.max(np.abs(_f32(a) - _f32(ref))))
    assert err <= atol, f"max err {err} > {atol}"


def _bits(a):
    """The 16-bit patterns of a bf16 torch or JAX array."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


@pytest.fixture
def jax_blocked(monkeypatch):
    """JAX's gate makes levels of 18+ cells a side blocked, and its blocked
    kernels run in interpret mode."""
    monkeypatch.setattr(ps, "use_blocked", lambda S_, dt_, sharded=False:
                        (not sharded) and min(S_) >= 18)
    for mod, name in ((ps, "mult3d_pallas"), (ps, "increment3d_pallas"),
                      (ja, "dot3d_pallas"), (ja, "pcg_axpy_pallas")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, **k: _o(
            *a, **{**k, "interpret": True}))


@pytest.fixture
def port_blocked(monkeypatch):
    """The port's kernel gate makes the same levels blocked on the CPU
    (the wrappers then run their plain versions)."""
    monkeypatch.setattr(sk, "use_blocked", lambda S_, dt_, dev:
                        len(S_) == 3 and min(S_) >= 18)


def _dead_coeffs(seed, shape=S):
    """Positive face coefficients with every face of a 3-cell cube zeroed,
    so its centre cell has D = 0 (a dead cell, iD = 0)."""
    L = bc_coeffs(seed, shape)
    L[:, 5:8, 5:8, 5:8] = 0.0
    L[0, 8, 6, 6] = L[1, 6, 8, 6] = L[2, 6, 6, 8] = 0.0
    return L


def _levels(seed=0):
    L = _dead_coeffs(seed)
    lj = jp.make_level(jj(L), op_bf16=True)
    lt = tp.make_level(tt(L), op_bf16=True)
    assert lj.L16 is not None and lt.L16 is not None
    return lj, lt


def _residual(lt, seed):
    rhs = interior_only(normal(seed, S, scale=0.1))
    return npy(tp.residual(lt, torch.zeros(S), tt(rhs)))


# --- (a) make_level's shadows ------------------------------------------------

def test_make_level_shadows_bit_equal_to_jax(jax_blocked, port_blocked):
    """L16, D16 and iD16 bit for bit; D16 is the f32 diagonal of the rounded
    taps (not bf16(D)); the dead-cell zeros survive; bf16 directions are
    forced off."""
    lj, lt = _levels()
    assert lt.L16.dtype == lt.iD16.dtype == bf16
    assert lt.D16.dtype == torch.float32
    assert np.array_equal(_bits(lt.L16), _bits(lj.L16))
    assert np.array_equal(_bits(lt.iD16), _bits(lj.iD16))
    assert np.array_equal(npy(lt.D16), np.asarray(lj.D16))
    assert torch.equal(lt.D16, tp._diag(lt.L16.float()))
    dead = npy(lt.iD) == 0
    assert dead[6, 6, 6] and dead[1:-1, 1:-1, 1:-1].sum() < dead.size // 100
    assert np.array_equal(npy(lt.iD16 == 0), dead)
    assert not lt.bf16_eps and not lj.bf16_eps
    assert not tp.make_level(lt.L, bf16_eps=True, op_bf16=True).bf16_eps
    L16, D16 = tp._opLD(lt)
    assert L16 is lt.L16 and D16 is lt.D16


def test_bf16_op_default_and_kwarg(port_blocked, monkeypatch):
    """``BF16_OP`` is False; ``op_bf16`` overrides it both ways; an
    unblocked level never carries shadows."""
    assert tp.BF16_OP is False and tp.STREAM is False
    L = tt(bc_coeffs(1, S))
    assert tp.make_level(L).L16 is None
    assert tp.make_level(L, op_bf16=True).L16 is not None
    monkeypatch.setattr(tp, "BF16_OP", True)
    assert tp.make_level(L).L16 is not None
    lev = tp.make_level(L, op_bf16=False, bf16_eps=True)
    assert lev.L16 is None and lev.bf16_eps
    small = tt(bc_coeffs(1, (10, 10, 10)))
    assert tp.make_level(small, op_bf16=True).L16 is None


# --- (b) the bf16-L forms of mult3d / increment3d ---------------------------

@pytest.mark.parametrize("block", [2, 3])
@pytest.mark.parametrize("with_dot", [False, True])
def test_mult3d_bf16_L_plain_vs_pallas(with_dot, block):
    """L16 upcast and the operator applied in f32 with D16, against
    `mult3d_pallas` given L16/D16 (block 3 leaves a ragged tail slab of the
    20 rows)."""
    L = tt(_dead_coeffs(2))
    L16, D16, _ = tp.operator_shadows(L)
    x = normal(3, S)
    ref = ps.mult3d_pallas(jnp.asarray(_f32(L16)).astype(jnp.bfloat16),
                           jj(npy(D16)), jj(x), S, interpret=True,
                           block=block, with_dot=with_dot)
    out = sk.mult3d(L16, D16, tt(x), with_dot=with_dot)
    z, zj = (out[0], ref[0]) if with_dot else (out, ref)
    assert z.dtype == torch.float32
    assert_rel(z, zj, STENCIL_RTOL[F32])
    assert torch.equal(z, sk.mult3d(L16.float(), D16, tt(x)))
    if with_dot:
        assert_rel(out[1], ref[1], 1e-5)


@pytest.mark.parametrize("block", [2, 3])
def test_increment3d_bf16_L_plain_vs_pallas(block):
    L = tt(_dead_coeffs(4))
    L16, D16, _ = tp.operator_shadows(L)
    x, r = normal(5, S), interior_only(normal(6, S))
    eps = interior_only(normal(7, S, scale=0.1))
    xj, rj = ps.increment3d_pallas(
        jnp.asarray(_f32(L16)).astype(jnp.bfloat16), jj(npy(D16)), jj(eps),
        jj(x), jj(r), S, interpret=True, block=block)
    xt, rt = sk.increment3d(L16, D16, tt(eps), tt(x), tt(r))
    assert xt.dtype == rt.dtype == torch.float32
    assert np.array_equal(npy(xt), np.asarray(xj))
    assert_rel(rt, rj, STENCIL_RTOL[F32])


# --- (c) a shadowed level against JAX's --------------------------------------

def test_rid_residual_increment_jacobi_vs_jax(jax_blocked, port_blocked):
    """`_rid` reads iD16 (exact), `residual` applies L16/D16 and keeps the
    f32 iD == 0 mask, `increment` and `jacobi` apply the rounded operator."""
    lj, lt = _levels()
    r = _residual(lt, 8)
    zt = tp._rid(lt, tt(r))
    assert zt.dtype == torch.float32
    assert np.array_equal(npy(zt), np.asarray(jp._rid(lj, jj(r))))
    assert torch.equal(zt, tt(r) * lt.iD16.float())
    x, z = normal(9, S), interior_only(normal(10, S, scale=0.1))
    rt = tp.residual(lt, tt(x), tt(z))
    assert_rel(rt, jp.residual(lj, jj(x), jj(z)), STENCIL_RTOL[F32])
    eps = interior_only(normal(11, S, scale=0.1))
    xj, rj = jp.increment(lj, jj(x), jj(r), jj(eps))
    xt, rt = tp.increment(lt, tt(x), tt(r), tt(eps))
    assert np.array_equal(npy(xt), np.asarray(xj))
    assert_rel(rt, rj, STENCIL_RTOL[F32])
    xj, rj = jp.jacobi(lj, jj(x), jj(r))
    xt, rt = tp.jacobi(lt, tt(x), tt(r))
    assert np.array_equal(npy(xt), np.asarray(xj))
    assert_rel(rt, rj, STENCIL_RTOL[F32])


def test_rounded_operator_differs_from_f32(port_blocked):
    """The shadowed operator is the rounded one: its A·x moves off the f32
    level's by more than f32 rounding (so a test that applied L, D would
    fail the comparisons above)."""
    L = tt(_dead_coeffs(12))
    l32, l16 = tp.make_level(L), tp.make_level(L, op_bf16=True)
    x = tt(normal(13, S))
    d = float(torch.max(torch.abs(tp.mult(l16, x) - tp.mult(l32, x))))
    assert d > 1e-3


@pytest.mark.parametrize("flags", [(), ("KDOT",), ("KAXPY",),
                                   ("KDOT", "KAXPY")])
def test_pcg_shadowed_vs_jax(flags, jax_blocked, port_blocked, monkeypatch):
    """Six iterations on a shadowed level (f32 directions), with the seams
    set in both packages: x and r within 2e-5 (the tolerance of
    `test_torch_attic.py`); the seams' kernels read iD16."""
    for f in flags:
        monkeypatch.setattr(jp, f, True)
        monkeypatch.setattr(tp, f, True)
    seen = []
    for name in ("dot3d", "pcg_axpy"):
        orig = getattr(ta, name)
        monkeypatch.setattr(tp.at, name, lambda *a, _o=orig, **k: (
            seen.extend(t.dtype for t in a if isinstance(t, torch.Tensor)),
            _o(*a, **k))[1])
    lj, lt = _levels()
    x, r = normal(14, S), _residual(lt, 15)
    xj, rj = jp.pcg(lj, jj(x), jj(r))
    xt, rt = tp.pcg(lt, tt(x), tt(r))
    _close(xt, xj, 2e-5)
    _close(rt, rj, 2e-5)
    assert (bf16 in seen) == bool(flags)


def test_pcg_blocked_shadowed_vs_jax(jax_blocked, port_blocked):
    """The fused-iteration smoother on a shadowed level reads L16/D16 and
    iD16 in both packages: within 2e-5."""
    lj, lt = _levels()
    x, r = normal(16, S), _residual(lt, 17)
    xj, rj = ja.pcg_blocked(lj, jj(x), jj(r), it=6, interpret=True)
    xt, rt = ta.pcg_blocked(lt, tt(x), tt(r), it=6)
    _close(xt, xj, 2e-5)
    _close(rt, rj, 2e-5)


def test_smooth_keeps_shadowed_levels_off_pcg_fused(port_blocked,
                                                    monkeypatch):
    """`smooth` never sends a shadowed level to the one-launch kernel,
    whose gate here takes every level."""
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    calls = []
    monkeypatch.setattr(pk, "use_pcg_fused", lambda *a: True)
    monkeypatch.setattr(pk, "pcg_fused", lambda *a: calls.append(1) or a[1:3])
    lt = tp.make_level(tt(_dead_coeffs(0)), op_bf16=True)
    assert lt.L16 is not None
    r = tt(_residual(lt, 18))
    tp.smooth(lt, torch.zeros(S), r)
    assert not calls
    tp.smooth(tp.make_level(lt.L), torch.zeros(S), r)
    assert len(calls) == 1


# --- (d) a multigrid solve ----------------------------------------------------

def _band_like(seed, shape=(18, 18, 18)):
    """Mostly exact 1.0 coefficients (bf16-exact far field) with a
    fractional shell on 15% of the faces, like a body's μ₀
    (`tests/test_pallas_stencil.py`'s shadow-solve coefficients, drawn with
    numpy)."""
    rng = np.random.default_rng(seed)
    L = np.ones((3,) + shape, F32)
    frac = rng.uniform(size=L.shape) < 0.15
    L = np.where(frac, rng.uniform(size=L.shape), L).astype(F32)
    from waterlily_tpu_torch.ops.bc import bc_vector_planes
    L = npy(bc_vector_planes(tt(L), (0.0,) * 3))
    z = interior_only(rng.standard_normal(shape).astype(F32))
    z = z - interior_only(np.full(shape, z.sum() / 16 ** 3, F32))
    return L, z


def test_ml_solve_shadowed_vs_jax(jax_blocked, port_blocked):
    """The same iteration count as JAX's, solutions within 1e-4 relative
    (tighter than the 0.05·std bound of JAX's own bf16-vs-f32 test)."""
    L, z = _band_like(19)
    levj = jmg.build_levels(jj(L), op_bf16=True)
    levt = tmg.build_levels(tt(L), op_bf16=True)
    assert [l.L16 is not None for l in levt] == \
        [l.L16 is not None for l in levj] == [True] + [False] * (len(levt) - 1)
    x0 = np.zeros(L.shape[1:], F32)
    xj, rj, nj = jmg.ml_solve(levj, jj(x0), jj(z), tol=1e-4, itmx=8)
    xt, rt, nt = tmg.ml_solve(levt, tt(x0), tt(z), tol=1e-4, itmx=8)
    assert nt == int(nj)
    assert_rel(xt, xj, 1e-4)
    xj = np.asarray(xj)
    assert float(np.max(np.abs(npy(xt) - xj))) < 0.05 * float(np.std(xj))


# --- (e)-(g) carrying the shadows -------------------------------------------

def test_update_levels_keeps_the_shadows(port_blocked, monkeypatch):
    """A shadowed stack stays shadowed whatever `BF16_OP` says, and a stack
    without shadows stays without."""
    L = tt(_band_like(20)[0])
    on = tmg.build_levels(L, op_bf16=True)
    off = tmg.build_levels(L, op_bf16=False)
    monkeypatch.setattr(tp, "BF16_OP", True)
    assert tmg.update_levels(on, L)[0].L16 is not None
    assert tmg.update_levels(off, L)[0].L16 is None
    monkeypatch.setattr(tp, "BF16_OP", False)
    new = tmg.update_levels(on, L)
    assert new[0].L16 is not None and not new[0].bf16_eps
    assert torch.equal(new[0].L16, on[0].L16)


def test_convert_carries_the_shadows(jax_blocked, port_blocked, monkeypatch):
    """JAX levels with shadows come back bit for bit through
    `levels_from_numpy` and keep them through `levels_to`; a copy the gate
    leaves unblocked drops them."""
    levj = jmg.build_levels(jj(_band_like(21)[0]), op_bf16=True)
    dicts = [{"L": np.asarray(l.L), "D": np.asarray(l.D),
              "iD": np.asarray(l.iD),
              **({} if l.L16 is None else {
                  "L16": np.asarray(l.L16), "D16": np.asarray(l.D16),
                  "iD16": np.asarray(l.iD16)})} for l in levj]
    levt = levels_from_numpy(dicts, "cpu")
    assert levt[0].L16 is not None and levt[1].L16 is None
    assert np.array_equal(_bits(levt[0].L16), _bits(levj[0].L16))
    assert np.array_equal(_bits(levt[0].iD16), _bits(levj[0].iD16))
    assert np.array_equal(npy(levt[0].D16), np.asarray(levj[0].D16))
    back = levels_to(levt, "cpu")
    assert all(torch.equal(getattr(back[0], k), getattr(levt[0], k))
               for k in ("L16", "D16", "iD16"))
    monkeypatch.setattr(sk, "use_blocked", lambda S_, dt_, dev: False)
    assert all(l.L16 is None for l in levels_to(levt, "cpu"))


def test_simulation_op_bf16(port_blocked):
    """With the gate patched the fine level carries shadows (and f32
    directions, even with ``smoother_bf16``) and the steps stay finite."""
    sim = Simulation((16, 16, 16), (1.0, 0.0, 0.0), 8.0, device="cpu",
                     op_bf16=True, smoother_bf16=True)
    lv = sim.levels[0]
    assert lv.blocked and lv.L16 is not None and not lv.bf16_eps
    assert all(l.L16 is None for l in sim.levels[1:])
    sim.steps(2, remeasure=False)
    sim.measure()
    assert sim.levels[0].L16 is not None
    assert all(bool(torch.isfinite(t).all())
               for t in (sim.flow.u, sim.flow.p, sim.flow.dt))


def test_simulation_op_bf16_without_blocked_levels():
    """On the CPU (no blocked level) ``op_bf16=True`` changes nothing, as
    in JAX on the CPU."""
    runs = []
    for flag in (False, True):
        sim = Simulation((16, 16, 16), (1.0, 0.0, 0.0), 8.0, device="cpu",
                         op_bf16=flag)
        assert not any(l.L16 is not None for l in sim.levels)
        sim.steps(2, remeasure=False)
        runs.append(sim)
    assert runs[0].pois_n == runs[1].pois_n
    assert torch.equal(runs[0].flow.u, runs[1].flow.u)
