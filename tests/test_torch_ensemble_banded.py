"""Port parity: the banded ensemble under `torch.func.vmap` (each member its
own body window) and `vmap` over `jvp` through the adaptive solve.

(a) `ana_mult3d`'s member form (its CPU form: `vmap` of the plain version)
against `jax.vmap` of the Pallas kernel in interpret mode, f64, three
members of a ragged shape: z bit for bit, the dot within 1e-12.
(b) `measure_fields_banded` and `grid.band_box_start` under `vmap` over a
body's position (member corners that differ; box bodies, which both
packages round alike) against `jax.vmap` of JAX's: corners and the
centre distances equal, the fields within the dense measurement's 1e-12
(the kernel moments' sin and cos round differently in XLA), and bit for
bit the port's dense measurement and each member's own run.
(c) `build_levels` with a batched corner at (66,50,50), box (14,14,14)
(three banded levels) against JAX's batched stack: corners and flags
equal on every level, the tensors bit for bit; JAX's stack carried
across with its member axis (`convert.levels_from_numpy`), each banded
level's corners a tensor, and a batched state's (`flow_from_numpy`).
(d) Two adaptive steps of a sphere swept over its position with banded
BDIM and banded levels (two of them at (34,26,26), box (12,10,10)), the
stencil gates open (so `ana_mult3d`'s member form is on the path), against
JAX's `jit(vmap(...))`: each member's pois_n equal, u and p within 1e-10;
the port's own per-member runs bit for bit; its dense (``bbox`` off)
ensemble with pois_n equal.
(e) `vmap` over `jvp` of `tests/test_ensemble.py`'s spinning-cylinder
lift through the adaptive solve (``fixed_iters=None``), in both orders and
under a nested `vmap`, against JAX's `jit(vmap(jvp))`: primal and tangent
within 1e-9 relative; each adaptive loop (`ml_solve` with its residual
trace, `poisson_solve`) under `vmap(jvp)` bit for bit each member's own
`jvp`; `vmap(grad)` raises in both packages.
f64 on both sides.
"""
import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import flow as jf
from waterlily_tpu.body import (AutoBody as JBody,
                                measure_fields_banded as jbanded)
from waterlily_tpu.grid import band_box_start as jstart
from waterlily_tpu.metrics import total_force as jforce
from waterlily_tpu.ops.multigrid import build_levels as jbuild
from waterlily_tpu.ops.pallas_stencil import ana_mult3d_pallas
from waterlily_tpu_torch import flow as tf
from waterlily_tpu_torch.convert import flow_from_numpy, levels_from_numpy
from waterlily_tpu_torch.body import (AutoBody, measure_fields,
                                      measure_fields_banded)
from waterlily_tpu_torch.grid import band_box_start
from waterlily_tpu_torch.metrics import total_force
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.ops.multigrid import build_levels

from _torch_parity import F64, normal, uniform, tt, jj, npy, assert_rel
from test_torch_ensemble import _force_fn
from test_torch_ensemble_3d import _gates_open

f64 = torch.float64
M = 3


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread (a plain form's sums, and so its bits, can depend on
    the thread count), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def member_calls(monkeypatch):
    """Spy on `stencil_kernels.member_form`: the member count of each of
    its calls, by wrapper."""
    calls = collections.defaultdict(list)
    real = sk.member_form

    def spy(name, *args):
        calls[name].append(args[sk._MEMBERS[name][1]].shape[0])
        return real(name, *args)
    monkeypatch.setattr(sk, "member_form", spy)
    return calls


# --- (a) ana_mult3d's member form against JAX's batched kernel -------------

@pytest.mark.parametrize("perdir", [(), (1,), (0, 2)])
@pytest.mark.parametrize("with_dot", [False, True])
def test_ana_mult3d_members_vs_pallas(member_calls, with_dot, perdir):
    S = (13, 9, 11)
    x = np.stack([normal(60 + m, S, F64) for m in range(M)])
    got = torch.func.vmap(lambda x: sk.ana_mult3d(x, 2.0, perdir,
                                                  with_dot))(tt(x))
    ref = jax.vmap(lambda x: ana_mult3d_pallas(
        x, 2.0, perdir, with_dot=with_dot, interpret=True, block=5))(jj(x))
    assert member_calls["ana_mult3d"] == [M]
    z, zj = (got[0], ref[0]) if with_dot else (got, ref)
    assert np.array_equal(npy(z), np.asarray(zj))
    if with_dot:
        assert got[1].shape == (M,)
        for m in range(M):
            assert_rel(got[1][m], ref[1][m], 1e-12)


# --- (b) the narrow-band measurement under vmap --------------------------

S_BOX = (40, 20, 18)
W_BOX = (16, 14, 12)
BOX_X = [10.0, 14.3, 19.1]
HALF = (3.0, 2.5, 2.0)


def _box_bodies():
    """A box at axis-0 position ``c`` moving along axis 1 (sdf max|x-c|-h:
    subtractions, abs and max only), on both packages."""
    def tbody(c):
        ctr = lambda t: torch.stack([c, 9.0 + 0.5 * t,
                                     torch.full_like(c, 8.0)])
        half = lambda x: torch.tensor(HALF, dtype=x.dtype)
        return AutoBody(lambda x, t: torch.max(torch.abs(x) - half(x)),
                        lambda x, t: x - ctr(t).to(x.dtype))

    def jbody(c):
        ctr = lambda t: jnp.stack([c, 9.0 + 0.5 * t, jnp.full_like(c, 8.0)])
        return JBody(
            lambda x, t: jnp.max(jnp.abs(x) - jnp.asarray(HALF, x.dtype)),
            lambda x, t: x - ctr(t).astype(x.dtype))
    return tbody, jbody


def test_measure_fields_banded_under_vmap_against_jax():
    tbody, jbody = _box_bodies()
    port = lambda c: measure_fields_banded(tbody(c), S_BOX, 0.3, 1.0, (),
                                           False, f64, W_BOX, "cpu")
    *fields, start = torch.func.vmap(port)(torch.tensor(BOX_X, dtype=f64))

    def jax_one(c):
        out = jbanded(jbody(c), S_BOX, 0.3, 1.0, (), False, jnp.float64,
                      W_BOX)
        return out, jstart(out[3] < 3.0, W_BOX)
    jfields, jcorner = jax.jit(jax.vmap(jax_one))(jnp.asarray(BOX_X))
    assert start.dtype == torch.int64 and start.shape == (M, 3)
    assert start.tolist() == np.asarray(jcorner).tolist()
    assert len({tuple(s) for s in start.tolist()}) == M
    assert torch.equal(start, torch.func.vmap(
        lambda d: band_box_start(d < 3.0, W_BOX))(fields[3]))
    # the sdf, and so d_center and the corners, round alike; the kernel
    # moments take sin and cos, which XLA and PyTorch round differently:
    # the dense measurement's tolerance (tests/test_torch_body.py)
    assert np.array_equal(npy(fields[3]), np.asarray(jfields[3]))
    for a, b in zip(fields, jfields):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=0,
                                   atol=1e-12)
    dense = torch.func.vmap(lambda c: measure_fields(
        tbody(c), S_BOX, 0.3, 1.0, (), False, f64, "cpu"))(
        torch.tensor(BOX_X, dtype=f64))
    for a, b in zip(fields, dense):
        assert torch.equal(a, b)
    for m, c in enumerate(BOX_X):
        *own, own_start = port(torch.tensor(c, dtype=f64))
        assert own_start == tuple(start[m].tolist())
        for a, b in zip(fields, own):
            assert torch.equal(a[m], b)


# --- (c) the level stack with a batched corner ----------------------------

S_LEV = (66, 50, 50)
W_LEV = (14, 14, 14)
CORNERS = [[3, 5, 7], [20, 17, 30], [50, 34, 34]]


def test_build_levels_batched_corner_against_jax():
    m0 = np.stack([uniform(70 + m, (3,) + S_LEV, 0.2, 1.0, F64)
                   for m in range(M)])
    starts = np.asarray(CORNERS, np.int64)
    jl = jax.jit(jax.vmap(lambda m, s: jbuild(m, (), False, W_LEV, s)))(
        jj(m0), jnp.asarray(starts, jnp.int32))
    spec = []

    def port(m, s):
        levels = build_levels(m, box_shape=W_LEV, box_start=s)
        spec.append([(lv.banded, lv.c, lv.box_shape) for lv in levels])
        return tuple((lv.L, lv.D, lv.iD) + ((lv.box_start,) if lv.banded
                                             else ()) for lv in levels)
    tl = torch.func.vmap(port)(tt(m0), torch.from_numpy(starts))
    flags = spec[0]
    assert sum(b for b, _c, _s in flags) == 3
    assert len(tl) == len(jl)
    for (banded, c, shape), t, j in zip(flags, tl, jl):
        assert banded == j.banded and c == j.c and shape == j.box_shape
        for a, b in zip(t[:3], (j.L, j.D, j.iD)):
            assert np.array_equal(npy(a), np.asarray(b))
        if banded:
            assert t[3].tolist() == np.asarray(j.box_start).tolist()
    # the members' corners differ on every banded level
    assert all(len({tuple(s) for s in t[3].tolist()}) == M
               for (banded, _c, _s), t in zip(flags, tl) if banded)
    # JAX's batched stack carried across with its member axis: each banded
    # level keeps every member's corner, a tensor
    carried = levels_from_numpy(
        [{k: (None if getattr(lv, k) is None else np.asarray(getattr(lv, k)))
          for k in ("L", "D", "iD", "banded", "c", "box_shape", "box_start")}
         for lv in jl], "cpu", members=True)
    for lv, t in zip(carried, tl):
        assert torch.equal(lv.L, t[0]) and torch.equal(lv.iD, t[2])
        if lv.banded:
            assert torch.equal(lv.box_start, t[3])
        else:
            assert lv.box_start is None
    state = flow_from_numpy({**{k: np.zeros(()) for k in tf.FlowState
                                .__dataclass_fields__ if k != "bbox"},
                             "bbox": starts}, "cpu", members=True)
    assert state.bbox.dtype == torch.int64 and state.bbox.tolist() == CORNERS


# --- (d) the banded step under vmap ----------------------------------------

S_STEP = (34, 26, 26)
W_STEP = (12, 10, 10)
RADIUS, NU = 1.5, 0.1
CENTRES = [10.0, 14.0, 19.0]


def _port_step(banded=True, steps=2):
    """u, p, each step's pois_n and the banded levels' corners after
    ``steps`` adaptive steps of a sphere at axis-0 position ``c``, as a
    pure function of ``c`` (banded BDIM and levels, or dense)."""
    def run(c):
        ctr = torch.stack([c, torch.full_like(c, 13.0),
                           torch.full_like(c, 13.0)])
        body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2))
                        - RADIUS)
        cfg = tf.FlowConfig(D=3, S=S_STEP, device="cpu", nu=NU,
                            U=(1.0, 0.0, 0.0), dtype=f64,
                            bbox_shape=W_STEP if banded else None)
        if banded:
            V, m0, m1, _d, start = measure_fields_banded(
                body, S_STEP, 0.0, 1.0, (), False, f64, W_STEP, "cpu")
            levels = build_levels(m0, box_shape=W_STEP, box_start=start)
        else:
            V, m0, m1, _d = measure_fields(body, S_STEP, 0.0, 1.0, (),
                                           False, f64, "cpu")
            levels, start = build_levels(m0), None
        state = tf.flow_init(cfg).replace(V=V, mu0=m0, mu1=m1, bbox=start)
        pois = []
        for _ in range(steps):
            state, aux = tf.mom_step(cfg, levels, state)
            pois.append(torch.as_tensor(aux["pois_n"]))
        corners = [torch.as_tensor(lv.box_start) for lv in levels
                   if lv.banded]
        return state.u, state.p, torch.stack(pois), corners
    return run


def _jax_step(steps=2):
    def run(c):
        ctr = jnp.stack([c, 13.0, 13.0])
        body = JBody(lambda x, t: jnp.sqrt(jnp.sum((x - ctr) ** 2)) - RADIUS)
        cfg = jf.FlowConfig(D=3, S=S_STEP, nu=NU, U=(1.0, 0.0, 0.0),
                            dtype=jnp.float64, bbox_shape=W_STEP)
        V, m0, m1, d = jbanded(body, S_STEP, 0.0, 1.0, (), False,
                               jnp.float64, W_STEP)
        start = jstart(d < 3.0, W_STEP)
        levels = jbuild(m0, (), False, W_STEP, start)
        state = jf.flow_init(cfg)._replace(V=V, mu0=m0, mu1=m1, bbox=start)

        def step(s, _):
            s, aux = jf.mom_step(cfg, levels, s)
            return s, jnp.asarray(aux["pois_n"])
        state, pois = jax.lax.scan(step, state, None, length=steps)
        return (state.u, state.p, pois,
                [lv.box_start for lv in levels if lv.banded])
    return run


@pytest.fixture(scope="module")
def jax_sweep():
    return jax.jit(jax.vmap(_jax_step()))(jnp.asarray(CENTRES))


def test_banded_sweep_against_jax(jax_sweep, member_calls):
    cs = torch.tensor(CENTRES, dtype=f64)
    with _gates_open():
        u, p, pois, corners = torch.func.vmap(_port_step())(cs)
    ju, jp_, jpois, jcorners = jax_sweep
    assert member_calls["ana_mult3d"] and all(
        n == M for n in member_calls["ana_mult3d"])
    assert len(corners) == len(jcorners) == 2
    for a, b in zip(corners, jcorners):
        assert a.tolist() == np.asarray(b).tolist()
        assert len({tuple(s) for s in a.tolist()}) == M
    assert pois.tolist() == np.asarray(jpois).tolist()
    assert_rel(u, ju, 1e-10)
    assert_rel(p, jp_, 1e-10)


def test_banded_sweep_equals_members_and_dense():
    cs = torch.tensor(CENTRES, dtype=f64)
    with _gates_open():
        u, p, pois, corners = torch.func.vmap(_port_step())(cs)
        for m in range(M):
            ou, op, opois, ocorners = _port_step()(cs[m])
            assert torch.equal(u[m], ou) and torch.equal(p[m], op)
            assert torch.equal(pois[m], opois)
            assert [c[m].tolist() for c in corners] == [
                c.tolist() for c in ocorners]
        du, dp, dpois, _ = torch.func.vmap(_port_step(banded=False))(cs)
    assert torch.equal(pois, dpois)
    assert_rel(u, du, 1e-12)


# --- (e) vmap over jvp through the adaptive solve ---------------------------

XIS = [0.5, 1.5, 3.0, 2.0]


def _jax_lift(n_steps=1):
    """`tests/test_ensemble.py`'s spinning cylinder's lift after
    ``n_steps`` steps of the adaptive solve (``fixed_iters=None``), a pure
    function of the spin ratio."""
    from waterlily_tpu.body import measure_fields as jmeasure
    Dm, Re, U = 8, 500, 1.0
    R = Dm // 2
    S = (2 * Dm + 2, 2 * Dm + 2)

    def lift(xi):
        def mp(x, t):
            a = xi * U * t / R
            s, c = jnp.sin(a), jnp.cos(a)
            return jnp.array([[c, -s], [s, c]], x.dtype) @ (x - Dm)
        body = JBody(lambda x, t: jnp.sqrt(jnp.sum(x * x)) - R, mp)
        cfg = jf.FlowConfig(D=2, S=S, nu=U * Dm / Re, U=(U, 0.0),
                            dtype=jnp.float64, fixed_iters=None)
        V, m0, m1, _ = jmeasure(body, S, 0.0, 1.0, (), False, jnp.float64)
        state = jf.flow_init(cfg)._replace(V=V, mu0=m0, mu1=m1)
        levels = jbuild(m0)
        for _ in range(n_steps):
            state, _aux = jf.mom_step(cfg, levels, state)
        return jforce(state.u, state.p, cfg.nu, body, state.t)[1]
    return lift


@pytest.fixture(scope="module")
def jax_jvp():
    lift = _jax_lift()
    return jax.jit(jax.vmap(lambda x: jax.jvp(lift, (x,), (1.0,))))(
        jnp.asarray(XIS))


def _lift():
    force = _force_fn(n_steps=1, fixed=None)
    return lambda x: force(x)[1]


@pytest.mark.parametrize("order", ["vmap(jvp)", "jvp(vmap)",
                                   "vmap(vmap(jvp))"])
def test_vmap_jvp_adaptive_against_jax(jax_jvp, order):
    lift = _lift()
    xis = torch.tensor(XIS, dtype=f64)
    jvp = lambda x: torch.func.jvp(lift, (x,), (torch.ones_like(x),))
    if order == "vmap(jvp)":
        p, d = torch.func.vmap(jvp)(xis)
    elif order == "jvp(vmap)":
        p, d = torch.func.jvp(torch.func.vmap(lift), (xis,),
                              (torch.ones_like(xis),))
    else:
        p, d = torch.func.vmap(torch.func.vmap(jvp))(xis.reshape(2, 2))
        p, d = p.reshape(-1), d.reshape(-1)
    assert bool(torch.isfinite(d).all())
    assert_rel(p, jax_jvp[0], 1e-9)
    assert_rel(d, jax_jvp[1], 1e-9)


def test_vmap_grad_adaptive_raises_in_both():
    """Reverse mode through the batched adaptive loop raises in JAX (its
    ``while_loop``: here the multigrid solve alone, whose gradient JAX
    refuses when it transposes the loop) and in the port, whose message
    names the ways to differentiate in reverse mode, whichever order of
    `vmap` and `grad`."""
    from waterlily_tpu.ops.multigrid import ml_solve as jsolve
    from waterlily_tpu_torch.ops.multigrid import ml_solve
    from test_torch_ensemble import _mu0, S_LOOP
    m0 = npy(_mu0(4.0))
    z = np.random.default_rng(3).standard_normal((2,) + S_LOOP) * 0.1
    jlevels = jbuild(jj(m0))

    def jloss(zz):
        return jnp.sum(jsolve(jlevels, jnp.zeros_like(zz), zz, tol=1e-3,
                              itmx=8)[0] ** 2)
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        jax.vmap(jax.grad(jloss))(jj(z))
    levels = build_levels(tt(m0))
    loss = lambda zz: torch.sum(ml_solve(levels, torch.zeros_like(zz), zz,
                                         tol=1e-3, itmx=8)[0] ** 2)
    for run in (lambda: torch.func.vmap(torch.func.grad(loss))(tt(z)),
                lambda: torch.func.grad(
                    lambda zz: torch.func.vmap(loss)(zz).sum())(tt(z))):
        with pytest.raises(NotImplementedError,
                           match="fixed_iters.*implicit_diff"):
            run()


@pytest.mark.parametrize("kind", ["ml_solve trace", "poisson_solve"])
def test_vmap_jvp_adaptive_loops_equal_members(kind):
    """`vmap` of `jvp` through each adaptive loop (`ml_solve` with its
    residual trace, `poisson_solve` on one level) in the radius of the
    body that makes the operator: each member's primal and tangent, the
    trace's included, equal its own `jvp` bit for bit, members stopping
    at different counts."""
    from test_torch_ensemble import _solve, S_LOOP, RADII
    z = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (len(RADII),) + S_LOOP) * 0.1)
    f = lambda rad, zz: torch.func.jvp(
        lambda r: tuple(o for i, o in enumerate(_solve(kind, r, zz))
                        if i != 2), (rad,), (torch.ones_like(rad),))
    rads = torch.tensor(RADII, dtype=f64)
    primal, tangent = torch.func.vmap(f)(rads, z)
    counts = torch.func.vmap(lambda r, zz: _solve(kind, r, zz)[2])(rads, z)
    assert len(set(counts.tolist())) > 1
    for m in range(len(RADII)):
        own_p, own_t = f(rads[m], z[m])
        for a, b in zip(primal + tangent, own_p + own_t):
            assert torch.equal(a[m], b)
        assert bool(tangent[0][m].abs().max() > 0)


def test_vmap_jvp_adaptive_runs_the_plain_forms(member_calls):
    """With the stencil gates open (as on the card), `vmap` over `jvp`
    runs the adaptive solve's primal loop in the plain forms, as its
    tangent loop and each member's own `jvp` do (one route, one count):
    no member form is called, and each member's tangent equals its own
    `jvp`; under `vmap` alone the member forms run."""
    run = _port_step(steps=1)
    f = lambda c: torch.sum(run(c)[1])
    jvp = lambda c: torch.func.jvp(f, (c,), (torch.ones_like(c),))
    cs = torch.tensor(CENTRES[:2], dtype=f64)
    with _gates_open():
        p, d = torch.func.vmap(jvp)(cs)
        assert not member_calls, dict(member_calls)
        for m in range(len(cs)):
            own = jvp(cs[m])
            assert_rel(p[m], own[0], 1e-12)
            assert_rel(d[m], own[1], 1e-12)
        torch.func.vmap(f)(cs)
    assert member_calls["ana_mult3d"]
