"""`Simulation.reverse_step`: one `implicit_diff` step differentiated in
reverse mode, held on a 32³ sphere, dense and banded, to JAX's `jax.grad`
of the same step from the same state (float64, equal forward and adjoint
iteration counts) and to the benchmark's plain reference gradient
(`benchmark/reference/adjoint.py`, which imports nothing of the port) in
float64 and float32; the banded and the dense gradients agree; the step
it takes is the untracked step's; the state advances detached and the
histories get the step's counts; under a profiler the unit is one root
with its forward and backward spans; the gates send the tracked fields to
the plain forms."""
import collections
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.reference import adjoint as radjoint  # noqa: E402
from benchmark.reference import measure as rmeasure  # noqa: E402
from benchmark.reference import solver as rsolver  # noqa: E402
from waterlily_tpu import body as jb  # noqa: E402
from waterlily_tpu import flow as jf  # noqa: E402
from waterlily_tpu.metrics import ke as jke  # noqa: E402
from waterlily_tpu.ops import multigrid as jmg  # noqa: E402
from waterlily_tpu.simulation import Simulation as JSim  # noqa: E402
from waterlily_tpu_torch import AutoBody, Simulation  # noqa: E402
from waterlily_tpu_torch.convert import (flow_from_numpy,  # noqa: E402
                                         levels_from_numpy)
from waterlily_tpu_torch.metrics import ke  # noqa: E402
from waterlily_tpu_torch.ops import stencil_kernels as sk  # noqa: E402
from waterlily_tpu_torch.utils import perf  # noqa: E402

N = (32, 32, 32)
RADIUS, CENTER = 4.0, (12.0, 16.0, 16.0)
NU = {1: 0.04, 2: 0.025}
# float64: both sides solve to 1e-10, so the gradients agree to rounding;
# float32 at the cell's tolerance: the port's and the reference's plain
# forms and solves round alike, the same iteration counts run, and what is
# left is the sums' association, a few ulps of a 1e4 loss
TOL = {torch.float64: (1e-10, 1e-8), torch.float32: (1e-5, 1e-5)}


def _sdf(x, t):
    return torch.sqrt(torch.sum(x * x, dim=-1)) - RADIUS


def _map(x, t):
    return x - torch.tensor(CENTER, dtype=x.dtype, device=x.device)


def _ulam(seed):
    g = torch.Generator().manual_seed(seed)
    k = torch.rand(3, 2, generator=g, dtype=torch.float64) * 0.5

    def ulam(i, x):
        base = torch.full_like(x[..., 0], 1.0 if i == 0 else 0.0)
        return base + 0.05 * torch.sin(k[i, 0] * x[..., 0] + i) * torch.cos(
            k[i, 1] * x[..., 1])
    return ulam


def _sim(seed, dtype, bbox, requires_grad=True, perdir=()):
    nu = torch.tensor(NU[seed], dtype=dtype, requires_grad=requires_grad)
    sim = Simulation(N, (1, 0, 0), 2 * RADIUS, nu=nu,
                     body=AutoBody(_sdf, _map), bbox=bbox, device="cpu",
                     dtype=dtype, implicit_diff=True, tol=TOL[dtype][0],
                     itmx=64, ulam=_ulam(seed), perdir=perdir)
    assert (sim.cfg.bbox_shape is not None) == (bbox == "force")
    return sim, nu


def _loss(flow):
    return torch.sum(ke(flow.u))


def _reference(sim, dtype, seed):
    """The reference's gradient from the simulation's current state."""
    S, perdir = sim.cfg.S, sim.cfg.perdir
    cfg = rsolver.Config(S=S, nu=NU[seed], U=(1.0, 0.0, 0.0), perdir=perdir,
                         tol=TOL[dtype][0], itmx=64)
    V, m0, m1 = rmeasure.measure(_sdf, _map, S, torch.zeros((), dtype=dtype),
                                 1.0, perdir, dtype, "cpu")
    f = sim.flow
    st = rsolver.State(u=f.u, p=f.p, V=V, mu0=m0, mu1=m1, dt=f.dt, t=f.t)
    return radjoint.reverse_step(cfg, rsolver.build_levels(m0, perdir), st)


def _interior(g):
    return g[:, 1:-1, 1:-1, 1:-1]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", sorted(NU))
@pytest.mark.parametrize("bbox", [False, "force"], ids=["dense", "banded"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_matches_the_plain_reference(dtype, bbox, seed):
    sim, nu = _sim(seed, dtype, bbox)
    loss_r, g_r, gnu_r, new_r, counts = _reference(sim, dtype, seed)
    loss, (g, gnu) = sim.reverse_step(_loss, wrt=(nu,))
    rtol = TOL[dtype][1]
    assert sim.pois_n[-1] + sim.adjoint_n[-1] == counts
    d = _interior(g) - _interior(g_r)
    assert float(d.abs().max()) <= rtol * float(_interior(g_r).abs().max())
    assert math.isclose(float(gnu), float(gnu_r), rel_tol=rtol)
    assert math.isclose(loss, float(loss_r), rel_tol=rtol)
    assert abs(float(gnu)) > 0 and float(g_r.abs().max()) > 0.1
    assert float((sim.flow.u - new_r.u).abs().max()) <= rtol
    assert float((sim.flow.p - new_r.p).abs().max()) <= rtol


def _jax_pair(seed, bbox):
    """The port's simulation and JAX's, both at the port's seeded initial
    velocity and at JAX's measured fields, levels and time step (carried
    across with `convert`), so both differentiate one step of one state."""
    sim, nu = _sim(seed, torch.float64, bbox)
    js = JSim(N, (1, 0, 0), 2 * RADIUS, nu=NU[seed], dtype=jnp.float64,
              body=jb.AutoBody(lambda x, t: jnp.sqrt(jnp.sum(x * x)) - RADIUS,
                               lambda x, t: x - jnp.asarray(CENTER)),
              bbox=bbox, implicit_diff=True, tol=TOL[torch.float64][0],
              itmx=64)
    assert js.cfg.bbox_shape == sim.cfg.bbox_shape
    jflow = js.flow._replace(u=jnp.asarray(sim.flow.u.numpy()))
    sim.flow = flow_from_numpy(
        {k: np.asarray(v) for k, v in jflow._asdict().items()}, "cpu")
    sim.levels = levels_from_numpy(
        [{"L": np.asarray(l.L), "D": np.asarray(l.D), "iD": np.asarray(l.iD),
          "banded": l.banded, "c": l.c, "box_shape": l.box_shape,
          "box_start": None if l.box_start is None
          else np.asarray(l.box_start)} for l in js.levels], "cpu")
    assert [l.banded for l in sim.levels] == [l.banded for l in js.levels]
    return sim, nu, js, jflow


@pytest.mark.parametrize("bbox", [False, "force"], ids=["dense", "banded"])
def test_matches_jax(bbox, monkeypatch):
    """The loss, d/du₀ over the whole field, d/dν and the new state equal
    `jax.grad` of Σ ke after JAX's `mom_step(implicit_diff=True)` to 1e-8
    relative, with the same forward and adjoint iteration counts (JAX's
    read from its `ml_solve` calls, forward and adjoint, by callback).

    JAX runs op by op: `_ulam`'s disturbance is uniform along z, so the
    limiters meet exact ties, where the derivative does not exist and
    XLA's compiled CPU program (`jax.jit`) breaks them otherwise (d/du₀ up
    to 15% of its largest value off); op by op JAX breaks them as PyTorch
    does."""
    seed = 1
    sim, nu, js, jflow = _jax_pair(seed, bbox)
    solves = []
    real = jmg.ml_solve

    def counted(*a, **kw):
        x, r, n = real(*a, **kw)
        jax.debug.callback(lambda v: solves.append(int(v)), n)
        return x, r, n
    monkeypatch.setattr(jmg, "ml_solve", counted)

    def jloss(u0, jnu):
        new, aux = jf.mom_step(js.cfg._replace(nu=jnu), js.levels,
                               jflow._replace(u=u0))
        return jnp.sum(jke(new.u)), (aux["pois_n"], new.u, new.p)
    (jv, (jpois, ju, jp)), (jg, jgnu) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jflow.u, jnp.asarray(NU[seed]))
    jg = np.asarray(jg)
    loss, (g, gnu) = sim.reverse_step(_loss, wrt=(nu,))
    assert sim.pois_n[-1] == np.asarray(jpois).tolist()
    assert sorted(solves) == sorted(sim.pois_n[-1] + sim.adjoint_n[-1])
    assert len(solves) == 4
    assert math.isclose(loss, float(jv), rel_tol=1e-8)
    assert float(np.abs(g.numpy() - jg).max()) <= 1e-8 * np.abs(jg).max()
    assert math.isclose(float(gnu), float(jgnu), rel_tol=1e-8)
    assert abs(float(jgnu)) > 0 and np.abs(jg).max() > 0.1
    for a, b in ((sim.flow.u, ju), (sim.flow.p, jp)):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) <= 1e-8 * np.abs(b).max()


@pytest.mark.parametrize("perdir", [(2,), (1, 2)], ids=["z", "yz"])
def test_periodic_ghosts_fold(perdir):
    """With periodic axes the cotangents of the pressure's periodic ghosts
    fold onto the cells they copy, in the program and in the reference
    alike (leaving the fold out of the reference moves d/du₀ by ~10%)."""
    sim, nu = _sim(1, torch.float64, False, perdir=perdir)
    loss_r, g_r, gnu_r, _, counts = _reference(sim, torch.float64, 1)
    loss, (g, gnu) = sim.reverse_step(_loss, wrt=(nu,))
    assert sim.pois_n[-1] + sim.adjoint_n[-1] == counts
    d = _interior(g) - _interior(g_r)
    assert float(d.abs().max()) <= 1e-8 * float(_interior(g_r).abs().max())
    assert math.isclose(float(gnu), float(gnu_r), rel_tol=1e-8)


@pytest.mark.parametrize("seed", sorted(NU))
def test_banded_and_dense_agree(seed):
    got = {}
    for bbox in (False, "force"):
        sim, nu = _sim(seed, torch.float64, bbox)
        got[bbox] = sim.reverse_step(_loss, wrt=(nu,))
    (l0, (g0, n0)), (l1, (g1, n1)) = got[False], got["force"]
    assert math.isclose(l0, l1, rel_tol=1e-12)
    assert float((g0 - g1).abs().max()) <= 1e-12 * float(g0.abs().max())
    assert math.isclose(float(n0), float(n1), rel_tol=1e-12)


@pytest.mark.parametrize("bbox", [False, "force"], ids=["dense", "banded"])
def test_takes_the_untracked_step(bbox):
    """The new state equals an untracked `step` of a twin, bit for bit:
    tracking changes no value of the step, banded or dense."""
    sim, nu = _sim(1, torch.float32, bbox)
    twin, _ = _sim(1, torch.float32, bbox, requires_grad=False)
    for _ in range(2):
        sim.reverse_step(_loss, wrt=(nu,))
        twin.step(remeasure=False)
    for a, b in ((sim.flow.u, twin.flow.u), (sim.flow.p, twin.flow.p),
                 (sim.flow.dt, twin.flow.dt), (sim.flow.t, twin.flow.t)):
        assert torch.equal(a, b)
    assert sim.pois_n == twin.pois_n and sim.dts == twin.dts


def test_advances_detached_and_counts():
    sim, nu = _sim(2, torch.float32, "force")
    t0, dt0 = float(sim.flow.t), float(sim.flow.dt)
    for k in range(2):
        loss, grads = sim.reverse_step(_loss, wrt=(nu,))
        assert isinstance(loss, float) and len(grads) == 2
        assert grads[0].shape == sim.flow.u.shape and grads[1].ndim == 0
        for f in (sim.flow.u, sim.flow.p, sim.flow.dt, sim.flow.t):
            assert not f.requires_grad and f.grad_fn is None
        assert len(sim.pois_n) == len(sim.adjoint_n) == k + 1
        assert len(sim.dts) == k + 2
        assert all(isinstance(n, int) and n > 0
                   for n in sim.pois_n[-1] + sim.adjoint_n[-1])
        assert sim.dts[-1] == float(sim.flow.dt)
    assert math.isclose(float(sim.flow.t), t0 + dt0 + sim.dts[1],
                        rel_tol=1e-6)
    assert nu.grad is None


def test_needs_implicit_diff():
    sim = Simulation(N, (1, 0, 0), 8.0, nu=0.04, body=AutoBody(_sdf, _map),
                     device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="implicit_diff"):
        sim.reverse_step(_loss)


def test_spans_and_plain_routings(monkeypatch):
    """Under a profiler the unit is one root holding ``wl.grad.forward``
    and ``wl.grad.backward``, the two adjoint solves and the loss read
    inside; off the profiler nothing is kept.  With the gates forced open
    on this CPU, the tracked step's stencils are refused by their gate
    (`stencil_kernels.members_ok`) and take their plain forms: both
    convections, the four boundary fills and the time step's CFL (the
    projection's divergence and correction are unfused under
    ``implicit_diff`` whatever tracks them, and the solves' levels are
    detached, so their kernels take them)."""
    monkeypatch.setattr(sk, "use_blocked", lambda S, dtype, device:
                        len(S) == 3 and math.prod(S) >= 1000)
    refused = collections.Counter()
    gate = sk.members_ok

    def spy(S, dtype, device, *operands):
        ok = gate(S, dtype, device, *operands)
        if not ok and sk.use_blocked(S, dtype, device):
            refused[sys._getframe(1).f_code.co_name] += 1
        return ok
    monkeypatch.setattr(sk, "members_ok", spy)
    sim, nu = _sim(1, torch.float32, "force")
    before = perf.span_records(perf.SPAN_STEPS)
    sim.reverse_step(_loss, wrt=(nu,))
    after = perf.span_records(perf.SPAN_STEPS)
    assert len(after) == len(before)
    assert all(a is b for a, b in zip(after, before))
    assert refused == {"conv_diff": 2, "bc_vector": 4, "cfl": 1}
    with profile(activities=[ProfilerActivity.CPU]):
        sim.reverse_step(_loss, wrt=(nu,))
    got = perf.span_totals(1)
    each = {"wl.sim.step": 1, "wl.grad.forward": 1, "wl.grad.backward": 1,
            "wl.solve.adjoint": 2, "wl.read.loss": 1, "wl.flow.mom_step": 1}
    for name, n in each.items():
        assert got[name]["calls"] == n, name
    assert got["wl.solve"]["calls"] == 4
    recs = perf.span_records(1)
    for r in recs:
        if r.name == "wl.solve.adjoint":
            assert r.parent.name == "wl.grad.backward"
