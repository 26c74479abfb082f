"""Port parity of the recording path (torch vs JAX on the CPU): the
solver's residual traces (`ml_solve(trace=True)`, `Simulation(log=True)`,
`write_log`), `run_record`, `set_body` and `utils.perf.trace_profile`.

Each twin runs the JAX package and the port on the same inputs; a
simulation pair starts from one state (the JAX state carried across) and
is held to the step-parity rule of `test_torch_sim.py`."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.body import AutoBody as JAutoBody
from waterlily_tpu.metrics import pressure_force as jpressure_force
from waterlily_tpu.models import cases as jcases
from waterlily_tpu.ops import multigrid as jmg
from waterlily_tpu.parallel import mesh as jmesh_mod
from waterlily_tpu.simulation import Simulation as JSimulation
from waterlily_tpu.utils.perf import trace_profile as jtrace_profile
import waterlily_tpu_torch as wt
from waterlily_tpu_torch import Simulation
from waterlily_tpu_torch.convert import flow_from_numpy, levels_from_numpy
from waterlily_tpu_torch.io.plots import read_log
from waterlily_tpu_torch.metrics import pressure_force
from waterlily_tpu_torch.ops import multigrid as tmg
from waterlily_tpu_torch.parallel.mesh import mesh_for
from waterlily_tpu_torch.parallel.shard_step import can_shard_step
from waterlily_tpu_torch.utils.perf import trace_profile

from _torch_parity import (F32, F64, normal, interior_only, bc_coeffs, tt,
                           jj, npy)

f32 = jnp.float32


def _pois_ok(a, b):
    """Equal iteration counts, or within ±2 per solve and ≤4 in total."""
    a, b = np.asarray(a, int), np.asarray(b, int)
    d = np.abs(a - b)
    return bool((d == 0).all() or ((d <= 2).all() and d.sum() <= 4))


def _carry(js, ts):
    """The port's `ts` takes the JAX sim's state and levels."""
    ts.flow = flow_from_numpy(
        {k: np.asarray(v) for k, v in js.flow._asdict().items()}, "cpu")
    if js.cfg.bbox_shape is None:
        ts.flow = ts.flow.replace(bbox=None)
    ts.levels = levels_from_numpy(
        [{"L": np.asarray(l.L), "D": np.asarray(l.D), "iD": np.asarray(l.iD)}
         for l in js.levels], "cpu", ts.cfg.perdir)
    return ts


def _trace_close(a, b, rtol):
    """Two residual traces: the same zero rows (the same iteration
    counts), each number within ``rtol`` of JAX's, relative to its row-0
    value (the solve's initial residual)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a == 0, b == 0)
    scale = np.maximum(np.abs(b[..., :1, :]), np.finfo(np.float32).tiny)
    err = np.abs(a - b) / scale
    assert err.max() <= rtol, err.max()


@pytest.mark.parametrize("dtype", [F32, F64])
def test_ml_solve_trace(dtype):
    """`ml_solve(trace=True)`: an (itmx+1, 2) trace, row 0 the initial
    residual, row k+1 after iteration k, zeros after the last, against
    JAX's; the fixed-count form (fixed+1, 2)."""
    S = (34, 18, 18)
    L = bc_coeffs(24, S, dtype)
    z = interior_only(normal(25, S, dtype, 0.1))
    z = z - interior_only(np.full(S, z.sum() / np.prod([s - 2 for s in S]),
                                  dtype))
    levj = jmg.build_levels(jj(L), bf16_eps=False)
    levt = tmg.build_levels(tt(L))
    x0 = np.zeros(S, dtype)
    rtol = 1e-4 if dtype is F32 else 1e-10
    *_, nj, trj = jmg.ml_solve(levj, jj(x0), jj(z), tol=1e-6, itmx=8,
                               trace=True)
    xt, rt, nt, trt = tmg.ml_solve(levt, tt(x0), tt(z), tol=1e-6, itmx=8,
                                   trace=True)
    assert nt == int(nj) and trt.shape == (9, 2) and trt.dtype == xt.dtype
    _trace_close(npy(trt), trj, rtol)
    assert bool((trt[nt + 1:] == 0).all()) and bool((trt[:nt + 1] > 0).all())
    xu, _, nu_ = tmg.ml_solve(levt, tt(x0), tt(z), tol=1e-6, itmx=8)
    assert nu_ == nt and torch.equal(xu, xt)
    *_, trjf = jmg.ml_solve(levj, jj(x0), jj(z), fixed=3, trace=True)
    xf, _, nf, trf = tmg.ml_solve(levt, tt(x0), tt(z), fixed=3, trace=True)
    assert nf == 3 and trf.shape == (4, 2)
    _trace_close(npy(trf), trjf, rtol)


@pytest.fixture(scope="module")
def logged():
    """A JAX circle_2d(48, 32, log=True) stepped 3 times and the port's
    twin from the same state: one `step`, then `steps(2)`."""
    js = jcases.circle_2d(48, 32, dtype=f32, log=True)
    ts = _carry(js, wt.circle_2d(48, 32, device="cpu", log=True))
    js.steps(3, remeasure=False)
    ts.step(remeasure=False)
    ts.steps(2, remeasure=False)
    return js, ts


def test_log_traces(logged):
    """One (2, itmx+1, 2) trace pair a step from `step` and `steps`, each
    within 1e-4 of JAX's (relative to the solve's initial residual)."""
    js, ts = logged
    assert _pois_ok(ts.pois_n, [[int(v) for v in r] for r in js.pois_n])
    assert len(ts.res_log) == len(js.res_log) == 3
    for a, b in zip(ts.res_log, js.res_log):
        assert isinstance(a, np.ndarray) and a.shape == (2, 33, 2)
        _trace_close(a, b, 1e-4)
    with pytest.raises(ValueError, match="log=True"):
        wt.circle_2d(16, 16, device="cpu").write_log("never.log")


def test_write_log(logged, tmp_path):
    """`write_log` writes JAX's format: the same header, the same p/c
    blocks and rows, each number within 1e-4 of JAX's (relative to the
    solve's first row)."""
    js, ts = logged
    ft, fj = str(tmp_path / "t.log"), str(tmp_path / "j.log")
    ts.write_log(ft)
    js.write_log(fj)
    lt, lj = open(ft).read().splitlines(), open(fj).read().splitlines()
    assert lt[0] == lj[0] == "p/c, iter, r∞, r₂"
    assert [l for l in lt if not l.startswith(",")] == \
        [l for l in lj if not l.startswith(",")]
    for bt, bj in zip(read_log(ft), read_log(fj)):
        assert [len(s) for s in bt] == [len(s) for s in bj]
        for st, sj in zip(bt, bj):
            _trace_close(np.array(st)[:, 1:], np.array(sj)[:, 1:], 1e-4)
            assert [r[0] for r in st] == list(range(len(st)))


def test_log_on_mesh_takes_dense_step():
    """``Simulation(mesh=..., log=True)`` takes the dense step (JAX keeps
    its per-phase path under ``log``); its traces match JAX's mesh run."""
    S = (34, 18, 18)
    js = jcases.sphere_3d(32, 16, dtype=f32, log=True,
                          mesh=jmesh_mod.mesh_for(S, 8))
    tmesh = mesh_for(S, 8, "cpu")
    ts = _carry(js, wt.sphere_3d(32, 16, device="cpu", log=True, mesh=tmesh))
    assert ts._sharded is False
    assert can_shard_step(dataclasses.replace(ts.cfg, log=False), tmesh,
                          ts.levels)
    js.steps(2, remeasure=False)
    ts.steps(2, remeasure=False)
    assert _pois_ok(ts.pois_n, [[int(v) for v in r] for r in js.pois_n])
    assert len(ts.res_log) == 2
    for a, b in zip(ts.res_log, js.res_log):
        _trace_close(a, b, 1e-4)


def _circle(cls, autobody, sqrt, sum_, center, radius=4.0, **kw):
    body = autobody(lambda x, t: sqrt(sum_((x - center) ** 2)) - radius)
    return body, cls((32, 32), (1, 0), 8, nu=0.03, body=body, **kw)


def test_run_record_forces():
    """The JAX test's run_record oracle (test_record.py) on both packages
    from one state: the same sample times and step counts, the forces
    within 1e-4 of their largest component."""
    jbody, js = _circle(JSimulation, JAutoBody, jnp.sqrt, jnp.sum, 16.0,
                        dtype=f32)
    tbody, ts = _circle(Simulation, wt.AutoBody, torch.sqrt, torch.sum, 16.0,
                        device="cpu")
    _carry(js, ts)
    jforce = jax.jit(lambda p, t: jpressure_force(p, jbody, t))
    recj = js.run_record(1.0, every=0.25, remeasure=False,
                         fields={"f": lambda s: jforce(s.flow.p, s.time)})
    rect = ts.run_record(1.0, every=0.25, remeasure=False, fields={
        "f": lambda s: pressure_force(s.flow.p, tbody, s.time)})
    assert len(rect["t"]) == len(rect["f"]) == len(recj["t"]) >= 2
    assert rect["t"][-1] >= 1.0
    np.testing.assert_allclose(rect["t"], recj["t"], rtol=1e-5)
    assert len(ts.dts) == len(js.dts)
    assert all(isinstance(f, np.ndarray) for f in rect["f"])
    ft, fj = np.stack(rect["f"]), np.stack(recj["f"])
    assert np.all(np.isfinite(ft))
    np.testing.assert_allclose(ft, fj, atol=1e-4 * np.abs(fj).max())


def test_run_record_sample_interval():
    """The JAX test (test_utils.py) on the port, and the samples at JAX's
    steps (the same step count; the times within 1e-4, the f32 dt
    histories drifting apart over the run): a decaying tgv_2d, whose dt
    grows fast."""
    js = jcases.tgv_2d(L=32, Re=100)
    ts = _carry(js, wt.tgv_2d(L=32, Re=100, device="cpu"))
    recj = js.run_record(3.0, every=0.5)
    rec = ts.run_record(3.0, every=0.5)
    t = np.array(rec["t"])
    assert len(t) >= 4
    max_dt_nd = max(ts.dts) * ts.U / ts.L
    gaps = np.diff(np.concatenate([[0.0], t]))
    assert np.all(gaps[:-1] >= 0.5 - 1e-9), gaps
    assert np.all(gaps <= 0.5 + max_dt_nd + 1e-6), (gaps, max_dt_nd)
    np.testing.assert_allclose(t, recj["t"], rtol=1e-4)
    assert len(ts.dts) == len(js.dts)


def test_set_body():
    """A body swapped after 2 steps (banded window sized again at the next
    step's time): the window, its corner and the next 3 steps match
    JAX's after the same swap."""
    jb1, js = _circle(JSimulation, JAutoBody, jnp.sqrt, jnp.sum, 16.0,
                      dtype=f32, bbox="force")
    tb1, ts = _circle(Simulation, wt.AutoBody, torch.sqrt, torch.sum, 16.0,
                      device="cpu", bbox="force")
    _carry(js, ts)
    ts.flow = ts.flow.replace(bbox=tuple(int(v) for v in
                                         np.asarray(js.flow.bbox)))
    tb1_box = ts.cfg.bbox_shape
    js.steps(2, remeasure=False)
    ts.steps(2, remeasure=False)
    c2 = jnp.asarray([12.0, 17.5], f32)
    js.set_body(JAutoBody(lambda x, t: jnp.sqrt(jnp.sum((x - c2) ** 2))
                          - 3.5))
    c2t = torch.tensor([12.0, 17.5])
    ts.set_body(wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - c2t) ** 2))
                            - 3.5))
    assert ts.cfg.bbox_shape == js.cfg.bbox_shape
    assert ts.cfg.bbox_shape is not None and ts.cfg.bbox_shape != tb1_box
    assert ts.flow.bbox == tuple(int(v) for v in np.asarray(js.flow.bbox))
    np.testing.assert_allclose(npy(ts.flow.mu0), np.asarray(js.flow.mu0),
                               atol=1e-6)
    js.steps(3, remeasure=False)
    ts.steps(3, remeasure=False)
    assert _pois_ok(ts.pois_n, [[int(v) for v in r] for r in js.pois_n])
    np.testing.assert_allclose(ts.dts, js.dts, rtol=1e-5)
    np.testing.assert_allclose(npy(ts.flow.u), np.asarray(js.flow.u),
                               atol=1e-4)
    np.testing.assert_allclose(npy(ts.flow.p), np.asarray(js.flow.p),
                               atol=1e-4)
    # no body: the window goes, the fields stay (as in JAX)
    mu0 = ts.flow.mu0
    ts.set_body(None)
    assert ts.cfg.bbox_shape is None and ts.flow.mu0 is mu0


def test_trace_profile(tmp_path):
    """A Chrome trace of the block in ``logdir`` (CPU activity here), as
    JAX's `trace_profile` writes its trace directory."""
    with jtrace_profile(str(tmp_path / "jtrace")) as d:
        jnp.sum(jnp.ones((32, 32))).block_until_ready()
    assert [f for _, _, fs in os.walk(d) for f in fs]
    with trace_profile(str(tmp_path / "trace")) as d:
        float(torch.ones(32, 32).sum())
    path = os.path.join(d, "trace.json")
    assert os.path.getsize(path) > 0
    assert "traceEvents" in open(path).read()
