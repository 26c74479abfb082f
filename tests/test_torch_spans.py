"""The port's spans (`utils.perf.span`, `host_read`): nothing without a
profiler; under one, one `wl.sim.step` root a step with the step's spans
nested inside it, host reads counted by the solver's iterations, records
on the profiler's own clock, and the step's results unchanged."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch.models.cases import tgv_3d
from waterlily_tpu_torch.utils import perf

# the ranges the benchmark puts around the program from outside
BENCH_RANGES = {"wl.step", "wl.mom_step", "wl.conv_diff", "wl.ml_solve",
                "wl.measure"}
STEPS = 3


def _heaving_sphere():
    """A radius-4 sphere heaving ±4 cells on a 32³ grid, small enough for
    its band window to cover under half the grid."""
    def heave(x, t):
        y = 4.0 * torch.sin(0.2 * t)
        return x - torch.stack([torch.full_like(y, 12.0), 16.0 + y,
                                torch.full_like(y, 16.0)])
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum(x * x)) - 4.0, heave)
    sim = Simulation((32, 32, 32), (1, 0, 0), 8.0, nu=0.04, body=body,
                     bbox="force", device="cpu")
    assert sim.cfg.bbox_shape is not None
    return sim


CASES = {
    # a moving body on the banded path, remeasured every step
    "heave": (_heaving_sphere, True),
    # no body, every axis periodic
    "tgv": (lambda: tgv_3d(16, device="cpu"), False),
}


def _state(sim):
    return sim.flow.u.clone(), sim.flow.p.clone(), sim.flow.dt.clone()


@pytest.fixture(scope="module", params=sorted(CASES))
def traced(request):
    """Two equal simulations of one case stepped `STEPS` times, the second
    under a CPU profiler session: its records, the session's events and
    both end states.  The records are read at once: the buffer is the
    process's."""
    make, remeasure = CASES[request.param]
    plain, sim = make(), make()
    for _ in range(STEPS):
        plain.step(remeasure)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with perf.span("wl.warm"):     # the profiler's first range
            pass
        for _ in range(STEPS):
            sim.step(remeasure)
    return {"case": request.param, "remeasure": remeasure, "sim": sim,
            "plain": plain, "records": perf.span_records(STEPS),
            "totals": perf.span_totals(STEPS),
            "events": prof.profiler.kineto_results.events(),
            "pois": sim.pois_n[-STEPS:]}


def test_off_enters_no_range(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(*a, **kw):
        calls.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    sim = tgv_3d(16, device="cpu")
    before = perf.span_records(perf.SPAN_STEPS)
    sim.step()
    sim.steps(2)
    assert calls == []
    assert perf.span("wl.sim.step") is perf.host_read("dt")
    after = perf.span_records(perf.SPAN_STEPS)
    assert len(after) == len(before)
    assert all(a is b for a, b in zip(after, before))


def test_one_root_a_step(traced):
    recs = traced["records"]
    roots = [r for r in recs if r.name == perf.STEP_SPAN]
    assert len(roots) == STEPS
    assert all(r.parent is None for r in roots)
    assert len({r.step for r in roots}) == STEPS
    for r in recs:
        top = r
        while top.parent is not None:
            top = top.parent
        assert top.name == perf.STEP_SPAN and top.step == r.step


def test_counts_follow_the_solver(traced):
    got = traced["totals"]
    iters = sum(sum(n) for n in traced["pois"])
    remeasured = 2 if traced["remeasure"] else 0
    reads = sum(v["calls"] for k, v in got.items()
                if k.startswith("wl.read."))
    assert got["wl.read.solve_check"]["calls"] == iters
    assert got["wl.mg.l0"]["calls"] == iters
    assert got["wl.solve.smooth"]["calls"] == iters
    assert reads == iters + STEPS * (1 + remeasured)
    each = {"wl.sim.step": 1, "wl.read.dt": 1, "wl.flow.mom_step": 1,
            "wl.flow.conv_diff": 2, "wl.flow.bdim": 2, "wl.flow.bc": 4,
            "wl.flow.project": 2, "wl.flow.cfl": 1, "wl.solve": 2,
            "wl.solve.residual": 2}
    if traced["remeasure"]:
        each.update({"wl.body.measure": 1, "wl.body.sdf": 1,
                     "wl.body.faces": 1, "wl.body.levels": 1,
                     "wl.read.band_start": 1, "wl.read.band_check": 1})
    else:
        assert not any(k.startswith("wl.body.") for k in got)
    for name, n in each.items():
        assert got[name]["calls"] == n * STEPS, name
    assert all(v["host_ms"] > 0 and v["stream_ms"] is None
               for v in got.values())


def test_nesting_and_names(traced):
    recs = traced["records"]
    assert all(r.t0_ns <= r.t1_ns for r in recs)
    for r in recs:
        if r.parent is not None:
            assert r.parent.t0_ns <= r.t0_ns and r.t1_ns <= r.parent.t1_ns
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append((r.t0_ns, r.t1_ns))
    for name, iv in by_name.items():
        iv.sort()
        assert all(a[1] <= b[0] for a, b in zip(iv, iv[1:])), name
        assert name.startswith("wl.") and name not in BENCH_RANGES
    # each level's V-cycle inside the one above it
    for r in recs:
        if r.name.startswith("wl.mg.l") and r.name != "wl.mg.l0":
            k = int(r.name[len("wl.mg.l"):])
            assert r.parent.name == f"wl.mg.l{k - 1}"


def test_records_on_the_profilers_clock(traced):
    ranges = {}
    for e in traced["events"]:
        if e.name().startswith("wl.") and e.name() != "wl.warm":
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    mine = {}
    for r in traced["records"]:
        mine.setdefault(r.name, []).append((r.t0_ns, r.t1_ns))
    assert set(ranges) == set(mine)
    for name in mine:
        assert len(ranges[name]) == len(mine[name]), name
        for (a, b), (c, d) in zip(sorted(ranges[name]), sorted(mine[name])):
            assert abs(a - c) < 100_000 and abs(b - d) < 100_000, name


def test_results_unchanged(traced):
    for a, b in zip(_state(traced["plain"]), _state(traced["sim"])):
        assert torch.equal(a, b)
    assert traced["plain"].pois_n == traced["sim"].pois_n
    assert traced["plain"].dts == traced["sim"].dts


def test_steps_read_dt_once():
    """`steps(n)` opens a root a step and reads the dts back once, in the
    last step's record."""
    sim = tgv_3d(16, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        sim.steps(2)
    got = perf.span_totals(2)
    assert got["wl.sim.step"]["calls"] == 2
    assert got["wl.read.dt"]["calls"] == 1
    last = perf.span_records(1)
    assert [r.name for r in last].count("wl.read.dt") == 1


def test_keeps_the_last_steps():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(perf.SPAN_STEPS + 10):
            with perf.span(perf.STEP_SPAN):
                with perf.host_read("x"):
                    pass
    recs = perf.span_records(10 ** 6)
    roots = [r for r in recs if r.name == perf.STEP_SPAN]
    assert len(roots) == perf.SPAN_STEPS
    assert len(recs) == 2 * perf.SPAN_STEPS
    assert perf.span_totals(5)["wl.read.x"]["calls"] == 5


def test_outside_a_step_keeps_nothing():
    """Spans opened with no `wl.sim.step` root on the thread (a bare
    solve, a construction and its measurement) are the profiler's ranges
    alone: the last step's records and totals stay as they were."""
    from waterlily_tpu_torch.ops.multigrid import ml_solve
    sim = tgv_3d(16, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.step()
        before = perf.span_records(1)
        totals = perf.span_totals(1)
        ml_solve(sim.levels, torch.zeros_like(sim.flow.p),
                 torch.randn_like(sim.flow.p))
        _heaving_sphere().measure()
    assert perf.span_records(1) == before
    assert perf.span_totals(1) == totals
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("wl.solve") == 2 + 1
    assert names.count("wl.body.measure") == 2


def test_spanned_keeps_the_function():
    """A function under `spanned` keeps its name and docstring and, with
    no profiler, returns what it returns."""
    from waterlily_tpu_torch import flow, simulation

    @perf.spanned("wl.test")
    def f(a, b=1):
        """doc"""
        return a + b
    assert (f.__name__, f.__doc__, f(1, b=2)) == ("f", "doc", 3)
    assert flow.mom_step.__name__ == "mom_step"
    assert simulation.Simulation.step.__doc__.startswith("Advance one")
