"""The ``grad`` entry (`entries/grad.py`): the cell ``sphere_256.grad``
through `harness.run` at a tiny size on the CPU, judged correct against
the plain reference gradient (`reference/adjoint.py`); a scaled gradient,
a gradient whose adjoint solve is cut short and a unit that leaves the
state where it was are not; the readers of its per-layer metrics; a span
opened on another thread inside a backward pass lands in the step's
totals, and on the card (skipped without one) the adjoint solves' and the
backward pass's spans read stream time."""
import json
import sys
import threading
from pathlib import Path

import pytest
import torch
from pytest import approx
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402
from waterlily_tpu_torch import AutoBody, Simulation  # noqa: E402
from waterlily_tpu_torch.metrics import ke  # noqa: E402
from waterlily_tpu_torch.ops import multigrid  # noqa: E402
from waterlily_tpu_torch.utils import perf  # noqa: E402

CELL = "sphere_256.grad"
TINY = {"dims": [32, 32, 32], "radius": 4, "center": [15, 15, 15]}
LIMITS = json.loads((harness.ROOT / "limits" / f"{CELL}.json").read_text())
METRICS = ["grad_forward_ms", "grad_backward_ms", "adjoint_ms_per_iter"]


def _run(detail=None):
    torch.set_num_threads(2)
    return harness.run(CELL, 2 ** 31 + 77, 0.2, False, device="cpu",
                       cfg_override=TINY, mix_override={"warmup_steps": 2},
                       detail=detail, log=lambda *a, **k: None)


def test_sound_run_is_correct():
    detail = {}
    out = _run(detail)
    assert out["correct"] and out["failed"] == 0, out["check"]
    assert set(out["check"]) == set(LIMITS)
    assert {"mlups", "step_ms_p95", "peak_gib", "setup_s"} <= set(
        out["metrics"])
    counts = detail["rec"]["pois"]
    assert counts and all(len(n) == 4 and min(n) > 0 for n in counts)
    nums = detail["numbers"]
    for tag in ("first", "last"):
        assert nums[f"dna_{tag}"] == 0 and nums[f"dn_{tag}"] == 0


def _scaled(monkeypatch):
    """The program's gradient in u₀ 5% too large."""
    real = Simulation.reverse_step

    def scaled(self, *a, **kw):
        loss, (g, *rest) = real(self, *a, **kw)
        return loss, (1.05 * g, *rest)
    monkeypatch.setattr(Simulation, "reverse_step", scaled)


def _cut_short(monkeypatch):
    """Each adjoint solve stopped after one iteration."""
    real = multigrid._ImplicitSolve.backward

    def cut(ctx, *grads):
        ctx.itmx = 1
        return real(ctx, *grads)
    monkeypatch.setattr(multigrid._ImplicitSolve, "backward",
                        staticmethod(cut))


def _stale(monkeypatch):
    """The state left where it was: the unit's gradient is sound, but the
    simulation never advances."""
    real = Simulation.reverse_step

    def stale(self, *a, **kw):
        flow = self.flow
        out = real(self, *a, **kw)
        self.flow = flow
        return out
    monkeypatch.setattr(Simulation, "reverse_step", stale)


@pytest.mark.parametrize("fault, caught", [
    (_scaled, ("eg_", "dnu_")), (_cut_short, ("eg_", "dnu_")),
    (_stale, ("dp_",))], ids=["scaled", "cut_short", "stale"])
def test_faults_are_not_correct(fault, caught, monkeypatch):
    fault(monkeypatch)
    detail = {}
    out = _run(detail)
    assert out["failed"] == 0 and not out["correct"], out["check"]
    over = [k for k, (v, lim) in out["check"].items() if v > lim]
    assert any(k.startswith(caught) for k in over), over


# --- the readers --------------------------------------------------------

MS = {"wl.grad.forward": 300.0, "wl.grad.backward": 600.0,
      "wl.solve.adjoint": 40.0}
UNITS = [[2, 1, 5, 4], [1, 1, 4, 4]]


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def _reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py")


@pytest.fixture
def filled(monkeypatch):
    """Two units of spans as the program opens them, the spans' events
    reading `MS` (0.5 ms for any other)."""
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in UNITS:
            with perf.span(perf.STEP_SPAN):
                with perf.span("wl.grad.forward"):
                    pass
                with perf.span("wl.grad.backward"):
                    for _ in range(2):
                        with perf.span("wl.solve.adjoint"):
                            pass
                with perf.host_read("loss"):
                    pass
    for r in perf.span_records(len(UNITS)):
        r.events = (_Event(0.0), _Event(MS.get(r.name, 0.5)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return {"trace": {"steps": len(UNITS), "pois": UNITS}, "pois": UNITS}


def test_readers(filled):
    assert _reader("grad_forward_ms").read(filled) == approx(300.0)
    assert _reader("grad_backward_ms").read(filled) == approx(600.0)
    assert _reader("adjoint_ms_per_iter").read(filled) == approx(
        2 * 2 * 40.0 / 17)
    assert _reader("adjoint_iters").read(filled) == approx(17 / 2)


@pytest.mark.parametrize("name", METRICS)
def test_nothing_without_a_trace(name):
    assert _reader(name).read({"trace": None, "pois": UNITS}) is None


def test_no_adjoint_count_without_adjoint_solves():
    assert _reader("adjoint_iters").read({"pois": [[2, 1], [1, 1]]}) is None


@pytest.mark.parametrize("name", METRICS)
def test_nothing_without_the_programs_spans(name, filled, monkeypatch):
    """A program without the spans (the parent of this cell) gives no
    value and no error."""
    monkeypatch.delattr(perf, "span_totals")
    assert _reader(name).read(filled) is None


# --- spans in a backward pass ----------------------------------------------

def test_span_on_another_thread_lands_in_the_step(monkeypatch):
    """A span opened on a thread with no open span, while a root is open
    in the process (autograd's device thread in a backward pass, whose
    profiler state the engine carries over), is kept under that root."""
    got = {}

    def device_thread():
        with perf.span("wl.solve.adjoint"):
            with perf.span("wl.solve"):
                pass
        got["open"] = list(perf._LOG.open_spans())

    with profile(activities=[ProfilerActivity.CPU]):
        with perf.span(perf.STEP_SPAN):
            with perf.span("wl.grad.backward"):
                monkeypatch.setattr(perf, "_profiling", lambda: True)
                t = threading.Thread(target=device_thread)
                t.start()
                t.join()
                monkeypatch.undo()
    totals = perf.span_totals(1)
    assert totals["wl.solve.adjoint"]["calls"] == 1
    assert totals["wl.solve"]["calls"] == 1
    recs = {r.name: r for r in perf.span_records(1)}
    assert recs["wl.solve.adjoint"].parent is recs[perf.STEP_SPAN]
    assert recs["wl.solve"].parent is recs["wl.solve.adjoint"]
    assert got["open"] == []
    assert perf._LOG.root is None


@pytest.mark.cuda
def test_backward_spans_on_the_card():
    """On the card autograd runs the backward pass on its own thread: the
    adjoint solves' spans are kept in the unit's root and read stream
    time, as the backward pass's does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: autograd's device thread")
    dev = "cuda:0"
    nu = torch.tensor(0.016, device=dev, requires_grad=True)

    def sdf(x, t):
        return torch.sqrt(torch.sum(x * x, dim=-1)) - 8.0

    def shift(x, t):
        return x - torch.tensor([24.0, 32.0, 32.0], dtype=x.dtype,
                                device=x.device)
    sim = Simulation((64, 64, 64), (1, 0, 0), 16.0, nu=nu,
                     body=AutoBody(sdf, shift), bbox="force", device=dev,
                     implicit_diff=True, tol=1e-5)

    def loss(flow):
        return torch.sum(ke(flow.u))
    sim.reverse_step(loss, wrt=(nu,))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        sim.reverse_step(loss, wrt=(nu,))
    totals = perf.span_totals(1)
    assert totals["wl.solve.adjoint"]["calls"] == 2
    assert totals["wl.solve"]["calls"] == 4
    for name in ("wl.solve.adjoint", "wl.grad.backward", "wl.grad.forward"):
        assert totals[name]["stream_ms"] > 0, name
    assert sum(sim.adjoint_n[-1]) > 0
