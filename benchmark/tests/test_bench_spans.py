"""The readers of the program's spans (`waterlily_tpu_torch.utils.perf.
span_totals`): each metric's value from a fabricated run and a buffer
filled under a CPU profiler session (its CUDA events faked), and nothing
without a trace or without the program's spans."""
import sys
from pathlib import Path

import pytest
import torch
from pytest import approx
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from waterlily_tpu_torch.utils import perf  # noqa: E402

METRICS = ["host_reads_per_step", "fine_smooth_ms_per_iter", "bdim_ms"]
# stream ms of one span of each name
MS = {"wl.solve.smooth": 4.0, "wl.flow.bdim": 1.5}
POIS = [[2, 1], [1, 1]]


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def _reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py")


@pytest.fixture
def filled(monkeypatch):
    """Two steps of spans as the program opens them: per step a dt read,
    a solver check and a fine smooth an iteration, two BDIM blends, a
    remeasure's level rebuild and two band reads; each span's events
    read `MS`."""
    with profile(activities=[ProfilerActivity.CPU]):
        for pois in POIS:
            with perf.span(perf.STEP_SPAN):
                with perf.span("wl.body.measure"):
                    with perf.host_read("band_start"):
                        pass
                    with perf.host_read("band_check"):
                        pass
                    with perf.span("wl.body.levels"):
                        pass
                for _ in range(2):
                    with perf.span("wl.flow.bdim"):
                        pass
                for _ in range(sum(pois)):
                    with perf.span("wl.solve.smooth"):
                        pass
                    with perf.host_read("solve_check"):
                        pass
                with perf.host_read("dt"):
                    pass
    for r in perf.span_records(len(POIS)):
        r.events = (_Event(0.0), _Event(MS.get(r.name, 0.5)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return {"trace": {"steps": len(POIS), "pois": POIS}}


def test_readers(filled):
    iters = sum(map(sum, POIS))
    assert _reader("host_reads_per_step").read(filled) == approx(
        (iters + len(POIS) * 3) / len(POIS))
    assert _reader("fine_smooth_ms_per_iter").read(filled) == approx(
        MS["wl.solve.smooth"])
    assert _reader("bdim_ms").read(filled) == approx(2 * MS["wl.flow.bdim"])


@pytest.mark.parametrize("name", METRICS)
def test_nothing_without_a_trace(name):
    assert _reader(name).read({"trace": None, "pois": POIS}) is None


@pytest.mark.parametrize("name", METRICS)
def test_nothing_without_the_programs_spans(name, filled, monkeypatch):
    """A program without `span_totals` (the parent of the spans) gives no
    value and no error."""
    monkeypatch.delattr(perf, "span_totals")
    assert _reader(name).read(filled) is None


def test_stream_readers_off_cuda():
    """Spans recorded with no CUDA events give the stream metrics
    nothing, the count its value."""
    with profile(activities=[ProfilerActivity.CPU]):
        with perf.span(perf.STEP_SPAN):
            with perf.span("wl.flow.bdim"):
                pass
            with perf.span("wl.solve.smooth"):
                pass
            with perf.host_read("dt"):
                pass
    run = {"trace": {"steps": 1, "pois": [[1, 0]]}}
    for name in METRICS[1:]:
        assert _reader(name).read(run) is None
    assert _reader("host_reads_per_step").read(run) == 1.0
