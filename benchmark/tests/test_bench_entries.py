"""The timed-entry seam: an entry that a configuration names is found in
the entries folder by name and driven by `harness.run` with no file of
the harness edited.  A stub entry, written from this file into a folder of
its own, stands for a program: each unit sleeps a little, ``cells`` is 7,
and its judgement returns the numbers the test hands it."""
import json
import sys
from pathlib import Path

import pytest
from pytest import approx

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness, trace  # noqa: E402

CELL = "sphere_384.static"
LIMITS = json.loads((harness.ROOT / "limits" / f"{CELL}.json").read_text())
WARMUP = 2
STUB = '''
import time


class _Units:
    cells = 7

    def __init__(self, cfg):
        self.stub = cfg["stub"]
        self.units = 0
        self.counts = None if self.stub["no_counts"] else []

    def advance(self):
        self.units += 1
        time.sleep(0.002)
        if self.counts is not None:
            self.counts.append([2, 1])

    def failed(self):
        return sum(1 for k in self.stub["nonfinite"] if k <= self.units)

    def finish(self):
        self.advance()
        return {"units": self.units}


def build(setup, cfg, mix, ulam, dtype, device, options):
    return _Units(cfg)


def judge(kept, setup, cfg, mix, ulam, dtype, device):
    return {**cfg["stub"]["numbers"], "units": float(kept["units"])}
'''


def _session(steps):
    """A profiler session's reading as `trace.read_session` gives it, the
    device busy half the window."""
    def read(prof):
        return {"steps": steps, "window_s": 0.02, "busy_s": 0.01,
                "range_s": {}, "range_calls": {}, "launches": 40,
                "device_ops": [["op", 0.01]], "idle_gaps": [["gap", 0.01]],
                "matched": 1.0}
    return read


@pytest.mark.parametrize("case", ["sound", "nonfinite", "over_limit",
                                  "counts", "no_counts"])
def test_a_stub_entry_through_the_harness(case, tmp_path, monkeypatch):
    (tmp_path / "stub.py").write_text(STUB)
    monkeypatch.setattr(harness, "ENTRIES", tmp_path)
    numbers = {k: v / 2 for k, v in LIMITS.items()}
    if case == "over_limit":
        numbers["dp_last"] = 2 * LIMITS["dp_last"]
    stub = {"numbers": numbers, "no_counts": case == "no_counts",
            "nonfinite": [2] if case == "nonfinite" else []}
    traced = case in ("counts", "no_counts")
    mix = {"warmup_steps": WARMUP, "trace_skip": 1, "trace_steps": 2}
    if traced:
        monkeypatch.setattr(trace, "read_session", _session(2))
    detail = {}
    out = harness.run(CELL, 2 ** 31 + 11, 0.05, traced, device="cpu",
                      cfg_override={"entry": "stub", "stub": stub},
                      mix_override=mix, detail=detail,
                      log=lambda *a, **k: None)
    rec, nums = detail["rec"], detail["numbers"]
    # the warm-up's units, the window's and the judged one
    assert nums["units"] == WARMUP + rec["steps"] + 1
    assert out["attempted"] == rec["steps"] and rec["cells"] == 7
    assert out["check"] == {k: [numbers[k], v] for k, v in LIMITS.items()}
    metrics = out["metrics"]
    if case == "sound":
        assert out["correct"] and out["failed"] == 0
        assert metrics["mlups"]["value"] == approx(
            7 * rec["steps"] / rec["window_s"] / 1e6, rel=1e-12)
    elif case == "nonfinite":
        assert out["failed"] == 1 and not out["correct"]
    elif case == "over_limit":
        assert out["failed"] == 0 and not out["correct"]
    elif case == "counts":
        assert out["correct"] and metrics["pois_iters"]["value"] == 3.0
        assert metrics["launches_per_step"]["value"] == 20.0
    else:
        assert out["correct"] and rec["pois"] == []
        assert "pois_iters" not in metrics
        assert metrics["launches_per_step"]["value"] == 20.0

