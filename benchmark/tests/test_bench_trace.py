"""The reading of a profiler session, on a session made of fake events:
device time by launching range, busy time with intervals merged, launch
calls, idle gaps labelled by the host's range."""
import sys
from pathlib import Path

import torch
from pytest import approx

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import trace  # noqa: E402


class _Ev:
    def __init__(self, name, a, d, dev="cpu", corr=0):
        self._n, self._a, self._d, self._c = name, a, d, corr
        self._dev = (torch.autograd.DeviceType.CUDA if dev == "gpu"
                     else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda self: events})()})()


def test_read_session():
    ev = [
        _Ev(trace.STEP, 0, 1000),
        _Ev(trace.RANGES["mom_step"], 10, 900),
        _Ev(trace.RANGES["conv_diff"], 20, 100),
        _Ev("cudaLaunchKernel", 30, 5, corr=1),
        _Ev(trace.RANGES["ml_solve"], 200, 600),
        _Ev("cudaLaunchKernel", 210, 5, corr=2),
        _Ev("aten::item", 400, 300),
        _Ev("cudaLaunchKernel", 850, 5, corr=3),
        _Ev("cudaMemcpyAsync", 950, 5, corr=4),
        _Ev("conv", 40, 100, "gpu", corr=1),
        _Ev("solve", 220, 150, "gpu", corr=2),
        _Ev("solve", 300, 50, "gpu", corr=2),
        _Ev("other", 860, 100, "gpu", corr=3),
        _Ev("copy", 970, 10, "gpu", corr=4),
    ]
    got = trace.read_session(_Prof(ev))
    assert got["steps"] == 1 and got["window_s"] == approx(1000e-9)
    assert got["busy_s"] == approx(360e-9)
    assert got["range_s"]["conv_diff"] == approx(100e-9)
    assert got["range_s"]["ml_solve"] == approx(200e-9)
    assert got["range_s"]["mom_step"] == approx(400e-9)
    assert got["range_calls"] == {"mom_step": 1, "conv_diff": 1,
                                  "ml_solve": 1}
    assert got["launches"] == 3 and got["matched"] == 1.0
    assert got["device_ops"][0] == ["solve", approx(200e-9)]
    gap_s = [g for _, g in got["idle_gaps"]]
    assert gap_s == sorted(gap_s, reverse=True)
    assert got["idle_gaps"][0] == ["wl.ml_solve > aten::item", approx(490e-9)]
