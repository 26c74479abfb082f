"""`utils.perf.device_profile` when the profiler records nothing: more
calls a session, then a raise or a CUDA-event time.  The profiler and
the CUDA calls are stand-ins, so this runs on the CPU."""
import types

import pytest
import torch

from waterlily_tpu_torch.utils import perf


class _Session:
    """A profiler session whose ``key_averages`` is what ``record`` gives
    for its number (1, 2, ...)."""
    opened = 0

    def __init__(self, record):
        self.record = record

    def __call__(self, activities):
        _Session.opened += 1
        self.n = _Session.opened
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return self.record(self.n)


class _Event:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, end):
        return 10.0


@pytest.fixture
def fake_card(monkeypatch):
    _Session.opened = 0
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(perf, "PROFILE_PAUSE_S", 0.0)
    monkeypatch.setattr(perf, "EVENT_FALLBACKS", [])

    def use(record):
        monkeypatch.setattr(torch.profiler, "profile", _Session(record))
    return use


def _op(key, count, us):
    return types.SimpleNamespace(key=key, count=count,
                                 self_device_time_total=us)


def test_empty_sessions_raise_after_doubling_calls(fake_card):
    fake_card(lambda n: [])
    calls = []
    with pytest.raises(RuntimeError, match="no device activity"):
        perf.device_profile(lambda: calls.append(1), 2)
    assert _Session.opened == perf.PROFILE_ATTEMPTS
    assert len(calls) == sum(2 << k for k in range(perf.PROFILE_ATTEMPTS))
    assert perf.EVENT_FALLBACKS == []


def test_empty_sessions_fall_back_to_events(fake_card):
    fake_card(lambda n: [])
    ms, ops = perf.device_profile(lambda: None, 2, events=True)
    assert ms == 5.0 and ops == {perf.EVENTS_KEY: 5.0}
    assert perf.EVENT_FALLBACKS == [(2, perf.PROFILE_ATTEMPTS)]


def test_retried_session_is_per_call(fake_card):
    """The second session runs 2n calls: 400 µs over 4 events of 4 calls
    is 0.1 ms a call; an op that lost an event still counts once a
    call."""
    fake_card(lambda n: [] if n == 1 else
              [_op("k", 4, 400.0), _op("fill", 3, 30.0), _op("cpu", 1, 0.0)])
    ms, ops = perf.device_profile(lambda: None, 2, events=True)
    assert ops == pytest.approx({"k": 0.1, "fill": 0.01})
    assert ms == pytest.approx(0.11)
    assert perf.EVENT_FALLBACKS == []


def test_span_ranges_are_no_operations(fake_card):
    """A span's range on the card's timeline (a user annotation) adds no
    device time: only the operations count."""
    span = types.SimpleNamespace(key="wl.solve", count=1,
                                 self_device_time_total=900.0,
                                 is_user_annotation=True)
    fake_card(lambda n: [span, _op("mult", 2, 400.0)])
    ms, ops = perf.device_profile(lambda: None, 2)
    assert ops == {"mult": 0.2} and ms == 0.2
