"""Performance accounting: MLUPS, CUDA-event step timing, device busy
time from `torch.profiler`, the card's idle share over a window of steps,
a profiler trace of a block (`trace_profile`) and the program's own spans
(`span`, `host_read`, read back by `span_totals`)."""
from __future__ import annotations

import collections
import contextlib
import functools
import math
import os
import sys
import tempfile
import threading
import time

import torch

__all__ = ["mlups", "time_steps", "device_profile", "idle_share",
           "trace_profile", "span", "spanned", "host_read", "span_records",
           "span_totals", "STEP_SPAN", "SPAN_STEPS"]

# Profiler sessions per measurement: a short session run right after
# others now and then records no device activity on the H100, so an
# empty session is run again, with twice the calls and after a pause,
# before `device_profile` gives up.  On the H100 one process once had
# five empty sessions in a row for one kernel after hundreds of good
# ones; a caller that only needs a time asks for CUDA events then.
PROFILE_ATTEMPTS = 5
PROFILE_PAUSE_S = 0.05
# op name of a time that CUDA events took in the profiler's place
EVENTS_KEY = "(CUDA events: the profiler recorded no device activity)"
# (calls, sessions) of every measurement that fell back to CUDA events
EVENT_FALLBACKS = []
# Profiled windows per `idle_share`: a window of many steps can lose a
# share of its events (on the H100 a 256³ window once read 18.69 busy
# ms/step where others read 33.8), so it reads low, never high, and the
# largest of its sessions is kept.
IDLE_SESSIONS = 2


def mlups(dims, n_steps: int, seconds: float) -> float:
    """Million cell-updates per second for ``n_steps`` over grid ``dims``."""
    return math.prod(dims) * n_steps / seconds / 1e6


def time_steps(sim, n_steps: int, warmup: int = 10, remeasure=False) -> dict:
    """Time ``n_steps`` of a CUDA Simulation with `torch.cuda.Event` after
    ``warmup`` untimed steps.

    Returns seconds, seconds per step, MLUPS over the interior cells and
    ns per velocity DOF (``3 * prod(dims)``, the reference's per-DOF
    accounting).  Raises for a simulation that is not on a CUDA device:
    a CPU time is not a device time."""
    if sim.device.type != "cuda":
        raise ValueError(f"time_steps times CUDA simulations; this one is on "
                         f"{sim.device}")
    sim.steps(warmup, remeasure=remeasure)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sim.steps(n_steps, remeasure=remeasure)
    end.record()
    torch.cuda.synchronize()
    sec = start.elapsed_time(end) / 1e3
    dims = tuple(s - 2 for s in sim.cfg.S)
    return {"seconds": sec, "sec_per_step": sec / n_steps,
            "mlups": mlups(dims, n_steps, sec),
            "ns_per_dof": sec / n_steps / (3 * math.prod(dims)) * 1e9,
            "dims": dims, "steps": n_steps}


def _events_ms(fn, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_profile(fn, n=1, events=False):
    """Run ``fn`` ``n`` times under `torch.profiler` (CUDA activity only)
    and return ``(device ms per call, {op name: device ms per call})``
    summed over every kernel, copy and fill the calls put on the card.
    A session can lose a few events of short kernels (on the H100, 17 of
    20 launches of a 6 µs kernel recorded), so an op's time per call is
    its mean time per event times its events per call, ``ceil(events /
    calls)``: exact when ``fn`` launches the same kernels at every call
    and no op loses as many events as there were calls.  A session that
    records no device activity is run again with twice the calls, up to
    `PROFILE_ATTEMPTS` sessions in all.  Then it raises, or with
    ``events`` returns the CUDA-event time of ``n`` back-to-back calls
    (the host's dispatch included) under the one name `EVENTS_KEY` and
    notes it in `EVENT_FALLBACKS`."""
    from torch.profiler import ProfilerActivity, profile
    calls = n
    for attempt in range(PROFILE_ATTEMPTS):
        if attempt:
            time.sleep(PROFILE_PAUSE_S)
            calls *= 2
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.key_averages():
            if getattr(e, "is_user_annotation", False):
                continue        # a span's range on the card, no operation
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                by_name[e.key] = us / 1e3 / e.count * -(-e.count // calls)
        if by_name:
            return sum(by_name.values()), by_name
        print(f"device_profile: session {attempt + 1} of {calls} calls "
              f"recorded no device activity", file=sys.stderr)
    if not events:
        raise RuntimeError(f"torch.profiler recorded no device activity in "
                           f"{PROFILE_ATTEMPTS} sessions")
    EVENT_FALLBACKS.append((n, PROFILE_ATTEMPTS))
    ms = _events_ms(fn, n)
    return ms, {EVENTS_KEY: ms}


def idle_share(sim, n_steps: int, remeasure=False) -> dict:
    """Share of the wall time of ``n_steps`` steps in which the card is idle.

    The same steps run again and again from the same state: first timed
    with CUDA events (the wall time, with no profiler on the host), then
    `IDLE_SESSIONS` times under `device_profile` (the device busy time,
    the largest of the sessions').  Every run must give the same solver
    iteration counts, so every window did the same work; the simulation
    ends ``n_steps`` ahead.  Returns per-step ``wall_ms``,
    ``busy_ms`` and ``by_name`` (device ms by op), and ``idle_share`` =
    1 - busy / wall; busy and idle share are NaN (not measured) when no
    session recorded device activity."""
    if sim.device.type != "cuda":
        raise ValueError(f"idle_share measures CUDA simulations; this one is "
                         f"on {sim.device}")
    flow, levels = sim.flow, sim.levels
    n_pois, n_dts, n_log = len(sim.pois_n), len(sim.dts), len(sim.res_log)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sim.steps(n_steps, remeasure=remeasure)
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / n_steps
    timed = sim.pois_n[n_pois:]

    def from_start():
        sim.flow, sim.levels = flow, levels
        del sim.pois_n[n_pois:], sim.dts[n_dts:], sim.res_log[n_log:]
        sim.steps(n_steps, remeasure=remeasure)

    busy, by_name = math.nan, {}
    for _ in range(IDLE_SESSIONS):
        try:
            b, ops = device_profile(from_start)
        except RuntimeError:
            b, ops = math.nan, {}
        if sim.pois_n[n_pois:] != timed:
            raise RuntimeError(f"the profiled steps solved differently: "
                               f"pois_n {sim.pois_n[n_pois:]} vs {timed}")
        if b > busy or math.isnan(busy):
            busy, by_name = b, ops
    busy /= n_steps
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "by_name": {k: v / n_steps for k, v in by_name.items()},
            "pois_n": timed, "steps": n_steps}


@contextlib.contextmanager
def trace_profile(logdir=None):
    """Record a `torch.profiler` trace of the block and write it to
    ``logdir/trace.json`` (Chrome trace format; ``logdir`` defaults to
    ``waterlily_trace`` in the temporary directory): CPU activity, and
    CUDA activity where a card is present.  Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "waterlily_trace")
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield logdir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# --- spans ----------------------------------------------------------------
#
# The step, the pressure solve and the body measurement open named spans
# (`span`) and wrap each blocking device-to-host read in one (`host_read`).
# A span is live only while a `torch.profiler` session is: then it is a
# profiler range (on the profiler's trace, which keeps CPU events on the
# Unix clock of `time.time_ns`), a record in memory with its host interval
# on that clock, read just inside the range, and, where CUDA is
# initialised, a pair of timing events on the current stream.  Records
# are kept by step: a `STEP_SPAN` root opens the next step, and a span is
# kept inside the root open on its own thread or, on a thread with no open
# span (autograd's device thread running a backward pass), inside the
# root open in the process; one opened outside any root is the profiler's
# range alone.  With no session `span` returns one shared no-op context,
# and a function under `spanned` is called straight through.

STEP_SPAN = "wl.sim.step"
# steps whose records are kept (the oldest dropped first)
SPAN_STEPS = 256
_profiling = torch.autograd._profiler_enabled
# the profiler's range: the C++ context where this PyTorch has it, whose
# entry and exit run no Python between the range's stamp and the record's
# clock read (`record_function`'s run tens of microseconds of it)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


class _SpanLog:
    """The records by step, the index of the last step opened, the root
    open in the process and each thread's open spans."""

    def __init__(self):
        self.steps = collections.deque(maxlen=SPAN_STEPS)
        self.index = 0
        self.root = None
        self.local = threading.local()

    def open_spans(self) -> list:
        try:
            return self.local.open
        except AttributeError:
            self.local.open = []
            return self.local.open


_LOG = _SpanLog()


class SpanRecord:
    """One live span: ``name``, the enclosing ``parent`` record (None at a
    root; on a thread with no open span, the root open in the process),
    the ``step`` it belongs to, host ``t0_ns``/``t1_ns`` (`time.time_ns`
    just after the profiler's range opens and just before it closes;
    ``t1_ns`` None while open) and ``events``, the CUDA timing events at
    entry and exit (None where CUDA is not initialised)."""

    __slots__ = ("name", "parent", "step", "t0_ns", "t1_ns", "events",
                 "_range", "_outer")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _LOG.open_spans()
        if stack:
            self.parent = stack[-1]
        else:
            self.parent = None if self.name == STEP_SPAN else _LOG.root
        if self.name == STEP_SPAN:
            _LOG.steps.append([])
            _LOG.index += 1
            self._outer, _LOG.root = _LOG.root, self
        self.step = _LOG.index
        _LOG.steps[-1].append(self)
        stack.append(self)
        self.t1_ns = None
        self._range = _RANGE(self.name)
        self._range.__enter__()
        self.t0_ns = time.time_ns()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.t1_ns = time.time_ns()
        self._range.__exit__(*exc)
        self._range = None
        _LOG.open_spans().pop()
        if self.name == STEP_SPAN:
            _LOG.root = self._outer
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context naming a part of the program: a no-op unless a
    `torch.profiler` session is live, then a `SpanRecord` (a `STEP_SPAN`
    root, or a span inside one) or the profiler's range alone."""
    if not _profiling():
        return _OFF
    if name != STEP_SPAN and not _LOG.open_spans() and _LOG.root is None:
        return _RANGE(name)
    return SpanRecord(name)


def spanned(name: str):
    """`span` as a decorator: each call of the function is the span."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned_fn(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return spanned_fn
    return wrap


def host_read(site: str):
    """The span ``wl.read.<site>``, around one blocking device-to-host
    read."""
    if not _profiling():
        return _OFF
    return span("wl.read." + site)


def span_records(steps: int) -> list:
    """The records of the last ``steps`` steps (`STEP_SPAN` roots) kept,
    in the order the spans opened."""
    kept = list(_LOG.steps)
    return [r for s in kept[len(kept) - min(steps, len(kept)):] for r in s]


def span_totals(steps: int) -> dict:
    """``{name: {"calls", "host_ms", "stream_ms"}}`` over the closed spans
    of the last ``steps`` steps recorded: their count, host milliseconds
    and CUDA-event milliseconds from entry to exit on the stream, summed
    (it synchronises first; None where a span of the name has no
    events)."""
    recs = [r for r in span_records(steps) if r.t1_ns is not None]
    if any(r.events is not None for r in recs):
        torch.cuda.synchronize()
    out = {}
    for r in recs:
        t = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                    "stream_ms": 0.0})
        t["calls"] += 1
        t["host_ms"] += (r.t1_ns - r.t0_ns) / 1e6
        if r.events is None or t["stream_ms"] is None:
            t["stream_ms"] = None
        else:
            t["stream_ms"] += r.events[0].elapsed_time(r.events[1])
    return out
