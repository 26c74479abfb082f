"""Spans around the program's layers and the reading of a profiler session.

`spans` wraps four calls of the measured program in
`torch.profiler.record_function` ranges, from the benchmark's side: the
module globals ``simulation.mom_step``, ``flow.conv_diff`` and
``flow.ml_solve``, which their callers look up at call time, and the
method ``Simulation.measure``.  `read_session` turns one profiler session
into what the per-layer metrics read: the device time launched inside each
range, the device's busy time (intervals merged) over the traced steps'
wall time, the runtime launch calls, the operations that took most device
time and the longest idle gaps with the host range they fell in.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
from collections import defaultdict

import torch

__all__ = ["RANGES", "STEP", "spans", "read_session"]

STEP = "wl.step"
RANGES = {"mom_step": "wl.mom_step", "conv_diff": "wl.conv_diff",
          "ml_solve": "wl.ml_solve", "measure": "wl.measure"}
_LAUNCH = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")


def _wrap(fn, name):
    @functools.wraps(fn)
    def ranged(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return ranged


@contextlib.contextmanager
def spans():
    """The four ranges, installed for the block and removed after."""
    from waterlily_tpu_torch import flow, simulation
    saved = [(simulation, "mom_step"), (flow, "conv_diff"),
             (flow, "ml_solve"), (simulation.Simulation, "measure")]
    old = [getattr(obj, attr) for obj, attr in saved]
    for (obj, attr), fn in zip(saved, old):
        setattr(obj, attr, _wrap(fn, RANGES[attr]))
    try:
        yield
    finally:
        for (obj, attr), fn in zip(saved, old):
            setattr(obj, attr, fn)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(sorted_iv, starts, x):
    """The interval of ``sorted_iv`` (disjoint, sorted) holding ``x``."""
    k = bisect.bisect_right(starts, x) - 1
    return k >= 0 and x < sorted_iv[k][1]


def read_session(prof) -> dict:
    """What one profiler session of whole steps recorded: ``steps``,
    ``window_s`` (first step's start to last step's end), ``busy_s``
    (device intervals merged, inside the window), ``range_s`` and
    ``range_calls`` by range key (`RANGES`), ``launches``, ``device_ops``
    and ``idle_gaps`` (top ten, seconds), ``matched`` (the share of device
    operations whose launch was found)."""
    evs = prof.profiler.kineto_results.events()
    gpu, runtime, cpu, steps = [], {}, [], []
    names = {v: k for k, v in RANGES.items()}
    ranges = defaultdict(list)
    launches = 0
    for e in evs:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a range's own device-side span is no device work
            if not (name == STEP or name in names or _annotation(e)):
                gpu.append(e)
            continue
        a = e.start_ns()
        b = a + e.duration_ns()
        if name == STEP:
            steps.append((a, b))
        elif name in names:
            ranges[names[name]].append((a, b))
        if name.startswith(_LAUNCH):
            launches += 1
        if name.startswith("cu"):
            runtime[e.correlation_id()] = a
        cpu.append((a, b, name))
    if not steps:
        raise RuntimeError("the profiler session holds no step range")
    steps.sort()
    w0, w1 = steps[0][0], steps[-1][1]

    for k in ranges:
        ranges[k].sort()
    starts = {k: [a for a, _ in v] for k, v in ranges.items()}
    range_ns = defaultdict(float)
    by_op = defaultdict(float)
    busy_iv = []
    matched = 0
    for e in gpu:
        a = e.start_ns()
        d = e.duration_ns()
        if d <= 0 or a + d <= w0 or a >= w1:
            continue
        busy_iv.append((max(a, w0), min(a + d, w1)))
        by_op[e.name()] += d
        launch = runtime.get(e.correlation_id())
        if launch is None:
            launch = runtime.get(e.linked_correlation_id())
        if launch is None:
            continue
        matched += 1
        for k, iv in ranges.items():
            if _inside(iv, starts[k], launch):
                range_ns[k] += d
    merged = _merge(busy_iv)
    busy = sum(b - a for a, b in merged)
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((w1 - prev, prev, w1))
    gaps.sort(reverse=True)
    idle = [[_label(cpu, (a + b) / 2), g / 1e9] for g, a, b in gaps[:10]]
    return {
        "steps": len(steps), "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "range_s": {k: v / 1e9 for k, v in range_ns.items()},
        "range_calls": {k: len(v) for k, v in ranges.items()},
        "launches": launches,
        "device_ops": [[n, ns / 1e9] for n, ns in sorted(
            by_op.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": idle,
        "matched": matched / max(1, len(busy_iv)),
    }


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def _label(cpu, x) -> str:
    """The innermost benchmark range and the innermost host call running
    at host time ``x``."""
    rng, op = None, None
    for a, b, name in cpu:
        if a <= x < b:
            if name.startswith("wl.") and (rng is None or b - a < rng[0]):
                rng = (b - a, name)
            if op is None or b - a < op[0]:
                op = (b - a, name)
    parts = [p[1] for p in (rng, op) if p is not None]
    return " > ".join(dict.fromkeys(parts)) or "(no host call)"
