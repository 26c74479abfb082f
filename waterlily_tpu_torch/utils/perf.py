"""Performance accounting: MLUPS, CUDA-event step timing, device busy
time from `torch.profiler`, the card's idle share over a window of steps
and a profiler trace of a block (`trace_profile`)."""
from __future__ import annotations

import contextlib
import math
import os
import sys
import tempfile
import time

import torch

__all__ = ["mlups", "time_steps", "device_profile", "idle_share",
           "trace_profile"]

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
