"""Performance accounting: MLUPS, CUDA-event step timing, device busy
time from `torch.profiler` and the card's idle share over a window of
steps."""
from __future__ import annotations

import math

import torch

__all__ = ["mlups", "time_steps", "device_profile", "idle_share"]

# Profiler sessions per measurement: a short session run right after
# others now and then records no device activity on the H100, so an
# empty session is run again before `device_profile` gives up.
PROFILE_ATTEMPTS = 5
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


def device_profile(fn, n=1):
    """Run ``fn`` ``n`` times under `torch.profiler` (CUDA activity only)
    and return ``(device ms per call, {op name: device ms per call})``
    summed over every kernel, copy and fill the calls put on the card.
    A session can lose a few events of short kernels (on the H100, 17 of
    20 launches of a 6 µs kernel recorded), so an op's time per call is
    its mean time per event times its events per call, ``ceil(events /
    n)``: exact when ``fn`` launches the same kernels at every call and no
    op loses ``n`` events or more.  A session that records no device
    activity is run again, up to `PROFILE_ATTEMPTS` sessions in all; then
    it raises."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                by_name[e.key] = us / 1e3 / e.count * -(-e.count // n)
        if by_name:
            return sum(by_name.values()), by_name
    raise RuntimeError(f"torch.profiler recorded no device activity in "
                       f"{PROFILE_ATTEMPTS} sessions")


def idle_share(sim, n_steps: int, remeasure=False) -> dict:
    """Share of the wall time of ``n_steps`` steps in which the card is idle.

    The same steps run again and again from the same state: first timed
    with CUDA events (the wall time, with no profiler on the host), then
    `IDLE_SESSIONS` times under `device_profile` (the device busy time,
    the largest of the sessions').  Every run must give the same solver
    iteration counts, so every window did the same work; the simulation
    ends ``n_steps`` ahead.  Returns per-step ``wall_ms``,
    ``busy_ms`` and ``by_name`` (device ms by op), and ``idle_share`` =
    1 - busy / wall."""
    if sim.device.type != "cuda":
        raise ValueError(f"idle_share measures CUDA simulations; this one is "
                         f"on {sim.device}")
    flow, levels = sim.flow, sim.levels
    n_pois, n_dts = len(sim.pois_n), len(sim.dts)
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
        del sim.pois_n[n_pois:], sim.dts[n_dts:]
        sim.steps(n_steps, remeasure=remeasure)

    busy, by_name = 0.0, {}
    for _ in range(IDLE_SESSIONS):
        b, ops = device_profile(from_start)
        if sim.pois_n[n_pois:] != timed:
            raise RuntimeError(f"the profiled steps solved differently: "
                               f"pois_n {sim.pois_n[n_pois:]} vs {timed}")
        if b > busy:
            busy, by_name = b, ops
    busy /= n_steps
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "by_name": {k: v / n_steps for k, v in by_name.items()},
            "pois_n": timed, "steps": n_steps}
