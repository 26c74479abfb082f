"""One run of one benchmark cell, driven by the files that name it.

`BENCHMARK.json` names each cell's configuration and traffic mix; the
harness reads ``configs/<config>.json``, its kind's closures from
``kinds/<kind>.py``, its timed entry from ``entries/<entry>.py`` (the
configuration's ``"entry"``, `DEFAULT_ENTRY` where it names none),
``traffic/<traffic>.json``, the correctness limits from
``limits/<cell>.json`` and each metric's reader from
``metrics/<metric>.py``.  Adding a cell, a configuration, an entry, a mix
or a metric adds files and entries; no file here changes.

A run: the entry builds the cell's program on the device from the seed;
set-up takes the mix's warm-up units (the entry judges the first); then
the entry's unit runs in a closed loop for ``seconds``, each timed by the
host clock (each unit ends in its own host read); the peak memory is read;
the entry takes one more unit, judged; the program is dropped, the
entry's reference judges what it kept, and the one result line is
printed.  `entries/step.py` sets out what an entry provides.  A traced run
(``trace=True``) puts ranges around the program's layers and records
``trace_steps`` units of the window with `torch.profiler`.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import trace, traffic

__all__ = ["ROOT", "REPO", "manifest", "cell_files", "cell_metrics",
           "entry_file", "run"]

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# the folder of the timed entries, and the entry of a configuration that
# names none
ENTRIES = ROOT / "entries"
DEFAULT_ENTRY = "step"
# the packages no part of a run may load (compared by top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "waterlily_tpu")
# profiler sessions a traced run tries before it gives up on an empty one
TRACE_SESSIONS = 3


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def load_module(path: Path):
    """The module in file ``path`` (found by name, not installed)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(man: dict, name: str) -> tuple[dict, dict, dict]:
    """``(cell, configuration, mix)`` of the cell ``name``."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    cfg = json.loads((REPO / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((ROOT / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    return cell, cfg, mix


def entry_file(cfg: dict) -> Path:
    """The file of configuration ``cfg``'s timed entry."""
    return ENTRIES / f"{cfg.get('entry', DEFAULT_ENTRY)}.py"


def cell_metrics(man: dict, name: str, traced: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end ones, or
    with ``traced`` its per-layer ones (a metric without ``workloads``
    wherever the end-to-end metric it moves is reported)."""
    def here(m):
        return name in m["workloads"] if "workloads" in m else True
    e2e = [m for m in man["end_to_end"] if here(m)]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def _card(device) -> dict:
    """The card's name, count and power limit, as its tools report them."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={torch.device(device).index or 0}"],
            capture_output=True, text=True, timeout=20)
        info["power_limit"] = got.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit"] = "not read"
    return info


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        device="cuda", t_start: float | None = None, options=None,
        cfg_override=None, mix_override=None, detail=None,
        log=print) -> dict:
    """One run of cell ``cell_name``; returns the result line's object.
    ``options`` are extra arguments of the program, handed to the entry's
    ``build`` (a control run's lower precision); ``cfg_override`` replaces
    configuration keys (a small grid in a test), ``mix_override`` mix
    keys; ``detail`` (a dict) receives the run's record and every number
    of the comparison."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest()
    _, cfg, mix = cell_files(man, cell_name)
    cfg = {**cfg, **(cfg_override or {})}
    mix = {**mix, **(mix_override or {})}
    limits = json.loads((ROOT / "limits" / f"{cell_name}.json").read_text())
    kind = load_module(ROOT / "kinds" / f"{cfg['kind']}.py")
    entry = load_module(entry_file(cfg))
    setup = kind.setup(cfg, mix.get("motion"))
    dtype = getattr(torch, cfg["dtype"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        from waterlily_tpu_torch.kernels.build import build_seconds, library
        library()
        log(f"kernel library: nvcc {build_seconds():.1f} s", file=sys.stderr)
        torch.cuda.reset_peak_memory_stats(dev)

    pert = traffic.perturbation(mix, seed, setup["dims"], dev, dtype)
    ulam = traffic.initial_velocity(setup["base"], pert, setup["U"])
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    spans = trace.spans() if traced else contextlib.nullcontext()
    with spans:
        t0 = time.perf_counter()
        prog = entry.build(setup, cfg, mix, ulam, dtype, dev, options)
        sync()
        construct_s = time.perf_counter() - t0
        for _ in range(int(mix["warmup_steps"])):
            prog.advance()
        sync()
        setup_s = time.perf_counter() - t_start

        # the measured window: a closed loop of the entry's unit
        step_s, sessions = [], []
        n0 = None if prog.counts is None else len(prog.counts)
        skip, n_tr = int(mix["trace_skip"]), int(mix["trace_steps"])
        prof, prof_end = None, -1
        w0 = time.perf_counter()
        while True:
            k = len(step_s)
            if traced and prof is None and k >= skip and (
                    not sessions or sessions[-1]["busy_s"] <= 0) and (
                    len(sessions) < TRACE_SESSIONS):
                prof = _profiler()
                prof.__enter__()
                prof_end = k + n_tr
            a = time.perf_counter()
            if traced:
                with torch.profiler.record_function(trace.STEP):
                    prog.advance()
            else:
                prog.advance()
            b = time.perf_counter()
            step_s.append(b - a)
            if prof is not None and len(step_s) == prof_end:
                prof.__exit__(None, None, None)
                got = trace.read_session(prof)
                got["pois"] = _counts(prog, n0, prof_end - n_tr, prof_end)
                sessions.append(got)
                prof = None
            traced_enough = not traced or (sessions and (
                sessions[-1]["busy_s"] > 0
                or len(sessions) >= TRACE_SESSIONS))
            if b - w0 >= seconds and prof is None and traced_enough:
                break
        window_s = b - w0
        pois_window = _counts(prog, n0, 0, len(step_s))
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

        # one more unit of the timed entry, judged against the reference
        kept = prog.finish()
        failed, cells, counts = prog.failed(), prog.cells, prog.counts
    # the program's memory goes before the reference takes its own
    del prog
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    nums = entry.judge(kept, setup, cfg, mix, ulam, dtype, dev)
    ref_s = time.perf_counter() - t_ref

    compared = {k: [nums[k], float(v)] for k, v in limits.items()}
    correct = failed == 0 and all(v <= lim for v, lim in compared.values())
    rec = {"cells": cells, "S": tuple(
        n + 2 for n in setup["dims"]), "steps": len(step_s),
        "step_s": step_s, "window_s": window_s, "setup_s": setup_s,
        "peak_bytes": peak, "construct_s": construct_s,
        "pois": pois_window, "trace": None}
    result_device = _card(dev) if cuda else {
        "platform": dev.type, "kind": "cpu", "count": 1}
    result_device["memory_peak_bytes"] = int(peak)
    if traced:
        if not sessions or sessions[-1]["busy_s"] <= 0:
            raise RuntimeError("no profiler session recorded device activity")
        tr = sessions[-1]
        if tr["busy_s"] > tr["window_s"]:
            raise RuntimeError(f"device busy {tr['busy_s']} s exceeds the "
                               f"traced window's {tr['window_s']} s")
        rec["trace"] = tr
        result_device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    metrics = {}
    for m in cell_metrics(man, cell_name, traced):
        reader = load_module(ROOT / "metrics" / f"{m['name']}.py")
        v = reader.read(rec)
        if v is None:
            continue
        if m["unit"] == "%" and not 0 <= v <= 100:
            raise RuntimeError(f"{m['name']} reads {v}%, outside 0-100: "
                               f"work counted too high or time missed")
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    log(f"cell {cell_name} seed {seed}: {len(step_s)} steps in "
        f"{window_s:.3f} s, warm-up {mix['warmup_steps']}, set-up "
        f"{setup_s:.3f} s (construction {construct_s:.3f} s), reference "
        f"{ref_s:.3f} s; counts first {counts and counts[0]} last "
        f"{counts and counts[-1]}; "
        f"card {result_device.get('kind')} power limit "
        f"{result_device.get('power_limit', 'n/a')}", file=sys.stderr)
    for k, v in nums.items():
        if k not in limits:
            log(f"diagnostic {k} {v:.6g}", file=sys.stderr)
    out = {"correct": bool(correct), "attempted": len(step_s),
           "failed": failed, "metrics": metrics, "device": result_device}
    if traced:
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
        log(f"trace: {rec['trace']['steps']} steps, busy "
            f"{rec['trace']['busy_s']:.6f} s of {rec['trace']['window_s']:.6f}"
            f" s, launches matched {rec['trace']['matched']:.4f}, ranges "
            f"{rec['trace']['range_s']}", file=sys.stderr)
    out["check"] = compared
    if detail is not None:
        detail.update(rec=rec, numbers=nums, ref_s=ref_s)
    return out


def _counts(prog, n0, a, b) -> list:
    """The program's counts of units ``a`` to ``b`` of the window (none
    where the entry keeps none)."""
    return [] if n0 is None else prog.counts[n0 + a:n0 + b]


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def loaded_forbidden() -> list[str]:
    """The forbidden packages in ``sys.modules``, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})
