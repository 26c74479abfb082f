"""Time kernels and cases of the PyTorch/CUDA port on one GPU, one JSON line
each.

    python -m waterlily_tpu_torch.kernels.times conv_diff3d:258,258,258 \\
        conv_diff3d:258,258,258:quick_p012 dot3d:130,130,130:ab \\
        bc3d:258,258,258:exit pcg_fused:50,34,34 barrier:113 \\
        case:sphere_3d:256,256 case:sphere_3d:256,256:banded_levels=True \\
        case:tgv_2d:64 \\
        call:ops.stencil_kernels.mult3d:258,258,258:L16,D16,x@bfloat16,False

A kernel argument is ``kernel:shape[:variant]`` (the variant by index or
by its first output's name, as `kernels.check.variants` lists them); its
line holds the kernel's and its plain version's device ms per call
(`check.time_pair`: profiler, each call on the next of three copies of its
inputs), its bound, and for a kernel with a one-call PyTorch yardstick
(`check.LIBRARY`, timed on its first variant) that call's ms; a variant
the checkout does not have gives a line with ``"missing": true``.  A
``barrier:blocks`` argument times a trivial cooperative kernel of that
many blocks (``csrc/pcg.cu`` `grid_sync_probe`, on no path): its launch
alone and the cost of one grid barrier, the unit of `pcg_fused`'s sync
floor.  A ``call:module.function:shape:args`` argument times one
function of the port on `kernels.check.inputs`' seeded fields at that
shape, each call on the next of three copies, device and wall ms per
call: a form that one checkout's `check.variants` lacks is timed the
same way in both (``args``: Python literals, or input names, a key of
`check.inputs` or ``lev.L``, ``lev.D``, ``lev.iD``, with ``@dtype`` for a
copy in that dtype).  A case argument is
``case:name:args[:key=value...]``, a model of the package's top level
with integer arguments and keyword flags (Python literals,
``banded_levels=True``): its line holds ms/step
(`utils.perf.time_steps`; 10 steps after 2 in 3D, 50 after 10 in 2D), the
device busy ms/step and idle share of further steps
(`utils.perf.idle_share`; 5 in 3D, 20 in 2D), the ops that take most
of the busy time and the pressure iterations of every step.  A
``twin:name:args[:key=value...]`` argument steps the case 3 times on the
card and 3 times on the CPU (plain versions) from the card's initial
state and levels: both runs' pressure iterations and the largest
relative difference of their time steps (with ``op_bf16=True`` the CPU
levels stay blocked and keep their shadows).  A
``remeasure:name:args[:key=value...]`` argument steps the case twice and
then times six calls of its `Simulation.measure` (wall seconds each,
synchronised), the moving-body remeasure alone.  An
``orders:S0,S1,S2`` argument runs the blocked-level smoother with bf16
directions (`ops.attic.pcg_blocked`, one smooth of `check.inputs`' level
and residual at that shape) on the card and on the CPU with 1, 2, 4 and
8 threads: the mean |Δx| and |Δr| of every pair (the card's sums and
the CPU's at each thread count add in other orders; a different order
can round a direction value to the neighbouring bf16 value).  A
``sweep:kind:M`` argument steps the (96,64,64) sphere's drag (a radius-8
sphere at 31, ν 0.16, the adaptive solve at tol 1e-5) under
``torch.func.vmap`` over M radii from 7 to 9 (``kind`` radius) or M values
of ν from 0.08 to 0.32 (``nu``): busy and wall ms a step (5 steps less the
set-up and force alone), idle share and peak GiB, beside one member alone;
it uses only functions the port has had since its ensembles (so ``--trees``
times a tree without the stencils' member forms the same way).
``--set module.NAME=value`` sets a module constant of the port first
(``--set ops.attic.DOT_ROWS_MIN=8``).  The first line is the card's name
and power limit.

``--trees A,B`` runs the same arguments on two checkouts in turns (A, B,
B, A), each in a process of its own that imports that checkout's package
(this file run by path with ``PYTHONPATH`` set to the checkout): two trees
compared in one run on one card.
"""
from __future__ import annotations

import ast
import functools
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path


def _card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def _set(assignment: str) -> None:
    target, value = assignment.split("=", 1)
    module, name = target.rsplit(".", 1)
    mod = importlib.import_module(f"waterlily_tpu_torch.{module}")
    setattr(mod, name, ast.literal_eval(value))


def _kernel(spec: str, dev) -> dict:
    import torch
    from waterlily_tpu_torch.kernels import check
    name, shape, *rest = spec.split(":")
    S = tuple(int(v) for v in shape.split(","))
    variant = rest[0] if rest else 0
    if isinstance(variant, str) and variant.isdigit():
        variant = int(variant)
    # a kernel or variant the checkout lacks gives a "missing" line
    names = ([(v[0] or ("",))[0] for v in check.variants(
        name, check._fresh_inputs(S, 0, dev))] if name in check.SOURCES
        else [])
    if (variant >= len(names) if isinstance(variant, int)
            else variant not in names):
        return {"kernel": name, "shape": S, "variant": variant,
                "missing": True}
    t = check.time_pair(name, S, dev, variant=variant)
    b, by = check.bound_ms(name, S, None if variant == 0 else variant)
    row = {"kernel": name, "shape": S, "variant": variant, **t,
           "bound_ms": b, "bound_by": by}
    if name in check.LIBRARY and variant == 0:
        row["library_ms"] = check.time_library(name, S, dev)
    check.clear_inputs()
    torch.cuda.empty_cache()
    return row


def _barrier(spec: str, dev, n=200, reps=20) -> dict:
    """A cooperative launch of ``blocks`` blocks with no grid barrier and
    with ``n``: device ms (profiler) of the empty launch and of one
    barrier, and the wall ms per back-to-back launch (CUDA events)."""
    import torch
    from waterlily_tpu_torch.kernels.build import launch
    from waterlily_tpu_torch.utils.perf import device_profile
    blocks = int(spec.split(":")[1])

    def wall(syncs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch("wl_grid_sync_probe", blocks, syncs)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps

    def device(syncs):
        return device_profile(
            lambda: launch("wl_grid_sync_probe", blocks, syncs), reps)[0]

    wall(n)  # warm-up
    d0, dn = device(0), device(n)
    return {"barrier_blocks": blocks, "launch_ms": d0,
            "barrier_ms": (dn - d0) / n, "launch_wall_ms": wall(0),
            "syncs": n}


def _call(spec: str, dev, n=20) -> dict:
    """Device ms per call (profiler, the mean of two sessions) and wall ms
    (CUDA events) of ``call:module.function:shape:args``, rotating over
    `check.ROTATE` input sets."""
    import torch
    from waterlily_tpu_torch.kernels import check
    from waterlily_tpu_torch.utils.perf import device_profile
    _, target, shape, args = spec.split(":")
    module, name = target.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"waterlily_tpu_torch.{module}"),
                 name)
    S = tuple(int(v) for v in shape.split(","))

    def value(d, arg):
        key, _, dtype = arg.partition("@")
        if key.startswith("lev."):
            v = getattr(d["lev"], key[4:])
        elif key in d:
            v = d[key]
        else:
            return ast.literal_eval(arg)
        return v.to(getattr(torch, dtype)) if dtype else v

    calls = [functools.partial(fn, *(value(d, a) for a in args.split(",")))
             for d in check._input_sets(S, dev)]
    for c in calls:
        c()
    torch.cuda.synchronize()
    f = check._rotating(calls)
    wall = (check._timed(f, n) + check._timed(f, n)) / 2
    ms = (device_profile(f, n, events=True)[0]
          + device_profile(f, n, events=True)[0]) / 2
    # the drawn inputs stay (`check.clear_inputs`) for the next call at S
    del calls, f
    torch.cuda.empty_cache()
    return {"call": target, "shape": S, "args": args, "ms": ms,
            "wall_ms": wall}


def case_spec(spec: str) -> tuple[str, tuple, dict, str]:
    """``case:name:args[:key=value...]`` as (model name, integer arguments,
    keyword flags, label)."""
    _, name, args, *flags = spec.split(":")
    kw = {k: ast.literal_eval(v) for k, v in (f.split("=", 1) for f in flags)}
    return (name, tuple(int(v) for v in args.split(",")), kw,
            f"{name}({', '.join([args, *flags])})")


def _case(spec: str, dev) -> dict:
    import torch
    import waterlily_tpu_torch as wt
    from waterlily_tpu_torch.utils.perf import time_steps, idle_share
    name, args, kw, label = case_spec(spec)
    sim = getattr(wt, name)(*args, device=dev, **kw)
    three = len(sim.cfg.S) == 3
    t = time_steps(sim, 10 if three else 50, warmup=2 if three else 10)
    r = idle_share(sim, 5 if three else 20)
    row = {"case": label, "ms_per_step": t["sec_per_step"] * 1e3,
           "busy_ms": r["busy_ms"], "wall_ms": r["wall_ms"],
           "idle_share": r["idle_share"], "pois_n": sim.pois_n,
           "by_op_ms": dict(sorted(r["by_name"].items(),
                                   key=lambda kv: -kv[1])[:15]),
           "finite": bool(torch.isfinite(sim.flow.u).all())}
    del sim
    torch.cuda.empty_cache()
    return row


def _remeasure(spec: str, dev, n=6) -> dict:
    """Wall seconds of each of ``n`` calls of a case's `measure` after 2
    steps."""
    import time
    import torch
    import waterlily_tpu_torch as wt
    name, args, kw, label = case_spec(spec)
    sim = getattr(wt, name)(*args, device=dev, **kw)
    sim.steps(2)
    secs = []
    for _ in range(n):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sim.measure()
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
    del sim
    torch.cuda.empty_cache()
    return {"remeasure": label, "s": secs, "median_s": sorted(secs)[n // 2]}


def _twin(spec: str, dev, n=3) -> dict:
    """``n`` steps of a case on the card and ``n`` on the CPU from the
    card's initial state and levels: pois_n of both, dt's largest
    relative difference and the CPU's seconds."""
    import dataclasses
    import time
    import torch
    import waterlily_tpu_torch as wt
    from waterlily_tpu_torch.convert import flow_to, levels_to
    from waterlily_tpu_torch.flow import mom_step
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    name, args, kw, label = case_spec(spec)
    sim = getattr(wt, name)(*args, device=dev, **kw)
    init, levels = sim.flow, sim.levels
    sim.steps(n, remeasure=False)
    cpu = torch.device("cpu")
    gate = sk.use_blocked
    if kw.get("op_bf16"):
        # a CPU copy of a shadowed level stays blocked, with its shadows
        sk.use_blocked = lambda S, dtype, device: gate(S, dtype, "cuda")
    t0 = time.perf_counter()
    try:
        state, lv = flow_to(init, cpu), levels_to(levels, cpu)
        cfg = dataclasses.replace(sim.cfg, device=cpu)
        pois, dts = [], []
        for _ in range(n):
            state, aux = mom_step(cfg, lv, state)
            pois.append(aux["pois_n"])
            dts.append(float(aux["dt"]))
    finally:
        sk.use_blocked = gate
    row = {"twin": label, "pois_n": sim.pois_n, "cpu_pois_n": pois,
           "dt_rel": max(abs(a - b) / abs(b)
                         for a, b in zip(sim.dts[1:], dts)),
           "cpu_s": time.perf_counter() - t0}
    del sim, init, levels
    torch.cuda.empty_cache()
    return row


def _orders(spec: str, dev) -> dict:
    """Mean |Δx|, |Δr| between the bf16-direction smooth on the card and
    on the CPU at 1, 2, 4 and 8 threads, every pair (each run's own sum
    order), at the shape of ``orders:S0,S1,S2``."""
    import dataclasses
    import torch
    from waterlily_tpu_torch.kernels.check import inputs
    from waterlily_tpu_torch.ops import attic as at
    S = tuple(int(v) for v in spec.split(":")[1].split(","))

    def smooth(device):
        d = inputs(S, 0, device)
        lev = dataclasses.replace(d["lev"], blocked=True, bf16_eps=True)
        x, r = at.pcg_blocked(lev, torch.zeros_like(d["r"]), d["r"])
        return x.cpu(), r.cpu()

    runs = {"card": smooth(dev)}
    threads = torch.get_num_threads()
    try:
        for t in (1, 2, 4, 8):
            torch.set_num_threads(t)
            runs[f"cpu{t}"] = smooth(torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    names = list(runs)
    return {"orders": list(S), "mean_abs_dx_dr": {
        f"{a} vs {b}": [float((p - q).abs().mean())
                        for p, q in zip(runs[a], runs[b])]
        for i, a in enumerate(names) for b in names[i + 1:]}}


def _sweep(spec: str, dev, steps=5) -> dict:
    """Busy and wall ms a step of ``sweep:kind:M`` and of its first member
    alone, the idle share and peak GiB (see the module docstring)."""
    import torch
    from waterlily_tpu_torch.body import AutoBody, measure_fields
    from waterlily_tpu_torch.flow import FlowConfig, flow_init, mom_step
    from waterlily_tpu_torch.metrics import total_force
    from waterlily_tpu_torch.ops.multigrid import build_levels
    from waterlily_tpu_torch.utils.perf import device_profile
    _, kind, M = spec.split(":")
    S, f32 = (98, 66, 66), torch.float32
    lo, hi = (7.0, 9.0) if kind == "radius" else (0.08, 0.32)
    vs = torch.linspace(lo, hi, int(M), device=dev)

    def drag(v, n):
        nu, radius = (0.16, v) if kind == "radius" else (v, 8.0)
        body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - 31.0) ** 2))
                        - radius)
        cfg = FlowConfig(D=3, S=S, device=dev, nu=nu, U=(1.0, 0.0, 0.0),
                         dtype=f32, tol=1e-5)
        V, m0, m1, _ = measure_fields(body, S, 0.0, 1.0, (), False, f32, dev)
        levels = build_levels(m0)
        state = flow_init(cfg).replace(V=V, mu0=m0, mu1=m1)
        for _ in range(n):
            state, _aux = mom_step(cfg, levels, state)
        return total_force(state.u, state.p, cfg.nu, body, state.t)[0]

    def cost(call):
        call(steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {}
        for n in (steps, 0):
            busy = device_profile(lambda: call(n), 1, events=True)[0]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            call(n)
            end.record()
            torch.cuda.synchronize()
            out[n] = (busy, start.elapsed_time(end))
            if n:
                gib = torch.cuda.max_memory_allocated() / 2 ** 30
        busy = (out[steps][0] - out[0][0]) / steps
        wall = (out[steps][1] - out[0][1]) / steps
        return {"busy_ms": busy, "wall_ms": wall, "idle": 1 - busy / wall,
                "peak_gib": gib}
    row = {"sweep": kind, "members": int(M), "steps": steps,
           "ensemble": cost(lambda n: torch.func.vmap(
               lambda v: drag(v, n))(vs)),
           "one_member": cost(lambda n: drag(vs[0], n))}
    torch.cuda.empty_cache()
    return row


def run(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("times: no CUDA device", file=sys.stderr)
        return 2
    sets = [a.split("=", 1)[1] for a in argv if a.startswith("--set=")]
    specs = [a for a in argv if not a.startswith("--set=")]
    for a in sets:
        _set(a)
    import waterlily_tpu_torch
    print(f"{_card()}; {Path(waterlily_tpu_torch.__file__).parent.parent}"
          + (f"; set {sets}" if sets else ""), flush=True)
    dev = torch.device("cuda", 0)
    for spec in specs:
        kind = spec.split(":")[0]
        row = {"case": _case, "barrier": _barrier, "call": _call,
               "twin": _twin, "remeasure": _remeasure,
               "orders": _orders, "sweep": _sweep}.get(
                   kind, _kernel)(spec, dev)
        print(json.dumps(row), flush=True)
    return 0


def main(argv) -> int:
    # --set A=B and --trees A,B also as two words
    args, i = [], 0
    while i < len(argv):
        if argv[i] in ("--set", "--trees"):
            args.append(f"{argv[i]}={argv[i + 1]}")
            i += 2
        else:
            args.append(argv[i])
            i += 1
    trees = [a.split("=", 1)[1] for a in args if a.startswith("--trees=")]
    if not trees:
        return run(args)
    rest = [a for a in args if not a.startswith("--trees=")]
    a, b = trees[0].split(",")
    rc = 0
    for tree in (a, b, b, a):
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
        rc |= subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              *rest], env=env).returncode
    return rc


if __name__ == "__main__":
    # run by path, this directory leads sys.path; the port is imported from
    # PYTHONPATH (or the working directory's checkout under -m) instead
    if Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    sys.exit(main(sys.argv[1:]))
