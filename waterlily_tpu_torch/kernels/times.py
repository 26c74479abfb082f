"""Time kernels and cases of the PyTorch/CUDA port on one GPU, one JSON line
each.

    python -m waterlily_tpu_torch.kernels.times conv_diff3d:258,258,258 \\
        conv_diff3d:258,258,258:quick_p012 dot3d:130,130,130:ab \\
        bc3d:258,258,258:exit pcg_fused:50,34,34 barrier:113 \\
        case:sphere_3d:256,256 case:sphere_3d:256,256:banded_levels=True \\
        case:tgv_2d:64

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
floor.  A case argument is ``case:name:args[:key=value...]``, a model of
the package's top level with integer arguments and keyword flags (Python
literals, ``banded_levels=True``): its line holds ms/step
(`utils.perf.time_steps`; 10 steps after 2 in 3D, 50 after 10 in 2D), the
device busy ms/step and idle share of further steps
(`utils.perf.idle_share`; 5 in 3D, 20 in 2D) and the ops that take most
of the busy time.
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
           "idle_share": r["idle_share"], "pois_n": sim.pois_n[-1],
           "by_op_ms": dict(sorted(r["by_name"].items(),
                                   key=lambda kv: -kv[1])[:15]),
           "finite": bool(torch.isfinite(sim.flow.u).all())}
    del sim
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
        row = (_case if kind == "case" else
               _barrier if kind == "barrier" else _kernel)(spec, dev)
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
