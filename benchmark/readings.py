"""Readings for the correctness limits: one cell's compared numbers over
many seeds of the program and of its control, in one process.

    python3 benchmark/readings.py --workload sphere_384.static \\
        --seeds 101-112 --control-seeds 201-203 --seconds 2

The control is the program with its own lower-precision path switched on:
``Simulation(smoother_bf16=True)``, the pressure smoother's search
directions stored in bfloat16 on the blocked levels.  Each run prints one
JSON line: the workload, the seed, ``control``, ``correct`` and every
number of the comparison.  The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CONTROL = {"smoother_bf16": True}


def _seeds(text):
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import harness
    runs = [(s, False) for s in _seeds(args.seeds)]
    runs += [(s, True) for s in _seeds(args.control_seeds)]
    for seed, control in runs:
        detail = {}
        t = time.perf_counter()
        out = harness.run(args.workload, seed, args.seconds, False,
                          device="cuda:0", options=CONTROL if control
                          else None, detail=detail)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": control,
            "correct": out["correct"], "numbers": detail["numbers"],
            "steps": out["attempted"], "seconds": time.perf_counter() - t,
            "pois_window": detail["rec"]["pois"][:3]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
