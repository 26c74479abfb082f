"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload sphere_384.static --seed 7 \\
        --seconds 30 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``check``: each compared number beside its limit).
A run needs a CUDA card: without one, or without the program beside the
benchmark, it exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches at fixed paths inside the checkout: only a checkout's first run
    # builds (the kernel library goes to waterlily_tpu_torch/_build/)
    os.environ.setdefault("CUDA_CACHE_PATH", str(HERE / ".cache" / "nv"))
    sys.path.insert(0, str(REPO))
    cells = {w["name"]: w for w in json.loads(
        (REPO / "BENCHMARK.json").read_text())["workloads"]}
    if args.workload not in cells:
        print(f"benchmark: no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); a run "
              f"measures the card and never falls back to the CPU",
              file=sys.stderr)
        return 2
    from benchmark import harness
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda:0", t_start=T_START)
    found = harness.loaded_forbidden()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, (value, limit) in out["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
