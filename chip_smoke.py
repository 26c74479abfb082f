#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`waterlily_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. card record: name and power limit (nvidia-smi), CUDA, nvcc, triton;
2. build of the hand-written kernels from ``waterlily_tpu_torch/csrc``;
3. every kernel against its plain PyTorch version on the card at the
   slice's shapes (exact for the stencils, 1e-5 relative for the matvec
   dot, 1e-5 absolute for the PCG smooth);
4. the slice: ``sphere_3d(96, 64)`` constructed and stepped 20 times on the
   card with every kernel launch-counted, then 3 steps from the same initial
   state on the CPU (plain versions), compared: pois_n, dt, u, p;
5. timing: ms/step, MLUPS, ns/DOF and the card's idle share at (96,64,64)
   and for ``sphere_3d(256, 256, bbox=False)``, and each kernel next to
   its plain version.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script prints no result and exits 2.  Imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

FINE = (98, 66, 66)          # ghost-padded (96, 64, 64)
PCG_LEVEL = (50, 34, 34)     # the first coarse level, the PCG kernel's
RAGGED = (37, 29, 35)        # non-cubic, 37555 cells: a ragged last block
PCG_RAGGED = (23, 17, 29)


def log(msg=""):
    print(msg, flush=True)


def card_record(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    from waterlily_tpu_torch.kernels.build import _nvcc
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton
        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import: {e}")
    return card


def check_kernels(torch, dev):
    from waterlily_tpu_torch.kernels.check import KERNELS, compare
    worst = {}
    failures = []
    for name in KERNELS:
        shapes = ((PCG_LEVEL, PCG_RAGGED) if name == "pcg_fused"
                  else (FINE, RAGGED))
        for S in shapes:
            for row in compare(name, S, 1, dev):
                log(f"  {row['output']:<20} {str(row['shape']):<14} "
                    f"max|d|={row['max_abs_err']:.3e} ulp={row['max_ulp']} "
                    f"[{row['tolerance']}] {'ok' if row['ok'] else 'FAIL'}")
                worst[name] = max(worst.get(name, 0.0), row["max_abs_err"])
                if not row["ok"]:
                    failures.append(row)
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    return worst


def pois_ok(a, b):
    d = [abs(x - y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return all(v == 0 for v in d) or (all(v <= 2 for v in d) and sum(d) <= 4)


def run_slice(torch, dev):
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.flow import mom_step
    from waterlily_tpu_torch.ops.stencil_kernels import kernel_wrappers
    from waterlily_tpu_torch.convert import levels_from_numpy

    kernels = kernel_wrappers()
    for w in kernels.values():
        w.launches = 0
    t0 = time.perf_counter()
    sim = sphere_3d(96, 64, device=dev)
    torch.cuda.synchronize()
    log(f"constructed sphere_3d(96, 64) on {dev} in "
        f"{time.perf_counter() - t0:.2f} s")
    init = sim.flow
    init_levels = sim.levels
    t0 = time.perf_counter()
    sim.steps(20, remeasure=False)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in kernels.items()}
    log(f"20 steps in {time.perf_counter() - t0:.2f} s; pois_n "
        f"{sim.pois_n}; dt {sim.dts[-1]}")
    log(f"launches on the main path: {launches}")
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    f = sim.flow
    S = sim.cfg.S
    assert tuple(f.u.shape) == (3,) + S and tuple(f.p.shape) == S
    for k in ("u", "p", "dt"):
        if not bool(torch.isfinite(getattr(f, k)).all()):
            raise AssertionError(f"non-finite {k} after 20 steps")

    # the same initial state, 3 steps on the CPU (plain versions)
    cpu = torch.device("cpu")
    state = dataclasses.replace(
        init, **{k.name: getattr(init, k.name).cpu()
                 for k in dataclasses.fields(init)})
    levels = levels_from_numpy(
        [{"L": l.L.cpu().numpy(), "D": l.D.cpu().numpy(),
          "iD": l.iD.cpu().numpy()} for l in init_levels], cpu)
    cfg = dataclasses.replace(sim.cfg, device=cpu)
    pois, dts = [], []
    t0 = time.perf_counter()
    for _ in range(3):
        state, aux = mom_step(cfg, levels, state)
        pois.append(aux["pois_n"])
        dts.append(float(aux["dt"]))
    log(f"3 CPU steps in {time.perf_counter() - t0:.1f} s: pois_n {pois}, "
        f"dt {dts}")
    log(f"GPU first 3 steps: pois_n {sim.pois_n[:3]}, dt {sim.dts[1:4]}")
    if not pois_ok(sim.pois_n[:3], pois):
        raise AssertionError(f"pois_n GPU {sim.pois_n[:3]} vs CPU {pois}")
    for a, b in zip(sim.dts[1:4], dts):
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"dt GPU {sim.dts[1:4]} vs CPU {dts}")
    # the GPU state after 3 steps, recomputed from the same start
    g = init
    for _ in range(3):
        g, _aux = mom_step(sim.cfg, init_levels, g)
    du = float((g.u.cpu() - state.u).abs().max())
    dp = float((g.p.cpu() - state.p).abs().max())
    log(f"after 3 steps: max|du| = {du:.3e}, max|dp| = {dp:.3e}")
    return sim, launches


def step_profile(sim, n, label):
    """The card's idle share over ``n`` steps: device busy time and wall
    time of the same steps (`utils.perf.idle_share`), and the ops that
    take the busy time."""
    from waterlily_tpu_torch.utils.perf import idle_share
    r = idle_share(sim, n)
    log(f"{label}: idle share {r['idle_share']:.4f}: device busy "
        f"{r['busy_ms']:.4f} ms/step of {r['wall_ms']:.4f} ms/step wall "
        f"(the same {n} steps, pois_n {r['pois_n']}; wall timed without "
        f"the profiler)")
    top = sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top:
        log(f"    {ms:9.4f} ms/step  {name[:90]}")


def timing(torch, dev, sim):
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.utils.perf import time_steps
    from waterlily_tpu_torch.kernels.check import KERNELS, time_pair

    r = time_steps(sim, 50, warmup=10)
    log(f"sphere_3d(96, 64): {r['sec_per_step'] * 1e3:.3f} ms/step, "
        f"{r['mlups']:.1f} MLUPS, {r['ns_per_dof']:.3f} ns/DOF "
        f"(50 steps after 10 warm-up; pois_n last {sim.pois_n[-1]})")
    step_profile(sim, 20, "sphere_3d(96, 64)")
    times = {}
    for name in KERNELS:
        S = PCG_LEVEL if name == "pcg_fused" else FINE
        t = time_pair(name, S, dev)
        times[name] = t
        log(f"  {name:<12} {str(S):<14} device (profiler): kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; wall per call: "
            f"kernel {t['wall_ms']:.4f} ms, plain {t['plain_wall_ms']:.4f} ms")

    del sim
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    big = sphere_3d(256, 256, bbox=False, device=dev)
    torch.cuda.synchronize()
    log(f"constructed sphere_3d(256, 256, bbox=False) in "
        f"{time.perf_counter() - t0:.1f} s")
    rb = time_steps(big, 10, warmup=2)
    if not bool(torch.isfinite(big.flow.u).all()):
        raise AssertionError("non-finite u at 256^3")
    log(f"sphere_3d(256, 256, bbox=False): {rb['sec_per_step'] * 1e3:.2f} "
        f"ms/step, {rb['mlups']:.1f} MLUPS, {rb['ns_per_dof']:.3f} ns/DOF, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(10 steps after 2 warm-up; pois_n {big.pois_n[-3:]})")
    step_profile(big, 5, "sphere_3d(256, 256, bbox=False)")
    return times


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    try:
        import waterlily_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: waterlily_tpu_torch not importable: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 1. card")
    card = card_record(torch)
    log("== 2. kernel build")
    from waterlily_tpu_torch.kernels.build import library, build_seconds
    t0 = time.perf_counter()
    library()
    log(f"kernel library ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build_seconds():.1f} s)")
    log("== 3. kernels vs plain versions")
    worst = check_kernels(torch, dev)
    log("== 4. the slice: sphere_3d(96, 64)")
    sim, launches = run_slice(torch, dev)
    log("== 5. timing")
    times = timing(torch, dev, sim)

    from waterlily_tpu_torch.kernels.check import SOURCES
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k][0],
                "replaces": SOURCES[k][1], "launches": launches[k],
                "max_abs_err": worst[k], "ms": times[k]["ms"],
                "plain_ms": times[k]["plain_ms"]} for k in SOURCES]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
