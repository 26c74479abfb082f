#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`waterlily_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. card record: name and power limit (nvidia-smi), CUDA, nvcc, triton;
2. build of the hand-written kernels from ``waterlily_tpu_torch/csrc``;
3. every kernel against its plain PyTorch version on the card at the
   dense slice's shapes and a ragged one (exact for the stencils, 1e-5
   relative for the matvec dots, 1e-5 absolute for the PCG smooth);
4. the dense slice: ``sphere_3d(96, 64)`` constructed and stepped 20 times
   on the card with every kernel launch-counted, then 3 steps from the same
   initial state on the CPU (plain versions), compared: pois_n, dt, u, p;
5. the banded slice, small: ``sphere_3d(48, 48, bbox="force",
   banded_levels=True)`` 3 steps on the card (``ana_mult3d`` launched) and
   on the CPU from one state, compared as in 4;
6. the banded paths at full size, each against ``bbox=False`` from the
   same start over 3 steps (equal pois_n, max|du| < 1e-3, the same μ₀):
   ``sphere_3d(256, 256)`` as it runs by default (banded BDIM window and
   narrow-band measurement, dense levels), the same with
   ``banded_levels=True`` (pois_n within the ±2/≤4 rule), and
   ``heaving_sphere_3d(radius=24)`` re-measured every step;
6.1 the periodic 3D path: ``tgv_3d(64)`` (66³, every 3D kernel in its
   periodic form) 5 steps on the card against 3 CPU steps from the same
   state as in 4, then ``tgv_3d(256)`` 3 steps (finite u, p, dt);
6.2 the convective outlet: ``sphere_3d(96, 64, exitBC=True)`` (``bc3d``
   with ``save_exit``) 3 steps against the CPU from one state;
6.3 the 2D paths (the 2D ``pcg_fused``): ``circle_2d(96, 64)``,
   ``tgv_2d(64)`` and ``oscillating_plate_2d(32)`` re-measured every step,
   each 3 steps against the CPU from one state, and the circle's
   ``metrics.total_force`` on the card against the CPU (1e-4 relative);
6.4 the blocked-level PCG paths (the `ops.attic` kernels, bf16 search
   directions and bf16 operator shadows): ``sphere_3d(256, 256)`` from one
   initial state, 3 steps in each of (a) the default, (b) ``poisson.KDOT =
   KAXPY = True``, (c) ``poisson.PCG_BLOCKED = True``, (d)
   ``smoother_bf16=True``, (e) (d) with (c), (f) ``op_bf16=True``, (g)
   ``poisson.STREAM = True`` (the carried-rows operator), (h) (f) with (g)
   and (i) (f) with (c), each against (a): finite u, p, dt; pois_n within
   the ±2/≤4 rule and max|du| < 1e-3 for (b), (c), (g), < 1e-2 for (d),
   (e); for the rounded operator (f), (h), (i) pois_n within ±2 per solve
   (the total |Δpois_n| logged) and max|du| < 1e-2; every blocked level
   carries the configuration's direction type and shadows, the kernels
   launched in the configuration's forms (bf16 L exactly where shadowed)
   and (g), (h) launched no halo-row ``mult3d``/``increment3d``; then
   ``sphere_3d(96, 64)`` in (b), (c), (d), (f) and (g) against the CPU
   from one state, as in 4 ((f)'s CPU twin with the kernel gate patched,
   so its levels are blocked and keep their shadows);
7. every kernel against its plain version again, every variant at every
   shape a path of 4-6.4 launched it at (258³, 130³, 66³, ..., the 2D
   levels) and the probes at 258³, with the tolerances of 3, and
   ``pcg_blocked`` against the per-pass ``pcg`` at the shapes
   ``pcg_dir_mult`` ran at;
8. timing: ms/step, MLUPS, ns/DOF and the card's idle share at (96,64,64),
   256³ dense and banded (in turns), 256³ ``banded_levels=True``, the
   256³ heaving sphere with its remeasure and ``tgv_3d(256)`` (with its
   kinetic energy before and after); ``circle_2d(96, 64)`` to tU/L = 50
   twice (wall seconds with construction; ms/step, idle share and the
   mean Cd over the last 10 tU/L); the plate's and ``tgv_2d(64)``'s
   ms/step; each kernel next to its plain version and its bound at
   (98,66,66) and at the largest shape a path launched it at (the shape
   the kernels line reports; each call on the next of three copies of its
   inputs, so that at 258³ no call finds its operands in L2), the
   periodic, 2D and bf16 forms at 258³, (34,34,34) and (98,66), the
   operator-shadow, bf16-iD and carried-rows forms at 258³ and
   (98,66,66), ``torch.dot`` beside ``dot3d`` and ``torch.mul`` beside
   ``copy_probe``; the probes' rates in GB/s and each kernel's bytes over
   its time as a share of the copy probe's rate; the 256³ sphere in
   configurations (a)-(i) of 6.4 in turns (a, ..., i, i, ..., a), each
   with its idle share and pois_n.

Every path runs with the launch counters set to 0 and the launched shapes
and forms cleared just before it, all read just after; a kernel of the
path that never launched fails the run.  The probes run on no path: the
kernels line gives them 0 launches and their calls in phase 8 as
``timing_launches``.  The line before the last is a JSON object with one
entry per kernel; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script prints no result and exits 2.  Imports
no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

FINE = (98, 66, 66)          # ghost-padded (96, 64, 64)
PCG_LEVEL = (50, 34, 34)     # the first coarse level, the PCG kernel's
RAGGED = (37, 29, 35)        # non-cubic, 37555 cells: a ragged last block
PCG_RAGGED = (23, 17, 29)
BIG = (258, 258, 258)        # ghost-padded 256³
# the periodic and 2D forms of pcg_fused: 258³'s 34³ level, JAX's periodic
# test shape, the 2D circle's two finest levels, a ragged 2D shape and
# JAX's 2D test shape
PCG_PERIODIC = ((34, 34, 34), (10, 10, 10))
PCG_2D = ((98, 66), (50, 34), (37, 29), (10, 14))


def log(msg=""):
    print(msg, flush=True)


T0 = time.perf_counter()


def phase(title):
    log(f"== {title} (at {time.perf_counter() - T0:.1f} s)")


def stage(title):
    log(f"-- {title} (at {time.perf_counter() - T0:.1f} s)")


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


# kernel -> the largest max|kernel - plain| and the shapes checked so far
WORST = {}
CHECKED = {}


def check_kernels(torch, dev, shapes):
    """Each kernel (and composite) against its plain version at every
    shape in ``shapes[name]`` not checked yet, shape by shape (each
    shape's inputs are drawn once)."""
    from waterlily_tpu_torch.kernels.check import (KERNELS, COMPOSITES,
                                                   compare, clear_inputs)
    todo = {name: set(shapes.get(name, ())) - CHECKED.setdefault(name, set())
            for name in KERNELS + COMPOSITES}
    failures = []
    for S in sorted(set().union(*todo.values()), key=lambda S: (len(S),
                                                               math.prod(S))):
        for name in KERNELS + COMPOSITES:
            if S not in todo[name]:
                continue
            for row in compare(name, S, 1, dev):
                log(f"  {row['output']:<20} {str(row['shape']):<15} "
                    f"max|d|={row['max_abs_err']:.3e} ulp={row['max_ulp']} "
                    f"[{row['tolerance']}] {'ok' if row['ok'] else 'FAIL'}")
                WORST[name] = max(WORST.get(name, 0.0), row["max_abs_err"])
                if not row["ok"]:
                    failures.append(row)
            CHECKED[name].add(S)
        clear_inputs()
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")


def pois_ok(a, b):
    d = [abs(x - y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return all(v == 0 for v in d) or (all(v <= 2 for v in d) and sum(d) <= 4)


# kernels each path must launch; PATH_LAUNCHES collects every path's counts
DENSE = ("mult3d", "increment3d", "cfl3d", "bc3d", "div3d", "project3d",
         "conv_diff3d", "pcg_fused")
BANDED_LEVELS = ("ana_mult3d", "cfl3d", "bc3d", "conv_diff3d", "pcg_fused")
# the blocked-level PCG configurations of phase 6.4: (label, poisson
# seams set, smoother_bf16, op_bf16, kernels the path must launch beyond
# DENSE's conv/projection ones); (a) is the default every other is held
# against
STREAMS = ("mult3d_stream", "increment3d_stream")
PCG_CONFIGS = (
    ("a default", {}, False, False, DENSE),
    ("b KDOT+KAXPY", {"KDOT": True, "KAXPY": True}, False, False,
     ("dot3d", "pcg_axpy", "mult3d")),
    ("c PCG_BLOCKED", {"PCG_BLOCKED": True}, False, False,
     ("pcg_dir_mult", "pcg_update")),
    ("d smoother_bf16", {}, True, False, ("mult3d", "increment3d")),
    ("e smoother_bf16+PCG_BLOCKED", {"PCG_BLOCKED": True}, True, False,
     ("pcg_dir_mult", "pcg_update", "increment3d")),
    ("f op_bf16", {}, False, True, ("mult3d", "increment3d")),
    ("g STREAM", {"STREAM": True}, False, False, STREAMS),
    ("h op_bf16+STREAM", {"STREAM": True}, False, True, STREAMS),
    ("i op_bf16+PCG_BLOCKED", {"PCG_BLOCKED": True}, False, True,
     ("pcg_dir_mult", "pcg_update", "increment3d")),
)
# the configurations also held against the CPU at (96,64,64)
CPU_CONFIGS = ("b", "c", "d", "f", "g")
PATH_LAUNCHES = {}
PATH_SHAPES = {}    # kernel -> every shape a path launched it at
PATH_FORMS = {}     # path -> kernel -> the bf16 forms it launched


def on_path(torch, label, expect, fn):
    """Run ``fn`` (a user-facing path) with every launch counter set to 0
    and every launched-shape and -form set cleared just before, all read
    just after; fail if a kernel in ``expect`` never launched."""
    from waterlily_tpu_torch.ops.stencil_kernels import kernel_wrappers
    kernels = kernel_wrappers()
    for w in kernels.values():
        w.launches = 0
        w.shapes.clear()
        w.forms.clear()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in kernels.items()}
    log(f"launches on {label}: {counts}")
    log(f"  at shapes: " + "; ".join(
        f"{k} {sorted(w.shapes, key=math.prod)}"
        for k, w in kernels.items() if w.shapes))
    PATH_FORMS[label] = {k: set(w.forms) for k, w in kernels.items()
                         if w.forms}
    log("  bf16 forms (names of the bf16 arguments): " + "; ".join(
        f"{k} {sorted(f)}" for k, f in PATH_FORMS[label].items()
        if f != {()}))
    idle = [k for k in expect if counts[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on {label}: {idle}")
    PATH_LAUNCHES[label] = counts
    for k, w in kernels.items():
        PATH_SHAPES.setdefault(k, set()).update(w.shapes)
    return out


def vs_cpu(torch, sim, init, init_levels, n=3):
    """``n`` steps of ``sim``'s configuration from the state ``init`` on the
    CPU (plain versions) against the card's first ``n`` steps: pois_n, dt,
    and max|du|, max|dp| against the card's run from the same state."""
    from waterlily_tpu_torch.flow import mom_step
    from waterlily_tpu_torch.convert import flow_to, levels_to
    cpu = torch.device("cpu")
    state, levels = flow_to(init, cpu), levels_to(init_levels, cpu)
    cfg = dataclasses.replace(sim.cfg, device=cpu)
    pois, dts = [], []
    t0 = time.perf_counter()
    for _ in range(n):
        state, aux = mom_step(cfg, levels, state)
        pois.append(aux["pois_n"])
        dts.append(float(aux["dt"]))
    log(f"{n} CPU steps in {time.perf_counter() - t0:.1f} s: pois_n {pois}, "
        f"dt {dts}")
    log(f"GPU first {n} steps: pois_n {sim.pois_n[:n]}, dt {sim.dts[1:n + 1]}")
    if not pois_ok(sim.pois_n[:n], pois):
        raise AssertionError(f"pois_n GPU {sim.pois_n[:n]} vs CPU {pois}")
    for a, b in zip(sim.dts[1:n + 1], dts):
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"dt GPU {sim.dts[1:n + 1]} vs CPU {dts}")
    g = init
    for _ in range(n):
        g, _aux = mom_step(sim.cfg, init_levels, g)
    du = float((g.u.cpu() - state.u).abs().max())
    dp = float((g.p.cpu() - state.p).abs().max())
    log(f"after {n} steps: max|du| = {du:.3e}, max|dp| = {dp:.3e}")


def run_slice(torch, dev):
    from waterlily_tpu_torch import sphere_3d

    def drive():
        t0 = time.perf_counter()
        sim = sphere_3d(96, 64, device=dev)
        torch.cuda.synchronize()
        log(f"constructed sphere_3d(96, 64) on {dev} in "
            f"{time.perf_counter() - t0:.2f} s")
        init, init_levels = sim.flow, sim.levels
        t0 = time.perf_counter()
        sim.steps(20, remeasure=False)
        torch.cuda.synchronize()
        log(f"20 steps in {time.perf_counter() - t0:.2f} s; pois_n "
            f"{sim.pois_n}; dt {sim.dts[-1]}")
        return sim, init, init_levels

    sim, init, init_levels = on_path(torch, "sphere_3d(96, 64)", DENSE, drive)
    f = sim.flow
    S = sim.cfg.S
    assert tuple(f.u.shape) == (3,) + S and tuple(f.p.shape) == S
    finite(torch, sim, "sphere_3d(96, 64) after 20 steps")
    vs_cpu(torch, sim, init, init_levels)
    return sim


def run_banded_small(torch, dev):
    from waterlily_tpu_torch import sphere_3d
    label = 'sphere_3d(48, 48, bbox="force", banded_levels=True)'

    def drive():
        sim = sphere_3d(48, 48, bbox="force", banded_levels=True, device=dev)
        init, init_levels = sim.flow, sim.levels
        sim.steps(3, remeasure=False)
        return sim, init, init_levels

    sim, init, init_levels = on_path(torch, label, BANDED_LEVELS, drive)
    log(f"box {sim.cfg.bbox_shape} at {init.bbox}; banded levels "
        f"{[l.banded for l in sim.levels]}")
    vs_cpu(torch, sim, init, init_levels)


def _max_du(a, b):
    return float((a.flow.u - b.flow.u).abs().max())


def banded_vs_dense(torch, label, expect, make, remeasure, exact_pois=True):
    """3 steps of the banded configuration ``make(True)`` (launch-counted)
    and of ``make(False)`` (bbox=False) from the same start: pois_n, u and
    the same μ₀."""
    def drive():
        t0 = time.perf_counter()
        sim = make(True)
        torch.cuda.synchronize()
        log(f"constructed {label} in {time.perf_counter() - t0:.1f} s: box "
            f"{sim.cfg.bbox_shape} at {sim.flow.bbox}, banded levels "
            f"{[l.banded for l in sim.levels]}")
        sim.steps(3, remeasure=remeasure)
        return sim

    a = on_path(torch, label, expect, drive)
    b = make(False)
    b.steps(3, remeasure=remeasure)
    du = _max_du(a, b)
    same_mu0 = bool(torch.equal(a.flow.mu0, b.flow.mu0))
    log(f"{label} vs bbox=False, 3 steps: pois_n {a.pois_n} vs {b.pois_n}, "
        f"max|du| = {du:.3e}, max|dp| = "
        f"{float((a.flow.p - b.flow.p).abs().max()):.3e}, "
        f"mu0 equal: {same_mu0}")
    ok = (a.pois_n == b.pois_n) if exact_pois else pois_ok(a.pois_n, b.pois_n)
    if not ok or not du < 1e-3 or not same_mu0:
        raise AssertionError(f"{label} differs from bbox=False")


def run_banded_big(torch, dev):
    from waterlily_tpu_torch import sphere_3d, heaving_sphere_3d
    banded_vs_dense(
        torch, "sphere_3d(256, 256)", DENSE,
        lambda on: sphere_3d(256, 256, device=dev,
                             **({} if on else {"bbox": False})),
        remeasure=False)
    torch.cuda.empty_cache()
    banded_vs_dense(
        torch, "sphere_3d(256, 256, banded_levels=True)", BANDED_LEVELS,
        lambda on: sphere_3d(256, 256, device=dev,
                             **({"banded_levels": True} if on
                                else {"bbox": False})),
        remeasure=False, exact_pois=False)
    torch.cuda.empty_cache()
    banded_vs_dense(
        torch, "heaving_sphere_3d(radius=24)", DENSE,
        lambda on: heaving_sphere_3d(radius=24, device=dev,
                                     **({} if on else {"bbox": False})),
        remeasure=True)
    torch.cuda.empty_cache()


def finite(torch, sim, label):
    for k in ("u", "p", "dt"):
        if not bool(torch.isfinite(getattr(sim.flow, k)).all()):
            raise AssertionError(f"non-finite {k}: {label}")


def run_periodic(torch, dev):
    """tgv_3d(64) against the CPU, then tgv_3d(256): every 3D kernel in
    its periodic form (66³ and 258³ take the stencil kernels, 34³ and
    below pcg_fused)."""
    from waterlily_tpu_torch import tgv_3d

    def drive():
        sim = tgv_3d(64, device=dev)
        init, init_levels = sim.flow, sim.levels
        sim.steps(5)
        return sim, init, init_levels

    sim, init, init_levels = on_path(torch, "tgv_3d(64)", DENSE, drive)
    finite(torch, sim, "tgv_3d(64)")
    vs_cpu(torch, sim, init, init_levels)
    del sim, init, init_levels
    torch.cuda.empty_cache()

    def drive_big():
        t0 = time.perf_counter()
        sim = tgv_3d(256, device=dev)
        torch.cuda.synchronize()
        log(f"constructed tgv_3d(256) in {time.perf_counter() - t0:.1f} s")
        sim.steps(3)
        return sim

    sim = on_path(torch, "tgv_3d(256)", DENSE, drive_big)
    finite(torch, sim, "tgv_3d(256)")
    log(f"tgv_3d(256), 3 steps: pois_n {sim.pois_n}, dt {sim.dts}")
    del sim
    torch.cuda.empty_cache()


def run_outlet(torch, dev):
    """The convective outlet (bc3d with save_exit, exit_bc) against the
    CPU from one state."""
    from waterlily_tpu_torch import sphere_3d
    label = "sphere_3d(96, 64, exitBC=True)"

    def drive():
        sim = sphere_3d(96, 64, exitBC=True, device=dev)
        init, init_levels = sim.flow, sim.levels
        sim.steps(3, remeasure=False)
        return sim, init, init_levels

    sim, init, init_levels = on_path(torch, label, DENSE, drive)
    finite(torch, sim, label)
    vs_cpu(torch, sim, init, init_levels)


def twin_vs_cpu(torch, sim, twin, init, init_levels, n, remeasure):
    """The card's first ``n`` steps (``sim`` ran exactly ``n``) against
    ``n`` steps of ``twin``, the same case on the CPU, from the same state,
    both re-measured each step with ``remeasure``: pois_n, dt, max|du|,
    max|dp|."""
    from waterlily_tpu_torch.convert import flow_to, levels_to
    cpu = torch.device("cpu")
    twin.flow, twin.levels = flow_to(init, cpu), levels_to(init_levels, cpu)
    t0 = time.perf_counter()
    twin.steps(n, remeasure=remeasure)
    log(f"{n} CPU steps in {time.perf_counter() - t0:.1f} s: pois_n "
        f"{twin.pois_n}, dt {twin.dts[1:]}")
    log(f"GPU {n} steps: pois_n {sim.pois_n}, dt {sim.dts[1:]}")
    if not pois_ok(sim.pois_n, twin.pois_n):
        raise AssertionError(f"pois_n GPU {sim.pois_n} vs CPU {twin.pois_n}")
    for a, b in zip(sim.dts[1:], twin.dts[1:]):
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"dt GPU {sim.dts} vs CPU {twin.dts}")
    du = float((sim.flow.u.cpu() - twin.flow.u).abs().max())
    dp = float((sim.flow.p.cpu() - twin.flow.p).abs().max())
    log(f"after {n} steps: max|du| = {du:.3e}, max|dp| = {dp:.3e} "
        f"(max|p| {float(twin.flow.p.abs().max()):.3e})")


CASES_2D = (("circle_2d(96, 64)", "circle_2d", (96, 64), False),
            ("tgv_2d(64)", "tgv_2d", (64,), False),
            ("oscillating_plate_2d(32), remeasure", "oscillating_plate_2d",
             (32,), True))


def run_2d(torch, dev):
    """Each 2D case 3 steps on the card (every level on the 2D
    pcg_fused) against the CPU from one state; the circle's forces on the
    card against the CPU on the same state."""
    import waterlily_tpu_torch as wt
    from waterlily_tpu_torch.metrics import total_force
    for label, case, args, remeasure in CASES_2D:
        make = getattr(wt, case)

        def drive():
            sim = make(*args, device=dev)
            init, init_levels = sim.flow, sim.levels
            sim.steps(3, remeasure=remeasure)
            return sim, init, init_levels

        sim, init, init_levels = on_path(torch, label, ("pcg_fused",), drive)
        finite(torch, sim, label)
        twin = make(*args, device="cpu")
        twin_vs_cpu(torch, sim, twin, init, init_levels, 3, remeasure)
        if case != "circle_2d":
            continue
        fg = total_force(sim.flow.u, sim.flow.p, sim.cfg.nu, sim.body,
                         sim.time).cpu()
        fc = total_force(sim.flow.u.cpu(), sim.flow.p.cpu(), sim.cfg.nu,
                         twin.body, sim.time)
        rel = float((fg - fc).abs().max() / fc.abs().max())
        log(f"{label} total_force on the card {fg.tolist()} vs CPU "
            f"{fc.tolist()}: max relative difference {rel:.3e}")
        if not rel <= 1e-4:
            raise AssertionError(f"{label}: total_force differs by {rel}")


@contextlib.contextmanager
def seams(flags):
    """`ops.poisson`'s seams (``KDOT``, ``KAXPY``, ``PCG_BLOCKED``,
    ``STREAM``) set to ``flags`` inside the block and restored after it,
    whatever happens."""
    from waterlily_tpu_torch.ops import poisson
    old = {k: getattr(poisson, k) for k in flags}
    try:
        for k, v in flags.items():
            setattr(poisson, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(poisson, k, v)


@contextlib.contextmanager
def blocked_on_cpu(on):
    """With ``on``, the kernel gate `stencil_kernels.use_blocked` made to
    ignore the device inside the block: a CPU copy of a blocked level stays
    blocked and keeps its operator shadows (`convert.levels_to`), and its
    wrappers run their plain versions."""
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    old = sk.use_blocked
    try:
        if on:
            sk.use_blocked = lambda S, dtype, device: old(S, dtype, "cuda")
        yield
    finally:
        sk.use_blocked = old


# the blocked-level kernels the default path must not launch (ops/attic.py)
PCG_ITERATION = ("pcg_dir_mult", "pcg_update", "dot3d", "pcg_axpy") + STREAMS
# the kernels that read a level's operator (L, or its shadow L16)
OPERATOR = ("mult3d", "increment3d", "pcg_dir_mult") + STREAMS


def _check_levels(sim, bf16, op16, label):
    """Every blocked level carries the configuration's direction type and
    operator shadows (and at 258³ at least one level is blocked)."""
    flags = [(l.blocked, l.bf16_eps, l.L16 is not None) for l in sim.levels]
    log(f"{label}: (blocked, bf16_eps, L16) per level {flags}")
    if not any(b for b, _, _ in flags) or any(
            e != (b and bf16 and not op16) or s != (b and op16)
            for b, e, s in flags):
        raise AssertionError(f"{label}: levels {flags}")


def _check_forms(label, flags, op16):
    """The operator kernels ran on the bf16 L exactly where the levels are
    shadowed, and under ``STREAM`` no halo-row operator kernel ran (nor a
    carried-rows one without it)."""
    forms = PATH_FORMS[label]
    for k in OPERATOR:
        if any(("L" in f) != op16 for f in forms.get(k, ())):
            raise AssertionError(f"{label}: {k} launched forms {forms[k]}")
    off = ("mult3d", "increment3d") if flags.get("STREAM") else STREAMS
    ran = [k for k in off if PATH_LAUNCHES[label][k]]
    if ran:
        raise AssertionError(f"{label}: launched {ran}")


def _config_kw(bf16, op16):
    """`Simulation` keywords of a phase-6.4 configuration."""
    return {"smoother_bf16": bf16, **({"op_bf16": True} if op16 else {})}


def pois_per_solve(a, b):
    """Within ±2 in every solve (the rounded operator's gate: JAX's TPU
    records expect about +1 a solve, so the total is logged, not gated)."""
    return all(abs(x - y) <= 2 for ra, rb in zip(a, b)
               for x, y in zip(ra, rb))


def run_pcg_paths(torch, dev):
    """Phase 6.4: the 256³ sphere in configurations (a)-(i) from one
    initial state, each held against (a); then the (96,64,64) sphere in
    `CPU_CONFIGS` against the CPU."""
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.grid import interior_view
    ref = ref_init = None
    for name, flags, bf16, op16, expect in PCG_CONFIGS:
        label = f"sphere_3d(256, 256) {name}"

        def drive():
            sim = sphere_3d(256, 256, device=dev, **_config_kw(bf16, op16))
            init = sim.flow
            sim.steps(3, remeasure=False)
            return sim, init

        with seams(flags):
            sim, init = on_path(torch, label, expect, drive)
        finite(torch, sim, label)
        _check_levels(sim, bf16, op16, label)
        _check_forms(label, flags, op16)
        log(f"{label}: pois_n {sim.pois_n}, dt {sim.dts[1:]}")
        if ref is None:
            new = [k for k in PCG_ITERATION if PATH_LAUNCHES[label][k]]
            if new:
                raise AssertionError(f"the default path launched {new}")
            ref, ref_init = sim, init
            continue
        same = (torch.equal(init.u, ref_init.u)
                and torch.equal(init.mu0, ref_init.mu0))
        du = _max_du(sim, ref)
        # p is fixed by the solve up to a constant: max|dp| and its spread
        # about its interior mean
        dpi = interior_view(sim.flow.p - ref.flow.p, 3)
        dp = float(dpi.abs().max())
        dpc = float((dpi - dpi.mean()).abs().max())
        lim = 1e-2 if bf16 or op16 else 1e-3
        dn = sum(abs(x - y) for ra, rb in zip(sim.pois_n, ref.pois_n)
                 for x, y in zip(ra, rb))
        log(f"{label} vs (a), 3 steps from the same state ({same}): pois_n "
            f"{sim.pois_n} vs {ref.pois_n} (total |Δpois_n| {dn}), max|du| "
            f"= {du:.3e} (limit {lim:g}), max|dp| = {dp:.3e}, max|dp - "
            f"mean dp| = {dpc:.3e}")
        pois = (pois_per_solve if op16 else pois_ok)(sim.pois_n, ref.pois_n)
        if not same or not pois or not du < lim:
            raise AssertionError(f"{label} differs from (a)")
        del sim, init
        torch.cuda.empty_cache()
    del ref, ref_init
    torch.cuda.empty_cache()

    for name, flags, bf16, op16, expect in PCG_CONFIGS:
        if name[0] not in CPU_CONFIGS:
            continue
        label = f"sphere_3d(96, 64) {name}"

        def drive():
            sim = sphere_3d(96, 64, device=dev, **_config_kw(bf16, op16))
            init, init_levels = sim.flow, sim.levels
            sim.steps(3, remeasure=False)
            return sim, init, init_levels

        with seams(flags):
            sim, init, init_levels = on_path(torch, label, expect, drive)
            finite(torch, sim, label)
            _check_levels(sim, bf16, op16, label)
            _check_forms(label, flags, op16)
            if op16:
                log("CPU twin: the card's levels copied with the kernel gate "
                    "patched to ignore the device, so the CPU fine level is "
                    "blocked, keeps L16/D16/iD16 and runs the plain forms")
            with blocked_on_cpu(op16):
                vs_cpu(torch, sim, init, init_levels)


def step_profile(sim, n, label, remeasure=False):
    """The card's idle share over ``n`` steps: device busy time and wall
    time of the same steps (`utils.perf.idle_share`), and the ops that
    take the busy time."""
    from waterlily_tpu_torch.utils.perf import idle_share
    r = idle_share(sim, n, remeasure=remeasure)
    log(f"{label}: idle share {r['idle_share']:.4f}: device busy "
        f"{r['busy_ms']:.4f} ms/step of {r['wall_ms']:.4f} ms/step wall "
        f"(the same {n} steps, pois_n {r['pois_n']}; wall timed without "
        f"the profiler)")
    top = sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top:
        log(f"    {ms:9.4f} ms/step  {name[:90]}")


def report_steps(torch, sim, label, n, warmup, remeasure=False):
    from waterlily_tpu_torch.utils.perf import time_steps
    r = time_steps(sim, n, warmup=warmup, remeasure=remeasure)
    if not bool(torch.isfinite(sim.flow.u).all()):
        raise AssertionError(f"non-finite u: {label}")
    log(f"{label}: {r['sec_per_step'] * 1e3:.3f} ms/step, "
        f"{r['mlups']:.1f} MLUPS, {r['ns_per_dof']:.3f} ns/DOF "
        f"({n} steps after {warmup} warm-up; pois_n last "
        f"{sim.pois_n[-3:]})")


def construct(torch, label, make):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = make()
    torch.cuda.synchronize()
    log(f"constructed {label} in {time.perf_counter() - t0:.1f} s")
    return sim


def peak(torch, label):
    log(f"{label}: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        "allocated")


# the forms timed besides each kernel's first variant: (kernel, shape,
# first output of the form); the operator-shadow, bf16-iD and carried-rows
# forms at 258³ and at the dense slice's shape
TIMED_FORMS = (
    ("bc3d", BIG, "p012"), ("bc3d", BIG, "exit"),
    ("conv_diff3d", BIG, "quick_p012"),
    ("pcg_fused", (34, 34, 34), "x_p012"), ("pcg_fused", (98, 66), "x"),
    ("pcg_fused", (66, 66), "x_p01"),
    ("mult3d", BIG, "z_bf16"), ("increment3d", BIG, "x_bf16"),
    ("pcg_dir_mult", BIG, "eps_bf16"), ("pcg_update", BIG, "x_bf16"),
    ("pcg_axpy", BIG, "x_bf16"), ("dot3d", BIG, "ab"), ("dot3d", BIG, "rid"),
) + tuple((name, S, form) for S in (BIG, FINE) for name, form in (
    ("mult3d", "z_L16"), ("increment3d", "x_L16"),
    ("pcg_dir_mult", "eps_L16"), ("pcg_update", "x_iD16"),
    ("pcg_axpy", "x_iD16"), ("dot3d", "rid_iD16"),
    ("mult3d_stream", "z_nodot"), ("mult3d_stream", "z_L16"),
    ("mult3d_stream", "z_nodot_L16"), ("increment3d_stream", "x_L16")))
PROBES = ("copy_probe", "roll_probe")
PROBE_LAUNCHES = {}   # the probes' launches in phase 8 (on no path)


def timing(torch, dev, sim):
    from waterlily_tpu_torch import sphere_3d, heaving_sphere_3d
    from waterlily_tpu_torch.kernels import probes
    from waterlily_tpu_torch.kernels.check import (KERNELS, LIBRARY, time_pair,
                                                   time_library, bound_ms,
                                                   clear_inputs)

    for w in probes.kernel_wrappers().values():
        w.launches = 0
    report_steps(torch, sim, "sphere_3d(96, 64)", 50, 10)
    step_profile(sim, 20, "sphere_3d(96, 64)")
    # each kernel at the dense slice's shape, then at the largest shape a
    # path launched it at (the kernels line's shape; 258³ for the probes)
    stage("kernels and forms against their plain versions")
    times, rows = {}, []
    for name in KERNELS:
        largest = max(PATH_SHAPES.get(name) or {BIG}, key=math.prod)
        for S in dict.fromkeys((PCG_LEVEL if name == "pcg_fused" else FINE,
                                largest)):
            t = time_pair(name, S, dev)
            t["shape"] = S
            t["bound_ms"], t["bound_by"] = bound_ms(name, S)
            if name in LIBRARY:
                t["library_ms"] = time_library(name, S, dev)
            log(f"  {name:<12} {str(S):<15} device (profiler): kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']})"
                + (f", library call {t['library_ms']:.4f} ms"
                   if name in LIBRARY else "")
                + f"; wall per call: kernel {t['wall_ms']:.4f} ms, plain "
                f"{t['plain_wall_ms']:.4f} ms")
            rows.append((name, S, None, t["ms"]))
            torch.cuda.empty_cache()
        times[name] = t
    # the periodic, outlet, 2D, bf16, shadow and carried-rows forms
    for name, S, variant in TIMED_FORMS:
        t = time_pair(name, S, dev, variant=variant)
        b, by = bound_ms(name, S, variant)
        log(f"  {name:<12} {str(S):<15} form {variant}, device "
            f"(profiler): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, bound {b:.4f} ms ({by}); wall per call: kernel "
            f"{t['wall_ms']:.4f} ms, plain {t['plain_wall_ms']:.4f} ms")
        rows.append((name, S, variant, t["ms"]))
        torch.cuda.empty_cache()
    PROBE_LAUNCHES.update({k: w.launches
                           for k, w in probes.kernel_wrappers().items()})
    bandwidth_shares(rows)
    # ana_mult3d without the dot (the bound counts the same bytes)
    t = time_pair("ana_mult3d", BIG, dev, variant=1)
    log(f"  ana_mult3d   {str(BIG):<15} without the dot, device "
        f"(profiler): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"bound {bound_ms('ana_mult3d', BIG)[0]:.4f} ms")
    clear_inputs()
    torch.cuda.empty_cache()
    del sim

    # 256³: dense and banded BDIM in turns (dense, banded, banded, dense)
    stage("256³ cells")
    dense = construct(torch, "sphere_3d(256, 256, bbox=False)",
                      lambda: sphere_3d(256, 256, bbox=False, device=dev))
    peak(torch, "sphere_3d(256, 256, bbox=False)")
    band = construct(torch, "sphere_3d(256, 256)",
                     lambda: sphere_3d(256, 256, device=dev))
    for sim_, label in ((dense, "sphere_3d(256, 256, bbox=False)"),
                        (band, "sphere_3d(256, 256)"),
                        (band, "sphere_3d(256, 256)"),
                        (dense, "sphere_3d(256, 256, bbox=False)")):
        report_steps(torch, sim_, label, 10, 2)
    step_profile(dense, 5, "sphere_3d(256, 256, bbox=False)")
    step_profile(band, 5, "sphere_3d(256, 256)")
    del dense, band
    stage("256³ sphere in configurations (a)-(i)")
    timing_pcg_paths(torch, dev)

    stage("256³ banded levels, heaving sphere")
    lv = construct(torch, "sphere_3d(256, 256, banded_levels=True)",
                   lambda: sphere_3d(256, 256, banded_levels=True,
                                     device=dev))
    report_steps(torch, lv, "sphere_3d(256, 256, banded_levels=True)", 10, 2)
    peak(torch, "sphere_3d(256, 256, banded_levels=True)")
    step_profile(lv, 5, "sphere_3d(256, 256, banded_levels=True)")
    del lv

    hv = construct(torch, "heaving_sphere_3d(radius=64)",
                   lambda: heaving_sphere_3d(radius=64, device=dev))
    report_steps(torch, hv, "heaving_sphere_3d(radius=64), remeasure", 10, 2,
                 remeasure=True)
    peak(torch, "heaving_sphere_3d(radius=64)")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        hv.measure()
    end.record()
    torch.cuda.synchronize()
    log(f"heaving_sphere_3d(radius=64): {start.elapsed_time(end) / 3e3:.4f} "
        f"s per remeasure (measure() alone, 3 calls; box "
        f"{hv.cfg.bbox_shape})")
    step_profile(hv, 5, "heaving_sphere_3d(radius=64), remeasure",
                 remeasure=True)
    del hv
    stage("tgv_3d(256), 2D cases")
    timing_periodic_2d(torch, dev)
    return times


def bandwidth_shares(rows):
    """The probes' measured rates (GB/s), and each 3D kernel or form timed
    at 258³ or (98,66,66): the bytes it must move over its time, as a
    share of the copy probe's rate at that shape.  Every time rotates over
    `check.ROTATE` input sets: at 258³ each call's operands come from
    device memory, at (98,66,66) they fit in L2 (the rates there are
    L2-warm, not device memory's)."""
    from waterlily_tpu_torch.kernels.check import bytes_moved, HBM_BYTES_PER_S
    rate = {(name, S, v): bytes_moved(name, S, v) / (ms * 1e6)
            for name, S, v, ms in rows}
    copy = {S: r for (name, S, v), r in rate.items() if name == "copy_probe"}
    warm = lambda S: " (L2-warm)" if S == FINE else ""
    for (name, S, v), r in rate.items():
        if name in PROBES:
            log(f"  {name} {S}{warm(S)}: {r:.1f} GB/s measured "
                f"({r * 1e9 / HBM_BYTES_PER_S:.3f} of the data sheet's "
                f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    log("  bytes moved over time, as a share of the copy probe's rate:")
    for (name, S, v), r in rate.items():
        if S in copy and name not in PROBES:
            log(f"    {name:<18} {v or 'timed form':<12} {str(S):<15} "
                f"{r:8.1f} GB/s = {r / copy[S]:.3f} of copy_probe{warm(S)}")


def timing_pcg_paths(torch, dev):
    """The 256³ sphere in configurations (a)-(i) of phase 6.4, in turns
    (a, ..., i, i, ..., a), then each one's idle share."""
    from waterlily_tpu_torch import sphere_3d
    sims = {name: construct(torch, f"sphere_3d(256, 256) {name}",
                            lambda bf16=bf16, op16=op16: sphere_3d(
                                256, 256, device=dev,
                                **_config_kw(bf16, op16)))
            for name, _flags, bf16, op16, _expect in PCG_CONFIGS}
    for name, flags, _bf16, _op16, _expect in PCG_CONFIGS + PCG_CONFIGS[::-1]:
        with seams(flags):
            report_steps(torch, sims[name], f"sphere_3d(256, 256) {name}",
                         10, 2)
    for name, flags, _bf16, _op16, _expect in PCG_CONFIGS:
        with seams(flags):
            step_profile(sims[name], 5, f"sphere_3d(256, 256) {name}")
    peak(torch, f"the {len(sims)} sphere_3d(256, 256) configurations")
    del sims
    torch.cuda.empty_cache()


def timing_periodic_2d(torch, dev):
    import waterlily_tpu_torch as wt
    from waterlily_tpu_torch.metrics import ke

    tg = construct(torch, "tgv_3d(256)", lambda: wt.tgv_3d(256, device=dev))
    ke0 = float(torch.sum(ke(tg.flow.u)))
    report_steps(torch, tg, "tgv_3d(256)", 10, 2)
    peak(torch, "tgv_3d(256)")
    step_profile(tg, 5, "tgv_3d(256)")
    ke1 = float(torch.sum(ke(tg.flow.u)))
    log(f"tgv_3d(256): interior kinetic energy {ke0!r} at step 0, {ke1!r} "
        f"after {len(tg.pois_n)} steps (tU/L {tg.sim_time!r})")
    del tg

    for run in (1, 2):
        sim = circle_horizon(torch, dev, run)
    step_profile(sim, 50, "circle_2d(96, 64) after tU/L=50")
    del sim

    plate = construct(torch, "oscillating_plate_2d(32)",
                      lambda: wt.oscillating_plate_2d(32, device=dev))
    report_steps(torch, plate, "oscillating_plate_2d(32), remeasure", 20, 5,
                 remeasure=True)
    step_profile(plate, 10, "oscillating_plate_2d(32), remeasure",
                 remeasure=True)
    tv = construct(torch, "tgv_2d(64)", lambda: wt.tgv_2d(64, device=dev))
    report_steps(torch, tv, "tgv_2d(64)", 50, 10)
    step_profile(tv, 20, "tgv_2d(64)")


def circle_horizon(torch, dev, run, t_end=50.0, chunk=100):
    """``circle_2d(96, 64)`` from construction to tU/L = ``t_end`` in
    chunks of ``chunk`` steps (bench.py's 2D yardstick, the reference's
    README.md:133-137; the kernels are built already), then 10-step chunks
    over the last 10 tU/L, whose states are kept for the forces: the wall
    seconds with and without construction, ms/step, and the mean drag and
    lift coefficients ``2·force/(U²·L)`` over the kept states, computed
    after the clock stops."""
    from waterlily_tpu_torch import circle_2d
    from waterlily_tpu_torch.metrics import total_force
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = circle_2d(96, 64, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kept = []
    while sim.sim_time < t_end:
        late = sim.sim_time >= t_end - 10
        sim.steps(10 if late else chunk, remeasure=False)
        if sim.sim_time >= t_end - 10:
            kept.append((sim.flow.u.clone(), sim.flow.p.clone(), sim.time))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = len(sim.pois_n)
    scale = 2 / (sim.U ** 2 * sim.L)
    f = torch.stack([total_force(u, p, sim.cfg.nu, sim.body, t)
                     for u, p, t in kept]).cpu() * scale
    cd, cl = float(-f[:, 0].mean()), float(f[:, 1].mean())
    iters = [sum(c) for c in sim.pois_n]
    log(f"circle_2d(96, 64) to tU/L={sim.sim_time:.4f}, run {run}: "
        f"{t2 - t0:.3f} s wall with construction ({t1 - t0:.3f} s of it), "
        f"{n} steps, {(t2 - t1) / n * 1e3:.4f} ms/step, "
        f"{sum(iters) / n:.3f} pressure iterations/step; over the last 10 "
        f"tU/L ({len(kept)} states): mean Cd {cd:.5f}, mean Cl {cl:.5f}, "
        f"Cl in [{float(f[:, 1].min()):.5f}, {float(f[:, 1].max()):.5f}]")
    finite(torch, sim, "circle_2d(96, 64)")
    return sim


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

    phase("1. card")
    card = card_record(torch)
    phase("2. kernel build")
    from waterlily_tpu_torch.kernels.build import library, build_seconds
    t0 = time.perf_counter()
    library()
    log(f"kernel library ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build_seconds():.1f} s)")
    phase("3. kernels vs plain versions")
    from waterlily_tpu_torch.kernels.check import KERNELS, COMPOSITES
    check_kernels(torch, dev, {
        k: (PCG_LEVEL, PCG_RAGGED) + PCG_PERIODIC + PCG_2D
        if k == "pcg_fused" else (FINE, RAGGED) for k in KERNELS + COMPOSITES})
    phase("4. the dense slice: sphere_3d(96, 64)")
    sim = run_slice(torch, dev)
    phase("5. the banded slice, small")
    run_banded_small(torch, dev)
    phase("6. the banded paths at full size")
    run_banded_big(torch, dev)
    phase("6.1 the periodic 3D path: tgv_3d")
    run_periodic(torch, dev)
    phase("6.2 the convective outlet: sphere_3d(96, 64, exitBC=True)")
    run_outlet(torch, dev)
    phase("6.3 the 2D paths")
    run_2d(torch, dev)
    phase("6.4 the blocked-level PCG paths: seams, bf16 directions, "
          "operator shadows, carried rows")
    run_pcg_paths(torch, dev)
    phase("7. kernels vs plain versions at the paths' shapes")
    check_kernels(torch, dev, {**PATH_SHAPES,
                               "pcg_blocked": PATH_SHAPES["pcg_dir_mult"],
                               **{k: (BIG,) for k in PROBES}})
    phase("8. timing")
    times = timing(torch, dev, sim)
    phase("end of timing")

    from waterlily_tpu_torch.kernels.check import SOURCES
    # launches on the paths only: the probes, on no path, have 0 there and
    # their phase-8 calls in a field of their own
    launches = {k: sum(c.get(k, 0) for c in PATH_LAUNCHES.values())
                for k in SOURCES}
    # one PyTorch call computes dot3d's timed form (torch.dot) and
    # copy_probe's (torch.mul; kernels/check.LIBRARY); none computes the
    # others (variable or wall-masked coefficients, BC stages, limiters, a
    # whole smooth, fused sweeps, wrapped in-plane neighbours)
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k][0],
                "replaces": SOURCES[k][1], "launches": launches[k],
                "max_abs_err": WORST[k], "ms": times[k]["ms"],
                "plain_ms": times[k]["plain_ms"],
                "bound_ms": times[k]["bound_ms"],
                "bound_by": times[k]["bound_by"],
                "library_ms": times[k].get("library_ms"),
                **({"timing_launches": PROBE_LAUNCHES[k]}
                   if k in PROBES else {})}
               for k in SOURCES]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
