#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`waterlily_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. card record: name and power limit (nvidia-smi), CUDA, nvcc, triton;
2. build of the hand-written kernels from ``waterlily_tpu_torch/csrc``;
3. every kernel against its plain PyTorch version on the card at the
   dense slice's shapes and a ragged one (exact for the stencils, 1e-5
   relative for the matvec dots, 1e-5 absolute for the PCG smooth):
   ``bc3d`` (in place) in all 16 periodic/outlet forms,
   ``conv_diff3d`` (QUICK, van Leer and a user-defined limiter, each with
   walls and every periodic mask) also where its column tiles and axis-0
   chunks are cut raggedly and where axis 0 is shorter than one chunk,
   ``pcg_fused`` on one block and on a cooperative grid (both sides of
   its threshold), ``cfl3d`` and every ``ana_mult3d``, ``pcg_dir_mult``,
   ``mult3d`` and ``mult3d_stream`` form where their column tiles and
   axis-0 chunks are cut raggedly and where axis 0 has one or two interior
   planes, ``roll_probe`` where its row bands and warps are cut raggedly;
   then ``cfl3d``, ``ana_mult3d`` (with and without the dot), ``dot3d``,
   ``pcg_update``, ``pcg_axpy``, every ``pcg_dir_mult`` form, ``mult3d``
   and ``mult3d_stream`` with the dot (f32 operator and shadows) are each
   one launch a call (the profiler sees one kernel on the card); then
   ``pcg_fused``'s member form (``pcg_members``, and ``pcg_fused`` under
   ``torch.func.vmap``) against ``vmap`` of the plain ``pcg`` at the
   ensemble sweep's (194,130) and (98,66) levels and the one-block
   (50,34), with 1, 3 and 32 members, the operator shared and one a
   member, member 1's residual zero (1e-5 absolute, that member exactly;
   one launch a member chunk); then the seven 3D stencils' member forms
   (``mult3d`` with and without the dot, f32 and bf16 L and x,
   ``increment3d``, ``cfl3d``, ``bc3d`` in place in its 16 forms,
   ``div3d``, ``project3d``, ``conv_diff3d`` with QUICK, van Leer, minmod
   and QUICK on every periodic mask), each ``torch.func.vmap`` of its
   wrapper at (98,66,66) with 3 and 8 members and at (37,29,35) with 3,
   the operator, dt, ν and BC values shared and one a member: against
   ``vmap`` of the plain version at the kernel's tolerance of 3, against
   each member's own launch exactly, one launch a call, ``bc3d``'s fill
   seen in the batched field; ``ana_mult3d``'s member form (with the
   dot, and without it on walls and every periodic mask) the same way at
   (98,66,66) with 1, 3 and 8 members and at (50,34,34) with 3 and 8;
   and the member forms of the blocked-level PCG seams' six wrappers
   (``dot3d`` aa, ab, rid and rid on iD16; ``pcg_axpy`` and
   ``pcg_update`` f32, bf16 eps and iD16; ``pcg_dir_mult`` with β from
   its words and at the seed (no words, β = 0), f32, bf16 directions and
   the shadows; ``mult3d_stream`` as
   ``mult3d``; ``increment3d_stream`` f32 and L16) and the composite
   ``pcg_blocked`` under ``vmap`` (against ``vmap`` of the per-pass
   ``pcg``, 1e-5 absolute, member 1's residual zero, 12 launches a
   smooth) the same way as the seven, at (98,66,66) with 3 and 8 members
   and at (37,29,35) with 3, the operator, the sweeps' words and
   ``pcg_axpy``'s upd shared and one a member;
4. the dense slice: ``sphere_3d(96, 64)`` constructed and stepped 20 times
   on the card with every kernel launch-counted (every ``bc3d`` launch in
   place), then 3 steps from the same initial state on the CPU (plain
   versions), compared: pois_n, dt, u, p;
4.1 a user-defined limiter: ``sphere_3d(96, 64, limiter=minmod)`` 3 steps
   on the card (every dense kernel launched, ``conv_diff3d`` only with the
   minmod limiter traced into it) against the CPU from one state, as in 4;
4.2 a callable domain velocity: the (96,64,64) sphere with ``u_BC(i, t) =
   t if i == 0 else 0.0`` (components that are numbers; ``U=1``)
   constructed and stepped 3 times on the card (every dense kernel
   launched) against the CPU from one state, as in 4;
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
   initial state, 3 steps in each of (a) the default (the blocked levels
   smoothed by ``attic.pcg_blocked``, its scalar step in its sweeps), (c)
   the plain ``pcg`` on the same blocked levels (``plain_smoother``, a
   patch of this script: no flag of the program), (d)
   ``smoother_bf16=True``, (e) (d) with the plain ``pcg``, (f)
   ``op_bf16=True``, (g) ``poisson.STREAM = True`` (the carried-rows
   operator), (h) (f) with (g) and (i) (f) with the plain ``pcg``, each
   against (a); and (b) ``poisson.KDOT = KAXPY = True`` on ``tgv_3d(256)``
   (periodic blocked levels, which `pcg` smooths: the seams act there)
   against ``tgv_3d(256)``'s default path from the same state: finite u,
   p, dt; pois_n within the ±2/≤4 rule and max|du| < 1e-3 for (b), (c),
   (g), < 1e-2 for (d), (e); for the rounded operator (f), (h), (i) pois_n
   within ±2 per solve (the total |Δpois_n| logged) and max|du| < 1e-2;
   every blocked level carries the configuration's direction type and
   shadows, the kernels launched in the configuration's forms (bf16 L
   exactly where shadowed), (g), (h) launched neither ``mult3d`` nor
   ``increment3d``, the plain-``pcg`` rows and the vortex neither sweep of
   ``pcg_blocked``, and ``poisson.smooth.routes`` is logged; then
   ``sphere_3d(96, 64)`` in (c), (d), (f) and (g) and ``tgv_3d(64)`` in
   (b) against the CPU from one state, as in 4 ((f)'s CPU twin with the
   kernel gate patched, so its levels are blocked and keep their
   shadows);
6.5 the sharded path (`waterlily_tpu_torch.parallel`, an in-process mesh
   of 8 shards on the card), each held against the dense step on the card
   from the same state over 3 steps (pois_n within the ±2/≤4 rule, the
   total |Δpois_n| logged, dt within 1e-5, max|du| < 1e-3): (i)
   ``sphere_3d(256, 256, bbox=False, mesh=mesh_for((258,)*3, 8))``, the
   (2,2,2) mesh of 129³ blocks, with ``conv_diff3d``, ``div3d`` and
   ``project3d`` launched only in their shard-local ("base") forms and
   ``mult3d`` at the 131³ halo-extended blocks; (ii) ``tgv_3d(64)`` on its
   (2,2,2) mesh and (iii) ``sphere_3d(96, 64, exitBC=True)`` on its, both
   with the kernel forms forced (`parallel.shard_smooth.PALLAS`; their
   blocks are under the kernel gate), ``conv_diff3d`` in its modular form
   in (ii); (iv) ``bc_vector_local`` with ``bc3d``'s shard-local form at
   every shard of the 258³ mesh, with and without ``save_exit``, bit for
   bit the select cascade; (v) ``sphere_3d(96, 64, fixed_iters=2)`` on its
   (2,2,2) mesh, JAX's per-phase path (``conv_diff3d`` only in its
   shard-local form, in the conv + BDIM region, every other kernel
   dense), 2 steps against the dense ``fixed_iters=2`` step from one
   state (max|du| < 1e-3, dt within 1e-5);
6.6 the recording path, held against the CPU from one state as in 4:
   (i) ``sphere_3d(96, 64, log=True)`` through ``run_record`` (7 steps, 3
   samples; every dense kernel launched, no shard-local form) with the
   total force in the ``"center"``, ``"surface"`` and ``"extrap"``
   samplings, the pressure moment, Σ|ω| and Σλ₂ as fields: the same
   sample times, pois_n as in 4, every field within 1e-4 relative, the
   residual traces of the steps whose pois_n agree within 1e-3 (relative
   to each solve's initial residual) and ``write_log``'s rows alike;
   (iv) u, p and λ₂ through ``write_vti``/``read_vti`` and a
   ``restart_from_vtk``, bit for bit; (ii) a checkpoint of the (96,64,64)
   sphere after 3 steps restarted in a fresh sim, both then 3 steps: u,
   p, dt and pois_n bit for bit; (iii) a CSG body (two spheres' union
   minus a third) at (96,64,64) 3 steps against the CPU, its μ₀ within
   1e-5 of the CPU's measurement and ``measure_sdf`` within 1 ulp of the
   distance to the centre; (v) ``sphere_3d(256, 256)`` after 3 steps:
   the total force in every sampling and λ₂ finite;
6.7 differentiability: the drag of the (96,64,64) sphere (ν = 0.16, a
   radius-8 sphere at 31 whose radius is a tensor inside the sdf, solver
   tolerance 1e-5) after `measure_fields`, `build_levels` and 2
   `mom_step`s, differentiated in
   ν and the radius: (i) with ``implicit_diff`` by ``torch.autograd``,
   held against the same program on the card with every gate shut (all
   plain forms, relative 1e-4), against the CPU in f32 (relative 1e-3,
   pois_n within the ±2/≤4 rule) and against central FD on the card (h =
   1e-2 of the parameter, relative 5e-2, the FD's spread at h/2 logged;
   the gradient at tol 1e-4 and 1e-7 logged beside it);
   ``mult3d``, ``increment3d`` and ``pcg_fused`` launched in the forward
   and in the backward pass (the adjoint solves), ``conv_diff3d``,
   ``bc3d``, ``div3d``, ``project3d`` and ``cfl3d`` never in the tracked
   steps or the backward pass; (ii) with ``fixed_iters=2`` the reverse
   gradient against `torch.func.jvp` of the same program (relative 1e-4);
   (iii) ``mult3d`` handed a ``requires_grad`` L raises; (iv) the wall
   seconds and peak memory of one reverse pass, ``implicit_diff`` against
   ``fixed_iters`` at the forward's largest pois_n, and of one
   ``implicit_diff`` reverse step of ``sphere_3d(256, 256, bbox=False)``
   (or, where it does not fit, the largest ``sphere_3d(n, n)`` that does);
6.8 ensembles (`examples/ensemble_sweep.py` under ``torch.func.vmap``):
   (i) the spinning cylinder at ``Dm=32`` ((194,130), f32,
   ``fixed_iters=2``) for 32 spin ratios and 5 steps in one batched
   program: each member's time-averaged (Cd, Cl) against its own run on
   the card (1e-5 relative) and members 0, 15, 31 against the CPU
   (1e-4), |Cl| growing with the spin, and ``pcg_fused`` launched only in
   its member form, at each level one member's launches times the
   level's member chunks; (ii) ms per ensemble step (its 5 steps and
   their forces) against 32 times one member's, wall and busy, the idle
   share and the peak memory; (iii) ``vmap(grad)`` of the kinetic energy
   after one ``implicit_diff`` step of the periodic (130,130)
   Taylor-Green vortex in ν, 4 members, f32: the member form launched in
   the forward and the adjoint solves, each member's adjoint counts
   recorded, against the per-member gradients on the card (1e-4);
   (iv) phase 6.7's (96,64,64) sphere (`drag_setup` + `drag_steps`) as a
   pure function of a parameter under ``torch.func.vmap`` at (98,66,66),
   8 members: a radius sweep (7 to 9, each member its own body and
   operator) and a ν sweep (0.08 to 0.32, one body, the operator
   shared); with ``fixed_iters=2`` and 3 steps each of the seven 3D
   stencils launched as often as by one member alone, ``mult3d``,
   ``increment3d``, ``div3d``, ``project3d`` and ``cfl3d`` only in their
   member form (``bc3d`` and ``conv_diff3d`` also in one-field launches
   on the members' shared set-up fields), ``pcg_fused`` one member's
   launches times the chunks, the drag within 1e-5 of each member alone;
   with the adaptive solve (tol 1e-5) each member's pois_n equal to its
   own card run's, drag within 1e-5, members 0 and 7 against the CPU
   (drag 1e-4, pois_n ±2 a solve, ≤ 4 in all); busy and wall ms a step,
   idle share and peak memory of each sweep against 8 x one member's;
   (v) the banded ensemble, each member its own body window (the
   corners device tensors): (a) (iv)'s radius sweep (3 steps) with banded
   BDIM and banded levels (the (98,66,66) and (50,34,34) levels banded, every
   member's corners differing): with ``fixed_iters=2`` ``ana_mult3d``
   launched as often as by one member alone, every launch in its member
   form but one (the first residual's, on the warm start every member
   shares before the first solve), the drag within 1e-5 of each member
   alone; adaptive, each
   member's pois_n equal to its own card run's and the drag within 1e-5,
   the sweep against the dense (``bbox`` off) sweep (pois_n ±2/≤4,
   max|du| < 1e-3), members 0 and 7 against the CPU, and its cost a step;
   (b) the 256³ sphere's geometry (258³, centre 127, ν 0.64) swept over
   the radii 28, 30, 32, 34, 1 adaptive step (258³, 130³, 66³ and 34³
   banded): each member's pois_n equal to its own card run's and the drag
   within 1e-4 (the batched plain reductions sum in another order: 1.5e-5
   measured); wall and busy ms a step, idle share and peak GiB against
   4 x one member's, ``ana_mult3d``'s member launches by shape; (c)
   ``vmap(jvp)`` of (a)'s adaptive drag in the radius (1 step, the
   primal solve in the plain forms as the member's own ``jvp``): each
   member's tangent and drag within 1e-4 of its own ``jvp`` on the card,
   pois_n equal, member 0 against the CPU (drag 1e-4, tangent 1e-3), its
   wall, busy and peak GiB; (vi) (iv)'s radius sweep under the
   blocked-level PCG configurations of 6.4, (b) ``KDOT = KAXPY = True``
   with the pipe periodic in z (its levels smoothed by ``pcg``), (c) the
   plain ``pcg`` on the blocked levels (``plain_smoother``) and (g)
   ``STREAM = True``: with ``fixed_iters=2`` each seam kernel (``dot3d``
   and ``pcg_axpy``; none; ``mult3d_stream`` and ``increment3d_stream``)
   launched only at (98,66,66), only in its
   member form and as often as by one member alone under the same seam
   (so no call took a plain form), the other kernels by (iv)'s rule, the
   drag within 1e-5 of each member alone; adaptive, each member's pois_n
   equal to its own card run's under the seam and the drag within 1e-5,
   members 0 and 7 against the CPU (drag 1e-4, pois_n ±2/≤4); each
   configuration's cost a step against 8 x one member's and against (iv)'s
   default-path radius sweep (``pcg_blocked``'s member forms);
6.9 the decomposition over processes (`parallel.dist.ProcessMesh`, ranks
   spawned by `parallel.launch.run_ranks`): (i) 8 gloo ranks sharing the
   card (each exchange staged through host memory) run
   ``sphere_3d(256, 256, bbox=False)`` on the (2,2,2) process mesh of
   129³ blocks for 2 steps, each rank's launch counters zeroed before and
   read after (the shard-local forms launched on every rank, each rank's
   launches logged by kernel): every rank's u and p blocks, dt and
   pois_n bit for bit phase 6.5 (i)'s in-process run after its 2 steps;
   (iv) in the same world a per-rank checkpoint written after step 1,
   restarted and stepped once: bit for bit step 2; (ii) NCCL at world
   size 1 (the only NCCL check one card allows): ``sphere_3d(96, 64)`` on
   a one-rank process mesh against ``mesh_for(S, 1)`` in process, bit for
   bit; (iii) ``examples/sharded_sphere.py --quick`` (8 gloo ranks on the
   card) against the in-process mesh: dt and pois_n equal.  A failing or
   hung rank fails the run;
7. every kernel against its plain version again, every variant at every
   shape a path of 4-6.9 launched it at (258³, 130³, 66³, ..., the 2D
   levels) and the probes at 258³, with the tolerances of 3, every
   shard-local form at every shape and base a path launched it at
   (exact), and ``pcg_blocked`` against the per-pass ``pcg`` at the
   shapes ``pcg_dir_mult`` ran at;
8. timing: ms/step, MLUPS, ns/DOF and the card's idle share at (96,64,64),
   256³ dense and banded (in turns), 256³ ``banded_levels=True``, the
   256³ heaving sphere with its remeasure and ``tgv_3d(256)`` (with its
   kinetic energy before and after); ``circle_2d(96, 64)`` to tU/L = 20
   (wall seconds with construction; ms/step, idle share and the
   mean Cd over the last 10 tU/L); the plate's and ``tgv_2d(64)``'s
   ms/step; each kernel next to its plain version and its bound at
   (98,66,66) and at the largest shape a path launched it at (the shape
   the kernels line reports; each call on the next of three copies of its
   inputs, so that at 258³ no call finds its operands in L2), the
   periodic, outlet, 2D and bf16 forms at 258³, (34,34,34) and (98,66),
   ``pcg_fused``, ``cfl3d``, ``ana_mult3d`` (with and without the
   dot), ``pcg_dir_mult`` (f32, bf16 directions, operator shadows),
   ``mult3d`` (with and without the dot, and with the shadows) and
   ``mult3d_stream`` (with the dot, f32 and shadows) at every shape a path
   launched them at, the
   operator-shadow, bf16-iD and carried-rows forms at 258³ and (98,66,66), ``torch.dot`` beside ``dot3d`` and
   ``torch.mul`` beside ``copy_probe``; the probes' rates in GB/s (the
   roll's also as a share of the copy's) and each kernel's bytes over
   its time as a share of the copy probe's rate; the 256³ configurations
   (a)-(i) of 6.4 ((b) the vortex's) in turns (a, ..., i, i, ..., a),
   each with its idle share and pois_n; the shard-local forms at the sharded
   path's shapes beside their plain versions and bounds, and the sharded
   256³ step of 6.5 (i) in turns with (a) (dense, sharded, sharded,
   dense): wall and busy ms/step, idle share, and the share of a step that
   splitting the state into blocks and assembling it takes; the recording
   path: each metric's wall time (its band measure included) at
   (98,66,66) and 258³, the 256³ sphere's Cd in the three samplings,
   ``run_record``'s cost a sample (its stepping loop and its fields, in
   turns with plain ``steps``) and checkpoint save and restart seconds;
   phase 6.9 (i)'s world: a step's wall time, each rank's busy time (8
   processes on one card), the card's idle share, each rank's peak
   memory and the host-staged exchanges' bytes and wall time a step;
   ``pcg_fused``'s member form at (194,130) and (98,66) with 32 members
   (an operator each) beside ``vmap`` of the plain ``pcg``, its bound and
   its sync floor (its launches times 12 grid barriers of the chunk's
   blocks, ``kernels/times.py``'s ``barrier:``); the seven stencils',
   ``ana_mult3d``'s and the six PCG-seam wrappers' member forms at
   (98,66,66) x 8 beside ``vmap`` of their plain versions and 8 times
   the one-field bound (``dot3d``'s also beside one batched
   ``torch.linalg.vecdot``).

Every path runs with the launch counters set to 0 and the launched shapes
and forms cleared just before it, all read just after (each kernel's
launches also by shape, per step); a kernel of the path that never
launched fails the run.  The probes run on no path: the
kernels line gives them 0 launches and their calls in phase 8 as
``timing_launches``.  The line before the last is a JSON object with one
entry per kernel, one for ``pcg_fused``'s member form (its launches
those of 6.8's batched paths, its time at (194,130) x 32) and one for
each of the seven stencils', ``ana_mult3d``'s and the six PCG-seam
wrappers' member forms (``"<name> (members)"``: its member-form launches
on the paths, its time at (98,66,66) x 8); the last
line is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script prints no result and exits 2.  Imports
no JAX.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

FINE = (98, 66, 66)          # ghost-padded (96, 64, 64)
PCG_LEVEL = (50, 34, 34)     # the first coarse level, the PCG kernel's
RAGGED = (37, 29, 35)        # non-cubic, 37555 cells: a ragged last block
# conv_diff3d's ragged (8, 32) column tiles and axis-0 chunks, and an axis 0
# shorter than its shortest chunk (4 planes)
CONV_RAGGED = ((70, 41, 67), (3, 37, 70))
PCG_RAGGED = (23, 17, 29)
BIG = (258, 258, 258)        # ghost-padded 256³
# the periodic and 2D forms of pcg_fused: 258³'s 34³ level, JAX's periodic
# test shape, the 2D circle's two finest levels, a ragged 2D shape and
# JAX's 2D test shape
PCG_PERIODIC = ((34, 34, 34), (10, 10, 10))
PCG_2D = ((98, 66), (50, 34), (37, 29), (10, 14))
# pcg_fused on both sides of its one-block threshold
# (`pcg_kernel.PCG_ONE_BLOCK_MAX` = 2048 cells): one block, then a grid
PCG_THRESHOLD = ((8, 16, 16), (9, 16, 16))
# the plane marches (MARCHES below): an axis 0 of one and
# two interior planes, axes 1 and 2 off their (8, 32) column tiles, and 8
# chunks of 9 interior planes over 65 (the last one of 2)
MARCH_RAGGED = ((3, 37, 70), (4, 9, 40), (37, 29, 35), (70, 41, 67),
                (67, 130, 130))
MARCHES = ("cfl3d", "ana_mult3d", "pcg_dir_mult", "mult3d", "mult3d_stream")
# the roll probe's row bands and warps cut raggedly: a short last band,
# warps across bands and planes, three-row and three-column planes
ROLL_RAGGED = ((5, 9, 13), (4, 258, 37), (3, 37, 70), (7, 3, 33),
               (5, 17, 3))


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


def one_launch(torch, dev):
    """The one-launch reductions put one kernel on the card a call and no
    PyTorch reduce after it (profiler, 5 calls at the dense slice's
    shape): `cfl3d`, `ana_mult3d`, `dot3d`, every form of `pcg_dir_mult`
    (beta from a smooth's words, or none at the smooth's seed),
    `pcg_update` (its words), `pcg_axpy`, and `mult3d` and `mult3d_stream`
    with the dot (f32 operator and shadows)."""
    from waterlily_tpu_torch.kernels.check import inputs, variants, words
    from waterlily_tpu_torch.ops import stencil_kernels as sk, attic as at
    from waterlily_tpu_torch.utils.perf import device_profile
    d = inputs(FINE, 0, dev)
    u, x, r, eps, z, s = d["u"], d["x"], d["r"], d["eps"], d["z"], d["dt"]
    iD, w = d["lev"].iD, words(None, dev)
    dir_mult = [(f"pcg_dir_mult {outs[0]}", kern)
                for outs, kern, _ in variants("pcg_dir_mult", d)]
    for label, call in [
            ("cfl3d", lambda: sk.cfl3d(u)),
            ("ana_mult3d, dot", lambda: sk.ana_mult3d(x, 1.0, with_dot=True)),
            ("ana_mult3d", lambda: sk.ana_mult3d(x, 1.0)),
            ("dot3d aa", lambda: at.dot3d(r, r, "aa")),
            ("pcg_update", lambda: at.pcg_update(x, r, eps, z, iD, w)),
            ("pcg_axpy", lambda: at.pcg_axpy(x, r, eps, z, iD, s)),
            ("mult3d, dot", lambda: sk.mult3d(d["lev"].L, d["lev"].D, x,
                                              True)),
            ("mult3d L16, dot", lambda: sk.mult3d(d["L16"], d["D16"], x,
                                                  True)),
            ("mult3d_stream, dot", lambda: at.mult3d_stream(
                d["lev"].L, d["lev"].D, x, True)),
            ("mult3d_stream L16, dot", lambda: at.mult3d_stream(
                d["L16"], d["D16"], x, True))
    ] + dir_mult:
        ops = device_profile(call, 5)[1]
        log(f"  {label:<21} ops on the card a call: {sorted(ops)}")
        if len(ops) != 1:
            raise AssertionError(f"{label} is not one launch a call: {ops}")
    del d
    torch.cuda.empty_cache()


def pois_ok(a, b):
    d = [abs(x - y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return all(v == 0 for v in d) or (all(v <= 2 for v in d) and sum(d) <= 4)


# kernels each path must launch; PATH_LAUNCHES collects every path's counts
DENSE = ("mult3d", "increment3d", "cfl3d", "bc3d", "div3d", "project3d",
         "conv_diff3d", "pcg_fused")
BANDED_LEVELS = ("ana_mult3d", "cfl3d", "bc3d", "conv_diff3d", "pcg_fused")
# the blocked-level PCG configurations of phase 6.4: (label, case, poisson
# seams set, plain `pcg` on the blocked levels, smoother_bf16, op_bf16,
# kernels the path must launch beyond DENSE's conv/projection ones); each
# is held against its case's default path, (a) the sphere's.  The blocked
# non-periodic levels' smoother is `pcg_blocked`'s two sweeps; (c), (e)
# and (i) hold the plain `pcg` (`plain_smoother`) on the same levels
# against it.  KDOT and KAXPY act in `pcg`, the smoother of periodic
# levels: (b) runs on the vortex
STREAMS = ("mult3d_stream", "increment3d_stream")
SMOOTH = ("pcg_dir_mult", "pcg_update")
PcgConfig = collections.namedtuple(
    "PcgConfig", "name case flags plain bf16 op16 expect")
PCG_CONFIGS = (
    PcgConfig("a default", "sphere", {}, False, False, False,
              DENSE + SMOOTH),
    PcgConfig("b KDOT+KAXPY", "tgv", {"KDOT": True, "KAXPY": True}, False,
              False, False, ("dot3d", "pcg_axpy", "mult3d")),
    PcgConfig("c plain pcg", "sphere", {}, True, False, False,
              ("mult3d", "increment3d")),
    PcgConfig("d smoother_bf16", "sphere", {}, False, True, False,
              ("mult3d", "increment3d") + SMOOTH),
    PcgConfig("e smoother_bf16+plain pcg", "sphere", {}, True, True, False,
              ("mult3d", "increment3d")),
    PcgConfig("f op_bf16", "sphere", {}, False, False, True,
              ("mult3d", "increment3d") + SMOOTH),
    PcgConfig("g STREAM", "sphere", {"STREAM": True}, False, False, False,
              STREAMS + SMOOTH),
    PcgConfig("h op_bf16+STREAM", "sphere", {"STREAM": True}, False, False,
              True, STREAMS + SMOOTH),
    PcgConfig("i op_bf16+plain pcg", "sphere", {}, True, False, True,
              ("mult3d", "increment3d")),
)
# each case's constructor at 256³ and at the CPU twin's size
PCG_CASES = {"sphere": ("sphere_3d(256, 256)", "sphere_3d(96, 64)"),
             "tgv": ("tgv_3d(256)", "tgv_3d(64)")}
# the configurations also held against the CPU at the twin's size
CPU_CONFIGS = ("b", "c", "d", "f", "g")
PATH_LAUNCHES = {}
PATH_SHAPES = {}    # kernel -> every shape a path launched it at
PATH_FORMS = {}     # path -> kernel -> the bf16 forms it launched
PATH_BASES = {}     # kernel -> every (shape, shard-local form) launched
MEMBER_COUNTS = {}      # path -> kernel -> its launches in the member form


def zeroed_wrappers():
    """Every kernel wrapper, its launch counters set to 0 and its
    launched shapes, forms and bases cleared; and `poisson.smooth`'s
    routes."""
    from waterlily_tpu_torch.ops.poisson import smooth
    from waterlily_tpu_torch.ops.stencil_kernels import kernel_wrappers
    smooth.routes.clear()
    kernels = kernel_wrappers()
    for w in kernels.values():
        w.launches = 0
        w.members = 0
        w.shapes.clear()
        w.forms.clear()
        w.bases.clear()
    return kernels


def on_path(torch, label, expect, fn):
    """Run ``fn`` (a user-facing path) with every launch counter set to 0
    and every launched-shape and -form set cleared just before, all read
    just after (and `poisson.smooth`'s routes by level shape); fail if a
    kernel in ``expect`` never launched."""
    from waterlily_tpu_torch.ops.poisson import smooth
    kernels = zeroed_wrappers()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in kernels.items()}
    log(f"launches on {label}: {counts}")
    log(f"  smooth routes (route, level shape): calls: "
        f"{dict(sorted((+smooth.routes).items(), key=str))}")
    MEMBER_COUNTS[label] = {k: w.members for k, w in kernels.items()
                            if w.members}
    if MEMBER_COUNTS[label]:
        log(f"  of them in the member form: {MEMBER_COUNTS[label]}")
    sim = out[0] if isinstance(out, tuple) else out
    steps = len(getattr(sim, "pois_n", ())) or 1
    log(f"  launches per step by shape ({steps} steps): " + "; ".join(
        f"{k} " + ", ".join(f"{S} {n / steps:g}" for S, n in sorted(
            w.shapes.items(), key=lambda kv: -math.prod(kv[0])))
        for k, w in kernels.items() if w.shapes))
    PATH_FORMS[label] = {k: set(w.forms) for k, w in kernels.items()
                         if w.forms}
    log("  forms (the bf16 arguments; conv_diff3d's limiters; bc3d's "
        "inplace or copy): "
        + "; ".join(f"{k} {sorted(f, key=str)}"
                    for k, f in PATH_FORMS[label].items()
                    if f != {()}))
    idle = [k for k in expect if counts[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on {label}: {idle}")
    PATH_LAUNCHES[label] = counts
    for k, w in kernels.items():
        PATH_SHAPES.setdefault(k, set()).update(w.shapes)
        PATH_BASES.setdefault(k, set()).update(w.bases)
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
    if PATH_FORMS["sphere_3d(96, 64)"]["bc3d"] != {"inplace"}:
        raise AssertionError("the dense slice launched bc3d in the forms "
                             f"{PATH_FORMS['sphere_3d(96, 64)']['bc3d']}, "
                             "not only in place")
    f = sim.flow
    S = sim.cfg.S
    assert tuple(f.u.shape) == (3,) + S and tuple(f.p.shape) == S
    finite(torch, sim, "sphere_3d(96, 64) after 20 steps")
    vs_cpu(torch, sim, init, init_levels)
    return sim


def run_user_limiter(torch, dev):
    """A limiter no kernel has compiled in (`kernels.check.minmod`): the
    conv step traces it into ``conv_diff3d``, which launches with it and
    no other limiter, every dense kernel runs, and 3 steps match the CPU
    from one state."""
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.kernels.check import minmod
    label = "sphere_3d(96, 64, limiter=minmod)"

    def drive():
        sim = sphere_3d(96, 64, limiter=minmod, device=dev)
        init, init_levels = sim.flow, sim.levels
        sim.steps(3, remeasure=False)
        return sim, init, init_levels

    sim, init, init_levels = on_path(torch, label, DENSE, drive)
    if PATH_FORMS[label].get("conv_diff3d") != {"minmod"}:
        raise AssertionError(f"{label} launched conv_diff3d with "
                             f"{PATH_FORMS[label].get('conv_diff3d')}")
    finite(torch, sim, label)
    vs_cpu(torch, sim, init, init_levels)


def run_callable_bc(torch, dev):
    """A domain velocity that is a function of time whose components are
    numbers (the reference's ``i == 1 ? t : zero(T)`` form): the sphere of
    ``sphere_3d(96, 64)`` in a flow accelerating from rest, constructed and
    stepped on the card (the BC values go to the kernels as 0-d tensors on
    the card) and held against the CPU from one state."""
    from waterlily_tpu_torch import Simulation, AutoBody
    label = "the (96,64,64) sphere, u_BC(i, t) = t if i == 0 else 0.0"
    radius, center = 64 / 8, 64 / 2 - 1

    def drive():
        body = AutoBody(lambda x, t: torch.sqrt(torch.sum(
            (x - center) ** 2, dim=0)) - radius)
        sim = Simulation((96, 64, 64), lambda i, t: t if i == 0 else 0.0,
                         2 * radius, U=1, nu=2 * radius / 100, body=body,
                         device=dev)
        init, init_levels = sim.flow, sim.levels
        sim.steps(3, remeasure=False)
        return sim, init, init_levels

    sim, init, init_levels = on_path(torch, label, DENSE, drive)
    finite(torch, sim, label)
    vs_cpu(torch, sim, init, init_levels)


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
    """`ops.poisson`'s seams (``KDOT``, ``KAXPY``, ``STREAM``) set to
    ``flags`` inside the block and restored after it, whatever happens."""
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


@contextlib.contextmanager
def plain_smoother(on):
    """With ``on``, `poisson.smooth`'s route of blocked non-periodic levels
    (`attic.pcg_blocked`) made to run the plain `pcg` inside the block,
    counted in ``smooth.routes`` as ``pcg``: the smoother those levels had
    before `pcg_blocked` took them, held against it.  A patch of this
    script's, not a flag of the program."""
    from waterlily_tpu_torch.ops import attic, poisson
    old = attic.pcg_blocked

    def pcg(lev, x, r, it=6):
        S = tuple(x.shape)
        poisson.smooth.routes.subtract({("pcg_blocked", S): 1})
        poisson.smooth.routes["pcg", S] += 1
        return poisson.pcg(lev, x, r, it)
    try:
        if on:
            attic.pcg_blocked = pcg
        yield
    finally:
        attic.pcg_blocked = old


# the blocked-level kernels the default path must not launch (ops/attic.py;
# it smooths the blocked non-periodic levels with pcg_dir_mult and
# pcg_update, none of the vortex's)
PCG_ITERATION = ("dot3d", "pcg_axpy") + STREAMS
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
    shadowed, and under ``STREAM`` neither `mult3d` nor `increment3d` ran
    (nor a carried-rows wrapper without it: `mult3d` launches the same
    kernel as `mult3d_stream`, but counts its own launches)."""
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


def _pcg_case(case, big, dev, bf16, op16):
    """Phase 6.4's ``case`` (`PCG_CASES`) at 256³ (``big``) or at its CPU
    twin's size, in a configuration's direction and operator types."""
    from waterlily_tpu_torch import sphere_3d, tgv_3d
    kw = _config_kw(bf16, op16)
    if case == "tgv":
        return tgv_3d(256 if big else 64, device=dev, **kw)
    return sphere_3d(*((256, 256) if big else (96, 64)), device=dev, **kw)


def run_pcg_paths(torch, dev):
    """Phase 6.4: the 256³ sphere in configurations (a), (c)-(i) from one
    initial state, each held against (a), and the 256³ vortex under (b)
    against its own default path; then the CPU twins of `CPU_CONFIGS`
    against the CPU."""
    from waterlily_tpu_torch.grid import interior_view
    refs = {}
    for c in PCG_CONFIGS:
        label = f"{PCG_CASES[c.case][0]} {c.name}"

        def drive(c=c):
            sim = _pcg_case(c.case, True, dev, c.bf16, c.op16)
            init = sim.flow
            sim.steps(3, remeasure=False)
            return sim, init

        if c.case not in refs:
            # the case's default path, which the configuration is held
            # against: (a) for the sphere, run here first for the vortex
            default = c.flags == {} and not (c.plain or c.bf16 or c.op16)
            ref_label = label if default else f"{PCG_CASES[c.case][0]} default"
            sim, init = on_path(torch, ref_label,
                                c.expect if default else DENSE, drive)
            finite(torch, sim, ref_label)
            _check_levels(sim, False, False, ref_label)
            log(f"{ref_label}: pois_n {sim.pois_n}, dt {sim.dts[1:]}")
            off = PCG_ITERATION + (SMOOTH if c.case == "tgv" else ())
            new = [k for k in off if PATH_LAUNCHES[ref_label][k]]
            if new:
                raise AssertionError(f"{ref_label} launched {new}")
            refs[c.case] = (sim, init)
            if default:
                continue
        ref, ref_init = refs[c.case]
        with seams(c.flags), plain_smoother(c.plain):
            sim, init = on_path(torch, label, c.expect, drive)
        finite(torch, sim, label)
        _check_levels(sim, c.bf16, c.op16, label)
        _check_forms(label, c.flags, c.op16)
        ran = [k for k in SMOOTH if PATH_LAUNCHES[label][k]]
        if ran and (c.plain or c.case == "tgv"):
            raise AssertionError(f"{label}: launched {ran}")
        log(f"{label}: pois_n {sim.pois_n}, dt {sim.dts[1:]}")
        same = (torch.equal(init.u, ref_init.u)
                and torch.equal(init.mu0, ref_init.mu0))
        du = _max_du(sim, ref)
        # p is fixed by the solve up to a constant: max|dp| and its spread
        # about its interior mean
        dpi = interior_view(sim.flow.p - ref.flow.p, 3)
        dp = float(dpi.abs().max())
        dpc = float((dpi - dpi.mean()).abs().max())
        lim = 1e-2 if c.bf16 or c.op16 else 1e-3
        dn = sum(abs(x - y) for ra, rb in zip(sim.pois_n, ref.pois_n)
                 for x, y in zip(ra, rb))
        log(f"{label} vs its default path, 3 steps from the same state "
            f"({same}): pois_n {sim.pois_n} vs {ref.pois_n} (total "
            f"|Δpois_n| {dn}), max|du| = {du:.3e} (limit {lim:g}), max|dp| "
            f"= {dp:.3e}, max|dp - mean dp| = {dpc:.3e}")
        pois = (pois_per_solve if c.op16 else pois_ok)(sim.pois_n,
                                                        ref.pois_n)
        if not same or not pois or not du < lim:
            raise AssertionError(f"{label} differs from its default path")
        del sim, init
        torch.cuda.empty_cache()
    del refs
    torch.cuda.empty_cache()

    for c in PCG_CONFIGS:
        if c.name[0] not in CPU_CONFIGS:
            continue
        label = f"{PCG_CASES[c.case][1]} {c.name}"

        def drive(c=c):
            sim = _pcg_case(c.case, False, dev, c.bf16, c.op16)
            init, init_levels = sim.flow, sim.levels
            sim.steps(3, remeasure=False)
            return sim, init, init_levels

        with seams(c.flags), plain_smoother(c.plain):
            sim, init, init_levels = on_path(torch, label, c.expect, drive)
            finite(torch, sim, label)
            _check_levels(sim, c.bf16, c.op16, label)
            _check_forms(label, c.flags, c.op16)
            if c.op16:
                log("CPU twin: the card's levels copied with the kernel gate "
                    "patched to ignore the device, so the CPU fine level is "
                    "blocked, keeps L16/D16/iD16 and runs the plain forms")
            with blocked_on_cpu(c.op16):
                vs_cpu(torch, sim, init, init_levels)


# the sharded path's kernels (phase 6.5): the fine blocks' operator and the
# shard-local forms, the replicated coarse levels' kernels (the 66³ and
# (50,34,34) meshes' coarse levels are under the stencil kernels' gate)
SHARD_FORMS = ("conv_diff3d", "div3d", "project3d")
SHARDED = ("mult3d", "increment3d", "pcg_fused") + SHARD_FORMS
SHARDED_SMALL = ("mult3d", "pcg_fused") + SHARD_FORMS


@contextlib.contextmanager
def shard_kernels():
    """The sharded step's kernel forms forced on, whatever the blocks'
    size (`parallel.shard_smooth.PALLAS`)."""
    from waterlily_tpu_torch.parallel import shard_smooth
    old = shard_smooth.PALLAS
    try:
        shard_smooth.PALLAS = "kernels"
        yield
    finally:
        shard_smooth.PALLAS = old


def sharded_vs_dense(torch, label, expect, make, mult_shape, modular=False,
                     snapshot=None):
    """3 steps of the sharded simulation ``make()`` (launch-counted) and 3
    dense steps on the card from its initial state and levels: pois_n
    within the ±2/≤4 rule (the total |Δpois_n| logged), dt within 1e-5,
    max|du| < 1e-3; `SHARD_FORMS` launched only in their shard-local forms
    (``conv_diff3d`` also modular with ``modular``) and ``mult3d`` at the
    halo-extended blocks' ``mult_shape``.  ``snapshot`` (a path) gets u,
    p, dts and pois_n after 2 steps (`torch.save`, on the host)."""
    from waterlily_tpu_torch.flow import mom_step

    def drive():
        t0 = time.perf_counter()
        sim = make()
        torch.cuda.synchronize()
        log(f"constructed {label} in {time.perf_counter() - t0:.1f} s: mesh "
            f"{sim.mesh}, sharded step {sim._sharded}")
        init, init_levels = sim.flow, sim.levels
        t0 = time.perf_counter()
        if snapshot is None:
            sim.steps(3, remeasure=False)
        else:
            sim.steps(2, remeasure=False)
            torch.save({"u": sim.flow.u.cpu(), "p": sim.flow.p.cpu(),
                        "dts": list(sim.dts), "pois_n": list(sim.pois_n)},
                       snapshot)
            sim.steps(1, remeasure=False)
        torch.cuda.synchronize()
        log(f"3 sharded steps in {time.perf_counter() - t0:.2f} s")
        return sim, init, init_levels

    from waterlily_tpu_torch.ops.stencil_kernels import kernel_wrappers
    sim, init, init_levels = on_path(torch, label, expect, drive)
    finite(torch, sim, label)
    # the wrappers still hold this path's counts
    kernels = kernel_wrappers()
    for k in SHARD_FORMS:
        w = kernels[k]
        want = {"base", "modular"} if modular and k == "conv_diff3d" \
            else {"base"}
        if not want <= w.forms or sum(w.bases.values()) != w.launches:
            raise AssertionError(f"{label}: {k} launched {w.launches} "
                                 f"times, in the forms {w.forms}, "
                                 f"{sum(w.bases.values())} shard-local")
        log(f"  {k}: {w.launches} shard-local launches at "
            f"{sorted(set(key[0] for key in w.bases))}, "
            f"{len(set(key[2] for key in w.bases))} bases")
    if mult_shape not in kernels["mult3d"].shapes:
        raise AssertionError(f"{label}: mult3d never ran at {mult_shape}")
    g, pois, dts = init, [], []
    t0 = time.perf_counter()
    dense = dataclasses.replace(sim.cfg, mesh=None)
    for _ in range(3):
        g, aux = mom_step(dense, init_levels, g)
        pois.append(aux["pois_n"])
        dts.append(float(aux["dt"]))
    torch.cuda.synchronize()
    du = float((sim.flow.u - g.u).abs().max())
    dp = float((sim.flow.p - g.p).abs().max())
    dn = sum(abs(x - y) for ra, rb in zip(sim.pois_n, pois)
             for x, y in zip(ra, rb))
    log(f"3 dense steps from the same state in "
        f"{time.perf_counter() - t0:.2f} s: sharded pois_n {sim.pois_n} vs "
        f"dense {pois} (total |Δpois_n| {dn}), dt {sim.dts[1:]} vs {dts}, "
        f"max|du| = {du:.3e}, max|dp| = {dp:.3e}")
    if not pois_ok(sim.pois_n, pois):
        raise AssertionError(f"{label}: pois_n {sim.pois_n} vs {pois}")
    for a, b in zip(sim.dts[1:], dts):
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"{label}: dt {sim.dts[1:]} vs {dts}")
    if not du < 1e-3:
        raise AssertionError(f"{label}: max|du| {du}")


def bc_local_vs_cascade(torch, dev):
    """``bc_vector_local`` with ``bc3d``'s shard-local form at every shard
    of the 258³ mesh against the select cascade, bit for bit, without and
    with ``save_exit``."""
    from waterlily_tpu_torch.parallel.mesh import mesh_for
    from waterlily_tpu_torch.parallel.shard_step import bc_vector_local
    mesh = mesh_for(BIG, 8, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    u = torch.randn((3,) + BIG, generator=g, device=dev)
    A = (1.0, -0.25, 0.5)
    u_l = mesh.split(u, 1)
    del u

    def drive():
        return [bc_vector_local(mesh, BIG, u_l, A, e, pallas="kernels")
                for e in (False, True)]

    label = "bc_vector_local, bc3d's shard-local form, 258³ mesh"
    outs = on_path(torch, label, ("bc3d",), drive)
    for e, out in zip((False, True), outs):
        ref = bc_vector_local(mesh, BIG, u_l, A, e, pallas="off")
        bad = [s for s, (a, b) in enumerate(zip(out, ref))
               if not torch.equal(a, b)]
        log(f"  save_exit={e}: {len(out)} shards, bases "
            f"{[mesh.base(s, BIG) for s in range(mesh.size)]}, differing "
            f"shards {bad}")
        if bad:
            raise AssertionError(f"{label}: shards {bad} differ")
    if "base" not in PATH_FORMS[label]["bc3d"]:
        raise AssertionError(f"{label}: bc3d forms {PATH_FORMS[label]}")


def per_phase_vs_dense(torch, dev):
    """``fixed_iters=2`` under the (2,2,2) mesh: JAX's per-phase path
    (`flow.mom_step` with `shardmap_conv_bdim`: ``conv_diff3d`` in its
    shard-local form on the blocks, every other kernel dense), 2 steps
    against the dense ``fixed_iters=2`` step from one state: max|du| <
    1e-3 (logged with max|dp|), dt within 1e-5."""
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.flow import mom_step
    from waterlily_tpu_torch.parallel.mesh import mesh_for
    label = "sphere_3d(96, 64, fixed_iters=2), mesh (2,2,2), per-phase"

    def drive():
        sim = sphere_3d(96, 64, device=dev, fixed_iters=2,
                        mesh=mesh_for(FINE, 8, dev))
        init, levels = sim.flow, sim.levels
        sim.steps(2, remeasure=False)
        return sim, init, levels

    with shard_kernels():
        sim, init, levels = on_path(torch, label, DENSE, drive)
    from waterlily_tpu_torch.ops.stencil_kernels import kernel_wrappers
    w = kernel_wrappers()["conv_diff3d"]    # still this path's counts
    if sim._sharded or "base" not in w.forms \
            or sum(w.bases.values()) != w.launches:
        raise AssertionError(f"{label}: whole-step region {sim._sharded}; "
                             f"conv_diff3d forms {w.forms}, "
                             f"{sum(w.bases.values())} of {w.launches} "
                             f"shard-local")
    g, dts = init, []
    dense = dataclasses.replace(sim.cfg, mesh=None)
    for _ in range(2):
        g, aux = mom_step(dense, levels, g)
        dts.append(float(aux["dt"]))
    du = float((sim.flow.u - g.u).abs().max())
    dp = float((sim.flow.p - g.p).abs().max())
    log(f"  {w.launches} conv_diff3d launches, all shard-local; against "
        f"the dense fixed_iters=2 step: dt {sim.dts[1:]} vs {dts}, max|du| "
        f"= {du:.3e}, max|dp| = {dp:.3e}")
    if not du < 1e-3 or any(abs(a - b) > 1e-5 * abs(b)
                             for a, b in zip(sim.dts[1:], dts)):
        raise AssertionError(f"{label}: max|du| {du}, dt {sim.dts} vs {dts}")


def run_sharded(torch, dev, snapshot):
    """Phase 6.5: (i) the full-width sphere on the (2,2,2) mesh (its state
    after 2 steps saved to ``snapshot`` for phase 6.9), (ii) the periodic
    and (iii) outlet paths with the kernel forms forced, (iv) ``bc3d``'s
    shard-local form."""
    from waterlily_tpu_torch import sphere_3d, tgv_3d
    from waterlily_tpu_torch.parallel.mesh import mesh_for
    stage("(i) sphere_3d(256, 256, bbox=False) on mesh_for((258,)*3, 8)")
    sharded_vs_dense(
        torch, "sphere_3d(256, 256, bbox=False), mesh (2,2,2)", SHARDED,
        lambda: sphere_3d(256, 256, bbox=False, device=dev,
                          mesh=mesh_for(BIG, 8, dev)), (131, 131, 131),
        snapshot=snapshot)
    torch.cuda.empty_cache()
    stage("(ii) tgv_3d(64) on mesh_for((66,)*3, 8), kernel forms forced")
    with shard_kernels():
        sharded_vs_dense(
            torch, "tgv_3d(64), mesh (2,2,2)", SHARDED_SMALL,
            lambda: tgv_3d(64, device=dev, mesh=mesh_for((66,) * 3, 8, dev)),
            (35, 35, 35), modular=True)
        stage("(iii) sphere_3d(96, 64, exitBC=True) on its mesh, kernel "
              "forms forced")
        sharded_vs_dense(
            torch, "sphere_3d(96, 64, exitBC=True), mesh (2,2,2)",
            SHARDED_SMALL,
            lambda: sphere_3d(96, 64, exitBC=True, device=dev,
                              mesh=mesh_for(FINE, 8, dev)), (51, 35, 35))
    stage("(iv) bc3d's shard-local form at every shard of the 258³ mesh")
    bc_local_vs_cascade(torch, dev)
    torch.cuda.empty_cache()
    stage("(v) fixed_iters=2 on the mesh: the per-phase conv + BDIM region")
    per_phase_vs_dense(torch, dev)


def check_shard_forms(torch, dev):
    """Each shard-local form against its plain version at every shape and
    base a path launched it at (`PATH_BASES`), exact."""
    from waterlily_tpu_torch.kernels.check import (SHARD_KERNELS, compare,
                                                   clear_inputs)
    failures = []
    for name in SHARD_KERNELS:
        keys = sorted(PATH_BASES.get(name, ()), key=repr)
        for S in sorted({key[0] for key in keys}, key=math.prod):
            forms = [key[1:] for key in keys if key[0] == S]
            worst, n = 0.0, 0
            for form in forms:
                for row in compare(name, S, 1, dev, form=form):
                    worst = max(worst, row["max_abs_err"])
                    n += 1
                    if not row["ok"]:
                        failures.append((row, form))
            WORST[name] = max(WORST.get(name, 0.0), worst)
            log(f"  {name:<12} {str(S):<15} {len(forms)} shard-local forms "
                f"(bases {sorted({f[1] for f in forms})}), {n} outputs: "
                f"max|d|={worst:.3e} [exact]")
            clear_inputs()
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"shard-local form checks failed: {failures}")


# phase 6.9: the decomposition over processes.  The ranks are processes
# of their own (`parallel.launch.run_ranks`, spawned): each loads the
# kernel library phase 2 built, counts its own launches and returns them.
RANKS = 8
PROCESS_TIMES = {}   # phase 6.9's figures, logged again in phase 8
RANK_TIMED_STEPS = 3
RANK_CASE = (256, 256)   # phase 6.9 (i)'s sphere_3d(n, m): BIG


def _read_wrappers(kernels):
    return {"counts": {k: w.launches for k, w in kernels.items()},
            "shapes": {k: dict(w.shapes) for k, w in kernels.items()},
            "bases": {k: set(w.bases) for k, w in kernels.items()}}


def _same_blocks(torch, sim, ru, rp):
    """Bit for bit: this rank's u and p blocks against ``ru``, ``rp`` (host
    tensors); the largest differences and the histories."""
    u, p = sim.flow.u.cpu(), sim.flow.p.cpu()
    return {"equal": torch.equal(u, ru) and torch.equal(p, rp),
            "max_du": float((u - ru).abs().max()),
            "max_dp": float((p - rp).abs().max()),
            "dts": list(sim.dts), "pois_n": list(sim.pois_n)}


def _ref_blocks(torch, mesh, path):
    """This rank's blocks of the global u and p saved at ``path``."""
    ref = torch.load(path, mmap=True)
    (ru,), (rp,) = mesh.split(ref["u"], 1), mesh.split(ref["p"])
    return ru, rp


def rank_sphere_256(rank, world, dev, ref_path, ckpt, n_time, case):
    """Phase 6.9 (i) and (iv) on one rank: ``sphere_3d(*case,
    bbox=False)`` (`RANK_CASE`, the 256³ sphere) on its process mesh
    ((2,2,2) on 8 ranks), 2 steps (a per-rank
    checkpoint after the first) with the launch counters zeroed before
    and read after, against phase 6.5 (i)'s in-process run; the restart
    from the checkpoint stepped once against the same state; then the
    step's wall time, this rank's busy time, its peak memory and the
    exchanges' bytes and wall time."""
    import torch
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.io import restart_sim, save_checkpoint
    from waterlily_tpu_torch.kernels.build import library
    from waterlily_tpu_torch.parallel.dist import dist_mesh_for
    from waterlily_tpu_torch.utils.perf import EVENTS_KEY, device_profile
    library()
    out = {"rank": rank}
    kernels = zeroed_wrappers()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    n, m = case
    mesh = dist_mesh_for((n + 2, m + 2, m + 2), device=dev)
    sim = sphere_3d(n, m, bbox=False, device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    out["construct_s"] = time.perf_counter() - t0
    out["peak_construct_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sim.steps(1, remeasure=False)
    save_checkpoint(ckpt, sim)
    sim.steps(1, remeasure=False)
    torch.cuda.synchronize(dev)
    out["two_steps_s"] = time.perf_counter() - t0
    out.update(_read_wrappers(kernels))
    out["peak_step_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["vs_in_process"] = _same_blocks(torch, sim,
                                        *_ref_blocks(torch, mesh, ref_path))
    # (iv) the restart from the per-rank checkpoint, one step
    u, p = sim.flow.u.cpu(), sim.flow.p.cpu()
    dts, pois = list(sim.dts), list(sim.pois_n)
    t0 = time.perf_counter()
    restart_sim(sim, ckpt)
    sim.steps(1, remeasure=False)
    torch.cuda.synchronize(dev)
    out["restart_s"] = time.perf_counter() - t0
    out["restart"] = dict(_same_blocks(torch, sim, u, p),
                          same_history=(sim.dts == dts
                                        and sim.pois_n == pois))
    # the step's cost on this rank
    stats0 = dict(mesh.stats)
    mesh.barrier()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    sim.steps(n_time, remeasure=False)
    torch.cuda.synchronize(dev)
    mesh.barrier()
    wall = (time.perf_counter() - t0) / n_time
    stats = {k: (mesh.stats[k] - stats0[k]) / n_time for k in stats0}
    busy, by_name = device_profile(lambda: sim.steps(1, remeasure=False),
                                   n_time, events=True)
    out["timing"] = {"wall_ms": wall * 1e3, "busy_ms": busy,
                     "events": EVENTS_KEY in by_name,
                     "pois_n": sim.pois_n[-2 * n_time:], **stats}
    return out


def rank_nccl(rank, world, dev, ref_path):
    """Phase 6.9 (ii): ``sphere_3d(96, 64)`` on the NCCL world of one rank,
    2 steps, against ``mesh_for(S, 1)``'s in-process run."""
    import torch
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.kernels.build import library
    from waterlily_tpu_torch.parallel.dist import dist_mesh_for
    library()
    kernels = zeroed_wrappers()
    mesh = dist_mesh_for(FINE, device=dev)
    sim = sphere_3d(96, 64, device=dev, mesh=mesh)
    sim.steps(2, remeasure=False)
    torch.cuda.synchronize(dev)
    out = _read_wrappers(kernels)
    out["mesh"] = repr(mesh)
    out["vs_in_process"] = _same_blocks(torch, sim,
                                        *_ref_blocks(torch, mesh, ref_path))
    return out


def _rank_report(label, res, expect):
    """Each rank's launches by kernel; fail where a rank did not equal the
    in-process run or left a kernel of ``expect`` unlaunched."""
    for r in res:
        v = r["vs_in_process"]
        launched = {k: n for k, n in r["counts"].items() if n}
        log(f"  rank {r.get('rank', 0)}: launches {launched}; vs in-process "
            f"equal={v['equal']} (max|du| {v['max_du']:.3e}, max|dp| "
            f"{v['max_dp']:.3e}), pois_n {v['pois_n']}, dt {v['dts'][1:]}")
        idle = [k for k in expect if r["counts"][k] == 0]
        if idle:
            raise AssertionError(f"{label}, rank {r.get('rank', 0)}: "
                                 f"kernels never launched: {idle}")
        if not v["equal"]:
            raise AssertionError(f"{label}, rank {r.get('rank', 0)}: not bit "
                                 f"for bit the in-process run: {v}")
        PATH_LAUNCHES[f"{label}, rank {r.get('rank', 0)}"] = r["counts"]
        for k, shapes in r["shapes"].items():
            PATH_SHAPES.setdefault(k, set()).update(shapes)
        for k, bases in r["bases"].items():
            PATH_BASES.setdefault(k, set()).update(bases)


def run_process_mesh(torch, dev, snapshot):
    """Phase 6.9: (i) 8 gloo ranks sharing the card run the 256³ sphere on
    the (2,2,2) process mesh, bit for bit phase 6.5 (i)'s in-process run
    (``snapshot``); (ii) NCCL at world size 1; (iii) the example
    ``sharded_sphere --quick``; (iv) the per-rank checkpoint at 129³
    blocks (in (i)'s world)."""
    import tempfile
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.examples import sharded_sphere
    from waterlily_tpu_torch.parallel.launch import run_ranks
    from waterlily_tpu_torch.parallel.mesh import mesh_for
    torch.cuda.empty_cache()
    ref = torch.load(snapshot)
    label = "6.9 (i) sphere_3d(256, 256, bbox=False), 8 gloo ranks"
    stage(f"(i) {label} sharing the card, (2,2,2) mesh of 129³ blocks, "
          f"2 steps; (iv) the per-rank checkpoint")
    with tempfile.TemporaryDirectory(prefix="wl_ranks_") as tmp:
        t0 = time.perf_counter()
        res = run_ranks(rank_sphere_256, RANKS, "gloo", dev, timeout=900.0,
                        args=(snapshot, os.path.join(tmp, "ckpt"),
                              RANK_TIMED_STEPS, RANK_CASE))
        log(f"8 ranks done in {time.perf_counter() - t0:.1f} s (spawned, "
            f"constructed in {max(r['construct_s'] for r in res):.1f} s, 2 "
            f"steps in {max(r['two_steps_s'] for r in res):.1f} s, restart "
            f"and a step in {max(r['restart_s'] for r in res):.1f} s)")
    _rank_report(label, res, SHARDED)
    for r in res:
        v = r["vs_in_process"]
        if v["pois_n"] != ref["pois_n"] or v["dts"] != ref["dts"]:
            raise AssertionError(f"{label}: rank {r['rank']} pois_n "
                                 f"{v['pois_n']} dt {v['dts']} vs in-process "
                                 f"{ref['pois_n']} {ref['dts']}")
        w = r["restart"]
        if not (w["equal"] and w["same_history"]):
            raise AssertionError(f"(iv) rank {r['rank']}: the restart is not "
                                 f"bit for bit: {w}")
    log(f"  in-process (phase 6.5 (i)) pois_n {ref['pois_n']}, dt "
        f"{ref['dts'][1:]}: every rank equal bit for bit (u, p, dt, "
        f"pois_n)")
    log("  (iv) per-rank checkpoint after step 1, restarted and stepped "
        "once: every rank bit for bit the uninterrupted step 2")
    PROCESS_TIMES["ranks"] = res
    del ref
    stage("(ii) NCCL at world size 1: sphere_3d(96, 64) against "
          "mesh_for(S, 1) in process (the only NCCL check one card allows)")
    sim = sphere_3d(96, 64, device=dev, mesh=mesh_for(FINE, 1, dev))
    sim.steps(2, remeasure=False)
    with tempfile.TemporaryDirectory(prefix="wl_nccl_") as tmp:
        path = os.path.join(tmp, "ref.pt")
        torch.save({"u": sim.flow.u.cpu(), "p": sim.flow.p.cpu()}, path)
        (r,) = run_ranks(rank_nccl, 1, "nccl", dev, timeout=300.0,
                         args=(path,))
    log(f"  {r['mesh']}")
    _rank_report("6.9 (ii) sphere_3d(96, 64), NCCL world of 1", [r],
                 ("mult3d", "pcg_fused") + SHARD_FORMS)
    if (r["vs_in_process"]["pois_n"] != sim.pois_n
            or r["vs_in_process"]["dts"] != sim.dts):
        raise AssertionError(f"(ii) {r['vs_in_process']} vs {sim.pois_n} "
                             f"{sim.dts}")
    del sim
    stage("(iii) examples/sharded_sphere --quick on the card")
    out = sharded_sphere.main(["--quick"])
    twin = sphere_3d(sharded_sphere.N, sharded_sphere.M, device=dev,
                     mesh=mesh_for(sharded_sphere.S, RANKS, dev))
    twin.steps(len(out["pois_n"]))
    log(f"  in-process: dt {twin.dts[-1]:.6f}, pois_n {twin.pois_n}")
    if out["dts"] != twin.dts or out["pois_n"] != twin.pois_n:
        raise AssertionError(f"(iii) {out} vs in-process {twin.dts} "
                             f"{twin.pois_n}")
    torch.cuda.empty_cache()


def timing_process_mesh():
    """Phase 8's lines of phase 6.9 (i)'s world: a step's wall time, each
    rank's busy time (8 processes sharing one card, not 8 cards), the
    card's idle share, each rank's peak memory and the host-staged
    exchanges' bytes and wall time a step."""
    res = PROCESS_TIMES["ranks"]
    wall = max(r["timing"]["wall_ms"] for r in res)
    busy = [r["timing"]["busy_ms"] for r in res]
    for r in res:
        t = r["timing"]
        log(f"  rank {r['rank']}: wall {t['wall_ms']:.1f} ms/step, busy "
            f"{t['busy_ms']:.2f} ms/step"
            f"{' (CUDA events: the profiler recorded nothing)' if t['events'] else ''}"
            f", halo {t['halo_bytes'] / 2**20:.2f} MiB sent and "
            f"{t['gather_bytes'] / 2**20:.2f} MiB gathered a step in "
            f"{t['calls']:.0f} exchanges taking {t['comm_s'] * 1e3:.1f} ms "
            f"wall a step (host-staged), peak {r['peak_construct_gib']:.2f} "
            f"GiB constructing, {r['peak_step_gib']:.2f} GiB stepping, "
            f"pois_n {t['pois_n']}")
    from waterlily_tpu_torch.utils.perf import mlups
    dims = tuple(n - 2 for n in BIG)
    log(f"256³ sphere, 8 gloo ranks sharing the card, (2,2,2) mesh: wall "
        f"{wall:.1f} ms/step, {mlups(dims, 1, wall / 1e3):.2f} MLUPS, "
        f"{wall / 1e3 / (3 * math.prod(dims)) * 1e9:.3f} ns/DOF; busy "
        f"{sum(busy):.2f} ms/step summed over the "
        f"ranks (max {max(busy):.2f}); card idle share "
        f"{1 - sum(busy) / wall:.4f}; exchanges {max(r['timing']['comm_s'] for r in res) * 1e3:.1f} "
        f"ms wall a step on the slowest rank ({RANK_TIMED_STEPS} steps)")


# phase 6.10: autograd across ranks.  Phase 6.7's (96,64,64) sphere on the
# (2,2,2) process mesh of 8 gloo ranks sharing the card, its drag of
# `Simulation.global_flow` differentiated on every rank alike in ν and the
# radius; then the 256³ sphere's reverse step at the size the reckoning
# below lets 8 ranks hold at once.
GRAD_STEPS = 2
# the reckoning of (iv): a rank's block of the single-device 256³ reverse
# step (phase 6.7: 53.457 GiB on an NVIDIA H100 80GB HBM3, 700.00 W,
# PERF.md §5), the replicated coarse levels (L, D, iD and the two solves'
# vectors: 5 fields over ~1/7 of the fine cells), a rank's peak while it
# constructs the 256³ sphere on the process mesh (phase 6.9: 3.69 GiB,
# the same card, PERF.md §5) and a CUDA context, each scaled by (n/256)³
# but the context; the largest n of `AD_SIZES` whose 8 ranks fit in the
# budget
SINGLE_REVERSE_GIB = 53.457
RANK_CONSTRUCT_GIB = 3.69
CONTEXT_GIB = 0.5
GRAD_BUDGET_GIB = 70.0


def reckon_gib(n):
    """(iv)'s reckoned GiB of 8 ranks at ``sphere_3d(n, n)``, and a
    rank's terms."""
    scale = (n / 256) ** 3
    cells = (n + 2) ** 3
    terms = {"block graph": SINGLE_REVERSE_GIB * scale / RANKS,
             "coarse levels": 5 * 4 * cells / 7 / 2 ** 30,
             "construction": RANK_CONSTRUCT_GIB * scale,
             "context": CONTEXT_GIB}
    return RANKS * sum(terms.values()), terms


def grad_sim(torch, dev, nu, radius, mesh, **ad):
    """Phase 6.7's sphere (`drag_setup`'s body, ν and tolerance) as a
    `Simulation` on ``mesh`` (None: dense)."""
    from waterlily_tpu_torch import Simulation
    from waterlily_tpu_torch.body import AutoBody
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - AD_CENTRE) ** 2))
                    - radius)
    return Simulation(tuple(s - 2 for s in FINE), (1.0, 0.0, 0.0),
                      2 * AD_RADIUS, nu=nu, body=body, device=dev, mesh=mesh,
                      **{"tol": AD_TOL, **ad})


def sim_drag(sim, flow):
    from waterlily_tpu_torch.metrics import total_force
    return total_force(flow.u, flow.p, sim.cfg.nu, sim.body, flow.t)[0]


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(torch, dev, reset=False):
    if dev.type != "cuda":
        return 0.0
    if reset:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def _exchanged(mesh, before):
    return {k: mesh.stats[k] - before[k] for k in before}


def rank_reverse(torch, dev, mesh, steps, **ad):
    """`steps` steps of the sphere on the process ``mesh``, its drag and
    the gradient in (ν, radius), the launches of the forward and of the
    backward pass (counters zeroed before each, read after), the walls,
    this rank's peak GiB and the exchanges of each pass."""
    from waterlily_tpu_torch.ops.multigrid import ml_solve_implicit
    nu, radius = ad_params(torch, dev)
    sim = grad_sim(torch, dev, nu, radius, mesh, **ad)
    _sync(torch, dev)
    _peak(torch, dev, reset=True)
    stats0 = dict(mesh.stats)
    kernels = zeroed_wrappers()
    t0 = time.perf_counter()
    sim.steps(steps, remeasure=False)
    drag = sim_drag(sim, sim.global_flow())
    _sync(torch, dev)
    t1 = time.perf_counter()
    fwd = _read_wrappers(kernels)
    kernels = zeroed_wrappers()
    ml_solve_implicit.adjoint_n.clear()
    g = torch.autograd.grad(drag, (nu, radius))
    _sync(torch, dev)
    t2 = time.perf_counter()
    return {"drag": float(drag.detach()), "grad": [float(v) for v in g],
            "pois_n": sim.pois_n, "dts": sim.dts, "fwd": fwd,
            "bwd": _read_wrappers(kernels),
            "adjoint": list(ml_solve_implicit.adjoint_n),
            "forward_s": t1 - t0, "backward_s": t2 - t1,
            "peak_gib": _peak(torch, dev),
            "exchanges": _exchanged(mesh, stats0)}


def rank_log(torch, dev, mesh):
    """(iii): the sphere with ``log=True``, 2 steps, and without it: this
    rank's traces, blocks and histories, and whether the two runs' blocks
    and histories are bit for bit."""
    runs = []
    for log_on in (True, False):
        nu, radius = ad_params(torch, dev, grad=False)
        sim = grad_sim(torch, dev, nu, radius, mesh, log=log_on,
                       tol=1e-4)
        sim.steps(GRAD_STEPS, remeasure=False)
        runs.append(sim)
    a, b = runs
    return {"res_log": [t.copy() for t in a.res_log], "dts": a.dts,
            "pois_n": a.pois_n,
            "same_as_plain": (torch.equal(a.flow.u, b.flow.u)
                              and torch.equal(a.flow.p, b.flow.p)
                              and a.dts == b.dts and a.pois_n == b.pois_n)}


def rank_big_reverse(torch, dev, n):
    """(iv): one ``implicit_diff`` reverse step of ``sphere_3d(n, n,
    bbox=False)`` on the (2,2,2) process mesh, the KE of the assembled
    velocity differentiated in this rank's block of the initial velocity:
    the gradient block (host), wall s, busy ms (a second step under the
    profiler), peak GiB, exchanges, pois_n and adjoint counts."""
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.metrics import ke
    from waterlily_tpu_torch.ops.multigrid import ml_solve_implicit
    from waterlily_tpu_torch.parallel.dist import dist_mesh_for
    from waterlily_tpu_torch.parallel.shard_step import shardmap_mom_step
    from waterlily_tpu_torch.utils.perf import EVENTS_KEY, device_profile
    mesh = dist_mesh_for((n + 2,) * 3, device=dev)
    sim = sphere_3d(n, n, bbox=False, implicit_diff=True, device=dev,
                    mesh=mesh)
    _sync(torch, dev)
    construct_gib = _peak(torch, dev)
    # a step with the residual traces first (untracked: the kernel forms)
    kernels = zeroed_wrappers()
    _state, aux = shardmap_mom_step(
        dataclasses.replace(sim.cfg, implicit_diff=False, log=True), mesh,
        sim.levels, sim.flow)
    _sync(torch, dev)
    log_step = {**_read_wrappers(kernels), "pois_n": aux["pois_n"],
                "rows": [int((t != 0).any(dim=1).sum())
                         for t in aux["res_trace"]]}
    del _state, aux

    def reverse():
        u0 = sim.flow.u.detach().requires_grad_()
        state, aux = shardmap_mom_step(sim.cfg, mesh, sim.levels,
                                       sim.flow.replace(u=u0))
        loss = torch.sum(ke(mesh.assemble([state.u], 1)))
        (g,) = torch.autograd.grad(loss, u0)
        return g, aux

    _peak(torch, dev, reset=True)
    stats0 = dict(mesh.stats)
    kernels = zeroed_wrappers()
    ml_solve_implicit.adjoint_n.clear()
    mesh.barrier()
    t0 = time.perf_counter()
    g, aux = reverse()
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    # numpy: a tensor would cross to the parent through shared memory
    out = {"n": n, "g": g.cpu().numpy(), "wall_s": wall, "peak_gib": _peak(torch, dev),
           "construct_gib": construct_gib, "pois_n": aux["pois_n"],
           "adjoint": list(ml_solve_implicit.adjoint_n),
           "exchanges": _exchanged(mesh, stats0),
           "counts": _read_wrappers(kernels)["counts"], "log_step": log_step}
    del g
    if dev.type == "cuda":
        busy, by_name = device_profile(lambda: reverse(), 1, events=True)
        out.update(busy_ms=busy, events=EVENTS_KEY in by_name)
    return out


def rank_grad(rank, world, dev, big_n):
    """Phase 6.10 (i)-(iv) on one rank of the (2,2,2) process mesh."""
    import gc
    import torch
    from waterlily_tpu_torch.parallel.dist import dist_mesh_for
    if dev.type == "cuda":
        from waterlily_tpu_torch.kernels.build import library
        library()
    mesh = dist_mesh_for(FINE, device=dev)
    out = {"rank": rank,
           "implicit": rank_reverse(torch, dev, mesh, GRAD_STEPS,
                                    implicit_diff=True),
           "fixed": rank_reverse(torch, dev, mesh, 1, fixed_iters=2),
           "log": rank_log(torch, dev, mesh)}
    gc.collect()
    _peak(torch, dev, reset=True)
    out["big"] = rank_big_reverse(torch, dev, big_n)
    return out


def rank_grad_nccl(rank, world, dev):
    """(v): (i) on the NCCL world of one rank."""
    import torch
    from waterlily_tpu_torch.kernels.build import library
    from waterlily_tpu_torch.parallel.dist import dist_mesh_for
    if dev.type == "cuda":
        library()
    mesh = dist_mesh_for(FINE, device=dev)
    out = rank_reverse(torch, dev, mesh, GRAD_STEPS, implicit_diff=True)
    out["mesh"] = repr(mesh)
    return out


def twin_reverse(torch, dev, mesh, steps, **ad):
    """The in-process block step's twin of `rank_reverse`: the dense
    Simulation's state and levels through `shardmap_mom_step` on ``mesh``
    (an in-process `mesh_for`)."""
    from waterlily_tpu_torch.parallel.shard_step import shardmap_mom_step
    nu, radius = ad_params(torch, dev, grad=not ad.get("log"))
    sim = grad_sim(torch, dev, nu, radius, None, **ad)
    state, pois, traces = sim.flow, [], []
    for _ in range(steps):
        state, aux = shardmap_mom_step(sim.cfg, mesh, sim.levels, state)
        pois.append(aux["pois_n"])
        if sim.cfg.log:
            traces.append(aux["res_trace"].cpu().numpy())
    out = {"pois_n": pois, "state": state, "res_log": traces}
    if not sim.cfg.log:
        drag = sim_drag(sim, state)
        out["drag"] = float(drag.detach())
        out["grad"] = [float(v) for v in torch.autograd.grad(drag,
                                                             (nu, radius))]
    return out


def _launch_report(label, res, part_of):
    """Each rank's launches in the forward and the backward pass of
    ``part_of(res[r])``: ``pcg_fused`` in both, nothing of `AD_PLAIN`."""
    for r in res:
        for part in ("fwd", "bwd"):
            counts = part_of(r)[part]["counts"]
            name = f"{label} {'forward' if part == 'fwd' else 'backward'}, " \
                   f"rank {r.get('rank', 0)}"
            ran = [k for k in AD_PLAIN if counts[k]]
            if ran or not counts["pcg_fused"]:
                raise AssertionError(f"{name}: launches {counts}")
            PATH_LAUNCHES[name] = counts
            for k, shapes in part_of(r)[part]["shapes"].items():
                PATH_SHAPES.setdefault(k, set()).update(shapes)
    launched = {k: n for k, n in part_of(res[0])["fwd"]["counts"].items()
                if n}
    back = {k: n for k, n in part_of(res[0])["bwd"]["counts"].items() if n}
    log(f"  launches a rank (rank 0; every rank alike checked): forward "
        f"{launched}, backward {back}; none of {AD_PLAIN}")


def run_process_grad(torch, dev):
    """Phase 6.10: autograd across ranks on the (2,2,2) process mesh of 8
    gloo ranks sharing the card, (i) ``implicit_diff``, (ii)
    ``fixed_iters=2``, (iii) ``log``, each against the in-process block
    step on the card, (iv) the big reverse step at the reckoned size
    against the dense one, (v) NCCL at world size 1."""
    import gc
    import numpy as np
    from waterlily_tpu_torch.parallel.launch import run_ranks
    from waterlily_tpu_torch.parallel.mesh import mesh_for
    fits = [n for n in AD_SIZES if reckon_gib(n)[0] <= GRAD_BUDGET_GIB]
    for n in AD_SIZES:
        total, terms = reckon_gib(n)
        log(f"  (iv) reckoning at sphere_3d({n}, {n}): {total:.2f} GiB for "
            f"{RANKS} ranks, a rank " + ", ".join(
                f"{k} {v:.3f}" for k, v in terms.items()))
    if not fits:
        raise AssertionError(f"no size of {AD_SIZES} fits "
                             f"{GRAD_BUDGET_GIB} GiB")
    big_n = fits[0]
    log(f"  (iv) runs at sphere_3d({big_n}, {big_n}): the largest of "
        f"{AD_SIZES} within {GRAD_BUDGET_GIB} GiB")
    label = "6.10 (i) implicit_diff, 8 gloo ranks"
    stage(f"(i)-(iv) 8 gloo ranks sharing the card, (2,2,2) mesh: "
          f"sphere_3d(96, 64) implicit_diff tol {AD_TOL:g}, fixed_iters=2, "
          f"log; sphere_3d({big_n}, {big_n}) implicit_diff reverse step")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_ranks(rank_grad, RANKS, "gloo", dev, timeout=900.0,
                    args=(big_n,))
    log(f"8 ranks done in {time.perf_counter() - t0:.1f} s")

    stage("(i) implicit_diff against the in-process block step")
    mesh = mesh_for(FINE, RANKS, dev)
    twin = twin_reverse(torch, dev, mesh, GRAD_STEPS, implicit_diff=True)
    grads = {tuple(r["implicit"]["grad"]) for r in res}
    g = res[0]["implicit"]["grad"]
    e_twin = rel_err(g + [res[0]["implicit"]["drag"]],
                     twin["grad"] + [twin["drag"]])
    single = AD_RESULTS["implicit"]
    e_single = rel_err(g, single["grad"])
    for r in res:
        x = r["implicit"]
        log(f"  rank {r['rank']}: drag {x['drag']!r}, d/dν, d/dradius = "
            f"{x['grad']}; pois_n {x['pois_n']}, adjoint {x['adjoint']}; "
            f"forward {x['forward_s']:.3f} s, reverse pass "
            f"{x['backward_s']:.3f} s, peak {x['peak_gib']:.3f} GiB; "
            f"exchanges forward {x['exchanges']['halo_bytes'] / 2**20:.2f} "
            f"MiB sent, {x['exchanges']['gather_bytes'] / 2**20:.2f} MiB "
            f"gathered in {x['exchanges']['calls']} calls "
            f"({x['exchanges']['comm_s']:.3f} s), backward "
            f"{x['exchanges']['bwd_halo_bytes'] / 2**20:.2f} MiB sent, "
            f"{x['exchanges']['bwd_gather_bytes'] / 2**20:.2f} MiB gathered "
            f"in {x['exchanges']['bwd_calls']} calls "
            f"({x['exchanges']['bwd_comm_s']:.3f} s)")
    log(f"  in-process block step (mesh_for(FINE, 8) on the card): drag "
        f"{twin['drag']!r}, {twin['grad']}, pois_n {twin['pois_n']}: "
        f"relative difference {e_twin:.3e}")
    log(f"  single device (phase 6.7 (i)): {single['grad']}, pois_n "
        f"{single['pois_n']}: relative difference {e_single:.3e}")
    if len(grads) != 1:
        raise AssertionError(f"{label}: the ranks' gradients differ: "
                             f"{grads}")
    if not (e_twin <= 1e-4 and all(r["implicit"]["pois_n"] == twin["pois_n"]
                                   for r in res)):
        raise AssertionError(f"{label} vs the in-process block step: {g} vs "
                             f"{twin['grad']}")
    if not e_single <= 2e-2:
        raise AssertionError(f"{label} vs single device: {g} vs "
                             f"{single['grad']}")
    _launch_report(label, res, lambda r: r["implicit"])
    del twin

    stage("(ii) fixed_iters=2, 1 step, against the in-process block step")
    twin = twin_reverse(torch, dev, mesh, 1, fixed_iters=2)
    x = res[0]["fixed"]
    e = abs(x["grad"][0] - twin["grad"][0]) / abs(twin["grad"][0])
    cost = AD_RESULTS["fixed_cost"]
    log(f"  ranks: d/dν, d/dradius = {x['grad']} (every rank alike: "
        f"{len({tuple(r['fixed']['grad']) for r in res}) == 1}); in-process "
        f"{twin['grad']}: d/dν relative difference {e:.3e}")
    for r in res:
        y = r["fixed"]
        log(f"  rank {r['rank']}: forward {y['forward_s']:.3f} s, reverse "
            f"pass {y['backward_s']:.3f} s, peak {y['peak_gib']:.3f} GiB, "
            f"exchanges backward {y['exchanges']['bwd_halo_bytes'] / 2**20:.2f} "
            f"MiB sent in {y['exchanges']['bwd_calls']} calls")
    log(f"  beside phase 6.7 (iv)'s single-device fixed_iters={cost['k']} "
        f"2 steps: reverse pass {cost['wall_s']:.3f} s, peak "
        f"{cost['peak_gib']:.3f} GiB")
    if not e <= 1e-4 or len({tuple(r["fixed"]["grad"]) for r in res}) != 1:
        raise AssertionError(f"(ii) fixed_iters=2: {x['grad']} vs "
                             f"{twin['grad']}")
    del twin

    stage("(iii) log=True: the residual traces")
    twin = twin_reverse(torch, dev, mesh, GRAD_STEPS, log=True, tol=1e-4)
    for r in res:
        y = r["log"]
        same = all(np.array_equal(a, b) for a, b in zip(y["res_log"],
                                                        twin["res_log"]))
        alike = all(np.array_equal(a, b) for a, b in zip(
            y["res_log"], res[0]["log"]["res_log"]))
        rows = [[int(np.any(t != 0, axis=1).sum()) for t in step]
                for step in y["res_log"]]
        want = [[n + 1 for n in p] for p in y["pois_n"]]
        if not (same and alike and rows == want and y["same_as_plain"]
                and y["pois_n"] == twin["pois_n"]
                and len(y["res_log"]) == GRAD_STEPS):
            raise AssertionError(f"(iii) rank {r['rank']}: traces equal the "
                                 f"block step's {same}, rank 0's {alike}; "
                                 f"rows {rows} vs {want}; the run without "
                                 f"log {y['same_as_plain']}")
    log(f"  every rank's res_log bit for bit the in-process block step's and "
        f"rank 0's; non-zero rows a solve {rows} = pois_n + 1; u, p, dt, "
        f"pois_n bit for bit the run without log; first rows "
        f"{res[0]['log']['res_log'][0][0][:2].tolist()}")
    del twin
    gc.collect()
    torch.cuda.empty_cache()

    stage(f"(iv) sphere_3d({big_n}, {big_n}, bbox=False): one implicit_diff "
          f"reverse step, 8 ranks against the in-process block step and "
          f"the single device")
    S_big = (big_n + 2,) * 3
    cpu_mesh = mesh_for(S_big, RANKS, "cpu")
    twin = cpu_mesh.split(block_reverse_step(torch, dev, big_n), 1)
    gc.collect()
    torch.cuda.empty_cache()
    dense = dense_reverse_step(torch, dev, big_n)
    with gates_shut():
        plain = dense_reverse_step(torch, dev, big_n)
    if dense is None or plain is None:
        raise AssertionError(f"(iv) the single-device step at {big_n} does "
                             f"not fit")
    scale = float(dense["g"].abs().max())
    spread = float((dense["g"] - plain["g"]).abs().max()) / scale
    blocks = cpu_mesh.split(dense["g"], 1)
    log(f"  the single device's own spread at the default tol 1e-4 (its "
        f"kernels against every plain form, max|Δg| / max|g|): "
        f"{spread:.3e}")
    for r in res:
        y = r["big"]
        gr = torch.from_numpy(y["g"])
        e = float((gr - blocks[r["rank"]]).abs().max()) / scale
        same = torch.equal(gr, twin[r["rank"]])
        finite = bool(torch.isfinite(gr).all())
        log(f"  rank {r['rank']}: {y['wall_s']:.3f} s wall, busy "
            f"{y.get('busy_ms', float('nan')):.2f} ms"
            f"{' (CUDA events)' if y.get('events') else ''}, peak "
            f"{y['peak_gib']:.3f} GiB stepping ({y['construct_gib']:.3f} "
            f"constructing); exchanges forward "
            f"{y['exchanges']['halo_bytes'] / 2**20:.2f} MiB sent, "
            f"{y['exchanges']['gather_bytes'] / 2**20:.2f} MiB gathered, "
            f"backward {y['exchanges']['bwd_halo_bytes'] / 2**20:.2f} MiB "
            f"sent, {y['exchanges']['bwd_gather_bytes'] / 2**20:.2f} MiB "
            f"gathered ({y['exchanges']['comm_s'] + y['exchanges']['bwd_comm_s']:.3f} "
            f"s in exchanges); pois_n {y['pois_n']}, adjoint "
            f"{y['adjoint']}; bit for bit the in-process block step's "
            f"{same}; max|Δg| / max|g| against the single device {e:.3e}; "
            f"launches {dict((k, n) for k, n in y['counts'].items() if n)}")
        if not (finite and same):
            raise AssertionError(f"(iv) rank {r['rank']}: finite {finite}, "
                                 f"bit for bit the in-process block step "
                                 f"{same}")
        PATH_LAUNCHES[f"6.10 (iv) {big_n}³ reverse step, rank "
                      f"{r['rank']}"] = y["counts"]
        z = y["log_step"]
        idle = [k for k in SHARDED if not z["counts"][k]]
        if r["rank"] == 0:
            log(f"    a log=True step at {big_n}³ before it (every rank "
                f"alike checked): launches "
                f"{dict((k, n) for k, n in z['counts'].items() if n)}, "
                f"pois_n {z['pois_n']}, non-zero trace rows {z['rows']}")
        if idle or z["rows"] != [k + 1 for k in z["pois_n"]]:
            raise AssertionError(f"(iii) log step at {big_n}³, rank "
                                 f"{r['rank']}: never launched {idle}; "
                                 f"rows {z['rows']}")
        PATH_LAUNCHES[f"6.10 (iii) log step at {big_n}³, rank "
                      f"{r['rank']}"] = z["counts"]
        for k, shapes in z["shapes"].items():
            PATH_SHAPES.setdefault(k, set()).update(shapes)
        for k, bases in z["bases"].items():
            PATH_BASES.setdefault(k, set()).update(bases)
        del y["g"]
    del dense, plain, blocks, twin

    stage("(v) NCCL at world size 1: (i) against mesh_for(S, 1) in process")
    (r,) = run_ranks(rank_grad_nccl, 1, "nccl", dev, timeout=300.0)
    twin = twin_reverse(torch, dev, mesh_for(FINE, 1, dev), GRAD_STEPS,
                        implicit_diff=True)
    e = [abs(a - b) / abs(b) for a, b in zip(r["grad"], twin["grad"])]
    log(f"  {r['mesh']}: {r['grad']}, in process {twin['grad']}: relative "
        f"differences {e[0]:.3e}, {e[1]:.3e}; pois_n {r['pois_n']} vs "
        f"{twin['pois_n']}")
    # d/dradius sums its terms in another association (a rank keeps the
    # measured fields as blocks, the in-process step splits them each
    # step): 4e-6 apart in f32 at (34,18,18) on the CPU, 2e-15 in f64
    if not (e[0] <= 1e-6 and e[1] <= 1e-4
            and r["pois_n"] == twin["pois_n"]):
        raise AssertionError(f"(v) NCCL: {r['grad']} vs {twin['grad']}")
    _launch_report("6.10 (v) NCCL world of 1", [r], lambda r: r)
    torch.cuda.empty_cache()


# phase 6.6: the samplings of the forces; the sphere's moments are taken
# about the domain's origin, so that the lever arm makes them large
SAMPLINGS = ("center", "surface", "extrap")
RECORD_EVERY = 0.05     # tU/L between samples: 2 steps of the (96,64,64)
RECORD_T = 0.15         # sphere at dt ~ 0.4 (tU/L 0.025 a step)


def record_fields(torch):
    """`run_record`'s fields: the total force in every sampling, the
    pressure moment, Σ|ω| and Σλ₂ (with Σ|λ₂|, its comparison's scale)."""
    from waterlily_tpu_torch import metrics as m

    def force(s):
        return lambda sim: m.total_force(sim.flow.u, sim.flow.p, sim.cfg.nu,
                                         sim.body, sim.time, s)

    def l2(sim):
        v = m.lambda2(sim.flow.u)
        return torch.stack([v.sum(), v.abs().sum()])

    return {**{f"force {s}": force(s) for s in SAMPLINGS},
            "moment": lambda sim: m.pressure_moment(
                (0.0,) * sim.cfg.D, sim.flow.p, sim.body, sim.time),
            "sum omega_mag": lambda sim: m.omega_mag(sim.flow.u).sum()[None],
            "sum lambda2": l2}


def trace_err(a, b):
    """max|a - b| of two residual traces, relative to each solve's initial
    residual (row 0)."""
    import numpy as np
    scale = np.maximum(np.abs(b[..., :1, :]), np.finfo(np.float32).tiny)
    return float((np.abs(a.astype(np.float64) - b) / scale).max())


def record_vs_cpu(torch, sim, twin, rec, rect, tmp):
    """Phase 6.6 (i)'s comparison: the sample times, pois_n (phase 4's
    rule), every field within 1e-4 of the CPU's (relative to its largest
    value; Σλ₂ to Σ|λ₂|), the residual traces of the steps whose pois_n
    agree within 1e-3, and `write_log`'s rows."""
    import os
    import numpy as np
    from waterlily_tpu_torch.io.plots import read_log
    log(f"samples at tU/L {rec['t']} (CPU {rect['t']}); pois_n "
        f"{sim.pois_n} (CPU {twin.pois_n})")
    if len(rec["t"]) != len(rect["t"]) or len(sim.pois_n) != len(twin.pois_n):
        raise AssertionError("run_record sampled at other steps than on "
                             "the CPU")
    if not np.allclose(rec["t"], rect["t"], rtol=1e-5):
        raise AssertionError(f"sample times {rec['t']} vs {rect['t']}")
    if not pois_ok(sim.pois_n, twin.pois_n):
        raise AssertionError(f"pois_n GPU {sim.pois_n} vs CPU {twin.pois_n}")
    for name in rec:
        if name == "t":
            continue
        g, c = np.stack(rec[name]), np.stack(rect[name])
        if name == "sum lambda2":
            rel = float(np.abs(g[:, 0] - c[:, 0]).max() / np.abs(c[:, 1]).max())
        else:
            rel = float(np.abs(g - c).max() / np.abs(c).max())
        log(f"  {name:<15} last sample {g[-1].tolist()} (CPU "
            f"{c[-1].tolist()}): max relative difference {rel:.3e}")
        if not (np.isfinite(g).all() and rel <= 1e-4):
            raise AssertionError(f"run_record field {name} differs: {rel}")
    same = [i for i, (a, b) in enumerate(zip(sim.pois_n, twin.pois_n))
            if a == b]
    errs = [trace_err(sim.res_log[i], twin.res_log[i]) for i in same]
    log(f"  residual traces of the {len(same)} steps whose pois_n agree: "
        f"max relative difference {max(errs):.3e}")
    if not max(errs) <= 1e-3:
        raise AssertionError(f"residual traces differ: {errs}")
    logs = []
    for label, s in (("gpu", sim), ("cpu", twin)):
        f = os.path.join(tmp, f"{label}.log")
        s.write_log(f)
        logs.append((f, read_log(f)))
    (fg, lg), (fc, lc) = logs
    heads = [open(f).readline() for f in (fg, fc)]
    for blocks_g, blocks_c in zip(lg, lc):
        if len(blocks_g) != len(blocks_c) or heads[0] != heads[1]:
            raise AssertionError("write_log: other blocks than the CPU's")
        for i in same:
            bg, bc = np.array(blocks_g[i]), np.array(blocks_c[i])
            if bg.shape != bc.shape or not (bg[:, 0] == bc[:, 0]).all() or (
                    trace_err(bg[None, :, 1:], bc[None, :, 1:]) > 1e-3):
                raise AssertionError(f"write_log rows of step {i} differ")
    log(f"  write_log: {sum(map(len, lg))} blocks, the rows of the "
        f"{len(same)} steps whose pois_n agree equal the CPU's (1e-3)")


def run_recording(torch, dev):
    """Phase 6.6: the recording path, (i) `run_record` of the logged
    (96,64,64) sphere against the CPU from one state, (ii) a checkpoint
    restart bit for bit, (iii) a CSG body against the CPU, (iv) VTK files
    bit for bit, (v) the 256³ sphere's metrics finite."""
    import tempfile
    import numpy as np
    import waterlily_tpu_torch as wt
    from waterlily_tpu_torch import metrics, io
    from waterlily_tpu_torch.convert import flow_to, levels_to
    from waterlily_tpu_torch.ops.stencil_kernels import kernel_wrappers
    cpu = torch.device("cpu")
    fields = record_fields(torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")

    stage("(i) run_record of sphere_3d(96, 64, log=True)")

    def drive():
        sim = wt.sphere_3d(96, 64, device=dev, log=True)
        init, init_levels = sim.flow, sim.levels
        t0 = time.perf_counter()
        rec = sim.run_record(RECORD_T, every=RECORD_EVERY, fields=fields,
                             remeasure=False)
        torch.cuda.synchronize()
        log(f"run_record to tU/L {RECORD_T} every {RECORD_EVERY}: "
            f"{len(sim.pois_n)} steps, {len(rec['t'])} samples in "
            f"{time.perf_counter() - t0:.2f} s")
        return sim, init, init_levels, rec

    label = "sphere_3d(96, 64, log=True), run_record"
    sim, init, init_levels, rec = on_path(torch, label, DENSE, drive)
    based = {k: sorted(w.bases) for k, w in kernel_wrappers().items()
             if w.bases}
    if based or sim._sharded:
        raise AssertionError(f"the recording path ran shard-local forms: "
                             f"{based}")
    finite(torch, sim, label)
    twin = wt.sphere_3d(96, 64, device="cpu", log=True)
    twin.flow, twin.levels = flow_to(init, cpu), levels_to(init_levels, cpu)
    t0 = time.perf_counter()
    rect = twin.run_record(RECORD_T, every=RECORD_EVERY, fields=fields,
                           remeasure=False)
    log(f"the same run_record on the CPU in {time.perf_counter() - t0:.1f} s")
    record_vs_cpu(torch, sim, twin, rec, rect, tmp)

    stage("(iv) VTK: u, p and lambda2 written and read back")
    snap = {"u": sim.flow.u, "p": sim.flow.p,
            "lambda2": metrics.lambda2(sim.flow.u)}
    f = os.path.join(tmp, "snap.vti")
    io.write_vti(f, snap)
    back = io.read_vti(f)
    for k, v in snap.items():
        if not np.array_equal(back[k], v.cpu().numpy()):
            raise AssertionError(f"VTK round trip of {k} is not bit for bit")
    again = wt.sphere_3d(96, 64, device=dev)
    with contextlib.chdir(tmp):       # the collection is written here
        io.VTKWriter("restart", dir="vtk").write(sim)
        io.restart_from_vtk(again, "restart.pvd")
    if not (torch.equal(again.flow.u, sim.flow.u)
            and torch.equal(again.flow.p, sim.flow.p)):
        raise AssertionError("restart_from_vtk: u or p not bit for bit")
    log(f"write_vti/read_vti of {sorted(snap)} at {tuple(sim.flow.p.shape)}"
        f" and restart_from_vtk: bit for bit")
    del sim, twin, again, snap, back

    stage("(ii) checkpoint after 3 steps, restart, 3 more steps each")
    a = wt.sphere_3d(96, 64, device=dev)
    a.steps(3, remeasure=False)
    f = os.path.join(tmp, "ckpt.npz")
    io.save_checkpoint(f, a)
    b = io.restart_sim(wt.sphere_3d(96, 64, device=dev), f)
    a.steps(3, remeasure=False)
    b.steps(3, remeasure=False)
    same = (torch.equal(a.flow.u, b.flow.u) and torch.equal(a.flow.p, b.flow.p)
            and a.dts == b.dts and a.pois_n == b.pois_n)
    log(f"restarted from the checkpoint: pois_n {b.pois_n[3:]} (writer "
        f"{a.pois_n[3:]}), dt {b.dts[4:]} (writer {a.dts[4:]}); u, p, dt and "
        f"pois_n bit for bit: {same}")
    if not same:
        raise AssertionError("checkpoint restart is not bit for bit")
    del a, b

    stage("(iii) a CSG body: two spheres' union minus a sphere")
    make = csg_sim(torch)

    def drive_csg():
        s = make(dev)
        init, init_levels = s.flow, s.levels
        s.steps(3, remeasure=False)
        return s, init, init_levels

    csg, init, init_levels = on_path(torch, "CSG (96,64,64)", DENSE,
                                     drive_csg)
    finite(torch, csg, "CSG (96,64,64)")
    twin = make(cpu)
    du = float((init.mu0.cpu() - twin.flow.mu0).abs().max())
    log(f"CSG mu0 measured on the card vs on the CPU: max|d| {du:.3e}")
    if not du <= 1e-5:
        raise AssertionError(f"CSG mu0 differs from the CPU's by {du}")
    twin_vs_cpu(torch, csg, twin, init, init_levels, 3, False)
    sg = wt.body.measure_sdf(csg.body, csg.cfg.S, 0.0, device=dev).cpu()
    sc = wt.body.measure_sdf(twin.body, twin.cfg.S, 0.0, device=cpu)
    dist = torch.abs(sc) + CSG_RMAX
    ulp = dist.nextafter(torch.full_like(dist, math.inf)) - dist
    dsd = (sg - sc).abs()
    log(f"measure_sdf on the card vs the CPU: bit for bit "
        f"{bool(torch.equal(sg, sc))}, max|d| {float(dsd.max()):.3e}, at "
        f"most {float((dsd / ulp).max()):.2f} ulp of the distance to the "
        f"centre (|sdf| + r)")
    if not bool((dsd <= ulp).all()):
        raise AssertionError("measure_sdf on the card differs from the CPU")
    del csg, twin

    stage("(v) sphere_3d(256, 256): forces in every sampling and lambda2")
    big = wt.sphere_3d(256, 256, device=dev)
    big.steps(3, remeasure=False)
    finite(torch, big, "sphere_3d(256, 256)")
    u, p, t = big.flow.u, big.flow.p, big.time
    out = {s: metrics.total_force(u, p, big.cfg.nu, big.body, t, s)
           for s in SAMPLINGS}
    l2 = metrics.lambda2(u)
    log("sphere_3d(256, 256) after 3 steps: total_force "
        + ", ".join(f"{s} {v.tolist()}" for s, v in out.items())
        + f"; lambda2 in [{float(l2.min()):.4e}, {float(l2.max()):.4e}]")
    if not (all(bool(v.isfinite().all()) for v in out.values())
            and bool(l2.isfinite().all())):
        raise AssertionError("sphere_3d(256, 256): a metric is not finite")
    del big, u, p, l2
    shutil.rmtree(tmp)
    torch.cuda.empty_cache()


# phase 6.7: the (96,64,64) sphere's drag as a function of ν and the
# sphere's radius; the kernels the AD program must launch (the pressure
# solves, forward and adjoint) and those it must not (a tracked field takes
# the plain forms)
AD_NU, AD_RADIUS, AD_CENTRE = 0.16, 8.0, 31.0
# the solves' tolerance: the implicit gradient assumes converged solves; at
# the default 1e-4 the radius gradient is 16.5% off its value at 1e-5 and
# 18.5% off at 1e-7 on an H100 80GB HBM3 at 700 W (the phase logs both),
# 1e-5 and 1e-7 differ by 1.7%, and at 1e-7 the f32 forward solve stalls
# at itmx (PERF.md §6)
AD_TOL = 1e-5
# (the detached levels' blocked smooths take pcg_blocked's two sweeps)
AD_KERNELS = ("mult3d", "increment3d", "pcg_fused", "pcg_dir_mult",
              "pcg_update")
AD_PLAIN = ("conv_diff3d", "bc3d", "div3d", "project3d", "cfl3d")
AD_SIZES = (256, 192, 128)   # the big reverse step, largest first
AD_RESULTS = {}     # phase 6.7's gradients and costs, read by phase 6.10


def drag_setup(torch, dev, nu, radius, **ad):
    """``(cfg, body, levels, state)`` of the (96,64,64) sphere at rest with
    viscosity ``nu`` and radius ``radius`` (0-d tensors) and the AD mode
    ``ad`` (and any other `FlowConfig` keyword, such as ``perdir``):
    `flow_init`, `measure_fields`, `build_levels`."""
    from waterlily_tpu_torch.body import AutoBody, measure_fields
    from waterlily_tpu_torch.flow import FlowConfig, flow_init
    from waterlily_tpu_torch.ops.multigrid import build_levels
    f32 = torch.float32
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - AD_CENTRE) ** 2))
                    - radius)
    cfg = FlowConfig(D=3, S=FINE, device=dev, nu=nu, U=(1.0, 0.0, 0.0),
                     dtype=f32, **{"tol": AD_TOL, **ad})
    state = flow_init(cfg)
    V, m0, m1, _ = measure_fields(body, FINE, 0.0, 1.0, cfg.perdir, False,
                                  f32, dev)
    return (cfg, body, build_levels(m0, cfg.perdir),
            state.replace(V=V, mu0=m0, mu1=m1))


def drag_steps(cfg, body, levels, state, steps=2):
    """``(drag, pois_n)`` after ``steps`` steps of `drag_setup`'s sphere."""
    from waterlily_tpu_torch.flow import mom_step
    from waterlily_tpu_torch.metrics import total_force
    pois = []
    for _ in range(steps):
        state, aux = mom_step(cfg, levels, state)
        pois.append(aux["pois_n"])
    return total_force(state.u, state.p, cfg.nu, body, state.t)[0], pois


def ad_params(torch, dev, nu=AD_NU, radius=AD_RADIUS, grad=True):
    return tuple(torch.tensor(v, dtype=torch.float32, device=dev,
                              requires_grad=grad) for v in (nu, radius))


def drag_grad(torch, dev, **ad):
    """``(drag, [d/dν, d/dradius], pois_n)`` by ``torch.autograd``."""
    nu, radius = ad_params(torch, dev)
    drag, pois = drag_steps(*drag_setup(torch, dev, nu, radius, **ad))
    g = torch.autograd.grad(drag, (nu, radius))
    return float(drag.detach()), [float(v) for v in g], pois


def rel_err(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


@contextlib.contextmanager
def gates_shut():
    """Every kernel gate closed inside the block (`use_blocked`,
    `use_pcg_fused`): the whole program in its plain forms on the card."""
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    old = sk.use_blocked, pk.use_pcg_fused
    try:
        sk.use_blocked = pk.use_pcg_fused = lambda S, dtype, device: False
        yield
    finally:
        sk.use_blocked, pk.use_pcg_fused = old


def reverse_cost(torch, dev, label, **ad):
    """Wall seconds and peak memory of one reverse pass of the drag."""
    from waterlily_tpu_torch.ops.multigrid import ml_solve_implicit
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ml_solve_implicit.adjoint_n.clear()
    t0 = time.perf_counter()
    drag, g, pois = drag_grad(torch, dev, **ad)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gib = torch.cuda.max_memory_allocated() / 2 ** 30
    adjoint = list(ml_solve_implicit.adjoint_n)
    log(f"  {label}: one reverse pass {wall:.3f} s, peak {gib:.3f} GiB "
        f"allocated; pois_n {pois}, adjoint {adjoint}; drag {drag!r}, "
        f"gradient {g}")
    if not all(math.isfinite(v) for v in g + [drag]):
        raise AssertionError(f"{label}: non-finite gradient {g}")
    return {"wall_s": wall, "peak_gib": gib, "grad": g, "pois_n": pois}


def dense_reverse_step(torch, dev, n):
    """One ``implicit_diff`` reverse step of ``sphere_3d(n, n, bbox=False)``
    on the card (d of the kinetic energy in the initial velocity): the
    gradient (on the host), wall seconds, peak GiB, pois_n and the adjoint
    solves' counts; None where it does not fit in the card's memory."""
    import gc
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.flow import mom_step
    from waterlily_tpu_torch.metrics import ke
    from waterlily_tpu_torch.ops.multigrid import ml_solve_implicit
    sim = sphere_3d(n, n, bbox=False, implicit_diff=True, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ml_solve_implicit.adjoint_n.clear()
    t0 = time.perf_counter()
    try:
        u0 = sim.flow.u.detach().requires_grad_()
        state, aux = mom_step(sim.cfg, sim.levels, sim.flow.replace(u=u0))
        (g,) = torch.autograd.grad(torch.sum(ke(state.u)), u0)
        torch.cuda.synchronize()
        out = {"n": n, "g": g.cpu(), "pois_n": aux["pois_n"],
               "adjoint": list(ml_solve_implicit.adjoint_n)}
    except torch.cuda.OutOfMemoryError:
        out = None
    wall = time.perf_counter() - t0
    gib = torch.cuda.max_memory_allocated() / 2 ** 30
    state = u0 = g = sim = None
    gc.collect()
    torch.cuda.empty_cache()
    if out is None:
        log(f"  sphere_3d({n}, {n}, bbox=False): one implicit_diff reverse "
            f"step does not fit in the card's memory (peak {gib:.3f} GiB "
            f"allocated when it ran out)")
        return None
    out.update(wall_s=wall, peak_gib=gib)
    log(f"  sphere_3d({n}, {n}, bbox=False) one implicit_diff reverse step: "
        f"{wall:.3f} s, peak {gib:.3f} GiB allocated; pois_n "
        f"{out['pois_n']}, adjoint {out['adjoint']}")
    if not bool(torch.isfinite(out["g"]).all()):
        raise AssertionError(f"sphere_3d({n}, {n}): non-finite gradient")
    return out


def block_reverse_step(torch, dev, n):
    """`dense_reverse_step`'s gradient by the block step on the in-process
    (2,2,2) mesh on the card (on the host)."""
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.metrics import ke
    from waterlily_tpu_torch.parallel.mesh import mesh_for
    from waterlily_tpu_torch.parallel.shard_step import shardmap_mom_step
    sim = sphere_3d(n, n, bbox=False, implicit_diff=True, device=dev)
    u0 = sim.flow.u.detach().requires_grad_()
    state, _aux = shardmap_mom_step(sim.cfg, mesh_for((n + 2,) * 3, 8, dev),
                                    sim.levels, sim.flow.replace(u=u0))
    (g,) = torch.autograd.grad(torch.sum(ke(state.u)), u0)
    return g.cpu()


def big_reverse_step(torch, dev):
    """`dense_reverse_step` at the largest n of `AD_SIZES` that fits in
    the card's memory (kept in `AD_RESULTS` for phase 6.10)."""
    for n in AD_SIZES:
        out = dense_reverse_step(torch, dev, n)
        if out is not None:
            AD_RESULTS["big"] = {k: v for k, v in out.items() if k != "g"}
            return
    raise AssertionError(f"no reverse step of the sizes {AD_SIZES} fits")


def run_differentiability(torch, dev):
    """Phase 6.7: gradients of the (96,64,64) sphere's drag in ν and its
    radius, (i) ``implicit_diff`` against the gates shut, the CPU and FD,
    with the pressure kernels launched forward and backward, (ii)
    ``fixed_iters=2`` reverse against `torch.func.jvp`, (iii) the guard,
    (iv) the cost of a reverse pass."""
    from waterlily_tpu_torch.ops.multigrid import ml_solve_implicit
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    cpu = torch.device("cpu")

    stage("(i) implicit_diff: the kernels in the forward and adjoint solves")
    nu, radius = ad_params(torch, dev)
    setup = drag_setup(torch, dev, nu, radius, implicit_diff=True)
    ml_solve_implicit.adjoint_n.clear()
    t0 = time.perf_counter()
    drag, pois = on_path(torch, "6.7 implicit_diff forward", AD_KERNELS,
                         lambda: drag_steps(*setup))
    t1 = time.perf_counter()
    g = on_path(torch, "6.7 implicit_diff backward", AD_KERNELS,
                lambda: torch.autograd.grad(drag, (nu, radius)))
    t2 = time.perf_counter()
    adjoint = list(ml_solve_implicit.adjoint_n)
    g = [float(v) for v in g]
    for label in ("6.7 implicit_diff forward", "6.7 implicit_diff backward"):
        ran = [k for k in AD_PLAIN if PATH_LAUNCHES[label][k]]
        if ran:
            raise AssertionError(f"{label} launched {ran} on tracked fields")
    log(f"  drag {float(drag.detach())!r}, d/dν, d/dradius = {g}; forward "
        f"{t1 - t0:.3f} s, backward {t2 - t1:.3f} s; pois_n {pois}, "
        f"adjoint {adjoint}")
    AD_RESULTS["implicit"] = {"drag": float(drag.detach()), "grad": g,
                              "pois_n": pois}
    del setup, drag

    stage("(i) against the gates shut, the CPU and FD")
    with gates_shut():
        _, g_plain, pois_plain = drag_grad(torch, dev, implicit_diff=True)
    e = rel_err(g, g_plain)
    log(f"  gates shut (every plain form on the card): {g_plain}, pois_n "
        f"{pois_plain}: relative difference {e:.3e}")
    if not e <= 1e-4:
        raise AssertionError(f"card vs plain forms: {g} vs {g_plain}")
    t0 = time.perf_counter()
    _, g_cpu, pois_cpu = drag_grad(torch, cpu, implicit_diff=True)
    e = rel_err(g, g_cpu)
    log(f"  CPU f32 ({time.perf_counter() - t0:.1f} s): {g_cpu}, pois_n "
        f"{pois_cpu}: relative difference {e:.3e}")
    if not (e <= 1e-3 and pois_ok(pois, pois_cpu)):
        raise AssertionError(f"card vs CPU: {g}, {pois} vs {g_cpu}, "
                             f"{pois_cpu}")

    def fd(which, h):
        vals = []
        for sgn in (1, -1):
            q = [AD_NU, AD_RADIUS]
            q[which] += sgn * h
            with torch.no_grad():
                vals.append(float(drag_steps(*drag_setup(
                    torch, dev, *ad_params(torch, dev, *q, grad=False),
                    implicit_diff=True))[0]))
        return (vals[0] - vals[1]) / (2 * h)

    for which, name in enumerate(("ν", "radius")):
        h = 1e-2 * (AD_NU, AD_RADIUS)[which]
        f1, f2 = fd(which, h), fd(which, h / 2)
        e = abs(g[which] - f1) / abs(f1)
        log(f"  d/d{name}: FD {f1!r} (h/2: {f2!r}, spread "
            f"{abs(f1 - f2) / abs(f1):.3e}), autograd {g[which]!r}: "
            f"relative difference {e:.3e}")
        if not e <= 5e-2:
            raise AssertionError(f"d/d{name}: autograd {g[which]} vs FD {f1}")

    stage("(i) the solves' tolerance (logged, no gate)")
    for tol in (1e-4, 1e-7):
        _, g_tol, pois_tol = drag_grad(torch, dev, implicit_diff=True,
                                       tol=tol, itmx=64)
        log(f"  tol {tol:g}, itmx 64: {g_tol}, pois_n {pois_tol}: relative "
            f"difference from tol {AD_TOL:g} {rel_err(g_tol, g):.3e}")

    stage("(ii) fixed_iters=2: reverse against torch.func.jvp")
    _, g_rev, _ = drag_grad(torch, dev, fixed_iters=2)
    jv = []
    for tangent in ((1.0, 0.0), (0.0, 1.0)):
        _, d = torch.func.jvp(
            lambda a, b: drag_steps(*drag_setup(torch, dev, a, b,
                                                fixed_iters=2))[0],
            ad_params(torch, dev, grad=False),
            ad_params(torch, dev, *tangent, grad=False))
        jv.append(float(d))
    e = rel_err(g_rev, jv)
    log(f"  reverse {g_rev}, jvp {jv}: relative difference {e:.3e}")
    if not e <= 1e-4:
        raise AssertionError(f"fixed_iters=2: reverse {g_rev} vs jvp {jv}")

    stage("(iii) the guard on the card")
    from waterlily_tpu_torch.kernels.check import inputs
    d = inputs(FINE, 0, dev)
    L = d["lev"].L.clone().requires_grad_()
    try:
        sk.mult3d(L, d["lev"].D, d["x"])
    except RuntimeError as err:
        log(f"  mult3d with a requires_grad L raises: {err}")
    else:
        raise AssertionError("mult3d launched on a requires_grad L")
    del d, L

    stage("(iv) the cost of a reverse pass")
    k = max(max(p) for p in pois)
    reverse_cost(torch, dev, "(96,64,64) implicit_diff", implicit_diff=True)
    AD_RESULTS["fixed_cost"] = dict(k=k, **reverse_cost(
        torch, dev, f"(96,64,64) fixed_iters={k}", fixed_iters=k))
    big_reverse_step(torch, dev)
    torch.cuda.empty_cache()


# the member-axis pcg_fused (phase 3, and its line in the kernels JSON):
# the ensemble sweep's fine level (grid form), its next level and a
# one-block 2D level, each with 1, 3 and 32 members, the operator shared
# and one a member
PCG_MEMBER_SHAPES = ((194, 130), (98, 66), (50, 34))
PCG_MEMBERS = (1, 3, 32)
MEMBERS_KEY = "pcg_fused (members)"
MEMBER_TIMES = {}     # shape -> time_members' row (phase 8)


def check_members(torch, dev):
    """Phase 3: `pcg_fused`'s member form (`pcg_members` and `pcg_fused`
    under `torch.func.vmap`) against `vmap` of the plain `poisson.pcg`,
    1e-5 absolute, member 1's zero residual exactly, each route launching
    once a member chunk."""
    from waterlily_tpu_torch.kernels.check import compare_members
    from waterlily_tpu_torch.ops.pcg_kernel import launch_chunks
    failures = []
    for S in PCG_MEMBER_SHAPES:
        for M in PCG_MEMBERS:
            for shared in (True, False):
                for row in compare_members(S, M, shared, 1, dev):
                    log(f"  {row['output']:<32} {str(S):<10} M={M:<3} "
                        f"{'shared' if shared else 'own   '} max|d|="
                        f"{row['max_abs_err']:.3e} launches "
                        f"{row['launches']} (chunks "
                        f"{row['expected_launches']}) "
                        f"{'ok' if row['ok'] else 'FAIL'}")
                    WORST[MEMBERS_KEY] = max(WORST.get(MEMBERS_KEY, 0.0),
                                             row["max_abs_err"])
                    if not row["ok"]:
                        failures.append(row)
        log(f"  {S}: 32 members in {launch_chunks(S, 32, dev)} launches")
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"member-axis pcg_fused failed: {failures}")


# the seven 3D stencils' member forms (phase 3, phase 8 and their rows
# in the kernels JSON): the dense slice's fine level and a ragged shape,
# each with 3 and 8 members, the operator (and dt, ν, BC values) shared and
# one a member
STENCIL_MEMBER_CASES = ((FINE, 3), (FINE, 8), (RAGGED, 3))
# ana_mult3d's member form (no operator to share): the banded sweep's two
# banded levels with 1, 3 and 8 members
ANA_MEMBER_CASES = ((FINE, 1), (FINE, 3), (FINE, 8), (PCG_LEVEL, 3),
                    (PCG_LEVEL, 8))
SWEEP_MEMBERS, SWEEP_STEPS = 8, 3
SWEEP_RADII = (7.0, 9.0)      # the radius sweeps' range
SWEEP_CPU = (0, 7)
SEVEN = ("mult3d", "increment3d", "conv_diff3d", "bc3d", "div3d",
         "project3d", "cfl3d")
# launches of the setup on the members' shared fields (flow_init's u and
# BCs; the ν sweep's one body) are one-field launches, once for all
SETUP_FORMS = ("bc3d", "conv_diff3d")
STENCIL_MEMBER_TIMES = {}    # name -> time_stencil_members' row (phase 8)


def members_key(name):
    return f"{name} (members)"


def check_stencil_members(torch, dev):
    """Phase 3: each member form of a 3D kernel (`torch.func.vmap` of its
    wrapper: the seven stencils, `ana_mult3d`, the six PCG-seam wrappers)
    and the composite `pcg_blocked` under `vmap` against `vmap` of its
    plain version at the kernel's tolerance and against each member's own
    launch exactly, one launch a call (`pcg_blocked` its sweeps' 12),
    every form (`kernels.check.stencil_member_variants`)."""
    from waterlily_tpu_torch.kernels.check import (STENCIL_MEMBERS,
                                                   MEMBER_COMPOSITES,
                                                   compare_stencil_members,
                                                   clear_inputs)
    failures = []
    for name in STENCIL_MEMBERS + MEMBER_COMPOSITES:
        ana = name == "ana_mult3d"
        for S, M in ANA_MEMBER_CASES if ana else STENCIL_MEMBER_CASES:
            for shared in (False,) if ana else (True, False):
                rows = compare_stencil_members(name, S, M, shared, 1, dev)
                worst = max(r["max_abs_err"] for r in rows)
                single = max(r["single_err"] for r in rows)
                bad = [r for r in rows if not r["ok"]]
                log(f"  {name:<18} {str(S):<13} M={M} "
                    f"{'shared' if shared else 'own   '} {len(rows):>2} "
                    f"outputs: max|d| vs vmap(plain) {worst:.3e}, vs the "
                    f"members' own launches {single:.3e}, launches a call "
                    f"{sorted({r['launches'] for r in rows})} "
                    f"{'FAIL' if bad else 'ok'}")
                WORST[members_key(name)] = max(
                    WORST.get(members_key(name), 0.0), worst)
                failures += bad
    clear_inputs()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"stencil member forms failed: {failures}")


def sweep_force(torch, kind, steps=SWEEP_STEPS, **ad):
    """Phase 6.7's sphere (`drag_setup`, `drag_steps`) as a pure function
    of the sweep's parameter: the radius (ν = AD_NU) or ν (radius
    AD_RADIUS), on the parameter's device; returns the drag and each
    step's pois_n, ``(steps, 2)``."""
    def force(v):
        nu, radius = (AD_NU, v) if kind == "radius" else (v, AD_RADIUS)
        drag, pois = drag_steps(*drag_setup(torch, v.device, nu, radius,
                                            **ad), steps)
        return drag, (torch.stack([torch.as_tensor(n, device=v.device)
                                   for n in pois]) if pois
                      else torch.zeros((0, 2), dtype=torch.int64,
                                       device=v.device))
    return force


def sweep_costs(torch, kind, vs, label, **cfg):
    """Busy and wall ms a step (the `SWEEP_STEPS`-step sweep less its
    setup and force alone), idle share and peak GiB of the adaptive sweep
    over ``vs`` (`FlowConfig` keywords ``cfg``) and of its first member
    alone, kept in `SWEEP_COSTS` under ``label``."""
    run = lambda steps, v: sweep_force(torch, kind, steps, **cfg)(v)
    rows = {}
    batched = lambda n: torch.func.vmap(lambda v: run(n, v))(vs)
    for who, call in (("ensemble", batched),
                      ("one member", lambda n: run(n, vs[0]))):
        call(SWEEP_STEPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        b5, w5 = _busy_wall(torch, lambda: call(SWEEP_STEPS))
        gib = torch.cuda.max_memory_allocated() / 2 ** 30
        b0, w0 = _busy_wall(torch, lambda: call(0))
        busy, wall = (b5 - b0) / SWEEP_STEPS, (w5 - w0) / SWEEP_STEPS
        rows[who] = (busy, wall, gib)
    (bm, wm, gm), (b1, w1, g1) = rows["ensemble"], rows["one member"]
    M = len(vs)
    log(f"  a step of the {label} sweep ({M} members, adaptive): "
        f"{wm:.3f} ms wall, {bm:.3f} ms busy, idle share "
        f"{1 - bm / wm:.4f}, peak {gm:.3f} GiB; one member: {w1:.3f} ms "
        f"wall, {b1:.3f} busy, idle {1 - b1 / w1:.4f}, peak {g1:.3f} GiB; "
        f"{M} x one member {M * w1:.3f} ms wall ({M * b1:.3f} busy) "
        f"(the {SWEEP_STEPS}-step sweep less its setup and force alone)")
    SWEEP_COSTS[label] = {"busy_ms": bm, "wall_ms": wm, "idle": 1 - bm / wm,
                          "peak_gib": gm, "one_busy_ms": b1,
                          "one_wall_ms": w1}


SWEEP_COSTS = {}


def run_sweeps(torch, dev):
    """Phase 6.8 (iv): the (96,64,64) sphere's drag under
    `torch.func.vmap` at FINE, 8 members: a radius sweep (each member its
    own body and operator) and a ν sweep (one body, the operator shared, ν
    a member's own), each held by `sweep_checks`."""
    for kind, lo, hi in (("radius",) + SWEEP_RADII, ("nu", 0.08, 0.32)):
        vs = torch.linspace(lo, hi, SWEEP_MEMBERS, device=dev)
        sweep_checks(torch, dev, kind, vs, f"(iv) {kind}")


def sweep_checks(torch, dev, kind, vs, tag, seam=(), perdir=()):
    """The checks of a `sweep_force` sweep of ``kind`` over ``vs``
    (logged under ``tag``; the pipe periodic along ``perdir``), on the
    seams ``poisson`` has set: with
    ``fixed_iters=2`` (3 steps) each of the seven stencils and of the
    ``seam`` kernels launches as often as one member alone (so no call
    took a plain form), the step's own fields' and the seam kernels' only
    in the member form (the seam kernels only at FINE), `pcg_fused` one
    member's launches times the chunks, the drag within 1e-5 of each
    member alone; with the adaptive solve (3 steps) each member's pois_n
    equals its own card run's and its drag within 1e-5, members 0 and 7
    against the CPU (drag 1e-4, pois_n ±2 a solve, ≤ 4 in all); then the
    sweep's cost a step (`SWEEP_COSTS[tag]`)."""
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    from waterlily_tpu_torch.ops.stencil_kernels import kernel_wrappers
    M = len(vs)
    cfg = {"perdir": perdir} if perdir else {}
    stage(f"{tag} sweep at {FINE} x {M}, fixed_iters=2, {SWEEP_STEPS} "
          f"steps{f', periodic along {perdir}' if perdir else ''}")
    fixed = sweep_force(torch, kind, fixed_iters=2, **cfg)
    one_label = f"6.8 {tag}: one member, fixed_iters=2"
    ens_label = f"6.8 {tag} sweep, fixed_iters=2"
    expect = SEVEN + ("pcg_fused",) + seam
    on_path(torch, one_label, expect if not seam else seam,
            lambda: fixed(vs[0]))
    one, one_forms = PATH_LAUNCHES[one_label], PATH_FORMS[one_label]
    single_pcg = dict(pk.pcg_fused.shapes)
    drag, _ = on_path(torch, ens_label, expect if not seam else seam,
                      lambda: torch.func.vmap(fixed)(vs))
    ens, forms = PATH_LAUNCHES[ens_label], PATH_FORMS[ens_label]
    members = MEMBER_COUNTS[ens_label]
    # a seam takes some of the seven off the path (STREAM: mult3d and
    # increment3d), in the ensemble as in one member; the blocked level's
    # smooth is pcg_blocked's two sweeps under every seam
    ran = [k for k in dict.fromkeys(SEVEN + SMOOTH + seam)
           if one[k] or ens[k]]
    bad = _stencil_launches(one, ens, one_forms, forms, members, ran)
    wrappers = kernel_wrappers()
    bad += [(k, dict(wrappers[k].shapes)) for k in seam
            if set(wrappers[k].shapes) != {FINE}]
    want = {S: n * pk.launch_chunks(S, M, dev)
            for S, n in single_pcg.items()}
    log(f"  one member {[(k, one[k]) for k in ran]}, the ensemble "
        f"{[(k, ens[k]) for k in ran]} launches, "
        f"{[(k, members.get(k, 0)) for k in ran]} of them in the member "
        f"form; forms {[sorted(map(str, forms[k])) for k in ran]}; "
        f"pcg_fused by shape {dict(pk.pcg_fused.shapes)} (one member's "
        f"times the chunks: {want})")
    if bad or dict(pk.pcg_fused.shapes) != want:
        raise AssertionError(f"{tag} sweep launches: {bad}, pcg_fused "
                             f"{dict(pk.pcg_fused.shapes)} vs {want}")
    alone = torch.stack([fixed(v)[0] for v in vs])
    err = rel_err(drag.tolist(), alone.tolist())
    log(f"  drag {drag.tolist()}; vs each member alone: max rel {err:.3e}")
    if not bool(torch.isfinite(drag).all()) or err > 1e-5:
        raise AssertionError(f"{tag} sweep vs members alone: {err}")
    PATH_LAUNCHES.pop(ens_label)    # the kernels line's member rows

    stage(f"{tag} sweep, the adaptive solve (tol {AD_TOL:g})")
    adapt = sweep_force(torch, kind, **cfg)
    drag, pois = torch.func.vmap(adapt)(vs)
    own = [adapt(v) for v in vs]
    err = rel_err(drag.tolist(), [float(d) for d, _ in own])
    same = all(torch.equal(pois[m], own[m][1]) for m in range(M))
    log(f"  pois_n a member {[p.tolist() for p in pois]}; equal to each "
        f"member's own card run: {same}; drag max rel {err:.3e}")
    if not same or err > 1e-5:
        raise AssertionError(f"{tag} adaptive sweep vs members alone: "
                             f"pois_n equal {same}, drag {err}")
    t0 = time.perf_counter()
    for m in SWEEP_CPU:
        d_cpu, p_cpu = adapt(vs[m].cpu())
        e = abs(float(drag[m]) - float(d_cpu)) / abs(float(d_cpu))
        log(f"  member {m} on the CPU: drag {float(d_cpu)!r} vs "
            f"{float(drag[m])!r} (rel {e:.3e}), pois_n {p_cpu.tolist()} vs "
            f"{pois[m].tolist()}")
        if e > 1e-4 or not pois_ok(pois[m].tolist(), p_cpu.tolist()):
            raise AssertionError(f"{tag} member {m} vs the CPU")
    log(f"  CPU runs {time.perf_counter() - t0:.1f} s")
    sweep_costs(torch, kind, vs, tag, **cfg)
    torch.cuda.empty_cache()


# phase 6.8 (vi): (iv)'s radius sweep under the blocked-level PCG
# configurations of phase 6.4: (name, seams set, plain `pcg` on the blocked
# levels, periodic axes, the `ops.attic` wrappers it routes the fine level
# through, in their member forms under vmap).  KDOT and KAXPY act in `pcg`,
# the smoother of periodic levels: (b)'s pipe is periodic in z; (c) holds
# the plain `pcg` against (iv)'s default `pcg_blocked`
SEAM_SWEEPS = (("b", {"KDOT": True, "KAXPY": True}, False, (2,),
                ("dot3d", "pcg_axpy")),
               ("c", {}, True, (), ()),
               ("g", {"STREAM": True}, False, (), STREAMS))
SEAM_MEMBERS = ("dot3d", "pcg_axpy", "pcg_dir_mult", "pcg_update") + STREAMS


def run_seam_sweeps(torch, dev):
    """Phase 6.8 (vi): (iv)'s radius sweep (FINE x 8) under (b) ``KDOT =
    KAXPY = True`` (the pipe periodic in z), (c) the plain `pcg` on the
    blocked levels and (g) ``STREAM``, each held by `sweep_checks` with its
    `ops.attic` kernels, (b) and (c) launching neither of `pcg_blocked`'s
    sweeps; then each one's cost a step against (iv)'s default-path
    radius sweep's."""
    vs = torch.linspace(*SWEEP_RADII, SWEEP_MEMBERS, device=dev)
    a = SWEEP_COSTS["(iv) radius"]
    for name, flags, plain, perdir, kernels in SEAM_SWEEPS:
        tag = f"(vi) ({name})"
        with seams(flags), plain_smoother(plain):
            log(f"{tag}: {flags}, plain pcg {plain}, perdir {perdir}")
            sweep_checks(torch, dev, "radius", vs, tag, kernels, perdir)
        ran = [k for k in SMOOTH
               if PATH_LAUNCHES[f"6.8 {tag}: one member, fixed_iters=2"][k]
               or MEMBER_COUNTS[f"6.8 {tag} sweep, fixed_iters=2"].get(k)]
        if ran and (plain or perdir):
            raise AssertionError(f"{tag} launched {ran}")
        c = SWEEP_COSTS[tag]
        log(f"  {tag} under vmap against (iv)'s default-path radius sweep "
            f"(a): busy {c['busy_ms']:.3f} vs {a['busy_ms']:.3f} ms a step "
            f"({c['busy_ms'] / a['busy_ms']:.3f}), wall {c['wall_ms']:.3f} "
            f"vs {a['wall_ms']:.3f} ({c['wall_ms'] / a['wall_ms']:.3f}) "
            f"(wall in one call only)")
        torch.cuda.empty_cache()


# phase 6.8 (v): the banded ensemble.  (a) 6.8 (iv)'s radius sweep with
# banded BDIM and banded levels (each member its own body window: at FINE
# the (98,66,66) and (50,34,34) levels are banded); (b) the 256³ sphere's
# geometry (sphere_3d(256, 256): 258³, centre 127, ν 0.64) swept over 4
# radii, 1 adaptive step; (c) vmap(jvp) of (a)'s adaptive drag in the
# radius
BANDED_RADII = (7.0, 9.0)
BIG_RADII = (28.0, 30.0, 32.0, 34.0)
BIG_NU, BIG_CENTRE, BIG_STEPS = 0.64, 127.0, 1
# (a)'s steps and (c)'s: (c) runs every pass but the solve's primal in the
# plain forms, ~6 s a member's own jvp of 2 steps on the H100
BANDED_STEPS, JVP_STEPS = 3, 1
BANDED_PATHS = ("6.8 (v) banded radius sweep, fixed_iters=2",
                "6.8 (v) banded 258^3 sweep")
BANDED_COSTS = {}


def sphere_body(torch, radius, centre):
    from waterlily_tpu_torch.body import AutoBody
    return AutoBody(lambda x, t: torch.sqrt(torch.sum((x - centre) ** 2))
                    - radius)


def banded_run(torch, S, nu, centre, box, steps, **cfg_kw):
    """The sphere at ``centre`` in the domain ``S`` as a pure function of
    its radius (a 0-d tensor on the card or the CPU): `measure_fields_banded`
    → `build_levels` with the window's corner → `flow_init` → ``steps``
    `mom_step`s → the drag, with banded BDIM and banded levels on the
    ``box`` window (``box`` None: dense); returns ``(drag, pois_n (steps,
    2), u, the banded levels' corners (n, 3))``."""
    from waterlily_tpu_torch.body import measure_fields, measure_fields_banded
    from waterlily_tpu_torch.flow import FlowConfig, flow_init, mom_step
    from waterlily_tpu_torch.metrics import total_force
    from waterlily_tpu_torch.ops.multigrid import build_levels
    f32 = torch.float32

    def run(v):
        dev = v.device
        body = sphere_body(torch, v, centre)
        cfg = FlowConfig(D=3, S=S, device=dev, nu=nu, U=(1.0, 0.0, 0.0),
                         dtype=f32, bbox_shape=box, **cfg_kw)
        state = flow_init(cfg)
        if box is None:
            V, m0, m1, _ = measure_fields(body, S, 0.0, 1.0, (), False, f32,
                                          dev)
            levels, start = build_levels(m0), None
        else:
            V, m0, m1, _, start = measure_fields_banded(
                body, S, 0.0, 1.0, (), False, f32, box, dev)
            levels = build_levels(m0, box_shape=box, box_start=start)
        state = state.replace(V=V, mu0=m0, mu1=m1, bbox=start)
        pois = []
        for _ in range(steps):
            state, aux = mom_step(cfg, levels, state)
            pois.append(torch.as_tensor(aux["pois_n"], device=dev))
        drag = total_force(state.u, state.p, cfg.nu, body, state.t)[0]
        return (drag, torch.stack(pois) if pois
                else torch.zeros((0, 2), dtype=torch.int64, device=dev),
                state.u,
                torch.stack([torch.as_tensor(lv.box_start, device=dev)
                             for lv in levels if lv.banded]
                            or [torch.zeros(3, dtype=torch.int64,
                                            device=dev)]))
    return run


def _static_box(torch, dev, S, radius, centre):
    from waterlily_tpu_torch.body import band_box_shape
    return band_box_shape(sphere_body(torch, radius, centre), S, 0.0, 1.0,
                          torch.float32, device=dev)


def _stencil_launches(one, ens, one_forms, forms, members, kernels,
                      shared=SETUP_FORMS):
    """(iv)'s rule on each of ``kernels``: the ensemble launches it as
    often as one member alone, in the member form (and, for the kernels
    in ``shared``, on the members' shared fields the one-field forms one
    member launched)."""
    bad = []
    for k in kernels:
        allowed = {"members"} | (one_forms.get(k, set())
                                 if k in shared else set())
        whole = k not in shared
        if (ens[k] != one[k] or "members" not in forms.get(k, set())
                or not forms[k] <= allowed
                or (whole and members.get(k, 0) != ens[k])):
            bad.append((k, one[k], ens[k], members.get(k, 0),
                        sorted(map(str, forms.get(k, set())))))
    return bad


def step_costs(torch, label, run, vs, steps):
    """Busy and wall ms a step (``steps`` steps less the setup and drag
    alone), idle share and peak GiB of ``run`` under `torch.func.vmap`
    over ``vs`` and of its first member alone."""
    rows = {}
    for who, call in (("ensemble", lambda n: torch.func.vmap(run(n))(vs)),
                      ("one member", lambda n: run(n)(vs[0]))):
        call(steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        b1, w1 = _busy_wall(torch, lambda: call(steps))
        gib = torch.cuda.max_memory_allocated() / 2 ** 30
        b0, w0 = _busy_wall(torch, lambda: call(0))
        rows[who] = ((b1 - b0) / steps, (w1 - w0) / steps, gib)
    (bm, wm, gm), (b1, w1, g1) = rows["ensemble"], rows["one member"]
    M = len(vs)
    log(f"  a step of {label} ({M} members): {wm:.3f} ms wall, {bm:.3f} ms "
        f"busy, idle share {1 - bm / wm:.4f}, peak {gm:.3f} GiB; one member: "
        f"{w1:.3f} ms wall, {b1:.3f} busy, idle {1 - b1 / w1:.4f}, peak "
        f"{g1:.3f} GiB; {M} x one member {M * w1:.3f} ms wall ({M * b1:.3f} "
        f"busy, {M * g1:.3f} GiB) ({steps} steps less the setup and drag "
        f"alone)")
    BANDED_COSTS[label] = {"busy_ms": bm, "wall_ms": wm, "idle": 1 - bm / wm,
                           "peak_gib": gm, "one_busy_ms": b1,
                           "one_wall_ms": w1, "one_peak_gib": g1}


def run_banded_sweeps(torch, dev):
    """Phase 6.8 (v): the banded ensemble, each member its own body window
    (`FlowState.bbox` and the banded levels' `box_start` device tensors
    under `torch.func.vmap`).  (a) The radius sweep at FINE x 8 with banded
    BDIM and banded levels: with ``fixed_iters=2`` `ana_mult3d` launches
    as often as one member alone, every launch in its member form but the
    first residual's on the members' shared warm start (the other kernels
    by (iv)'s rule), the drag within 1e-5 of each member
    alone; adaptive, each member's pois_n equal to its own card run's and
    the drag within 1e-5, the sweep against the dense one (pois_n within
    ±2/≤4, max|du| < 1e-3), members 0 and 7 against the CPU (drag 1e-4,
    pois_n ±2/≤4).  (b) 258³ x 4 radii, 1 adaptive step: each member's
    pois_n equal to its own card run's, drag within 1e-4 (the plain
    reductions' order); its cost a step
    against 4 x one member's.  (c) `vmap(jvp)` of (a)'s adaptive drag in
    the radius: each member's tangent and drag within 1e-4 of its own
    `jvp` on the card, pois_n equal; member 0 against the CPU (drag 1e-4,
    tangent 1e-3, pois_n ±2/≤4); its wall, busy and peak GiB."""
    box = _static_box(torch, dev, FINE, BANDED_RADII[1], AD_CENTRE)
    banded_sweep(torch, dev, box)
    banded_sweep_big(torch, dev)
    banded_jvp(torch, dev, box)


def banded_sweep(torch, dev, box):
    """Phase 6.8 (v) (a): the banded radius sweep at FINE x 8 on the
    ``box`` window."""
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    M = SWEEP_MEMBERS
    vs = torch.linspace(*BANDED_RADII, M, device=dev)
    stage(f"(v)(a) banded radius sweep at {FINE} x {M}, box {box}, "
          f"fixed_iters=2, {BANDED_STEPS} steps")
    fixed = banded_run(torch, FINE, AD_NU, AD_CENTRE, box, BANDED_STEPS,
                       tol=AD_TOL, fixed_iters=2)
    one_label = "6.8 (v) banded, one member, fixed_iters=2"
    on_path(torch, one_label, BANDED_LEVELS, lambda: fixed(vs[0]))
    one, one_forms = PATH_LAUNCHES[one_label], PATH_FORMS[one_label]
    single_pcg = dict(pk.pcg_fused.shapes)
    drag, _p, _u, corners = on_path(torch, BANDED_PATHS[0], BANDED_LEVELS,
                                    lambda: torch.func.vmap(fixed)(vs))
    ens, forms = PATH_LAUNCHES[BANDED_PATHS[0]], PATH_FORMS[BANDED_PATHS[0]]
    members = MEMBER_COUNTS[BANDED_PATHS[0]]
    # the first residual's A·x is of the warm start p·dt, which every
    # member shares before the first solve (p = 0): one one-field launch
    bad = _stencil_launches(one, ens, one_forms, forms, members,
                            ("ana_mult3d", "cfl3d", "bc3d", "conv_diff3d"),
                            SETUP_FORMS + ("ana_mult3d",))
    if ens["ana_mult3d"] - members.get("ana_mult3d", 0) > 1:
        bad.append(("ana_mult3d one-field launches",
                    ens["ana_mult3d"] - members.get("ana_mult3d", 0)))
    want = {S: n * pk.launch_chunks(S, M, dev)
            for S, n in single_pcg.items()}
    log(f"  banded levels' corners a member {corners.tolist()}")
    log(f"  ana_mult3d: one member {one['ana_mult3d']}, the ensemble "
        f"{ens['ana_mult3d']} launches ({members.get('ana_mult3d', 0)} in "
        f"the member form) by shape {dict(sk.ana_mult3d.shapes)}; pcg_fused "
        f"{dict(pk.pcg_fused.shapes)} (one member's times the chunks: "
        f"{want})")
    # radii 7 to 9 move the band's edge by two cells: the members' windows
    # sit at a few distinct corners
    distinct = [len({tuple(c) for c in corners[:, lv].tolist()})
                for lv in range(corners.shape[1])]
    log(f"  distinct corners on each banded level: {distinct}")
    if bad or dict(pk.pcg_fused.shapes) != want or len(distinct) < 2 \
            or distinct[0] < 2:
        raise AssertionError(f"banded sweep launches: {bad}, pcg_fused "
                             f"{dict(pk.pcg_fused.shapes)} vs {want}, "
                             f"corners {corners.tolist()}")
    alone = torch.stack([fixed(v)[0] for v in vs])
    err = rel_err(drag.tolist(), alone.tolist())
    log(f"  drag {drag.tolist()}; vs each member alone: max rel {err:.3e}")
    if not bool(torch.isfinite(drag).all()) or err > 1e-5:
        raise AssertionError(f"banded sweep vs members alone: {err}")
    PATH_LAUNCHES.pop(BANDED_PATHS[0])    # the kernels line's member rows

    stage(f"(v)(a) the adaptive solve (tol {AD_TOL:g}): against each "
          f"member, the dense sweep and the CPU")
    adapt = banded_run(torch, FINE, AD_NU, AD_CENTRE, box, BANDED_STEPS,
                       tol=AD_TOL)
    drag, pois, u, _c = torch.func.vmap(adapt)(vs)
    own = [adapt(v) for v in vs]
    err = rel_err(drag.tolist(), [float(o[0]) for o in own])
    same = all(torch.equal(pois[m], own[m][1]) for m in range(M))
    log(f"  pois_n a member {[p.tolist() for p in pois]}; equal to each "
        f"member's own card run: {same}; drag max rel {err:.3e}")
    if not same or err > 1e-5:
        raise AssertionError(f"banded adaptive sweep vs members alone: "
                             f"pois_n equal {same}, drag {err}")
    dense = banded_run(torch, FINE, AD_NU, AD_CENTRE, None, BANDED_STEPS,
                       tol=AD_TOL)
    ddrag, dpois, du, _c = torch.func.vmap(dense)(vs)
    du_max = float((u - du).abs().max())
    pois_dense = all(pois_ok(pois[m].tolist(), dpois[m].tolist())
                     for m in range(M))
    log(f"  vs the dense sweep (bbox off): pois_n {[p.tolist() for p in dpois]}"
        f" ({pois_dense} under the ±2/≤4 rule), max|du| {du_max:.3e}, drag "
        f"max rel {rel_err(drag.tolist(), ddrag.tolist()):.3e}")
    if not pois_dense or not du_max < 1e-3:
        raise AssertionError("banded sweep differs from the dense sweep")
    t0 = time.perf_counter()
    for m in SWEEP_CPU:
        d_cpu, p_cpu, _u, _c = adapt(vs[m].cpu())
        e = abs(float(drag[m]) - float(d_cpu)) / abs(float(d_cpu))
        log(f"  member {m} on the CPU: drag {float(d_cpu)!r} vs "
            f"{float(drag[m])!r} (rel {e:.3e}), pois_n {p_cpu.tolist()} vs "
            f"{pois[m].tolist()}")
        if e > 1e-4 or not pois_ok(pois[m].tolist(), p_cpu.tolist()):
            raise AssertionError(f"banded member {m} vs the CPU")
    log(f"  CPU runs {time.perf_counter() - t0:.1f} s")
    step_costs(torch, "the banded radius sweep (adaptive)",
               lambda n: banded_run(torch, FINE, AD_NU, AD_CENTRE, box, n,
                                    tol=AD_TOL), vs, BANDED_STEPS)
    del u, du, own
    torch.cuda.empty_cache()


def banded_sweep_big(torch, dev):
    """Phase 6.8 (v) (b): the 256³ sphere's geometry over `BIG_RADII`."""
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    big_vs = torch.tensor(BIG_RADII, device=dev)
    big_box = _static_box(torch, dev, BIG, BIG_RADII[-1], BIG_CENTRE)
    stage(f"(v)(b) the 256³ sphere's geometry, {len(BIG_RADII)} radii "
          f"{BIG_RADII}, box {big_box}, {BIG_STEPS} adaptive steps")
    big = lambda n: banded_run(torch, BIG, BIG_NU, BIG_CENTRE, big_box, n)
    drag, pois, _u, corners = on_path(
        torch, BANDED_PATHS[1], BANDED_LEVELS,
        lambda: torch.func.vmap(big(BIG_STEPS))(big_vs))
    del _u
    log(f"  banded levels' corners a member {corners.tolist()}; ana_mult3d "
        f"member-form launches {MEMBER_COUNTS[BANDED_PATHS[1]].get('ana_mult3d', 0)}"
        f" by shape {dict(sk.ana_mult3d.shapes)}")
    PATH_LAUNCHES.pop(BANDED_PATHS[1])
    own = [big(BIG_STEPS)(v)[:2] for v in big_vs]
    err = rel_err(drag.tolist(), [float(o[0]) for o in own])
    same = all(torch.equal(pois[m], own[m][1]) for m in range(len(own)))
    log(f"  pois_n a member {[p.tolist() for p in pois]}; equal to each "
        f"member's own card run: {same}; drag {drag.tolist()}, max rel "
        f"{err:.3e}")
    distinct = [len({tuple(c) for c in corners[:, lv].tolist()})
                for lv in range(corners.shape[1])]
    log(f"  distinct corners on each banded level: {distinct}")
    # each member's kernels are its own launches bit for bit, but the plain
    # reductions (the PCG dots, the residual's mean, the force) sum a
    # batched field in another order than a single one: at 258³ after 2
    # steps that moved the drag by 1.5e-5 on an H100 80GB HBM3 at 700 W,
    # against 3.6e-7 at FINE (PERF.md §6), so the drag is held at the f32
    # gate of a reordered run
    if len(distinct) < 3 or distinct[0] < len(BIG_RADII) or not same \
            or err > 1e-4 or not bool(torch.isfinite(drag).all()):
        raise AssertionError(f"258^3 banded sweep vs members alone: pois_n "
                             f"equal {same}, drag {err}, corners "
                             f"{corners.tolist()}")
    del own
    torch.cuda.empty_cache()
    step_costs(torch, "the banded 258^3 sweep", big, big_vs, BIG_STEPS)
    torch.cuda.empty_cache()


def banded_jvp(torch, dev, box):
    """Phase 6.8 (v) (c): `vmap(jvp)` of (a)'s adaptive drag in the
    radius on the ``box`` window."""
    M = SWEEP_MEMBERS
    vs = torch.linspace(*BANDED_RADII, M, device=dev)
    stage(f"(v)(c) vmap(jvp) of the banded adaptive drag in the radius, "
          f"{FINE} x {M}, {JVP_STEPS} steps")
    base = banded_run(torch, FINE, AD_NU, AD_CENTRE, box, JVP_STEPS,
                      tol=AD_TOL)
    jvp = lambda r: torch.func.jvp(lambda v: base(v)[:2], (r,),
                                   (torch.ones_like(r),), has_aux=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p, d, pois = torch.func.vmap(jvp)(vs)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    gib = torch.cuda.max_memory_allocated() / 2 ** 30
    own = [jvp(v) for v in vs]
    terr = rel_err(d.tolist(), [float(o[1]) for o in own])
    perr = rel_err(p.tolist(), [float(o[0]) for o in own])
    same = all(torch.equal(pois[m], own[m][2]) for m in range(M))
    log(f"  d(drag)/d(radius) {d.tolist()}; vs each member's own jvp: max "
        f"rel {terr:.3e} (drag {perr:.3e}), pois_n equal {same} "
        f"{[q.tolist() for q in pois]}")
    # both take the plain forms; the batched plain reductions sum in
    # another order (the drag moved by 1.0e-5 at 2 steps, PERF.md §6)
    if not same or terr > 1e-4 or perr > 1e-4 \
            or not bool(torch.isfinite(d).all()):
        raise AssertionError(f"vmap(jvp) vs each member: tangent {terr}, "
                             f"drag {perr}, pois_n equal {same}")
    t0 = time.perf_counter()
    pc, dc, qc = jvp(vs[0].cpu())
    e_p = abs(float(p[0]) - float(pc)) / abs(float(pc))
    e_d = abs(float(d[0]) - float(dc)) / abs(float(dc))
    log(f"  member 0 on the CPU ({time.perf_counter() - t0:.1f} s): drag "
        f"rel {e_p:.3e}, tangent {float(dc)!r} vs {float(d[0])!r} (rel "
        f"{e_d:.3e}), pois_n {qc.tolist()} vs {pois[0].tolist()}")
    if e_p > 1e-4 or e_d > 1e-3 or not pois_ok(pois[0].tolist(),
                                                qc.tolist()):
        raise AssertionError("vmap(jvp) member 0 vs the CPU")
    busy, wall = _busy_wall(torch, lambda: torch.func.vmap(jvp)(vs))
    log(f"  vmap(jvp) of {M} members, {JVP_STEPS} steps with their setup and "
        f"drag: {wall:.1f} ms wall ({first * 1e3:.1f} the first call), "
        f"{busy:.1f} ms busy, idle share {1 - busy / wall:.4f}, peak "
        f"{gib:.3f} GiB")
    BANDED_COSTS["vmap(jvp)"] = {"busy_ms": busy, "wall_ms": wall,
                                 "peak_gib": gib}
    torch.cuda.empty_cache()


def timing_stencil_members(torch, dev):
    """Phase 8: each 3D kernel's member form at FINE x 8 (an operator,
    step, ν, BC values and PCG scalars a member) against `vmap` of its
    plain version, beside 8 times the one-field bound (and `dot3d`'s
    beside one batched `torch.linalg.vecdot`)."""
    from waterlily_tpu_torch.kernels.check import (STENCIL_MEMBERS,
                                                   time_stencil_members)
    for name in STENCIL_MEMBERS:
        t = time_stencil_members(name, FINE, SWEEP_MEMBERS, dev)
        STENCIL_MEMBER_TIMES[name] = t
        lib = t.get("library_ms")
        log(f"  {name:<18} {str(FINE)} x {SWEEP_MEMBERS} members: kernel "
            f"{t['ms']:.4f} ms, plain vmap {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})"
            + (f", library call {lib:.4f} ms" if lib is not None else "")
            + f"; wall per call {t['wall_ms']:.4f} ms")
        torch.cuda.empty_cache()


# phase 6.8: the ensemble sweep of examples/ensemble_sweep.py at the size
# the JAX example names for a chip: Dm = 32 (S = (194, 130)), 32 members,
# 20 fixed_iters=2 steps; members held against their own card runs and
# three against the CPU; and vmap(grad) through implicit_diff
ENS_DM, ENS_MEMBERS, ENS_STEPS = 32, 32, 5
ENS_CPU = (0, 15, 31)
ENS_PATHS = ("6.8 ensemble sweep", "6.8 vmap(implicit_diff) forward",
             "6.8 vmap(grad(implicit_diff))")


def _busy_wall(torch, fn):
    """Device busy ms (`utils.perf.device_profile`) and wall ms (CUDA
    events, after it) of one call of ``fn``."""
    from waterlily_tpu_torch.utils.perf import device_profile
    busy = device_profile(fn, 1, events=True)[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return busy, start.elapsed_time(end)


def ens_ke(torch, dev, L=128, tol=1e-5):
    """The kinetic energy after one implicit_diff step of the periodic
    Taylor-Green vortex on (L+2)², f32 on ``dev``, as a function of ν
    (the twin of tests/test_ensemble.py's ``ke_after``)."""
    from waterlily_tpu_torch.flow import FlowConfig, flow_init, mom_step
    from waterlily_tpu_torch.metrics import ke
    from waterlily_tpu_torch.ops.multigrid import build_levels
    kappa = 2 * math.pi / L

    def ulam(i, x):
        if i == 0:
            return -torch.sin(kappa * x[0]) * torch.cos(kappa * x[1])
        return torch.cos(kappa * x[0]) * torch.sin(kappa * x[1])

    def ke_after(nu):
        cfg = FlowConfig(D=2, S=(L + 2, L + 2), device=dev, nu=nu,
                         U=(0.0, 0.0), perdir=(0, 1), dtype=torch.float32,
                         tol=tol, itmx=32, implicit_diff=True)
        state = flow_init(cfg, ulam)
        levels = build_levels(state.mu0, cfg.perdir)
        state, _aux = mom_step(cfg, levels, state)
        return torch.sum(ke(state.u))
    return ke_after


def run_ensemble(torch, dev):
    """Phase 6.8: (i) the sweep under `torch.func.vmap` against each
    member's own card run (1e-5 relative) and three members' CPU runs
    (1e-4), its `pcg_fused` launches those of one member times the member
    chunks, all of the member form; (ii) its ms per step against 32 times
    one member's, busy, idle share and peak memory; (iii) `vmap(grad)`
    through implicit_diff, the member form launched in the forward and
    the adjoint solves, against the per-member card gradients (1e-4)."""
    from waterlily_tpu_torch.examples.ensemble_sweep import make_force_fn
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    from waterlily_tpu_torch.ops.multigrid import ml_solve_implicit
    cpu = torch.device("cpu")
    xis = torch.linspace(0.5, 4.0, ENS_MEMBERS, device=dev)
    force = make_force_fn(Dm=ENS_DM, n_steps=ENS_STEPS, device=dev)
    sweep = lambda: torch.func.vmap(force)(xis)

    stage(f"(i) Dm={ENS_DM}, {ENS_MEMBERS} members, {ENS_STEPS} steps")
    on_path(torch, "6.8 one member alone", ("pcg_fused",),
            lambda: force(xis[0]))
    single = dict(pk.pcg_fused.shapes)
    torch.cuda.reset_peak_memory_stats()
    coeffs = on_path(torch, ENS_PATHS[0], ("pcg_fused",), sweep)
    gib = torch.cuda.max_memory_allocated() / 2 ** 30
    batched, forms = dict(pk.pcg_fused.shapes), set(pk.pcg_fused.forms)
    want = {S: n * pk.launch_chunks(S, ENS_MEMBERS, dev)
            for S, n in single.items()}
    log(f"  pcg_fused launches by shape: one member {single}, the "
        f"ensemble {batched} (one member's times its member chunks: "
        f"{want}); forms {sorted(forms)}")
    if batched != want or forms != {"members"}:
        raise AssertionError(f"ensemble pcg_fused launches {batched} "
                             f"(forms {forms}), expected {want}")
    alone = torch.stack([force(x) for x in xis])
    err = rel_err(coeffs.flatten().tolist(), alone.flatten().tolist())
    log(f"  (Cd, Cl) xi {float(xis[0]):.2f}: {coeffs[0].tolist()}, xi "
        f"{float(xis[-1]):.2f}: {coeffs[-1].tolist()}; vs each member "
        f"alone on the card: max rel {err:.3e}")
    if not bool(torch.isfinite(coeffs).all()) or err > 1e-5:
        raise AssertionError(f"ensemble vs members alone: {err}")
    cforce = make_force_fn(Dm=ENS_DM, n_steps=ENS_STEPS, device=cpu)
    t0 = time.perf_counter()
    cerr = max(rel_err(coeffs[i].tolist(), cforce(xis[i].cpu()).tolist())
               for i in ENS_CPU)
    log(f"  members {ENS_CPU} on the CPU ({time.perf_counter() - t0:.1f} "
        f"s): max rel {cerr:.3e}")
    if cerr > 1e-4:
        raise AssertionError(f"ensemble vs CPU: {cerr}")
    if not abs(float(coeffs[-1, 1])) > abs(float(coeffs[0, 1])):
        raise AssertionError(f"|Cl| does not grow with xi: {coeffs}")

    stage("(ii) time per ensemble step")
    busy, wall = _busy_wall(torch, sweep)
    busy1, wall1 = _busy_wall(torch, lambda: force(xis[0]))
    n = ENS_STEPS
    log(f"  ensemble of {ENS_MEMBERS}: {wall / n:.3f} ms/step wall, "
        f"{busy / n:.3f} ms/step busy, idle share {1 - busy / wall:.4f}, "
        f"peak {gib:.2f} GiB; one member: {wall1 / n:.3f} ms/step wall "
        f"({busy1 / n:.3f} busy), {ENS_MEMBERS} x one member "
        f"{ENS_MEMBERS * wall1 / n:.3f} ms/step wall "
        f"({ENS_MEMBERS * busy1 / n:.3f} busy) (measurement, {n} steps and "
        f"their forces, per step)")

    stage("(iii) vmap(grad) through implicit_diff, 4 members, (130, 130)")
    ke_after = ens_ke(torch, dev)
    nus = torch.tensor([0.005, 0.01, 0.02, 0.04], device=dev)
    on_path(torch, ENS_PATHS[1], ("pcg_fused",),
            lambda: torch.func.vmap(ke_after)(nus))
    fwd = pk.pcg_fused.launches
    ml_solve_implicit.adjoint_n.clear()
    gb = on_path(torch, ENS_PATHS[2], ("pcg_fused",),
                 lambda: torch.func.vmap(torch.func.grad(ke_after))(nus))
    both, adjoint = pk.pcg_fused.launches, list(ml_solve_implicit.adjoint_n)
    if (pk.pcg_fused.forms != {"members"} or both <= fwd
            or not all(len(a) == len(nus) for a in adjoint)):
        raise AssertionError(f"implicit_diff under vmap: launches {fwd} "
                             f"forward, {both} with the adjoint, forms "
                             f"{pk.pcg_fused.forms}, adjoint_n {adjoint}")
    gs = torch.stack([torch.func.grad(ke_after)(nu) for nu in nus])
    gerr = rel_err(gb.tolist(), gs.tolist())
    log(f"  dKE/dν {gb.tolist()}, per member {gs.tolist()}: max rel "
        f"{gerr:.3e}; pcg_fused launches forward {fwd}, forward and "
        f"adjoint {both}; adjoint counts {adjoint}")
    if not bool(torch.isfinite(gb).all()) or gerr > 1e-4:
        raise AssertionError(f"vmap(grad) vs per member: {gerr}")
    for label in ENS_PATHS:
        PATH_LAUNCHES.pop(label)    # the kernels line's member rows
    torch.cuda.empty_cache()


def timing_members(torch, dev):
    """Phase 8: the member form at the sweep's two finest levels, 32
    members with an operator each, against `vmap` of the plain version;
    its sync floor: the chunks' launches times the smooth's 12 grid
    barriers at the chunk's block count (kernels/times.py ``barrier:``)."""
    from waterlily_tpu_torch.kernels.check import (time_members,
                                                   member_bound_ms)
    from waterlily_tpu_torch.kernels.times import _barrier
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    for S in PCG_MEMBER_SHAPES[:2]:
        t = time_members(S, ENS_MEMBERS, dev)
        t["bound_ms"], t["bound_by"] = member_bound_ms(S, ENS_MEMBERS)
        blocks = pk.pcg_grid(math.prod(S),
                             lambda k: pk._coresident(dev.index or 0,
                                                      len(S), k))[0]
        chunks = pk.launch_chunks(S, ENS_MEMBERS, dev)
        per = -(-ENS_MEMBERS // chunks)
        b = _barrier(f"barrier:{blocks * per}", dev)
        t["sync_floor_ms"] = chunks * (b["launch_ms"] + 12 * b["barrier_ms"])
        MEMBER_TIMES[S] = t
        log(f"  pcg_fused    {str(S):<10} x {ENS_MEMBERS} members, "
            f"{chunks} launches of {per} members x {blocks} blocks: kernel "
            f"{t['ms']:.4f} ms, plain vmap(pcg) {t['plain_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), sync floor "
            f"{t['sync_floor_ms']:.4f} ms ({b['barrier_ms'] * 1e3:.2f} us "
            f"a barrier of {blocks * per} blocks, {b['launch_ms'] * 1e3:.2f}"
            f" us a launch); wall per call {t['wall_ms']:.4f} ms")
    torch.cuda.empty_cache()


# phase 6.6 (iii): two spheres' union minus a third, in the (96,64,64)
# domain of the dense slice
CSG_SPHERES = (((31.0, 31.0, 31.0), 8.0), ((41.0, 31.0, 31.0), 6.0),
               ((36.0, 31.0, 35.0), 4.0))
CSG_RMAX = 8.0


def csg_sim(torch):
    """``make(device)``: the CSG body's `Simulation` on ``device``."""
    import waterlily_tpu_torch as wt

    def sphere(c, r, device):
        c = torch.tensor(c, device=device)
        return wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - c) ** 2))
                           - r)

    def make(device):
        s = [sphere(c, r, device) for c, r in CSG_SPHERES]
        return wt.Simulation((96, 64, 64), (1, 0, 0), 16.0, nu=16.0 / 100,
                             body=(s[0] + s[1]) - s[2], device=device)
    return make


def timing_recording(torch, dev):
    """Phase 8's lines of the recording path: each metric's wall time
    (its band measure included) at (96,64,64) and 258³, the 256³
    sphere's Cd in the extrapolated and the centre sampling, run_record's
    cost per sample, and checkpoint save and restart seconds."""
    import tempfile
    import waterlily_tpu_torch as wt
    from waterlily_tpu_torch import metrics as m, io

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    for n, big in (((96, 64), False), ((256, 256), True)):
        sim = wt.sphere_3d(*n, device=dev)
        sim.steps(3, remeasure=False)
        u, p, b, nu, t = sim.flow.u, sim.flow.p, sim.body, sim.cfg.nu, \
            sim.time
        S = tuple(p.shape)
        x0 = (0.0,) * 3
        calls = {"lambda2": lambda: m.lambda2(u),
                 "omega_mag": lambda: m.omega_mag(u),
                 "nds (band measure)": lambda: m.nds(b, S, t, u.dtype, dev),
                 "pressure_moment": lambda: m.pressure_moment(x0, p, b, t),
                 **{f"total_force {s}": (lambda s=s: m.total_force(
                     u, p, nu, b, t, s)) for s in SAMPLINGS}}
        if not big:
            calls.update({"ke": lambda: m.ke(u),
                          "curl": lambda: m.curl(0, u),
                          "omega_theta": lambda: m.omega_theta(
                              u, (1, 0, 0), (31.0, 31.0, 31.0)),
                          **{f"pressure_force {s}": (lambda s=s:
                              m.pressure_force(p, b, t, s))
                             for s in SAMPLINGS},
                          **{f"viscous_force {s}": (lambda s=s:
                              m.viscous_force(u, nu, b, t, s))
                             for s in SAMPLINGS}})
        got = {}
        for name, fn in calls.items():
            fn()                                  # warm-up
            sec, got[name] = wall(fn)
            log(f"  {name:<24} at {S}: {sec * 1e3:.3f} ms wall")
        if big:
            area = math.pi * (sim.L / 2) ** 2
            cd = {s: -2 * float(got[f"total_force {s}"][0])
                  / (sim.U ** 2 * area) for s in SAMPLINGS}
            log(f"sphere_3d(256, 256) after 3 steps (tU/L "
                f"{sim.sim_time:.4f}, the impulsive start, not a settled "
                f"drag): Cd extrap {cd['extrap']:.6f}, center "
                f"{cd['center']:.6f}, surface {cd['surface']:.6f}")
        del sim, u, p, calls, got
        torch.cuda.empty_cache()

    sim = wt.sphere_3d(96, 64, device=dev, log=True)
    sim.steps(3, remeasure=False)
    flow, levels = sim.flow, sim.levels
    hist = (list(sim.dts), list(sim.pois_n), list(sim.res_log))
    t_end = sim.sim_time + RECORD_SPAN
    fields = record_fields(torch)
    rows = {"run_record, no fields": [], "steps": [],
            "run_record, fields": []}
    for label in list(rows) * 3:          # three rounds, in turns
        sim.flow, sim.levels = flow, levels
        sim.dts, sim.pois_n, sim.res_log = (list(h) for h in hist)
        if label == "steps":
            sec, _ = wall(lambda: sim.steps(n_steps, remeasure=False))
        else:
            sec, rec = wall(lambda: sim.run_record(
                t_end, every=0.05, remeasure=False,
                fields=fields if label == "run_record, fields" else {}))
            n_steps = len(sim.pois_n) - len(hist[1])
            n_samples = len(rec["t"])
        rows[label].append(sec)
    for label, secs in rows.items():
        log(f"  {label:<22} {n_steps} steps of sphere_3d(96, 64, log=True):"
            f" {', '.join(f'{v:.4f}' for v in secs)} s wall")
    lo = {k: min(v) for k, v in rows.items()}
    spread = max(max(v) - min(v) for v in rows.values())
    log(f"run_record a sample ({n_samples} samples, {n_steps} steps; the "
        f"least of 3 runs each): stepping loop "
        f"{(lo['run_record, no fields'] - lo['steps']) / n_samples * 1e3:.3f}"
        f" ms beside plain steps, the fields (3 forces, moment, |omega|, "
        f"lambda2) "
        f"{(lo['run_record, fields'] - lo['run_record, no fields']) / n_samples * 1e3:.3f}"
        f" ms; the runs of one kind spread by up to "
        f"{spread / n_samples * 1e3:.3f} ms a sample")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    f = os.path.join(tmp, "ckpt.npz")
    for _ in range(2):
        save, _ = wall(lambda: io.save_checkpoint(f, sim))
        fresh = wt.sphere_3d(96, 64, device=dev, log=True)
        rest, _ = wall(lambda: io.restart_sim(fresh, f))
        log(f"checkpoint of sphere_3d(96, 64): save {save:.4f} s, restart "
            f"{rest:.4f} s ({os.path.getsize(f) / 2**20:.1f} MiB)")
    shutil.rmtree(tmp)
    del sim, fresh
    torch.cuda.empty_cache()


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
    return r


def report_steps(torch, sim, label, n, warmup, remeasure=False):
    from waterlily_tpu_torch.utils.perf import time_steps
    r = time_steps(sim, n, warmup=warmup, remeasure=remeasure)
    if not bool(torch.isfinite(sim.flow.u).all()):
        raise AssertionError(f"non-finite u: {label}")
    log(f"{label}: {r['sec_per_step'] * 1e3:.3f} ms/step, "
        f"{r['mlups']:.1f} MLUPS, {r['ns_per_dof']:.3f} ns/DOF "
        f"({n} steps after {warmup} warm-up; pois_n last "
        f"{sim.pois_n[-3:]})")
    return r


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
    ("conv_diff3d", BIG, "quick_p012"), ("conv_diff3d", BIG, "minmod"),
    ("pcg_fused", (34, 34, 34), "x_p012"), ("pcg_fused", (98, 66), "x"),
    ("pcg_fused", (66, 66), "x_p01"),
    ("mult3d", BIG, "z_bf16"), ("increment3d", BIG, "x_bf16"),
    ("pcg_update", BIG, "x_bf16"),
    ("pcg_axpy", BIG, "x_bf16"), ("dot3d", BIG, "ab"), ("dot3d", BIG, "rid"),
) + tuple((name, S, form) for S in (BIG, FINE) for name, form in (
    ("mult3d", "z_L16"), ("increment3d", "x_L16"), ("pcg_update", "x_iD16"),
    ("pcg_axpy", "x_iD16"), ("dot3d", "rid_iD16"),
    ("mult3d_stream", "z_nodot"), ("mult3d_stream", "z_L16"),
    ("mult3d_stream", "z_nodot_L16"), ("increment3d_stream", "x_L16")))
PROBES = ("copy_probe", "roll_probe")
PROBE_LAUNCHES = {}   # the probes' launches in phase 8 (on no path)


# phase 8's repeat counts: each kernel pair's timed calls, the steps each
# 256³ configuration is timed over and profiled over, the steps, warm-up
# steps and profiled steps of the (96,64,64) sphere and the 2D cases, and
# the circle's horizon in tU/L (cut from 20 and 10 when phase 6.10 was
# added; when phase 6.8 (vi) was, from 5, 5, (50, 10, 20) and 50, to keep
# the run within its limit)
PAIR_CALLS = 10
STEPS_256, PROFILE_256 = 3, 3
STEPS_SMALL, WARM_SMALL, PROFILE_SMALL = 20, 5, 10
CIRCLE_T = 20.0
# tU/L that phase 8 times `run_record` over (39 steps of the (96,64,64)
# sphere at 1.0, before phase 6.8 (vi) was added)
RECORD_SPAN = 0.5


def timing(torch, dev, sim):
    from waterlily_tpu_torch import sphere_3d, heaving_sphere_3d
    from waterlily_tpu_torch.kernels import probes
    from waterlily_tpu_torch.kernels.check import (KERNELS, LIBRARY, time_pair,
                                                   time_library, bound_ms,
                                                   clear_inputs)
    from waterlily_tpu_torch.ops.pcg_kernel import pcg_grid

    for w in probes.kernel_wrappers().values():
        w.launches = 0
    report_steps(torch, sim, "sphere_3d(96, 64)", STEPS_SMALL, WARM_SMALL)
    step_profile(sim, PROFILE_SMALL, "sphere_3d(96, 64)")
    # each kernel at the dense slice's shape, then at the largest shape a
    # path launched it at (the kernels line's shape; 258³ for the probes)
    stage("kernels and forms against their plain versions")
    # (kernel, shape, variant) -> its time_pair row: a form timed once
    times, rows, done = {}, [], {}
    for name in KERNELS:
        largest = max(PATH_SHAPES.get(name) or {BIG}, key=math.prod)
        for S in dict.fromkeys((PCG_LEVEL if name == "pcg_fused" else FINE,
                                largest)):
            t = time_pair(name, S, dev, n=PAIR_CALLS)
            done[name, S, 0] = t
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
        t = time_pair(name, S, dev, variant=variant, n=PAIR_CALLS)
        done[name, S, variant] = t
        b, by = bound_ms(name, S, variant)
        log(f"  {name:<12} {str(S):<15} form {variant}, device "
            f"(profiler): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, bound {b:.4f} ms ({by}); wall per call: kernel "
            f"{t['wall_ms']:.4f} ms, plain {t['plain_wall_ms']:.4f} ms")
        rows.append((name, S, variant, t["ms"]))
        torch.cuda.empty_cache()
    # pcg_fused at every shape a path launched it at (walls; the timed
    # forms above hold the periodic ones)
    for S in sorted(PATH_SHAPES.get("pcg_fused", ()),
                    key=lambda S: (len(S), -math.prod(S))):
        t = time_pair("pcg_fused", S, dev, n=PAIR_CALLS)
        b, by = bound_ms("pcg_fused", S)
        form = "one block" if pcg_grid(math.prod(S))[0] == 1 else "grid"
        log(f"  pcg_fused    {str(S):<15} {form:<9} device (profiler): "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{b:.4f} ms ({by}); wall per call: kernel {t['wall_ms']:.4f} "
            f"ms")
    # the plane-marching kernels at every shape a path launched them at
    # (ana_mult3d also without the dot: the bound counts the same bytes;
    # pcg_dir_mult also with bf16 directions and operator shadows;
    # mult3d also without the dot and with the shadows; mult3d_stream with
    # the dot, also with the shadows)
    for name, forms in (("cfl3d", ((0, ""),)),
                        ("ana_mult3d", ((0, ""), (1, ", without the dot"))),
                        ("pcg_dir_mult", ((0, ""), ("eps_bf16", ", bf16"),
                                          ("eps_L16", ", L16"))),
                        ("mult3d", ((0, ""), ("z_nodot", ", no dot"),
                                    ("z_L16", ", L16"))),
                        ("mult3d_stream", ((0, ""), ("z_L16", ", L16")))):
        for S in sorted(PATH_SHAPES.get(name, ()), key=math.prod,
                        reverse=True):
            for v, form in forms:
                # a form timed above is logged again, not timed twice
                t = done.get((name, S, v)) or time_pair(
                    name, S, dev, variant=v, n=PAIR_CALLS)
                b = bound_ms(name, S, v if isinstance(v, str) else None)[0]
                log(f"  {name:<12} {str(S) + form:<15} device (profiler): "
                    f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
                    f"ms, bound {b:.4f} ms; wall per call: kernel "
                    f"{t['wall_ms']:.4f} ms")
            clear_inputs()
            torch.cuda.empty_cache()
    timing_shard_forms(torch, dev)
    PROBE_LAUNCHES.update({k: w.launches
                           for k, w in probes.kernel_wrappers().items()})
    bandwidth_shares(rows)
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
        report_steps(torch, sim_, label, STEPS_256, 2)
    step_profile(dense, PROFILE_256, "sphere_3d(256, 256, bbox=False)")
    step_profile(band, PROFILE_256, "sphere_3d(256, 256)")
    del dense, band
    stage("256³ sphere on the (2,2,2) mesh, in turns with (a)")
    timing_sharded(torch, dev)
    stage("256³ sphere in configurations (a)-(i)")
    timing_pcg_paths(torch, dev)

    stage("256³ banded levels, heaving sphere")
    lv = construct(torch, "sphere_3d(256, 256, banded_levels=True)",
                   lambda: sphere_3d(256, 256, banded_levels=True,
                                     device=dev))
    report_steps(torch, lv, "sphere_3d(256, 256, banded_levels=True)",
                 STEPS_256, 2)
    peak(torch, "sphere_3d(256, 256, banded_levels=True)")
    step_profile(lv, PROFILE_256, "sphere_3d(256, 256, banded_levels=True)")
    del lv

    hv = construct(torch, "heaving_sphere_3d(radius=64)",
                   lambda: heaving_sphere_3d(radius=64, device=dev))
    report_steps(torch, hv, "heaving_sphere_3d(radius=64), remeasure",
                 STEPS_256, 2,
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
    step_profile(hv, PROFILE_256, "heaving_sphere_3d(radius=64), remeasure",
                 remeasure=True)
    del hv
    stage("tgv_3d(256), 2D cases")
    timing_periodic_2d(torch, dev)
    return times


def timing_shard_forms(torch, dev):
    """The shard-local forms at the sharded path's largest block shape (its
    first base), beside their plain versions and bounds."""
    from waterlily_tpu_torch.kernels.check import (SHARD_KERNELS, time_pair,
                                                   bound_ms, clear_inputs)
    for name in SHARD_KERNELS:
        keys = sorted(PATH_BASES.get(name, ()), key=lambda k: (
            -math.prod(k[0]), repr(k)))
        if not keys:
            continue
        S, form = keys[0][0], keys[0][1:]
        t = time_pair(name, S, dev, form=form, n=PAIR_CALLS)
        b, by = bound_ms(name, S, form=form)
        log(f"  {name:<12} {str(S):<15} shard-local form {form}, device "
            f"(profiler): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, bound {b:.4f} ms ({by}); wall per call: kernel "
            f"{t['wall_ms']:.4f} ms, plain {t['plain_wall_ms']:.4f} ms")
        clear_inputs()
        torch.cuda.empty_cache()


def split_assemble_ms(torch, sim, n=5):
    """Device and wall ms of what one sharded step moves between the global
    state and the blocks: the split of u, p, V, μ₀, μ₁ and the fine level's
    L, D, iD, and the assembly of u and p."""
    from waterlily_tpu_torch.utils.perf import device_profile, _events_ms
    mesh, f, lev = sim.mesh, sim.flow, sim.levels[0]

    def once():
        u, p = mesh.split(f.u, 1), mesh.split(f.p)
        for a, lead in ((f.V, 1), (f.mu0, 1), (f.mu1, 2), (lev.L, 1),
                        (lev.D, 0), (lev.iD, 0)):
            mesh.split(a, lead)
        mesh.assemble(u, 1)
        mesh.assemble(p)

    once()
    return device_profile(once, n, events=True)[0], _events_ms(once, n)


def timing_sharded(torch, dev):
    """The sharded 256³ step of phase 6.5 (i) in turns with the default
    dense 256³ sphere (a) (dense, sharded, sharded, dense), each one's idle
    share, and the share of the sharded step that splitting and
    assembling the state takes."""
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.parallel.mesh import mesh_for
    la, ls = ("sphere_3d(256, 256) (a)",
              "sphere_3d(256, 256, bbox=False), mesh (2,2,2)")
    dense = construct(torch, la, lambda: sphere_3d(256, 256, device=dev))
    shard = construct(torch, ls, lambda: sphere_3d(
        256, 256, bbox=False, device=dev, mesh=mesh_for(BIG, 8, dev)))
    peak(torch, ls)
    for sim_, label in ((dense, la), (shard, ls), (shard, ls), (dense, la)):
        report_steps(torch, sim_, label, STEPS_256, 2)
    step_profile(dense, PROFILE_256, la)
    r = step_profile(shard, PROFILE_256, ls)
    busy, wall = split_assemble_ms(torch, shard)
    log(f"{ls}: split and assemble {busy:.4f} ms device, {wall:.4f} ms wall "
        f"a step: {busy / r['busy_ms']:.4f} of the busy and "
        f"{wall / r['wall_ms']:.4f} of the wall time a step")
    del dense, shard
    torch.cuda.empty_cache()


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
                f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s"
                + (f"; {r / copy[S]:.3f} of copy_probe's" if name !=
                   "copy_probe" and S in copy else "") + ")")
    log("  bytes moved over time, as a share of the copy probe's rate:")
    for (name, S, v), r in rate.items():
        if S in copy and name not in PROBES:
            log(f"    {name:<18} {v or 'timed form':<12} {str(S):<15} "
                f"{r:8.1f} GB/s = {r / copy[S]:.3f} of copy_probe{warm(S)}")


def timing_pcg_paths(torch, dev):
    """Phase 6.4's configurations at 256³, (a)-(i) (the sphere's, (b) the
    vortex's), in turns (a, ..., i, i, ..., a), then each one's idle
    share."""
    label = lambda c: f"{PCG_CASES[c.case][0]} {c.name}"
    sims = {c.name: construct(torch, label(c),
                              lambda c=c: _pcg_case(c.case, True, dev,
                                                    c.bf16, c.op16))
            for c in PCG_CONFIGS}
    for c in PCG_CONFIGS + PCG_CONFIGS[::-1]:
        with seams(c.flags), plain_smoother(c.plain):
            report_steps(torch, sims[c.name], label(c), STEPS_256, 2)
    for c in PCG_CONFIGS:
        with seams(c.flags), plain_smoother(c.plain):
            step_profile(sims[c.name], PROFILE_256, label(c))
    peak(torch, f"the {len(sims)} phase-6.4 configurations at 256³")
    del sims
    torch.cuda.empty_cache()


def timing_periodic_2d(torch, dev):
    import waterlily_tpu_torch as wt
    from waterlily_tpu_torch.metrics import ke

    tg = construct(torch, "tgv_3d(256)", lambda: wt.tgv_3d(256, device=dev))
    ke0 = float(torch.sum(ke(tg.flow.u)))
    report_steps(torch, tg, "tgv_3d(256)", STEPS_256, 2)
    peak(torch, "tgv_3d(256)")
    step_profile(tg, PROFILE_256, "tgv_3d(256)")
    ke1 = float(torch.sum(ke(tg.flow.u)))
    log(f"tgv_3d(256): interior kinetic energy {ke0!r} at step 0, {ke1!r} "
        f"after {len(tg.pois_n)} steps (tU/L {tg.sim_time!r})")
    del tg

    # one horizon: two were within 5% of each other, and the script's
    # time is limited
    sim = circle_horizon(torch, dev, 1, CIRCLE_T)
    step_profile(sim, PROFILE_SMALL,
                 f"circle_2d(96, 64) after tU/L={CIRCLE_T:g}")
    del sim

    plate = construct(torch, "oscillating_plate_2d(32)",
                      lambda: wt.oscillating_plate_2d(32, device=dev))
    report_steps(torch, plate, "oscillating_plate_2d(32), remeasure",
                 STEPS_SMALL // 2, WARM_SMALL,
                 remeasure=True)
    step_profile(plate, PROFILE_SMALL // 2,
                 "oscillating_plate_2d(32), remeasure",
                 remeasure=True)
    tv = construct(torch, "tgv_2d(64)", lambda: wt.tgv_2d(64, device=dev))
    report_steps(torch, tv, "tgv_2d(64)", STEPS_SMALL, WARM_SMALL)
    step_profile(tv, PROFILE_SMALL, "tgv_2d(64)")


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
    from concurrent.futures import ThreadPoolExecutor
    from waterlily_tpu_torch.kernels.build import library, build_seconds
    from waterlily_tpu_torch.kernels.check import minmod
    from waterlily_tpu_torch.kernels.limiter import entry_point
    t0 = time.perf_counter()
    # the conv kernel with phase 4.1's user-defined limiter builds beside
    # the library
    with ThreadPoolExecutor(1) as pool:
        user = pool.submit(entry_point, minmod)
        library()
        user.result()
    log(f"kernel library and the minmod conv kernel ready in "
        f"{time.perf_counter() - t0:.1f} s (library nvcc "
        f"{build_seconds():.1f} s)")
    phase("3. kernels vs plain versions")
    from waterlily_tpu_torch.kernels.check import KERNELS, COMPOSITES
    check_kernels(torch, dev, {
        k: (PCG_LEVEL, PCG_RAGGED) + PCG_PERIODIC + PCG_2D + PCG_THRESHOLD
        if k == "pcg_fused" else (FINE, RAGGED)
        + (CONV_RAGGED if k == "conv_diff3d" else ())
        + (MARCH_RAGGED if k in MARCHES else ())
        + (ROLL_RAGGED if k == "roll_probe" else ())
        for k in KERNELS + COMPOSITES})
    one_launch(torch, dev)
    stage("pcg_fused's member form (torch.func.vmap)")
    check_members(torch, dev)
    stage("the 3D kernels' member forms (torch.func.vmap)")
    check_stencil_members(torch, dev)
    phase("4. the dense slice: sphere_3d(96, 64)")
    sim = run_slice(torch, dev)
    phase("4.1 a user-defined limiter traced into conv_diff3d")
    run_user_limiter(torch, dev)
    phase("4.2 a callable u_BC on the blocked path")
    run_callable_bc(torch, dev)
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
    phase("6.5 the sharded path: the spatial decomposition on one card")
    import tempfile
    snapdir = tempfile.TemporaryDirectory(prefix="wl_snapshot_")
    snapshot = os.path.join(snapdir.name, "sharded_256.pt")
    run_sharded(torch, dev, snapshot)
    phase("6.6 the recording path: run_record, checkpoint, CSG, VTK")
    run_recording(torch, dev)
    phase("6.7 differentiability: implicit_diff, fixed_iters, jvp")
    run_differentiability(torch, dev)
    phase("6.8 ensembles: the sweep under torch.func.vmap")
    run_ensemble(torch, dev)
    run_sweeps(torch, dev)
    run_banded_sweeps(torch, dev)
    run_seam_sweeps(torch, dev)
    phase("6.9 the decomposition over processes: ProcessMesh, gloo and "
          "NCCL")
    run_process_mesh(torch, dev, snapshot)
    snapdir.cleanup()
    phase("6.10 autograd across ranks: implicit_diff, fixed_iters and log "
          "on the process mesh")
    run_process_grad(torch, dev)
    phase("7. kernels vs plain versions at the paths' shapes")
    check_kernels(torch, dev, {**PATH_SHAPES,
                               "pcg_blocked": PATH_SHAPES["pcg_dir_mult"],
                               **{k: (BIG,) for k in PROBES}})
    check_shard_forms(torch, dev)
    phase("8. timing")
    times = timing(torch, dev, sim)
    stage("the recording path")
    timing_recording(torch, dev)
    stage("pcg_fused's member form")
    timing_members(torch, dev)
    stage("the 3D kernels' member forms")
    timing_stencil_members(torch, dev)
    stage("the process mesh: phase 6.9 (i)'s world")
    timing_process_mesh()
    from waterlily_tpu_torch.utils.perf import EVENT_FALLBACKS
    log(f"device times the profiler could not record, taken with CUDA "
        f"events instead (the host's dispatch included): "
        f"{len(EVENT_FALLBACKS)}")
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
    # the member form of pcg_fused (phase 6.8's paths, the sweep's level)
    S = PCG_MEMBER_SHAPES[0]
    kernels.append({
        "name": MEMBERS_KEY, "route": "cuda",
        "source": SOURCES["pcg_fused"][0],
        "replaces": SOURCES["pcg_fused"][1],
        "launches": sum(c.get("pcg_fused", 0)
                        for c in MEMBER_COUNTS.values()),
        "max_abs_err": WORST[MEMBERS_KEY], "ms": MEMBER_TIMES[S]["ms"],
        "plain_ms": MEMBER_TIMES[S]["plain_ms"],
        "bound_ms": MEMBER_TIMES[S]["bound_ms"],
        "bound_by": MEMBER_TIMES[S]["bound_by"], "library_ms": None,
        "shape": [ENS_MEMBERS, *S],
        "sync_floor_ms": MEMBER_TIMES[S]["sync_floor_ms"]})
    # the seven stencils', ana_mult3d's and the PCG seams' six member
    # forms (phase 6.8 (iv)'s, (v)'s and (vi)'s member-form launches;
    # checked in phase 3, timed at FINE x 8 in phase 8); one PyTorch call
    # computes a batch of dot3d's (torch.linalg.vecdot), none of the
    # others
    for k in SEVEN + ("ana_mult3d",) + SEAM_MEMBERS:
        t = STENCIL_MEMBER_TIMES[k]
        kernels.append({
            "name": members_key(k), "route": "cuda",
            "source": SOURCES[k][0], "replaces": SOURCES[k][1],
            "launches": sum(c.get(k, 0) for c in MEMBER_COUNTS.values()),
            "max_abs_err": WORST[members_key(k)], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            "shape": [SWEEP_MEMBERS, *FINE]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
