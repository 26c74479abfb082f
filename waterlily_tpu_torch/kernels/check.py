"""Kernel-versus-plain checks and timings on a CUDA device.

Each case builds numpy-seeded inputs at a given shape, runs a kernel's
wrapper and its plain PyTorch version on the same device tensors and
returns the largest differences.  `chip_smoke.py` and
``tests/test_torch_kernels.py`` use these cases; neither falls back to the
plain version when a kernel fails.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import numpy as np
import torch

from ..ops import stencil_kernels as sk
from ..ops import pcg_kernel as pk
from ..ops import attic as at
from ..ops import poisson, convect
from ..ops.bc import bc_vector_planes
from ..utils.perf import device_profile
from . import probes

__all__ = ["KERNELS", "COMPOSITES", "TOLERANCE", "SOURCES", "LIBRARY",
           "SHARD_KERNELS", "minmod", "inputs", "clear_inputs", "variants",
           "shard_variants", "compare",
           "time_pair", "time_library",
           "ulp_diff", "bound_ms", "bytes_moved", "HBM_BYTES_PER_S",
           "F32_FLOPS_PER_S", "member_inputs", "member_variants",
           "compare_members", "member_bound_ms", "time_members",
           "STENCIL_MEMBERS", "MEMBER_COMPOSITES", "MEMBER_LIBRARY",
           "stencil_member_inputs", "stencil_member_variants", "member_args",
           "compare_stencil_members", "member_stencil_bound_ms",
           "time_stencil_members"]

# csrc file and the TPU kernel (file:line of its function) of each wrapper
SOURCES = {
    "mult3d": ("waterlily_tpu_torch/csrc/stream_march.cu",
               "waterlily_tpu/ops/pallas_stencil.py:161"),
    "increment3d": ("waterlily_tpu_torch/csrc/poisson_stencil.cu",
                    "waterlily_tpu/ops/pallas_stencil.py:198"),
    "cfl3d": ("waterlily_tpu_torch/csrc/cfl.cu",
              "waterlily_tpu/ops/pallas_stencil.py:260"),
    "bc3d": ("waterlily_tpu_torch/csrc/bc.cu",
             "waterlily_tpu/ops/pallas_stencil.py:359"),
    "project3d": ("waterlily_tpu_torch/csrc/projection.cu",
                  "waterlily_tpu/ops/pallas_stencil.py:454"),
    "div3d": ("waterlily_tpu_torch/csrc/projection.cu",
              "waterlily_tpu/ops/pallas_stencil.py:537"),
    "conv_diff3d": ("waterlily_tpu_torch/csrc/conv_diff.cu",
                    "waterlily_tpu/ops/pallas_stencil.py:934"),
    "pcg_fused": ("waterlily_tpu_torch/csrc/pcg.cu",
                  "waterlily_tpu/ops/pallas_kernels.py:127"),
    "ana_mult3d": ("waterlily_tpu_torch/csrc/ana_stencil.cu",
                   "waterlily_tpu/ops/pallas_stencil.py:622"),
    "pcg_dir_mult": ("waterlily_tpu_torch/csrc/pcg_iter.cu",
                     "waterlily_tpu/ops/attic.py:132"),
    "pcg_update": ("waterlily_tpu_torch/csrc/pcg_iter.cu",
                   "waterlily_tpu/ops/attic.py:172"),
    "dot3d": ("waterlily_tpu_torch/csrc/reduce.cu",
              "waterlily_tpu/ops/attic.py:456"),
    "pcg_axpy": ("waterlily_tpu_torch/csrc/reduce.cu",
                 "waterlily_tpu/ops/attic.py:493"),
    "mult3d_stream": ("waterlily_tpu_torch/csrc/stream_march.cu",
                      "waterlily_tpu/ops/attic.py:353"),
    "increment3d_stream": ("waterlily_tpu_torch/csrc/stream_stencil.cu",
                           "waterlily_tpu/ops/attic.py:401"),
    "copy_probe": ("waterlily_tpu_torch/csrc/probes.cu",
                   "scripts/bench_kernels.py:108"),
    "roll_probe": ("waterlily_tpu_torch/csrc/probes.cu",
                   "scripts/bench_kernels.py:128"),
}

# Checked like a kernel, but built from kernels: the fused-iteration
# smoother against the per-pass `poisson.pcg` (f32 directions: with bf16
# ones the two forms' sums, taken in other orders, can round a direction
# value to neighbouring bf16 values; the step-level runs of chip_smoke.py
# hold that form), on an f32 level and on one with operator shadows.
COMPOSITES = ("pcg_blocked",)

# Periodic axes of the checked variants: bc3d's every mask (with and
# without save_exit: the kernel's 16 forms), ana_mult3d's every mask,
# conv_diff3d's every non-empty mask (the walls are its first variants),
# pcg_fused's those of the 3D and 2D Taylor-Green cases and
# tests/test_pallas.py.
BC_PERDIRS = ((), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2))
CONV_PERDIRS = ((0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2))
PCG_PERDIRS = {3: ((0, 1, 2),), 2: ((1,), (0, 1))}


def _tag(perdir=(), save_exit=False) -> str:
    """A variant's output suffix: ``p`` and its periodic axes, ``exit``."""
    return "_".join(filter(None, ("p" + "".join(map(str, perdir))
                                  if perdir else "",
                                  "exit" if save_exit else "")))


# ("exact", None): equal values; ("rel", r): max|a-b| <= r*max|b|;
# ("abs", a): max|a-b| <= a.  Sums taken in another order than torch.sum
# (the matvec dots, pcg's dots, the attic kernels' sums) are the only
# inexact outputs; every elementwise output is exact (--fmad=false), bf16
# forms included.
TOLERANCE = {
    "increment3d.x": ("exact", None), "increment3d.r": ("exact", None),
    "cfl3d": ("exact", None), "bc3d": ("exact", None),
    "div3d.z": ("exact", None), "div3d.x": ("exact", None),
    "project3d.u": ("exact", None), "project3d.p": ("exact", None),
    "conv_diff3d.quick": ("exact", None), "conv_diff3d.vanleer": ("exact", None),
    "pcg_fused.x": ("abs", 1e-5), "pcg_fused.r": ("abs", 1e-5),
    "ana_mult3d.z": ("exact", None), "ana_mult3d.dot": ("rel", 1e-5),
    **{"_".join(filter(None, ("ana_mult3d.z_c2", _tag(p)))): ("exact", None)
       for p in BC_PERDIRS},
    **{f"bc3d.{_tag(p, e)}": ("exact", None)
       for p in BC_PERDIRS for e in (False, True) if p or e},
    "conv_diff3d.minmod": ("exact", None),
    **{f"conv_diff3d.{lim}_{_tag(p)}": ("exact", None)
       for lim in ("quick", "vanleer", "minmod") for p in CONV_PERDIRS},
    **{f"pcg_fused.{o}_{_tag(p)}": ("abs", 1e-5)
       for ps in PCG_PERDIRS.values() for p in ps for o in "xr"},
    "increment3d.x_bf16": ("exact", None),
    "increment3d.r_bf16": ("exact", None),
    # the sweeps' words carry their sums (rho, <z, eps>, rho2) and the
    # scalar step taken from them
    **{f"pcg_dir_mult.{o}{t}": (("rel", 1e-5) if o == "words"
                                else ("exact", None))
       for o in ("eps", "z", "words")
       for t in ("", "_b0", "_bf16", "_b0_bf16")},
    **{f"{k}.{o}{t}": ("rel", 1e-5) if o in ("rho", "words")
       else ("exact", None)
       for k, sums in (("pcg_update", "words"), ("pcg_axpy", "rho"))
       for o in ("x", "r", sums) for t in ("", "_bf16")},
    "dot3d.aa": ("rel", 1e-5), "dot3d.ab": ("rel", 1e-5),
    "dot3d.rid": ("rel", 1e-5),
    "pcg_blocked.x": ("abs", 1e-5), "pcg_blocked.r": ("abs", 1e-5),
    # the operator-shadow forms (bf16 L with the f32 D16, bf16 iD)
    "increment3d.x_L16": ("exact", None),
    "increment3d.r_L16": ("exact", None),
    **{f"pcg_dir_mult.{o}{t}": (("rel", 1e-5) if o == "words"
                                else ("exact", None))
       for o in ("eps", "z", "words") for t in ("_L16", "_b0_L16")},
    **{f"{k}.{o}_iD16": ("rel", 1e-5) if o in ("rho", "words")
       else ("exact", None)
       for k, sums in (("pcg_update", "words"), ("pcg_axpy", "rho"))
       for o in ("x", "r", sums)},
    "dot3d.rid_iD16": ("rel", 1e-5),
    "pcg_blocked.x_L16": ("abs", 1e-5), "pcg_blocked.r_L16": ("abs", 1e-5),
    # the operator (`mult3d` and `mult3d_stream` launch the same march),
    # with and without the dot, f32 and bf16 L, f32 and bf16 x
    **{f"{k}.{o}{t}": ("rel", 1e-5) if o == "dot" else ("exact", None)
       for k in ("mult3d", "mult3d_stream")
       for o in ("z", "dot", "z_nodot")
       for t in ("", "_L16", "_bf16", "_L16_bf16")},
    **{f"increment3d_stream.{o}{t}": ("exact", None)
       for o in ("x", "r") for t in ("", "_L16")},
    "copy_probe": ("exact", None), "roll_probe": ("exact", None),
    # the shard-local forms (`shard_variants`)
    "bc3d.base": ("exact", None), "bc3d.base_exit": ("exact", None),
    "div3d.z_base": ("exact", None), "div3d.x_base": ("exact", None),
    "project3d.u_base": ("exact", None), "project3d.p_base": ("exact", None),
    **{f"conv_diff3d.{lim}_base{'_' + _tag(p) if p else ''}": ("exact", None)
       for lim in ("quick", "vanleer", "minmod") for p in ((),) + CONV_PERDIRS},
}

# The kernels with shard-local forms (`parallel`).  A form is a key of the
# wrapper's ``.bases`` without its shape: ``(S_glob, base)`` for div3d and
# project3d, ``(S_glob, base, save_exit)`` for bc3d, ``(S_glob, base,
# perdir)`` for conv_diff3d (modular where an axis is periodic).
SHARD_KERNELS = ("bc3d", "div3d", "project3d", "conv_diff3d")


def minmod(u, c, d):
    """A user-defined limiter (minmod-limited linear upwind) in torch
    operations, as a user writes one: no kernel has it compiled in, so
    `conv_diff3d` traces it into its kernel (`kernels.limiter`)."""
    a, b = c - u, d - c
    return c + 0.5 * torch.where(
        a * b > 0, torch.sign(a) * torch.minimum(a.abs(), b.abs()), 0.0)


# conv_diff3d's checked limiters: the two compiled in and a user's own
CONV_LIMITERS = (convect.quick, convect.vanleer, minmod)


def inputs(S, seed, device) -> dict:
    """Seeded fields at ghost-padded shape ``S`` (2D or 3D): a level built
    from positive face coefficients with wall-normal ghosts zeroed (a μ₀),
    a right-hand side and residual with zero ghosts, a velocity, a pressure
    and a time step on the device, and the level's operator shadows
    (``L16``, ``D16``, ``iD16``, built at any shape: the kernel gate gives a
    level its shadows only where it is blocked).  ``level(perdir)`` builds
    the level and residual of the same coefficients and right-hand side
    with periodic axes ``perdir``."""
    rng = np.random.default_rng(seed)
    S = tuple(S)
    D = len(S)
    f32 = np.float32
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, f32)).to(device)
    inner = np.zeros(S, bool)
    inner[(slice(1, -1),) * D] = True
    L_raw = t(rng.uniform(0.5, 1.5, (D,) + S))
    rhs = t(np.where(inner, rng.standard_normal(S) * 0.1, 0.0))

    def level(perdir=()):
        L = bc_vector_planes(L_raw, (0.0,) * D, perdir=perdir)
        lev = poisson.make_level(L.contiguous(), perdir)
        r = poisson.residual(lev, torch.zeros_like(rhs), rhs).contiguous()
        return lev, r

    lev, r = level()
    eps = t(np.where(inner, rng.standard_normal(S) * 0.1, 0.0))
    L16, D16, iD16 = poisson.operator_shadows(lev.L) if D == 3 else (None,) * 3
    return {
        "lev": lev, "r": r, "level": level,
        "L16": L16, "D16": D16, "iD16": iD16,
        "x": t(rng.standard_normal(S)),
        "eps": eps, "eps16": eps.to(torch.bfloat16),
        "u": t(rng.standard_normal((D,) + S)),
        "p": t(rng.standard_normal(S)),
        "dt": torch.full((), 0.37, dtype=torch.float32, device=device),
        "A": (1.0, 0.0, 0.0), "nu": 0.01,
        # drawn last, so the fields above stay those of earlier seeds
        "z": t(np.where(inner, rng.standard_normal(S), 0.0)),
    }


def words(M, device) -> torch.Tensor:
    """Scalar-step words (`ops.attic.WORDS`: rho, the last sweep's sum,
    dead, upd, beta) of a smooth in flight: one run, or with ``M`` one a member, the
    member m's values moved by 0.01 m and member 1 dead."""
    runs = [[0.8 + 0.01 * m, 1.3 + 0.01 * m, float(m == 1),
             0.3 + 0.01 * m, 0.37 + 0.01 * m] for m in range(M or 1)]
    w = torch.tensor(runs, dtype=torch.float32, device=device)
    return w if M else w[0]


def variants(name, d) -> list:
    """``[(outputs, kernel call, plain call), ...]`` of kernel ``name`` on
    inputs ``d``, every variant the kernel has at their rank (only
    pcg_fused has 2D ones); each call returns one tensor or a tuple
    matching ``outputs``.  The first variant is the one timed by
    default."""
    lev = d["lev"]
    L, Dd, x, r, eps, u, p, dt = (lev.L, lev.D, d["x"], d["r"], d["eps"],
                                  d["u"], d["p"], d["dt"])
    D = x.ndim
    x0 = torch.zeros_like(r)
    x16, eps16, iD, z = x.to(torch.bfloat16), d["eps16"], lev.iD, d["z"]
    L16, D16, iD16 = d["L16"], d["D16"], d["iD16"]
    s = dt    # beta and upd: a 0-d device scalar, as in a smooth

    def pcg(perdir=()):
        lv, rr = d["level"](perdir) if perdir else (lev, r)
        tag = _tag(perdir)
        return (tuple("_".join(filter(None, (o, tag))) for o in "xr"),
                lambda: pk.pcg_fused(lv, x0, rr),
                lambda: poisson.pcg(lv, x0, rr))

    if D == 2:
        return [pcg()] + [pcg(q) for q in PCG_PERDIRS[2]] \
            if name == "pcg_fused" else []
    conv = lambda lim, perdir=(): (
        ("_".join(filter(None, (lim.__name__, _tag(perdir)))),),
        lambda: sk.conv_diff3d(u, d["nu"], lim, perdir),
        lambda: sk._conv_diff3d_plain(u, d["nu"], lim, perdir))
    def bc(perdir, save_exit):
        # the kernel and the plain form each fill their own copy of u in
        # place, made at their first call: the first calls are compared,
        # and a later call (timing) does the same work again on the filled
        # copy (the fill is idempotent: it writes no cell it reads)
        def in_place(fill):
            own = []

            def call():
                if not own:
                    own.append(u.clone())
                return fill(own[0], d["A"], save_exit, perdir, inplace=True)
            return call
        return ((_tag(perdir, save_exit),), in_place(sk.bc3d),
                in_place(bc_vector_planes))
    # the fused iteration's sweeps read their scalars from a smooth's words
    # (the seed's first sweep from none: beta 0), pcg_axpy its upd
    w = words(None, x.device)

    def dir_mult(tag, eps_prev, ws, bf16, op=(L, Dd, iD)):
        Lc, Dc, iDc = op
        return (tuple(o + tag for o in ("eps", "z", "words")),
                lambda: at.pcg_dir_mult(Lc, Dc, eps_prev, r, iDc, ws, bf16),
                lambda: at._pcg_dir_mult_plain(Lc, Dc, eps_prev, r, iDc, ws,
                                               bf16))

    def axpy_rho(name, tag, e, iDa=iD):
        update = name == "pcg_update"
        sv, plain = ((w, at._pcg_update_plain) if update
                     else (s, at._axpy_rho_plain))
        return (tuple(o + tag for o in ("x", "r", "words" if update
                                        else "rho")),
                lambda: getattr(at, name)(x, r, e, z, iDa, sv),
                lambda: plain(x, r, e, z, iDa, sv))

    def dot(mode, a, b, tag=""):
        return ((mode + tag,), lambda: at.dot3d(a, b, mode),
                lambda: at._dot3d_plain(a, b, mode))

    def operator(fn):
        # all eight forms of an operator wrapper: f32 and bf16 L (with the
        # D16 of its shadows), f32 and bf16 x, with and without the dot
        def form(tag, Lc, Dc, xs, with_dot):
            outs = (("z" + tag, "dot" + tag) if with_dot
                    else ("z_nodot" + tag,))
            return (outs, lambda: fn(Lc, Dc, xs, with_dot),
                    lambda: sk._mult3d_plain(Lc, Dc, xs, with_dot))
        return [form(t, Lc, Dc, xs, dot)
                for t, Lc, Dc, xs in (("", L, Dd, x), ("_L16", L16, D16, x),
                                      ("_bf16", L, Dd, x16),
                                      ("_L16_bf16", L16, D16, x16))
                for dot in (True, False)]

    def probe(fn, plain):
        return ((), lambda: fn(x), lambda: plain(x))

    # a blocked level with the operator shadows (pcg_blocked reads the
    # level's flags, not the kernel gate)
    lev16 = dataclasses.replace(lev, blocked=True, bf16_eps=False, L16=L16,
                                D16=D16, iD16=iD16)

    return {
        # the timed (first) form is the PCG denominator's, with the dot;
        # then without it, with the shadows, and with a bf16 x (a bf16
        # direction)
        "mult3d": operator(sk.mult3d),
        "increment3d": [(("x", "r"),
                         lambda: sk.increment3d(L, Dd, eps, x, r),
                         lambda: sk._increment3d_plain(L, Dd, eps, x, r)),
                        (("x_bf16", "r_bf16"),
                         lambda: sk.increment3d(L, Dd, eps16, x, r),
                         lambda: sk._increment3d_plain(L, Dd, eps16, x, r)),
                        (("x_L16", "r_L16"),
                         lambda: sk.increment3d(L16, D16, eps, x, r),
                         lambda: sk._increment3d_plain(L16, D16, eps, x, r))],
        # the timed (first) form is the iteration's: beta != 0, f32
        "pcg_dir_mult": [dir_mult("", eps, w, False),
                         dir_mult("_b0", r, None, False),
                         dir_mult("_bf16", eps16, w, True),
                         dir_mult("_b0_bf16", r, None, True),
                         dir_mult("_L16", eps, w, False, (L16, D16, iD16)),
                         dir_mult("_b0_L16", r, None, False,
                                  (L16, D16, iD16))],
        "pcg_update": [axpy_rho("pcg_update", "", eps),
                       axpy_rho("pcg_update", "_bf16", eps16),
                       axpy_rho("pcg_update", "_iD16", eps, iD16)],
        "pcg_axpy": [axpy_rho("pcg_axpy", "", eps),
                     axpy_rho("pcg_axpy", "_bf16", eps16),
                     axpy_rho("pcg_axpy", "_iD16", eps, iD16)],
        # aa first (the solver's r.r, timed beside torch.dot); ab on a
        # field with non-zero ghosts, which both forms mask
        "dot3d": [dot("aa", r, r), dot("ab", x, eps), dot("rid", r, iD),
                  dot("rid", r, iD16, "_iD16")],
        "pcg_blocked": [(("x", "r"), lambda: at.pcg_blocked(lev, x0, r),
                         lambda: poisson.pcg(lev, x0, r)),
                        (("x_L16", "r_L16"),
                         lambda: at.pcg_blocked(lev16, x0, r),
                         lambda: poisson.pcg(lev16, x0, r))],
        # as mult3d's: the same kernel behind the STREAM seam
        "mult3d_stream": operator(at.mult3d_stream),
        "increment3d_stream": [
            (("x", "r"), lambda: at.increment3d_stream(L, Dd, eps, x, r),
             lambda: sk._increment3d_plain(L, Dd, eps, x, r)),
            (("x_L16", "r_L16"),
             lambda: at.increment3d_stream(L16, D16, eps, x, r),
             lambda: sk._increment3d_plain(L16, D16, eps, x, r))],
        "copy_probe": [probe(probes.copy_probe, probes._copy_probe_plain)],
        "roll_probe": [probe(probes.roll_probe, probes._roll_probe_plain)],
        "cfl3d": [((), lambda: sk.cfl3d(u), lambda: sk._cfl3d_plain(u))],
        "bc3d": [bc(q, e) for q in BC_PERDIRS for e in (False, True)],
        "div3d": [(("z", "x"), lambda: sk.div3d(u, p, dt),
                   lambda: sk._div3d_plain(u, p, dt))],
        "project3d": [(("u", "p"), lambda: sk.project3d(L, x, u, dt),
                       lambda: sk._project3d_plain(L, x, u, dt))],
        "conv_diff3d": [conv(lim) for lim in CONV_LIMITERS]
        + [conv(lim, q) for lim in CONV_LIMITERS for q in CONV_PERDIRS],
        "pcg_fused": [pcg()] + [pcg(q) for q in PCG_PERDIRS[3]],
        # with the dot first (the PCG denominator's form, timed), then
        # without it at c = 2, walls and every periodic mask
        "ana_mult3d": [
            (("z", "dot"), lambda: sk.ana_mult3d(x, 1.0, with_dot=True),
             lambda: sk._ana_mult3d_plain(x, 1.0, with_dot=True))]
        + [(("_".join(filter(None, ("z_c2", _tag(q)))),),
            lambda q=q: sk.ana_mult3d(x, 2.0, q),
            lambda q=q: sk._ana_mult3d_plain(x, 2.0, q)) for q in BC_PERDIRS],
    }[name]


def shard_variants(name, d, form) -> list:
    """``[(outputs, kernel call, plain call), ...]`` of the shard-local
    form ``form`` of kernel ``name`` (one of `SHARD_KERNELS`) on inputs
    ``d``: bc3d's copy form on a block, div3d, project3d and each checked
    limiter of conv_diff3d on a halo-extended block."""
    S_glob, base, *extra = form
    glob = dict(S_glob=tuple(S_glob), base=tuple(base))
    u, p, dt, x, L = d["u"], d["p"], d["dt"], d["x"], d["lev"].L
    if name == "bc3d":
        save_exit = bool(extra[0])
        return [(("base_exit" if save_exit else "base",),
                 lambda: sk.bc3d(u, d["A"], save_exit, **glob),
                 lambda: bc_vector_planes(u, d["A"], save_exit, (), False,
                                          **glob))]
    if name == "div3d":
        return [(("z_base", "x_base"), lambda: sk.div3d(u, p, dt, **glob),
                 lambda: sk._div3d_plain(u, p, dt, **glob))]
    if name == "project3d":
        return [(("u_base", "p_base"),
                 lambda: sk.project3d(L, x, u, dt, **glob),
                 lambda: sk._project3d_plain(L, x, u, dt, **glob))]
    perdir = tuple(extra[0])
    tag = "_base" + ("_" + _tag(perdir) if perdir else "")
    return [((lim.__name__ + tag,),
             lambda lim=lim: sk.conv_diff3d(u, d["nu"], lim, perdir,
                                            modular=bool(perdir), **glob),
             lambda lim=lim: sk._conv_diff3d_plain(u, d["nu"], lim, perdir,
                                                   modular=bool(perdir),
                                                   **glob))
            for lim in CONV_LIMITERS]


KERNELS = tuple(SOURCES)

# The card's published peaks (H100 SXM data sheet, at the 700 W limit):
# device memory rate and f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def _bc_written(S, perdir=(), save_exit=False) -> tuple[int, int]:
    """Cells bc3d writes at shape ``S``, ``(copied, Dirichlet)``: for each
    component its ghost shell and the interior of its Dirichlet plane 1
    (none along a periodic axis), less the kept outlet plane's interior.
    The Dirichlet cells, which take A[c] and read nothing, are the whole
    planes 0, 1 and S-1 of each non-periodic component's normal axis (not
    the kept outlet plane); every other written cell copies a source."""
    shell = math.prod(S) - math.prod(s - 2 for s in S)
    inner = lambda c: math.prod(s - 2 for a, s in enumerate(S) if a != c)
    whole = lambda c: math.prod(s for a, s in enumerate(S) if a != c)
    kept = save_exit and 0 not in perdir
    n = sum(shell + (0 if c in perdir else inner(c)) for c in range(3))
    n -= inner(0) if kept else 0
    dirichlet = sum(3 * whole(c) for c in range(3) if c not in perdir)
    dirichlet -= whole(0) if kept else 0
    return n - dirichlet, dirichlet


def _bc_written_base(S, S_glob, base, save_exit=False) -> tuple[int, int]:
    """`_bc_written` of bc3d's shard-local form on a block at global index
    ``base``: the cells of the global faces present in the block (and of
    the Dirichlet plane 1 where the block holds plane 0), less the kept
    outlet plane's cells on no other face."""
    D = len(S)
    ax = [np.arange(S[a]).reshape([-1 if b == a else 1 for b in range(D)])
          for a in range(D)]
    lo = [b == 0 for b in base]
    hi = [b + n == g for b, n, g in zip(base, S, S_glob)]
    face = [(ax[a] == 0) & lo[a] | (ax[a] == S[a] - 1) & hi[a]
            for a in range(D)]
    copied = dirichlet = 0
    for c in range(D):
        kept = save_exit and c == 0
        dirc = (ax[c] <= 1) & lo[c] | (ax[c] == S[c] - 1) & hi[c] & (not kept)
        written = np.broadcast_to(dirc, S).copy()
        for a in range(D):
            written |= face[a]
        if kept:
            others = np.zeros(S, bool)
            for a in range(1, D):
                others |= face[a]
            written &= ~(face[0] & ~others & ~dirc)
        nd = int(np.broadcast_to(dirc, S).sum())
        copied += int(written.sum()) - nd
        dirichlet += nd
    return copied, dirichlet


def _bc_work(S, perdir=(), save_exit=False, form=None) -> tuple[float, int]:
    """bc3d's fields a cell: a 4 B read and a 4 B write for each copied
    cell, a 4 B write for each Dirichlet one (~21 planes written at
    most, not 6 fields a cell: a function of the shape); ``form`` a
    shard-local form (`SHARD_KERNELS`)."""
    copied, dirichlet = (_bc_written(S, perdir, save_exit) if form is None
                         else _bc_written_base(S, *form))
    return (2 * copied + dirichlet) / math.prod(S), 0


# Work of the first (timed) variant of each kernel per cell: f32 fields it
# must read once and write once, and its float operations (the dots' and
# maxima's reduction counted as one add per cell).  pcg_fused counts all
# six iterations of its smooth.  conv_diff3d counts the nine face fluxes a
# cell owns (three components, three axes), each evaluated once: two QUICK
# limiters of 16 operations (5 for (5c + 2d - u) / 6 with the division as
# one, 3 for 10c - 9u, 4 min/max for each median), the advecting velocity
# (2), the wall face's central value (2), the upwind product and the
# diffusive term (4): 40 a face; then 3 differences and 3 sums a component.
# (That is the plain form's expression; the kernel picks the limiter's
# arguments by the upwind sign first and runs one limiter a face.)
_WORK = {
    "mult3d": (6, 15),          # L(3), D, x in; z out
    "increment3d": (9, 15),     # L(3), D, eps, x, r in; x, r out
    "cfl3d": (3, 13),           # u(3) in
    "bc3d": _bc_work,           # the cells it writes (_bc_written)
    "div3d": (6, 6),            # u(3), p in; z, x out
    "project3d": (11, 10),      # L(3), x, u(3) in; u(3), p out
    "conv_diff3d": (6, 378),    # u(3) in, r(3) out; 9 * 40 + 3 * 6
    "pcg_fused": (9, 150),      # L(3), D, iD, x, r in; x, r out
    "ana_mult3d": (2, 22),      # x in, z out
    "pcg_dir_mult": (9, 21),    # L(3), D, eps_prev, r, iD in; eps, z out
    "pcg_update": (7, 8),       # x, r, eps, z, iD in; x, r out
    "dot3d": (1, 2),            # aa: a in
    "pcg_axpy": (7, 8),         # x, r, eps, z, iD in; x, r out
    "mult3d_stream": (6, 15),   # as mult3d
    "increment3d_stream": (9, 15),  # L(3), D, eps, x, r in; x, r out
    "copy_probe": (2, 1),       # x in, o out
    "roll_probe": (2, 6),       # x in, o out
}
# the same at a 2D shape (only pcg_fused has a 2D form): L(2) instead of
# L(3), and two neighbours (four operations) fewer in each of six matvecs
_WORK_2D = {"pcg_fused": (8, 126)}


# forms whose work differs from the first variant's (by first output): a
# bf16 field counts half (L16: 1.5 fields for 3, iD16: 0.5), dot3d's
# two-operand modes read two fields, a matvec without its dot does two
# operations a cell fewer; bc3d's periodic and outlet forms write other
# cells (`_bc_work`)
_WORK_FORMS = {
    **{("bc3d", _tag(p, e)): (lambda S, p=p, e=e: _bc_work(S, p, e))
       for p in BC_PERDIRS for e in (False, True) if p or e},
    ("increment3d", "x_bf16"): (8.5, 15),
    ("pcg_dir_mult", "eps_bf16"): (8, 21), ("pcg_update", "x_bf16"): (6.5, 8),
    ("pcg_axpy", "x_bf16"): (6.5, 8), ("dot3d", "ab"): (2, 2),
    ("dot3d", "rid"): (2, 3),
    ("increment3d", "x_L16"): (7.5, 15),
    ("pcg_dir_mult", "eps_L16"): (7, 21), ("pcg_update", "x_iD16"): (6.5, 8),
    ("pcg_axpy", "x_iD16"): (6.5, 8), ("dot3d", "rid_iD16"): (1.5, 3),
    **{(k, f"z{o}{t}"): (b, 13 if o else 15)
       for k in ("mult3d", "mult3d_stream") for o in ("", "_nodot")
       for t, b in (("", 6), ("_L16", 4.5), ("_bf16", 5.5),
                    ("_L16_bf16", 4)) if o or t},
    ("increment3d_stream", "x_L16"): (7.5, 15),
}


def _work(name, S, variant=None, form=None):
    """A shard-local form (``form``) does the work of the whole-grid form
    at its shape, but bc3d's, which writes only the faces in its block."""
    if name == "bc3d" and form is not None:
        return _bc_work(S, form=form)
    w = _WORK_FORMS.get(
        (name, variant), (_WORK_2D if len(S) == 2 else _WORK)[name])
    return w(S) if callable(w) else w


def bytes_moved(name, S, variant=None, form=None) -> float:
    """Bytes kernel ``name``'s timed variant (or the form whose first output
    is ``variant``, or the shard-local form ``form``) must move at shape
    ``S``: each input read once, each output written once, a bf16 field at
    half."""
    return 4 * _work(name, S, variant, form)[0] * math.prod(S)


def bound_ms(name, S, variant=None, form=None) -> tuple[float, str]:
    """The least time the card could take for kernel ``name``'s timed
    variant (or the form whose first output is ``variant``, or the
    shard-local form ``form``) at shape ``S``: the larger of its bytes over
    the memory rate and its operations over the f32 rate, in ms, and which
    of the two bounds it ("bytes" or "operations")."""
    t_bytes = bytes_moved(name, S, variant, form) / HBM_BYTES_PER_S * 1e3
    t_ops = (_work(name, S, variant, form)[1] * math.prod(S)
             / F32_FLOPS_PER_S * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two f32
    tensors (signed zeros count as equal)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(torch.max(torch.abs(ordered(a) - ordered(b))))


def compare(name, S, seed, device, form=None) -> list[dict]:
    """Run kernel ``name`` and its plain version at shape ``S`` (every
    variant, or the shard-local form ``form``); one row per output with its
    max |diff|, max ulp distance and pass verdict."""
    rows = []
    pairs = []
    d = _fresh_inputs(S, seed, device)
    for outputs, kern, plain in (variants(name, d) if form is None
                                 else shard_variants(name, d, form)):
        k_out, p_out = kern(), plain()
        if not isinstance(k_out, tuple):
            k_out, p_out = (k_out,), (p_out,)
        pairs += [(".".join(filter(None, (name, o))), k, p)
                  for o, k, p in zip(outputs or ("",), k_out, p_out)]
    torch.cuda.synchronize(device)
    for key, k, p in pairs:
        k, p = k.float(), p.float()
        err = float(torch.max(torch.abs(k - p)))
        kind, tol = TOLERANCE[key]
        if kind == "exact":
            ok = bool(torch.equal(k, p))
        elif kind == "rel":
            ok = err <= tol * float(torch.max(torch.abs(p)))
        else:
            ok = err <= tol
        rows.append({"output": key, "shape": tuple(S), "max_abs_err": err,
                     "max_ulp": ulp_diff(k, p),
                     "finite": bool(torch.isfinite(k).all()),
                     "tolerance": kind if tol is None else f"{kind} {tol}",
                     "ok": ok and bool(torch.isfinite(k).all())})
    return rows


def _timed(fn, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _variant(name, d, variant, form=None):
    """Variant ``variant`` of `variants` (of `shard_variants` with
    ``form``): its index, or its first output's name ("" for a variant
    with none)."""
    vs = variants(name, d) if form is None else shard_variants(name, d, form)
    if isinstance(variant, int):
        return vs[variant]
    for v in vs:
        if (v[0] or ("",))[0] == variant:
            return v
    raise KeyError(f"{name} has no variant {variant!r}")


# One PyTorch call that computes a kernel's timed form on the same inputs,
# timed beside it as a yardstick and used nowhere in the port: dot3d's aa
# form on a ghost-zero field is torch.dot over the flat array, copy_probe
# is torch.mul by the probe's scale.
LIBRARY = {"dot3d": lambda d: (
    lambda: torch.dot(d["r"].view(-1), d["r"].view(-1))),
    "copy_probe": lambda d: (lambda: torch.mul(d["x"], probes.C))}


# The timings rotate over this many copies of their inputs, each on its own
# device memory, so that a call does not find the operands of the call
# before it in the card's 50 MB L2: at 258³ one field is 69 MB and the
# sets' fields together some 4 GB.  At (98,66,66) (1.7 MB a field) a call's
# operands in all three sets still fit in L2, and those times are L2-warm,
# as the multigrid's small levels are in a solve.
ROTATE = 3


def _fresh(v):
    """``v`` on its own device memory: a tensor cloned, a level with its
    tensors cloned, anything else as it is."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, poisson.PoissonLevel):
        return dataclasses.replace(v, **{
            f.name: getattr(v, f.name).clone()
            for f in dataclasses.fields(v)
            if isinstance(getattr(v, f.name), torch.Tensor)})
    return v


@functools.lru_cache(maxsize=4)
def _seeded(S, seed, device) -> dict:
    # drawing 258³ fields on the host takes seconds a shape
    return inputs(S, seed, device)


def clear_inputs():
    """Free the inputs `compare`, the member checks and the timings keep
    for reuse."""
    _seeded.cache_clear()
    _member_seeded.cache_clear()


def _fresh_inputs(S, seed, device) -> dict:
    """``inputs(S, seed, device)`` on device memory of its own: drawn once
    a shape and seed (kept until `clear_inputs`), cloned for each use, so
    that no call sees what an earlier one left in its inputs."""
    return {k: _fresh(v)
            for k, v in _seeded(tuple(S), seed, torch.device(device)).items()}


def _input_sets(S, device) -> list[dict]:
    """`ROTATE` sets of the same seeded inputs at shape ``S``."""
    return [_fresh_inputs(S, 0, device) for _ in range(ROTATE)]


def _rotating(fns):
    """One call that calls ``fns`` in turn, a different one each time."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def time_library(name, S, device, n=20) -> float:
    """Device ms per call (profiler, the mean of two sessions) of
    ``LIBRARY[name]`` on the inputs `time_pair` gives the kernel, rotating
    over the same `ROTATE` sets."""
    calls = [LIBRARY[name](d) for d in _input_sets(S, device)]
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    fn = _rotating(calls)
    return (device_profile(fn, n, events=True)[0]
            + device_profile(fn, n, events=True)[0]) / 2


def time_pair(name, S, device, n=20, variant=0, form=None) -> dict:
    """Per-call times of kernel ``name``'s variant ``variant`` (index or
    first output name, `_variant`) and its plain version at shape ``S``,
    over ``n`` back-to-back calls of the kernel and ``n // 4`` of the
    plain version (a reference, up to 60 ms a call at 258³), each on the
    next of `ROTATE` input
    sets: device time from `torch.profiler` (`utils.perf.device_profile`:
    the card's busy time for one call, every kernel, fill and copy it
    launches) and wall time from CUDA events (the host's dispatch
    included).  Measured in turns plain, kernel, kernel, plain after a
    warm-up, first wall, then device; each is the mean of its two
    runs.  A device time the profiler could not record is a CUDA-event
    time (`device_profile`'s ``events``).  ``form``: a shard-local form
    (`shard_variants`)."""
    sets = [_variant(name, d, variant, form)
            for d in _input_sets(S, device)]
    for _, k, p in sets:
        k(), p()
    torch.cuda.synchronize()
    kern = _rotating([k for _, k, _ in sets])
    plain = _rotating([p for _, _, p in sets])
    n_plain = max(1, n // 4)
    pw1 = _timed(plain, n_plain)
    kw1 = _timed(kern, n)
    kw2 = _timed(kern, n)
    pw2 = _timed(plain, n_plain)
    p1 = device_profile(plain, n_plain, events=True)[0]
    k1 = device_profile(kern, n, events=True)[0]
    k2 = device_profile(kern, n, events=True)[0]
    p2 = device_profile(plain, n_plain, events=True)[0]
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "wall_ms": (kw1 + kw2) / 2, "plain_wall_ms": (pw1 + pw2) / 2}


# --- pcg_fused's member-axis form (an ensemble under torch.func.vmap) -------

def member_inputs(S, members: int, shared: bool, seed, device) -> dict:
    """``members`` members' levels at shape ``S``: one operator for all
    (``shared``: ``L`` (D, *S), ``D`` and ``iD`` ``S``, member 0's) or one
    a member (``(M, D, *S)``, ``(M, *S)``, each member's `inputs` of seed
    ``seed + m``), x zero and each member's residual (``(M, *S)``; member
    1's zero, so that its smooth exits at its first test while the others
    iterate), and the `poisson.PoissonLevel` of each member's operator."""
    ds = [inputs(S, seed + m, device) for m in range(members)]
    levs = [ds[0]["lev"]] * members if shared else [d["lev"] for d in ds]
    r = torch.stack([d["r"] for d in ds])
    if members > 1:
        r[1] = 0.0
    op = lambda f: (getattr(levs[0], f) if shared
                    else torch.stack([getattr(l, f) for l in levs]))
    return {"L": op("L"), "D": op("D"), "iD": op("iD"),
            "x": torch.zeros_like(r), "r": r.contiguous(), "levels": levs}


def member_variants(d) -> list:
    """``[(route, kernel call, plain call)]`` on `member_inputs` ``d``: the
    member-axis wrapper `pcg_kernel.pcg_members`, and `pcg_fused` under
    `torch.func.vmap` (its `vmap` rule), each against the plain version,
    `vmap` of `ops.poisson.pcg`."""
    L, Dd, iD, x, r = d["L"], d["D"], d["iD"], d["x"], d["r"]
    S = tuple(x.shape[1:])
    dims = tuple(0 if t.ndim > n else None
                 for t, n in ((L, len(S) + 1), (Dd, len(S)), (iD, len(S))))

    def via_vmap():
        return torch.func.vmap(
            lambda L, Dd, iD, x, r: pk.pcg_fused(
                poisson.PoissonLevel(L=L, D=Dd, iD=iD), x, r),
            in_dims=dims + (0, 0))(L, Dd, iD, x, r)

    plain = lambda: pk._plain_members(L, Dd, iD, x, r, 6, ())
    return [("pcg_members", lambda: pk.pcg_members(L, Dd, iD, x, r), plain),
            ("vmap(pcg_fused)", via_vmap, plain)]


def compare_members(S, members: int, shared: bool, seed, device) -> list:
    """The member-axis `pcg_fused` against `vmap` of its plain version
    (`member_variants`) at shape ``S``: a row per route and output, with
    max |diff|, the launches the route made (`pcg_kernel.launch_chunks`'
    count expected) and the verdict (1e-5 absolute, the kernel's
    tolerance; member 1's zero residual exactly)."""
    d = member_inputs(S, members, shared, seed, device)
    rows = []
    for route, kern, plain in member_variants(d):
        before = pk.pcg_fused.launches
        k_out = kern()
        launches = pk.pcg_fused.launches - before
        p_out = plain()
        torch.cuda.synchronize(device)
        for o, k, p in zip("xr", k_out, p_out):
            err = float(torch.max(torch.abs(k - p)))
            zero = members < 2 or bool(torch.equal(k[1], p[1]))
            rows.append({
                "output": f"pcg_fused.{o} ({route})", "shape": tuple(S),
                "members": members, "shared": shared, "max_abs_err": err,
                "launches": launches,
                "expected_launches": pk.launch_chunks(S, members, device),
                "ok": (err <= 1e-5 and zero
                       and bool(torch.isfinite(k).all())
                       and launches == pk.launch_chunks(S, members,
                                                        device))})
    return rows


def member_bound_ms(S, members: int) -> tuple[float, str]:
    """`bound_ms` of ``members`` smooths of shape ``S`` with an operator
    a member: each member's fields read and written once, its operations
    once."""
    b, by = bound_ms("pcg_fused", S)
    return b * members, by


def time_members(S, members: int, device, n=20) -> dict:
    """Device ms per call (profiler; CUDA events where it records
    nothing) of the member-axis smooth of ``members`` members of shape
    ``S``, an operator a member, and of its plain version (`vmap` of
    `ops.poisson.pcg`), in turns plain, kernel, kernel, plain; and wall
    ms of the kernel's call (CUDA events)."""
    d = member_inputs(S, members, False, 0, device)
    kern, plain = member_variants(d)[0][1:]
    kern(), plain()
    torch.cuda.synchronize()
    wall = _timed(kern, n)
    p1 = device_profile(plain, n, events=True)[0]
    k1 = device_profile(kern, n, events=True)[0]
    k2 = device_profile(kern, n, events=True)[0]
    p2 = device_profile(plain, n, events=True)[0]
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "wall_ms": wall}


# --- the 3D kernels' member forms (a 3D ensemble under torch.func.vmap) -----

# the wrappers with a member form: the seven stencils of the dense step,
# the banded levels' far-field operator and the blocked-level PCG seams'
# six (`ops.attic`)
STENCIL_MEMBERS = ("mult3d", "increment3d", "cfl3d", "bc3d", "div3d",
                   "project3d", "conv_diff3d", "ana_mult3d", "dot3d",
                   "pcg_axpy", "pcg_dir_mult", "pcg_update", "mult3d_stream",
                   "increment3d_stream")
# checked like a member form, but built from two: the fused-iteration
# smoother under `vmap` (two member-form launches an iteration, 12 in a
# 6-iteration smooth: 6 of `pcg_dir_mult`, 6 of `pcg_update`)
MEMBER_COMPOSITES = ("pcg_blocked",)
_MEMBER_WRAPPERS = {"pcg_blocked": ("pcg_dir_mult", "pcg_update")}
_MEMBER_LAUNCHES = {"pcg_blocked": 12}
# one PyTorch call that computes a member form's timed form on the same
# inputs (timed beside it, used nowhere in the port): the members' aa dots
# of ghost-zero fields are one batched vector dot
MEMBER_LIBRARY = {"dot3d": lambda d: (
    lambda: torch.linalg.vecdot(d["r"].reshape(d["M"], -1),
                                d["r"].reshape(d["M"], -1)))}


def stencil_member_inputs(S, members: int, shared: bool, seed, device):
    """``members`` members' seeded fields at shape ``S`` (member m's those
    of `inputs` of seed ``seed + m``), stacked on a leading member axis;
    the operator (``L``, ``D``, ``iD`` and the shadows ``L16``, ``D16``,
    ``iD16``), the time step (also the PCG scalars' β and upd), ν and the
    BC values are member 0's for all where ``shared`` (the step and ν a
    0-d tensor and a number, the BC values numbers), one a member
    otherwise (``(M,)`` and ``(M, 3)`` tensors).  Drawn once a key (kept
    until `clear_inputs`): callers copy a tensor before they write into
    it (`member_args`)."""
    return dict(_member_seeded(tuple(S), members, bool(shared), seed,
                               torch.device(device)))


@functools.lru_cache(maxsize=16)
def _member_seeded(S, members, shared, seed, device) -> dict:
    # drawing 8 members' fields at (98,66,66) on the host takes about a
    # second, and every member form is checked on the same nine keys
    # (chip_smoke's phase 3), which the cache holds all at once
    ds = [inputs(S, seed + m, device) for m in range(members)]
    st = lambda f: torch.stack([f(d) for d in ds]).contiguous()
    op = lambda f: f(ds[0]) if shared else st(f)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "M": members, "shared": shared,
        "L": op(lambda d: d["lev"].L), "D": op(lambda d: d["lev"].D),
        "iD": op(lambda d: d["lev"].iD),
        "L16": op(lambda d: d["L16"]), "D16": op(lambda d: d["D16"]),
        "iD16": op(lambda d: d["iD16"]),
        **{k: st(lambda d, k=k: d[k]) for k in ("x", "eps", "eps16", "r",
                                                "u", "p", "z")},
        "x16": st(lambda d: d["x"].to(torch.bfloat16)),
        "dt": (ds[0]["dt"] if shared else
               torch.tensor([0.37 + 0.01 * m for m in range(members)], **f32)),
        "nu": (ds[0]["nu"] if shared else
               torch.tensor([0.01 * (1 + m) for m in range(members)], **f32)),
        "A": (ds[0]["A"] if shared else torch.tensor(
            [[1.0 + 0.1 * m, 0.05 * m, -0.02 * m] for m in range(members)],
            **f32)),
    }


def stencil_member_variants(name, d) -> list:
    """``[(outputs, fn, plain, args, dims)]`` of stencil ``name``'s member
    form on `stencil_member_inputs` ``d``: ``fn`` the wrapper and ``plain``
    its plain version, both on one member's operands, ``args`` every
    member's (an operand with a member axis where ``dims`` says 0, shared
    where None), so that ``torch.func.vmap(fn, in_dims=dims)(*args)``
    launches the member form.  The forms of `variants`: the operator with
    and without the dot, f32 and bf16 L and x; the increment in f32, bf16
    eps and L16; ``bc3d`` in place in all 16 periodic and outlet forms;
    ``conv_diff3d`` with QUICK, van Leer and minmod, and QUICK on every
    periodic mask; ``ana_mult3d`` with the dot and without it on every
    periodic mask (it reads no operator: ``shared`` changes nothing); the
    PCG seams' wrappers in the forms of `variants`: ``mult3d_stream`` as
    ``mult3d``, ``increment3d_stream`` f32 and L16, ``pcg_dir_mult`` with
    its words (a member's each or shared) and at the seed (none: β = 0),
    f32, bf16 directions and the shadows, ``pcg_update`` (its words a
    member's each or shared) and ``pcg_axpy`` f32, bf16 eps and iD16,
    ``dot3d`` aa, ab, rid and rid on iD16; the composite ``pcg_blocked``
    against the per-pass `ops.poisson.pcg`, f32 and with the shadows,
    member 1's residual zero (its own dead mask)."""
    od = None if d["shared"] else 0     # the operator, dt, ν, A
    # the scalar-step words: shared, or one run a member
    wm, dev = (None if d["shared"] else d["M"]), d["x"].device
    if name in ("mult3d", "mult3d_stream"):
        fn = sk.mult3d if name == "mult3d" else at.mult3d_stream
        return [(("z" + t, "dot" + t) if dot else ("z_nodot" + t,),
                 lambda L, Dd, x, dot=dot: fn(L, Dd, x, dot),
                 lambda L, Dd, x, dot=dot: sk._mult3d_plain(L, Dd, x, dot),
                 (d[Lk], d[Dk], d[xk]), (od, od, 0))
                for t, Lk, Dk, xk in (("", "L", "D", "x"),
                                      ("_L16", "L16", "D16", "x"),
                                      ("_bf16", "L", "D", "x16"),
                                      ("_L16_bf16", "L16", "D16", "x16"))
                for dot in (True, False)]
    if name in ("increment3d", "increment3d_stream"):
        fn = (sk.increment3d if name == "increment3d"
              else at.increment3d_stream)
        return [(("x" + t, "r" + t), fn, sk._increment3d_plain,
                 (d[Lk], d[Dk], d[ek], d["x"], d["r"]), (od, od, 0, 0, 0))
                for t, Lk, Dk, ek in (("", "L", "D", "eps"),
                                      ("_bf16", "L", "D", "eps16"),
                                      ("_L16", "L16", "D16", "eps"))
                if name == "increment3d" or t != "_bf16"]
    if name == "pcg_dir_mult":
        # the iteration's form (β from the words, timed) first, then the
        # seed's (no words: β = 0, eps_prev the residual)
        def dir_mult(tag, op, ek, seed, bf16):
            Lk, Dk, iDk = op
            return (tuple(o + tag for o in ("eps", "z", "words")),
                    lambda L, Dd, e, r, iD, w: at.pcg_dir_mult(
                        L, Dd, e, r, iD, w, bf16),
                    lambda L, Dd, e, r, iD, w: at._pcg_dir_mult_plain(
                        L, Dd, e, r, iD, w, bf16),
                    (d[Lk], d[Dk], d[ek], d["r"], d[iDk],
                     None if seed else words(wm, dev)),
                    (od, od, 0, 0, od, None if seed else od))
        f32, sh = ("L", "D", "iD"), ("L16", "D16", "iD16")
        return [dir_mult("", f32, "eps", False, False),
                dir_mult("_b0", f32, "r", True, False),
                dir_mult("_bf16", f32, "eps16", False, True),
                dir_mult("_b0_bf16", f32, "r", True, True),
                dir_mult("_L16", sh, "eps", False, False),
                dir_mult("_b0_L16", sh, "r", True, False)]
    if name in ("pcg_update", "pcg_axpy"):
        # pcg_update's upd from the words (a member's each or shared),
        # pcg_axpy's a member's or shared
        update = name == "pcg_update"
        plain = at._pcg_update_plain if update else at._axpy_rho_plain
        return [(tuple(o + t for o in ("x", "r", "words" if update
                                       else "rho")),
                 getattr(at, name), plain,
                 (d["x"], d["r"], d[ek], d["z"], d[iDk],
                  words(wm, dev) if update else d["dt"]),
                 (0, 0, 0, 0, od, od))
                for t, ek, iDk in (("", "eps", "iD"),
                                   ("_bf16", "eps16", "iD"),
                                   ("_iD16", "eps", "iD16"))]
    if name == "dot3d":
        # aa first (timed, beside one batched torch.linalg.vecdot); ab on
        # two member fields with non-zero ghosts; rid on the operator's iD
        def dot(tag, mode, ak, bk, bd):
            return ((tag,), lambda a, b: at.dot3d(a, b, mode),
                    lambda a, b: at._dot3d_plain(a, b, mode),
                    (d[ak], d[bk]), (0, bd))
        return [dot("aa", "aa", "r", "r", 0), dot("ab", "ab", "x", "eps", 0),
                dot("rid", "rid", "r", "iD", od),
                dot("rid_iD16", "rid", "r", "iD16", od)]
    if name == "pcg_blocked":
        rz = d["r"].clone()
        if d["M"] > 1:
            rz[1] = 0.0

        def smooth(f16, fn):
            def call(L, Dd, iD, L16, D16, iD16, x, r):
                lev = poisson.PoissonLevel(L=L, D=Dd, iD=iD, blocked=True)
                if f16:
                    lev = dataclasses.replace(lev, L16=L16, D16=D16,
                                              iD16=iD16)
                return fn(lev, x, r)
            return call
        ops = tuple(d[k] for k in ("L", "D", "iD", "L16", "D16", "iD16"))
        return [(("x" + t, "r" + t), smooth(f16, at.pcg_blocked),
                 smooth(f16, poisson.pcg),
                 ops + (torch.zeros_like(rz), rz), (od,) * 6 + (0, 0))
                for t, f16 in (("", False), ("_L16", True))]
    if name == "cfl3d":
        return [((), sk.cfl3d, sk._cfl3d_plain, (d["u"],), (0,))]
    if name == "bc3d":
        # in place on the members' own copy of u (each route fills a copy
        # of its own, `member_args`); the fill is idempotent
        def bc(perdir, save_exit):
            def fill(fn):
                return lambda u, A: fn(
                    u, tuple(A) if isinstance(A, torch.Tensor) else A,
                    save_exit, perdir, inplace=True)
            return ((_tag(perdir, save_exit),), fill(sk.bc3d),
                    fill(bc_vector_planes), (d["u"], d["A"]), (0, od))
        return [bc(q, e) for q in BC_PERDIRS for e in (False, True)]
    if name == "div3d":
        return [(("z", "x"), sk.div3d, sk._div3d_plain,
                 (d["u"], d["p"], d["dt"]), (0, 0, od))]
    if name == "project3d":
        return [(("u", "p"), sk.project3d, sk._project3d_plain,
                 (d["L"], d["x"], d["u"], d["dt"]), (od, 0, 0, od))]
    if name == "conv_diff3d":
        def conv(lim, perdir=()):
            return (("_".join(filter(None, (lim.__name__, _tag(perdir)))),),
                    lambda u, nu: sk.conv_diff3d(u, nu, lim, perdir),
                    lambda u, nu: sk._conv_diff3d_plain(u, nu, lim, perdir),
                    (d["u"], d["nu"]), (0, od))
        return ([conv(lim) for lim in CONV_LIMITERS]
                + [conv(convect.quick, q) for q in CONV_PERDIRS])
    if name == "ana_mult3d":
        # the level's c and periodic axes are every member's: with the dot
        # at c = 1 (timed), then without it at c = 2 on every mask
        def ana(q, c, dot):
            tag = ("z", "dot") if dot else (
                "_".join(filter(None, ("z_c2", _tag(q)))),)
            return (tag, lambda x: sk.ana_mult3d(x, c, q, dot),
                    lambda x: sk._ana_mult3d_plain(x, c, q, dot),
                    (d["x"],), (0,))
        return [ana((), 1.0, True)] + [ana(q, 2.0, False) for q in BC_PERDIRS]
    raise KeyError(name)


def member_args(args) -> list:
    """Copies of a variant's ``args`` (tensors cloned), so that a route
    that fills in place (``bc3d``) fills its own."""
    return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def compare_stencil_members(name, S, members: int, shared: bool, seed,
                            device) -> list[dict]:
    """Stencil ``name``'s member form (``torch.func.vmap`` of its wrapper)
    against ``vmap`` of its plain version, within the kernel's tolerance
    (`TOLERANCE`), and against each member's own one-field call, exactly,
    every form of `stencil_member_variants`; ``bc3d``'s fill also in the
    batched field itself.  A row per form and output: max |d| to each,
    the member form's launches (one a call on CUDA, a composite's its
    sweeps' 12; none on the CPU) and the verdict."""
    d = stencil_member_inputs(S, members, shared, seed, device)
    wrappers = [sk.kernel_wrappers()[k]
                for k in _MEMBER_WRAPPERS.get(name, (name,))]
    launched = lambda: sum(w.launches for w in wrappers)
    expected = _MEMBER_LAUNCHES.get(name, 1)
    cuda = torch.device(device).type == "cuda"
    rows = []
    for outputs, fn, plain, args, dims in stencil_member_variants(name, d):
        kargs = member_args(args)
        before = launched()
        k_out = _outputs(torch.func.vmap(fn, in_dims=dims)(*kargs))
        launches = launched() - before
        p_out = _outputs(torch.func.vmap(plain, in_dims=dims)(
            *member_args(args)))
        sargs = member_args(args)
        singles = [_outputs(fn(*[a[m] if dd == 0 else a
                                 for a, dd in zip(sargs, dims)]))
                   for m in range(members)]
        if name == "bc3d":     # the batched field filled in place
            outputs, k_out = outputs * 2, k_out + (kargs[0],)
            p_out, singles = p_out * 2, [s * 2 for s in singles]
        if cuda:
            torch.cuda.synchronize(device)
        for i, o in enumerate(outputs or ("",)):
            key = ".".join(filter(None, (name, o)))
            k, p = k_out[i].float(), p_out[i].float()
            one = torch.stack([s[i] for s in singles]).float()
            err = float(torch.max(torch.abs(k - p)))
            kind, tol = TOLERANCE[key]
            ok = (bool(torch.equal(k, p)) if kind == "exact"
                  else err <= tol * float(torch.max(torch.abs(p)))
                  if kind == "rel" else err <= tol)
            own = bool(torch.equal(k, one))
            rows.append({
                "output": key + (" (members, in place)" if i >= 1
                                 and name == "bc3d" else " (members)"),
                "shape": tuple(S), "members": members, "shared": shared,
                "max_abs_err": err,
                "single_err": float(torch.max(torch.abs(k - one))),
                "launches": launches,
                "tolerance": kind if tol is None else f"{kind} {tol}",
                "ok": (ok and own and launches == (expected if cuda else 0)
                       and bool(torch.isfinite(k).all()))})
    return rows


def member_stencil_bound_ms(name, S, members: int) -> tuple[float, str]:
    """`bound_ms` of stencil ``name``'s timed form times ``members``."""
    b, by = bound_ms(name, S)
    return b * members, by


def time_stencil_members(name, S, members: int, device, n=20) -> dict:
    """Device ms per call (profiler; CUDA events where it records
    nothing) of stencil ``name``'s member form (its first variant of
    `stencil_member_variants`, an operator, step, ν and BC values a
    member) and of ``vmap`` of its plain version, in turns plain, kernel,
    kernel, plain, each call on the next of `ROTATE` copies of its inputs;
    wall ms a call of the member form (CUDA events); where
    `MEMBER_LIBRARY` has one, the device ms of that PyTorch call on the
    same inputs (``library_ms``)."""
    d = stencil_member_inputs(S, members, False, 0, device)
    _, fn, plain, args, dims = stencil_member_variants(name, d)[0]
    sets = [member_args(args) for _ in range(ROTATE)]
    kern = _rotating([functools.partial(torch.func.vmap(fn, in_dims=dims),
                                        *a) for a in sets])
    pl = _rotating([functools.partial(torch.func.vmap(plain, in_dims=dims),
                                      *a) for a in sets])
    for _ in range(ROTATE):
        kern(), pl()
    torch.cuda.synchronize()
    wall = _timed(kern, n)
    p1 = device_profile(pl, n, events=True)[0]
    k1 = device_profile(kern, n, events=True)[0]
    k2 = device_profile(kern, n, events=True)[0]
    p2 = device_profile(pl, n, events=True)[0]
    b, by = member_stencil_bound_ms(name, S, members)
    lib = None
    if name in MEMBER_LIBRARY:
        call = _rotating([MEMBER_LIBRARY[name](
            {**d, "r": a[0]}) for a in sets])
        call()
        lib = (device_profile(call, n, events=True)[0]
               + device_profile(call, n, events=True)[0]) / 2
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "wall_ms": wall,
            "bound_ms": b, "bound_by": by, "library_ms": lib}
