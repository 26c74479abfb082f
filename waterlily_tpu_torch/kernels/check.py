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
           "inputs", "clear_inputs", "variants", "compare", "time_pair",
           "time_library",
           "ulp_diff", "bound_ms", "bytes_moved", "HBM_BYTES_PER_S",
           "F32_FLOPS_PER_S"]

# csrc file and the TPU kernel (file:line of its function) of each wrapper
SOURCES = {
    "mult3d": ("waterlily_tpu_torch/csrc/poisson_stencil.cu",
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
    "mult3d_stream": ("waterlily_tpu_torch/csrc/stream_stencil.cu",
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

# Periodic axes of the checked variants: bc3d's and conv_diff3d's are the
# JAX package's own test sets (tests/test_pallas_stencil.py), pcg_fused's
# those of the 3D and 2D Taylor-Green cases and tests/test_pallas.py.
BC_PERDIRS = ((), (1,), (0, 2), (0, 1, 2))
CONV_PERDIRS = ((0,), (1,), (2,), (0, 2), (0, 1, 2))
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
    "mult3d.z": ("exact", None), "mult3d.dot": ("rel", 1e-5),
    "increment3d.x": ("exact", None), "increment3d.r": ("exact", None),
    "cfl3d": ("exact", None), "bc3d": ("exact", None),
    "div3d.z": ("exact", None), "div3d.x": ("exact", None),
    "project3d.u": ("exact", None), "project3d.p": ("exact", None),
    "conv_diff3d.quick": ("exact", None), "conv_diff3d.vanleer": ("exact", None),
    "pcg_fused.x": ("abs", 1e-5), "pcg_fused.r": ("abs", 1e-5),
    "ana_mult3d.z": ("exact", None), "ana_mult3d.dot": ("rel", 1e-5),
    "ana_mult3d.z_c2": ("exact", None),
    "ana_mult3d.z_periodic": ("exact", None),
    **{f"bc3d.{_tag(p, e)}": ("exact", None)
       for p in BC_PERDIRS for e in (False, True) if p or e},
    **{f"conv_diff3d.{lim}_{_tag(p)}": ("exact", None)
       for lim in ("quick", "vanleer") for p in CONV_PERDIRS},
    **{f"pcg_fused.{o}_{_tag(p)}": ("abs", 1e-5)
       for ps in PCG_PERDIRS.values() for p in ps for o in "xr"},
    "mult3d.z_bf16": ("exact", None), "mult3d.dot_bf16": ("rel", 1e-5),
    "increment3d.x_bf16": ("exact", None),
    "increment3d.r_bf16": ("exact", None),
    **{f"pcg_dir_mult.{o}{t}": (("rel", 1e-5) if o in ("den", "rho")
                                else ("exact", None))
       for o in ("eps", "z", "den", "rho")
       for t in ("", "_b0", "_bf16", "_b0_bf16")},
    **{f"{k}.{o}{t}": ("rel", 1e-5) if o == "rho" else ("exact", None)
       for k in ("pcg_update", "pcg_axpy") for o in ("x", "r", "rho")
       for t in ("", "_bf16")},
    "dot3d.aa": ("rel", 1e-5), "dot3d.ab": ("rel", 1e-5),
    "dot3d.rid": ("rel", 1e-5),
    "pcg_blocked.x": ("abs", 1e-5), "pcg_blocked.r": ("abs", 1e-5),
    # the operator-shadow forms (bf16 L with the f32 D16, bf16 iD)
    "mult3d.z_L16": ("exact", None), "mult3d.dot_L16": ("rel", 1e-5),
    "increment3d.x_L16": ("exact", None),
    "increment3d.r_L16": ("exact", None),
    **{f"pcg_dir_mult.{o}{t}": (("rel", 1e-5) if o in ("den", "rho")
                                else ("exact", None))
       for o in ("eps", "z", "den", "rho") for t in ("_L16", "_b0_L16")},
    **{f"{k}.{o}_iD16": ("rel", 1e-5) if o == "rho" else ("exact", None)
       for k in ("pcg_update", "pcg_axpy") for o in ("x", "r", "rho")},
    "dot3d.rid_iD16": ("rel", 1e-5),
    "pcg_blocked.x_L16": ("abs", 1e-5), "pcg_blocked.r_L16": ("abs", 1e-5),
    # the carried-rows operator, with and without the dot, f32 and bf16 L
    **{f"mult3d_stream.{o}{t}": ("rel", 1e-5) if o == "dot"
       else ("exact", None)
       for o in ("z", "dot", "z_nodot") for t in ("", "_L16")},
    **{f"increment3d_stream.{o}{t}": ("exact", None)
       for o in ("x", "r") for t in ("", "_L16")},
    "copy_probe": ("exact", None), "roll_probe": ("exact", None),
}


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
    bc = lambda perdir, save_exit: (
        (_tag(perdir, save_exit),),
        lambda: sk.bc3d(u, d["A"], save_exit, perdir),
        lambda: bc_vector_planes(u, d["A"], save_exit, perdir))
    def dir_mult(tag, eps_prev, beta, bf16, op=(L, Dd, iD)):
        Lc, Dc, iDc = op
        return (tuple(o + tag for o in ("eps", "z", "den", "rho")),
                lambda: at.pcg_dir_mult(Lc, Dc, eps_prev, r, iDc, beta, bf16),
                lambda: at._pcg_dir_mult_plain(Lc, Dc, eps_prev, r, iDc,
                                               beta, bf16))

    def axpy_rho(name, tag, e, iDa=iD):
        return (tuple(o + tag for o in ("x", "r", "rho")),
                lambda: getattr(at, name)(x, r, e, z, iDa, s),
                lambda: at._axpy_rho_plain(x, r, e, z, iDa, s))

    def dot(mode, a, b, tag=""):
        return ((mode + tag,), lambda: at.dot3d(a, b, mode),
                lambda: at._dot3d_plain(a, b, mode))

    def stream(tag, Lc, Dc, with_dot):
        outs = ("z" + tag, "dot" + tag) if with_dot else ("z_nodot" + tag,)
        return (outs, lambda: at.mult3d_stream(Lc, Dc, x, with_dot),
                lambda: sk._mult3d_plain(Lc, Dc, x, with_dot))

    def probe(fn, plain):
        return ((), lambda: fn(x), lambda: plain(x))

    # a blocked level with the operator shadows (pcg_blocked reads the
    # level's flags, not the kernel gate)
    lev16 = dataclasses.replace(lev, blocked=True, bf16_eps=False, L16=L16,
                                D16=D16, iD16=iD16)

    return {
        "mult3d": [(("z", "dot"), lambda: sk.mult3d(L, Dd, x, with_dot=True),
                    lambda: sk._mult3d_plain(L, Dd, x, with_dot=True)),
                   (("z_bf16", "dot_bf16"),
                    lambda: sk.mult3d(L, Dd, x16, with_dot=True),
                    lambda: sk._mult3d_plain(L, Dd, x16, with_dot=True)),
                   (("z_L16", "dot_L16"),
                    lambda: sk.mult3d(L16, D16, x, with_dot=True),
                    lambda: sk._mult3d_plain(L16, D16, x, with_dot=True))],
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
        "pcg_dir_mult": [dir_mult("", eps, s, False),
                         dir_mult("_b0", r, 0.0, False),
                         dir_mult("_bf16", eps16, s, True),
                         dir_mult("_b0_bf16", r, 0.0, True),
                         dir_mult("_L16", eps, s, False, (L16, D16, iD16)),
                         dir_mult("_b0_L16", r, 0.0, False,
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
        # the timed (first) form is the PCG iteration's, with the dot
        "mult3d_stream": [stream("", L, Dd, True), stream("", L, Dd, False),
                          stream("_L16", L16, D16, True),
                          stream("_L16", L16, D16, False)],
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
        "conv_diff3d": [conv(convect.quick), conv(convect.vanleer)]
        + [conv(lim, q) for lim in (convect.quick, convect.vanleer)
           for q in CONV_PERDIRS],
        "pcg_fused": [pcg()] + [pcg(q) for q in PCG_PERDIRS[3]],
        "ana_mult3d": [
            (("z", "dot"), lambda: sk.ana_mult3d(x, 1.0, with_dot=True),
             lambda: sk._ana_mult3d_plain(x, 1.0, with_dot=True)),
            (("z_c2",), lambda: sk.ana_mult3d(x, 2.0),
             lambda: sk._ana_mult3d_plain(x, 2.0)),
            (("z_periodic",), lambda: sk.ana_mult3d(x, 2.0, (1,)),
             lambda: sk._ana_mult3d_plain(x, 2.0, (1,)))],
    }[name]


KERNELS = tuple(SOURCES)

# The card's published peaks (H100 SXM data sheet, at the 700 W limit):
# device memory rate and f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Work of the first (timed) variant of each kernel per cell: f32 fields it
# must read once and write once, and its float operations (the dots' and
# maxima's reduction counted as one add per cell).  pcg_fused counts all
# six iterations of its smooth, conv_diff3d the nine face fluxes a cell
# owns (about twenty operations each, the limiter included).
_WORK = {
    "mult3d": (6, 15),          # L(3), D, x in; z out
    "increment3d": (9, 15),     # L(3), D, eps, x, r in; x, r out
    "cfl3d": (3, 13),           # u(3) in
    "bc3d": (6, 0),             # u(3) in, u(3) out
    "div3d": (6, 6),            # u(3), p in; z, x out
    "project3d": (11, 10),      # L(3), x, u(3) in; u(3), p out
    "conv_diff3d": (6, 200),    # u(3) in, r(3) out
    "pcg_fused": (9, 150),      # L(3), D, iD, x, r in; x, r out
    "ana_mult3d": (2, 22),      # x in, z out
    "pcg_dir_mult": (9, 21),    # L(3), D, eps_prev, r, iD in; eps, z out
    "pcg_update": (7, 8),       # x, r, eps, z, iD in; x, r out
    "dot3d": (1, 2),            # aa: a in
    "pcg_axpy": (7, 8),         # x, r, eps, z, iD in; x, r out
    "mult3d_stream": (6, 15),   # L(3), D, x in; z out (with the dot)
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
# operations a cell fewer
_WORK_FORMS = {
    ("mult3d", "z_bf16"): (5.5, 15), ("increment3d", "x_bf16"): (8.5, 15),
    ("pcg_dir_mult", "eps_bf16"): (8, 21), ("pcg_update", "x_bf16"): (6.5, 8),
    ("pcg_axpy", "x_bf16"): (6.5, 8), ("dot3d", "ab"): (2, 2),
    ("dot3d", "rid"): (2, 3),
    ("mult3d", "z_L16"): (4.5, 15), ("increment3d", "x_L16"): (7.5, 15),
    ("pcg_dir_mult", "eps_L16"): (7, 21), ("pcg_update", "x_iD16"): (6.5, 8),
    ("pcg_axpy", "x_iD16"): (6.5, 8), ("dot3d", "rid_iD16"): (1.5, 3),
    ("mult3d_stream", "z_nodot"): (6, 13),
    ("mult3d_stream", "z_L16"): (4.5, 15),
    ("mult3d_stream", "z_nodot_L16"): (4.5, 13),
    ("increment3d_stream", "x_L16"): (7.5, 15),
}


def _work(name, S, variant=None):
    return _WORK_FORMS.get(
        (name, variant), (_WORK_2D if len(S) == 2 else _WORK)[name])


def bytes_moved(name, S, variant=None) -> float:
    """Bytes kernel ``name``'s timed variant (or the form whose first output
    is ``variant``) must move at shape ``S``: each input read once, each
    output written once, a bf16 field at half."""
    return 4 * _work(name, S, variant)[0] * math.prod(S)


def bound_ms(name, S, variant=None) -> tuple[float, str]:
    """The least time the card could take for kernel ``name``'s timed
    variant (or the form whose first output is ``variant``) at shape
    ``S``: the larger of its bytes over the memory rate and its operations
    over the f32 rate, in ms, and which of the two bounds it ("bytes" or
    "operations")."""
    t_bytes = bytes_moved(name, S, variant) / HBM_BYTES_PER_S * 1e3
    t_ops = _work(name, S, variant)[1] * math.prod(S) / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two f32
    tensors (signed zeros count as equal)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(torch.max(torch.abs(ordered(a) - ordered(b))))


def compare(name, S, seed, device) -> list[dict]:
    """Run kernel ``name`` and its plain version at shape ``S``; one row per
    output with its max |diff|, max ulp distance and pass verdict."""
    rows = []
    pairs = []
    d = _fresh_inputs(S, seed, device)
    for outputs, kern, plain in variants(name, d):
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


def _variant(name, d, variant):
    """Variant ``variant`` of `variants`: its index, or its first output's
    name ("" for a variant with none)."""
    vs = variants(name, d)
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
    """Free the inputs `compare` and the timings keep for reuse."""
    _seeded.cache_clear()


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
    return (device_profile(fn, n)[0] + device_profile(fn, n)[0]) / 2


def time_pair(name, S, device, n=20, variant=0) -> dict:
    """Per-call times of kernel ``name``'s variant ``variant`` (index or
    first output name, `_variant`) and its plain version at shape ``S``,
    over ``n`` back-to-back calls, each on the next of `ROTATE` input
    sets: device time from `torch.profiler` (`utils.perf.device_profile`:
    the card's busy time for one call, every kernel, fill and copy it
    launches) and wall time from CUDA events (the host's dispatch
    included).  Measured in turns plain, kernel, kernel, plain after a
    warm-up, first wall, then device; each is the mean of its two
    runs."""
    sets = [_variant(name, d, variant) for d in _input_sets(S, device)]
    for _, k, p in sets:
        k(), p()
    torch.cuda.synchronize()
    kern = _rotating([k for _, k, _ in sets])
    plain = _rotating([p for _, _, p in sets])
    pw1 = _timed(plain, n)
    kw1 = _timed(kern, n)
    kw2 = _timed(kern, n)
    pw2 = _timed(plain, n)
    p1 = device_profile(plain, n)[0]
    k1 = device_profile(kern, n)[0]
    k2 = device_profile(kern, n)[0]
    p2 = device_profile(plain, n)[0]
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "wall_ms": (kw1 + kw2) / 2, "plain_wall_ms": (pw1 + pw2) / 2}
