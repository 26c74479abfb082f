"""Kernel-versus-plain checks and timings on a CUDA device.

Each case builds numpy-seeded inputs at a given shape, runs a kernel's
wrapper and its plain PyTorch version on the same device tensors and
returns the largest differences.  `chip_smoke.py` and
``tests/test_torch_kernels.py`` use these cases; neither falls back to the
plain version when a kernel fails.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import stencil_kernels as sk
from ..ops import pcg_kernel as pk
from ..ops import poisson, convect
from ..ops.bc import bc_vector_planes
from ..utils.perf import device_profile

__all__ = ["KERNELS", "TOLERANCE", "SOURCES", "inputs", "variants", "compare",
           "time_pair", "ulp_diff", "bound_ms", "HBM_BYTES_PER_S",
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
}

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
# (the mult3d dot, pcg's dots) are the only inexact outputs.
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
}


def inputs(S, seed, device) -> dict:
    """Seeded fields at ghost-padded shape ``S`` (2D or 3D): a level built
    from positive face coefficients with wall-normal ghosts zeroed (a μ₀),
    a right-hand side and residual with zero ghosts, a velocity, a pressure
    and a time step on the device.  ``level(perdir)`` builds the level and
    residual of the same coefficients and right-hand side with periodic
    axes ``perdir``."""
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
    return {
        "lev": lev, "r": r, "level": level,
        "x": t(rng.standard_normal(S)),
        "eps": t(np.where(inner, rng.standard_normal(S) * 0.1, 0.0)),
        "u": t(rng.standard_normal((D,) + S)),
        "p": t(rng.standard_normal(S)),
        "dt": torch.full((), 0.37, dtype=torch.float32, device=device),
        "A": (1.0, 0.0, 0.0), "nu": 0.01,
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
    return {
        "mult3d": [(("z", "dot"), lambda: sk.mult3d(L, Dd, x, with_dot=True),
                    lambda: sk._mult3d_plain(L, Dd, x, with_dot=True))],
        "increment3d": [(("x", "r"),
                         lambda: sk.increment3d(L, Dd, eps, x, r),
                         lambda: sk._increment3d_plain(L, Dd, eps, x, r))],
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
}
# the same at a 2D shape (only pcg_fused has a 2D form): L(2) instead of
# L(3), and two neighbours (four operations) fewer in each of six matvecs
_WORK_2D = {"pcg_fused": (8, 126)}


def bound_ms(name, S) -> tuple[float, str]:
    """The least time the card could take for kernel ``name``'s timed
    variant at shape ``S``: the larger of its bytes over the memory rate
    and its operations over the f32 rate, in ms, and which of the two
    bounds it ("bytes" or "operations")."""
    fields, flops = (_WORK_2D if len(S) == 2 else _WORK)[name]
    n = math.prod(S)
    t_bytes = 4 * fields * n / HBM_BYTES_PER_S * 1e3
    t_ops = flops * n / F32_FLOPS_PER_S * 1e3
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
    for outputs, kern, plain in variants(name, inputs(S, seed, device)):
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


def time_pair(name, S, device, n=20, variant=0) -> dict:
    """Per-call times of kernel ``name``'s variant ``variant`` (index or
    first output name, `_variant`) and its plain version at shape
    ``S``: device time from `torch.profiler` (the card's busy time for
    one call: every kernel, fill and copy it launches) and wall time per
    call from CUDA events over ``n`` back-to-back calls (includes the host
    dispatch).  Measured in turns plain, kernel, kernel, plain after a
    warm-up; the device time is the larger of each side's two sessions
    (a session that lost events reads low), the wall time their mean."""
    _, kern, plain = _variant(name, inputs(S, 0, device), variant)
    kern(), plain()
    torch.cuda.synchronize()
    p1 = device_profile(plain, n)[0]
    k1 = device_profile(kern, n)[0]
    k2 = device_profile(kern, n)[0]
    p2 = device_profile(plain, n)[0]
    pw1 = _timed(plain, n)
    kw1 = _timed(kern, n)
    kw2 = _timed(kern, n)
    pw2 = _timed(plain, n)
    return {"ms": max(k1, k2), "plain_ms": max(p1, p2),
            "wall_ms": (kw1 + kw2) / 2, "plain_wall_ms": (pw1 + pw2) / 2}
