"""Wrappers, plain versions and launch counters of the blocked levels'
PCG iteration kernels and carried-rows operator, and the smoother built
from two of them.

Counterpart of `waterlily_tpu.ops.attic`: its fused-iteration sweeps
(`pcg_dir_mult`, `pcg_update`, `pcg_blocked`), solver-dot reduction kernels
(`dot3d`, `pcg_axpy`) and carried-rows operator (`mult3d_stream`,
`increment3d_stream`).  The JAX package retired these kernels on the TPU,
where they lost their A/Bs; here they are the fused forms of the big 3D
levels' PCG iteration and operator, reached through four module flags of
`ops.poisson`, all off by default: ``KDOT`` (`dot3d` for the solver dots),
``KAXPY`` (`pcg_axpy` for the axpy pair and next rho), ``PCG_BLOCKED``
(`pcg_blocked` as the smoother of blocked, non-periodic, non-banded
levels) and ``STREAM`` (`mult3d_stream` and `increment3d_stream` for the
blocked levels' A·x and r − A·eps).

As in `ops.stencil_kernels`, each wrapper launches its hand-written CUDA
kernel (``csrc/pcg_iter.cu``, ``csrc/reduce.cu``, ``csrc/stream_stencil.cu``)
on CUDA tensors, runs its plain PyTorch version on CPU tensors and raises on
any other device or on a CUDA tensor its kernel does not take; it counts its
launches in ``.launches``, its shapes in ``.shapes`` and its bf16 forms in
``.forms``.  Scalars (``beta``, ``upd``) may be 0-d device tensors, so a
smooth never synchronises with the host.  Every sum is over the interior
(ghost cells masked), taken in per-block partials and reduced on the
device.  A search direction may be stored in bf16 (`PoissonLevel.bf16_eps`);
it is upcast before it meets an f32 scalar, as JAX promotes
``f32_scalar * bf16_array`` to f32 (PyTorch would keep bf16).  A level's
operator shadows (`PoissonLevel.L16`, ``iD16``) pass as bf16 ``L`` and
``iD``, upcast where they are read.
"""
from __future__ import annotations

import functools

import torch

from ..grid import interior_view
from ..kernels.build import launch, library
from .stencil_kernels import (_on_cpu, _check, _scalar_on, _counted, _count,
                              _bf16, _blocks, _wide, _mult3d_plain,
                              _increment3d_plain)

__all__ = ["pcg_dir_mult", "pcg_update", "pcg_blocked", "dot3d", "pcg_axpy",
           "mult3d_stream", "increment3d_stream", "kernel_wrappers"]


def _interior_sum(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(interior_view(v, v.ndim))


# --- the fused PCG iteration: pcg_dir_mult, pcg_update, pcg_blocked --------

def _pcg_dir_mult_plain(L, Dd, eps_prev, r, iD, beta, bf16=False):
    eps = beta * _wide(eps_prev) + r * iD
    if bf16:
        eps = eps.to(torch.bfloat16)
    z = _mult3d_plain(L, Dd, eps)
    return (eps, z, _interior_sum(z * _wide(eps)),
            _interior_sum(r * (r * iD)))


@_counted
def pcg_dir_mult(L, Dd, eps_prev, r, iD, beta, bf16: bool = False):
    """``(eps, z, ⟨z, eps⟩, ⟨r, r∘iD⟩)`` in one sweep: the search direction
    ``eps = beta·eps_prev + r∘iD`` (rounded to bf16 with ``bf16``), ``z =
    A·eps`` applied to the rounded direction in f32, and the two interior
    dots, the second from the unrounded ``r∘iD`` (the rho seed at
    ``beta = 0``, where ``eps_prev`` must be finite: pass ``r``).
    ``eps_prev`` may be bf16; a new ``eps`` is written (never in place).
    ``L`` and ``iD`` may be a level's bf16 shadows L16 and iD16 (both, with
    the f32 D16), upcast where they are read."""
    S = tuple(r.shape)
    if _on_cpu("pcg_dir_mult", r):
        return _pcg_dir_mult_plain(L, Dd, eps_prev, r, iD, beta, bf16)
    _check("pcg_dir_mult", S, bf16=("eps_prev", "L", "iD"),
           L=(L, (3,) + S), D=(Dd, S), eps_prev=(eps_prev, S), r=(r, S),
           iD=(iD, S))
    if L.dtype != iD.dtype:
        raise TypeError(f"pcg_dir_mult: L is {L.dtype} and iD {iD.dtype}; "
                        "the kernel takes both f32 or both bf16 (a level's "
                        "L16 and iD16)")
    eps = torch.empty(S, dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=r.device)
    z = torch.empty_like(r)
    part = torch.empty((2, _blocks(S)), dtype=torch.float32, device=r.device)
    launch("wl_pcg_dir_mult", L, Dd, eps_prev, r, iD,
           _scalar_on(beta, r, "pcg_dir_mult"), eps, z, part,
           _bf16(eps_prev), int(bool(bf16)), _bf16(L), *S)
    _count(pcg_dir_mult, S, L=L, iD=iD, eps_prev=eps_prev, eps=eps)
    sums = torch.sum(part, dim=1)
    return eps, z, sums[0], sums[1]


def _axpy_rho_plain(x, r, eps, z, iD, upd):
    x = x + upd * _wide(eps)
    r = r - upd * z
    return x, r, _interior_sum(r * (r * iD))


def _axpy_rho(wrapper, name, x, r, eps, z, iD, upd):
    """``(x + upd·eps, r − upd·z, ⟨r', r'∘iD⟩)``: the kernel shared by
    `pcg_update` and `pcg_axpy` (``csrc/pcg_axpy.cuh``), counted on
    ``wrapper``; ``eps`` and ``iD`` (a level's iD16) may be bf16.  New x
    and r are written (nothing in place)."""
    S = tuple(x.shape)
    if _on_cpu(name, x):
        return _axpy_rho_plain(x, r, eps, z, iD, upd)
    _check(name, S, bf16=("eps", "iD"), x=(x, S), r=(r, S), eps=(eps, S),
           z=(z, S), iD=(iD, S))
    x_out = torch.empty_like(x)
    r_out = torch.empty_like(r)
    part = torch.empty(_blocks(S), dtype=torch.float32, device=x.device)
    launch(f"wl_{name}", x, r, eps, z, iD, _scalar_on(upd, x, name), x_out,
           r_out, part, _bf16(eps), _bf16(iD), *S)
    _count(wrapper, S, eps=eps, iD=iD)
    return x_out, r_out, torch.sum(part)


@_counted
def pcg_update(x, r, eps, z, iD, upd):
    """The fused iteration's second sweep: ``(x + upd·eps, r − upd·z,
    ⟨r', r'∘iD⟩)``; ``eps`` and ``iD`` may be bf16."""
    return _axpy_rho(pcg_update, "pcg_update", x, r, eps, z, iD, upd)


def pcg_blocked(lev, x, r, it: int = 6):
    """Whole PCG smooth from the two fused-iteration sweeps, the
    restructure of `ops.poisson.pcg` by `waterlily_tpu.ops.attic.
    pcg_blocked`: the same dead-mask early exits in 0-d device tensors;
    the denominator of iteration i+1 comes from the sweep that rebuilds
    eps at the end of iteration i.  Two launches per iteration, no other
    full-grid pass.  A level with operator shadows applies L16/D16 and
    preconditions with iD16, as JAX's does.  Non-periodic, non-banded
    levels only: the in-kernel eps rebuild fills no periodic ghosts and
    reads the dense coefficients.  Returns new ``(x, r)``."""
    if lev.perdir or lev.banded:
        raise ValueError("pcg_blocked: the fused iteration takes dense, "
                         "non-periodic levels only (got perdir="
                         f"{lev.perdir}, banded={lev.banded})")
    from .poisson import _opLD, _iDk
    dt = x.dtype
    teneps = 10 * torch.finfo(dt).eps
    bf16 = lev.bf16_eps
    L, Dd = _opLD(lev)
    iD = _iDk(lev)
    eps, z, denom, rho = pcg_dir_mult(L, Dd, r, r, iD, 0.0, bf16)
    dead = torch.abs(rho) < teneps
    for i in range(it):
        alpha = torch.where(dead | (denom == 0), 0.0,
                            rho / torch.where(denom == 0, 1.0, denom)).to(dt)
        dead = dead | (torch.abs(alpha) < 1e-2) | (torch.abs(alpha) > 1e2)
        upd = torch.where(dead, 0.0, alpha).to(dt)
        x, r, rho2 = pcg_update(x, r, eps, z, iD, upd)
        if i == it - 1:
            break
        dead = dead | (torch.abs(rho2) < teneps)
        beta = torch.where(dead, 0.0,
                           rho2 / torch.where(rho == 0, 1.0, rho)).to(dt)
        eps, z, denom, _ = pcg_dir_mult(L, Dd, eps, r, iD, beta, bf16)
        rho = torch.where(dead, rho, rho2)
    return x, r


# --- solver dots and the axpy sweep: dot3d, pcg_axpy ----------------------------

_DOT_MODES = {"aa": 0, "ab": 1, "rid": 2}
# dot3d's blocks (at most one per interior row): each sums whole rows, so
# the order of the sum depends on the shape alone (csrc/reduce.cu)
DOT_BLOCKS = 1024


def _dot3d_plain(a, b, mode):
    A = interior_view(a, a.ndim)
    if mode == "aa":
        return torch.sum(A * A)
    B = interior_view(b, b.ndim)
    return torch.sum(A * (A * B) if mode == "rid" else A * B)


@_counted
def dot3d(a, b, mode=None):
    """Interior dot as a 0-d tensor: ``⟨a, b⟩`` (``mode="ab"``), ``⟨a, a⟩``
    (``"aa"``, one stream read; the default when ``b is a``) or ``⟨a, a∘b⟩``
    (``"rid"``: PCG's rho against the Jacobi-preconditioned residual,
    without writing the product; ``b`` may be a level's bf16 iD16).
    Equals `grid.field_dot` on ghost-zero operands up to the order of the
    sum."""
    if mode is None:
        mode = "aa" if b is a else "ab"
    if mode not in _DOT_MODES:
        raise ValueError(f"dot3d: mode {mode!r} is not one of "
                         f"{sorted(_DOT_MODES)}")
    S = tuple(a.shape)
    if _on_cpu("dot3d", a):
        return _dot3d_plain(a, b, mode)
    ops = {"a": (a, S)} if mode == "aa" else {"a": (a, S), "b": (b, S)}
    _check("dot3d", S, bf16=("b",) if mode == "rid" else (), **ops)
    blocks = min((S[0] - 2) * (S[1] - 2), DOT_BLOCKS)
    part = torch.empty(blocks, dtype=torch.float32, device=a.device)
    launch("wl_dot3d", a, None if mode == "aa" else b, part, _DOT_MODES[mode],
           0 if mode == "aa" else _bf16(b), blocks, *S)
    _count(dot3d, S, a=a, **({} if mode == "aa" else {"b": b}))
    return torch.sum(part)


@_counted
def pcg_axpy(x, r, eps, z, iD, upd):
    """The PCG iteration's axpy pair and next rho in one sweep: ``(x +
    upd·eps, r − upd·z, ⟨r', r'∘iD⟩)``; ``eps`` and ``iD`` may be bf16
    (upcast), ``upd`` is the dead-masked step."""
    return _axpy_rho(pcg_axpy, "pcg_axpy", x, r, eps, z, iD, upd)


# --- the carried-rows operator: mult3d_stream, increment3d_stream ----------

# the most and the fewest axis-0 rows a carried-rows block marches down,
# and the blocks a grid should give the card (about 2.6 waves of the 132
# SMs at 6 resident blocks each)
STREAM_ROWS = (4, 32)
STREAM_BLOCKS = 2048


@functools.cache
def _stream_tile() -> tuple[int, int]:
    """The (axis 1, axis 2) columns of one carried-rows block, as the
    kernel library was built with them (csrc/stream_stencil.cu ST_TJ,
    ST_TK)."""
    lib = library()
    return lib.wl_stream_tile(1), lib.wl_stream_tile(2)


def _stream_rows(S, tile) -> int:
    """Rows of each block's march: the fewest chunks of at most
    ``STREAM_ROWS[1]`` rows, more where the grid's ``tile`` s would give
    the card fewer than `STREAM_BLOCKS` blocks, down to chunks of
    ``STREAM_ROWS[0]``; balanced over S[0].  With (8, 32) tiles 258³
    marches 9 chunks of 29 rows (2673 blocks), 130³ 22 of 6, 66³ 17 of 4:
    a small level's blocks would otherwise be too few to fill the card,
    each walking many rows."""
    lo, hi = STREAM_ROWS
    tiles = -(-S[1] // tile[0]) * -(-S[2] // tile[1])
    chunks = max(-(-S[0] // hi),
                 min(-(-STREAM_BLOCKS // tiles), -(-S[0] // lo)))
    return -(-S[0] // chunks)


def _stream_blocks(S, rows: int, tile) -> int:
    return -(-S[0] // rows) * -(-S[1] // tile[0]) * -(-S[2] // tile[1])


@_counted
def mult3d_stream(L, Dd, x, with_dot: bool = False):
    """z = A·x (and with ``with_dot`` ⟨A·x, x⟩ as a 0-d tensor), the
    function of `stencil_kernels.mult3d`, by the carried-rows kernel: each
    thread marches its (axis 1, axis 2) column down a chunk of axis-0 rows
    with x and L0 carried in registers, so every input row is read once.
    ``L`` (a level's L16) and ``x`` may be bf16; every shape is taken.
    Periodic ghosts of ``x`` must be filled by the caller."""
    S = tuple(x.shape)
    if _on_cpu("mult3d_stream", x):
        return _mult3d_plain(L, Dd, x, with_dot)
    _check("mult3d_stream", S, bf16=("L", "x"), L=(L, (3,) + S), D=(Dd, S),
           x=(x, S))
    tile = _stream_tile()
    rows = _stream_rows(S, tile)
    z = torch.empty(S, dtype=torch.float32, device=x.device)
    part = (torch.empty(_stream_blocks(S, rows, tile), dtype=torch.float32,
                        device=x.device) if with_dot else None)
    launch("wl_mult3d_stream", L, Dd, x, z, part, _bf16(L), _bf16(x), rows,
           *S)
    _count(mult3d_stream, S, L=L, x=x)
    return (z, torch.sum(part)) if with_dot else z


@_counted
def increment3d_stream(L, Dd, eps, x, r):
    """(x + eps, r − A·eps), the function of `stencil_kernels.increment3d`,
    by the carried-rows kernel, which also writes x + eps from the eps it
    reads once.  ``L`` and ``eps`` may be bf16.  Returns new tensors."""
    S = tuple(x.shape)
    if _on_cpu("increment3d_stream", x):
        return _increment3d_plain(L, Dd, eps, x, r)
    _check("increment3d_stream", S, bf16=("L", "eps"), L=(L, (3,) + S),
           D=(Dd, S), eps=(eps, S), x=(x, S), r=(r, S))
    x_out = torch.empty_like(x)
    r_out = torch.empty_like(r)
    launch("wl_increment3d_stream", L, Dd, eps, x, r, x_out, r_out,
           _bf16(L), _bf16(eps), _stream_rows(S, _stream_tile()), *S)
    _count(increment3d_stream, S, L=L, eps=eps)
    return x_out, r_out


def kernel_wrappers() -> dict:
    """Name → wrapper of this module's kernels."""
    return {"pcg_dir_mult": pcg_dir_mult, "pcg_update": pcg_update,
            "dot3d": dot3d, "pcg_axpy": pcg_axpy,
            "mult3d_stream": mult3d_stream,
            "increment3d_stream": increment3d_stream}
