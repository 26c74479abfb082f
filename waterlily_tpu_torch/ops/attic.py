"""Wrappers, plain versions and launch counters of the blocked levels'
PCG iteration kernels and carried-rows operator, and the smoother built
from two of them.

Counterpart of `waterlily_tpu.ops.attic`: its fused-iteration sweeps
(`pcg_dir_mult`, `pcg_update`, `pcg_blocked`), solver-dot reduction kernels
(`dot3d`, `pcg_axpy`) and carried-rows operator (`mult3d_stream`,
`increment3d_stream`).  The JAX package retired these kernels on the TPU,
where they lost their A/Bs; here they are the fused forms of the big 3D
levels' PCG iteration and operator.  `pcg_blocked` is the default
smoother of blocked, non-periodic, non-banded levels (`ops.poisson.
smooth`), its two sweeps taking the PCG's scalar step too; the rest are
reached through three module flags of `ops.poisson`, all off by default,
in the plain `pcg`: ``KDOT`` (`dot3d` for the solver dots), ``KAXPY``
(`pcg_axpy` for the axpy pair and next rho) and ``STREAM``
(`mult3d_stream` and `increment3d_stream` for the blocked levels' A·x and
r − A·eps).  `mult3d_stream`'s kernel is also
the default path's: `stencil_kernels.mult3d` launches it through the same
helper (`_mult3d_march`), so ``STREAM`` now differs from the default only
in `increment3d_stream`.

As in `ops.stencil_kernels`, each wrapper launches its hand-written CUDA
kernel (``csrc/pcg_iter.cu``, ``csrc/reduce.cu``, ``csrc/stream_march.cu``,
``csrc/stream_stencil.cu``) on CUDA tensors, runs its plain PyTorch
version on CPU tensors and raises on any other device or on a CUDA tensor
its kernel does not take; it counts its launches in ``.launches``, by
shape in ``.shapes`` and its bf16 forms in ``.forms``.  `pcg_axpy`'s
``upd`` may be a 0-d device tensor, and the fused iteration's sweeps read
their scalars from a smooth's words on the device, so a smooth never
synchronises with the host.  Every sum is over the interior
(ghost cells masked), taken in per-block partials that the kernel's last
block reduces in index order: each call is one launch, and its sums the
same bits on every call.  A search direction may be stored in bf16
(`PoissonLevel.bf16_eps`); it is upcast before it meets an f32 scalar, as
JAX promotes ``f32_scalar * bf16_array`` to f32 (PyTorch would keep bf16).
A level's operator shadows (`PoissonLevel.L16`, ``iD16``) pass as bf16
``L`` and ``iD``, upcast where they are read.

Every wrapper has a member form (an ensemble under `torch.func.vmap`, as
`stencil_kernels.mult3d`'s): handed operands that `vmap` alone batches
(`stencil_kernels.vmap_only`), it enters its `autograd.Function`
(`stencil_kernels._member_function`), whose `vmap` rule folds every
`vmap` level into one member axis and launches the kernel once for all
members, each member's work and sums those of its own launch, bit for
bit; an operand without a member axis (a level's shared operator) is
shared at a member stride of 0, `pcg_axpy`'s ``upd`` may be a number,
a 0-d tensor or one value a member, and the words one run a member or
shared.  `pcg_blocked` under `vmap` is then two member-form
launches an iteration for all members, its words one run a member on the
device.
"""
from __future__ import annotations

import functools

import torch

from ..grid import interior_view
from ..kernels.build import launch, library
from .stencil_kernels import (_on_cpu, _check, _counted, _count, _bf16,
                              _blocks, _wide, _mult3d_plain,
                              _increment3d_plain, _counter, _march, _each,
                              _stride, _scalars_on, vmap_only, _by_members,
                              _member_function)

__all__ = ["pcg_dir_mult", "pcg_update", "pcg_blocked", "dot3d", "pcg_axpy",
           "mult3d_stream", "increment3d_stream", "kernel_wrappers"]


def _interior_sum(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(interior_view(v, v.ndim))


# --- the fused PCG iteration: pcg_dir_mult, pcg_update, pcg_blocked --------

# The words of a PCG smooth's scalar step, one run of WORDS a member
# (csrc/pcg_axpy.cuh PCG_WORDS): rho, the sweep's own sum (<z, eps> after
# `pcg_dir_mult`, <r', r'∘iD> after `pcg_update`), the dead flag (1 or 0),
# the step upd and the next beta.
WORDS = 5
W_RHO, W_SUM, W_DEAD, W_UPD, W_BETA = range(WORDS)


def _alpha_step(words, denom, rho_seed):
    """The scalar step after `pcg_dir_mult`'s ``<z, eps>`` (``denom``), as
    `ops.poisson.pcg` takes it: the new words from ``words`` or, None (the
    smooth's seed), from the sweep's rho ``rho_seed`` (dead where it is
    under 10 eps, beta 0)."""
    teneps = 10 * torch.finfo(denom.dtype).eps
    if words is None:
        rho, beta = rho_seed, torch.zeros_like(rho_seed)
        dead = torch.abs(rho) < teneps
    else:
        rho, dead, beta = words[W_RHO], words[W_DEAD] != 0, words[W_BETA]
    alpha = torch.where(dead | (denom == 0), 0.0,
                        rho / torch.where(denom == 0, 1.0, denom))
    dead = dead | (torch.abs(alpha) < 1e-2) | (torch.abs(alpha) > 1e2)
    upd = torch.where(dead, 0.0, alpha)
    return torch.stack([rho, denom, dead.to(rho.dtype), upd, beta])


def _beta_step(words, rho2):
    """The scalar step after `pcg_update`'s ``rho2``, as `ops.poisson.pcg`
    takes it: dead where rho2 is under 10 eps, beta = rho2/rho, rho = rho2
    where alive."""
    teneps = 10 * torch.finfo(rho2.dtype).eps
    rho = words[W_RHO]
    dead = (words[W_DEAD] != 0) | (torch.abs(rho2) < teneps)
    beta = torch.where(dead, 0.0, rho2 / torch.where(rho == 0, 1.0, rho))
    return torch.stack([torch.where(dead, rho, rho2), rho2,
                        dead.to(rho.dtype), words[W_UPD], beta])


def _pcg_dir_mult_plain(L, Dd, eps_prev, r, iD, words=None, bf16=False):
    beta = 0.0 if words is None else words[W_BETA]
    eps = beta * _wide(eps_prev) + r * iD
    if bf16:
        eps = eps.to(torch.bfloat16)
    z = _mult3d_plain(L, Dd, eps)
    rho = _interior_sum(r * (r * iD)) if words is None else None
    return eps, z, _alpha_step(words, _interior_sum(z * _wide(eps)), rho)


# pcg_dir_mult's chunks: (fewest, most) interior planes a block marches
# (`stencil_kernels.march_planes`); on the H100 at 258³, chunks of at most
# 32 planes (2048 blocks) beat 64 (1024 blocks) with the operator shadows
# (0.225 against 0.259 ms) and tie with f32 operands
DIR_PLANES = (4, 32)


def _words_on(words, like, name, M):
    """``(words, stride)`` of a sweep's input words for ``M`` members: one
    run of `WORDS` (stride 0: every member's) or one a member (stride
    `WORDS`), f32 on ``like``'s device."""
    _check(name, tuple(like.shape[1:]),
           words=(words, (M, WORDS) if words.ndim > 1 else (WORDS,)))
    return words, _stride(words, 1)


def _pcg_dir_mult_launch(L, Dd, eps_prev, r, iD, words=None, bf16=False,
                         members=False):
    """The kernel on ``r`` (``(M, *S)``) and each other operand with a
    member axis or shared (a member stride of 0), ``words`` (a member's
    each or shared) or None: eps and z ``(M, *S)``, the new words ``(M,
    WORDS)``, every member's in the order of its own launch."""
    M, S = r.shape[0], tuple(r.shape[1:])
    _check("pcg_dir_mult", S, bf16=("eps_prev", "L", "iD"),
           L=(L, _each(L, (3,) + S, M)), D=(Dd, _each(Dd, S, M)),
           eps_prev=(eps_prev, _each(eps_prev, S, M)), r=(r, (M,) + S),
           iD=(iD, _each(iD, S, M)))
    if L.dtype != iD.dtype:
        raise TypeError(f"pcg_dir_mult: L is {L.dtype} and iD {iD.dtype}; "
                        "the kernel takes both f32 or both bf16 (a level's "
                        "L16 and iD16)")
    planes, buf = _march("pcg_dir_mult", S, r.device, 2, DIR_PLANES,
                         members=M)
    eps = torch.empty((M,) + S,
                      dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=r.device)
    z = torch.empty((M,) + S, dtype=torch.float32, device=r.device)
    sw = 0
    if words is not None:
        words, sw = _words_on(words, r, "pcg_dir_mult", M)
    w_out = torch.empty((M, WORDS), dtype=torch.float32, device=r.device)
    launch("wl_pcg_dir_mult", L, Dd, eps_prev, r, iD, words, w_out, eps, z,
           buf[2 * M:], _counter(r.device), buf[:2 * M], _bf16(eps_prev),
           int(bool(bf16)), _bf16(L), planes, M, _stride(L, 4),
           _stride(Dd, 3), _stride(eps_prev, 3), _stride(r, 3),
           _stride(iD, 3), sw, *S)
    _count(pcg_dir_mult, S, members, L=L, iD=iD, eps_prev=eps_prev, eps=eps)
    return eps, z, w_out


@_counted
def pcg_dir_mult(L, Dd, eps_prev, r, iD, words=None, bf16: bool = False):
    """The fused iteration's first sweep, with the PCG's scalar step:
    ``(eps, z, words')``.  The search direction ``eps = beta·eps_prev +
    r∘iD`` (rounded to bf16 with ``bf16``), ``z = A·eps`` applied to the
    rounded direction in f32, and the interior sum ``⟨z, eps⟩``, from
    which its last block takes the step into the new `WORDS` words (rho,
    that sum, dead, upd, beta): ``beta`` and the rest read from ``words``,
    the previous `pcg_update`'s, or, None (the smooth's seed), beta 0 and
    rho the sweep's own ``⟨r, r∘iD⟩`` of the unrounded ``r∘iD`` (where
    ``eps_prev`` must be finite: pass ``r``).  ``eps_prev`` may be bf16; a new
    ``eps`` is written (never in place).  ``L`` and ``iD`` may be a level's
    bf16 shadows L16 and iD16 (both, with the f32 D16), upcast where they
    are read.  One launch.  Under `vmap` alone, the member form (the words
    one run a member or shared)."""
    if vmap_only(L, Dd, eps_prev, r, iD, words):
        return _by_members("pcg_dir_mult", L, Dd, eps_prev, r, iD, words,
                           bool(bf16))
    if _on_cpu("pcg_dir_mult", r, L, Dd, eps_prev, iD, words):
        return _pcg_dir_mult_plain(L, Dd, eps_prev, r, iD, words, bf16)
    out = _pcg_dir_mult_launch(L, Dd, eps_prev, r[None], iD, words, bf16)
    return tuple(o[0] for o in out)


_member_function("pcg_dir_mult", (4, 3, 3, 3, 3, 1), 3, _pcg_dir_mult_plain,
                 _pcg_dir_mult_launch)


def _axpy_rho_plain(x, r, eps, z, iD, upd):
    x = x + upd * _wide(eps)
    r = r - upd * z
    return x, r, _interior_sum(r * (r * iD))


def _pcg_update_plain(x, r, eps, z, iD, words):
    x, r, rho2 = _axpy_rho_plain(x, r, eps, z, iD, words[W_UPD])
    return x, r, _beta_step(words, rho2)


def _axpy_rho_launch(wrapper, x, r, eps, z, iD, s, members=False):
    """``(x + upd·eps, r − upd·z, ⟨r', r'∘iD⟩)``: the kernel shared by
    `pcg_update` and `pcg_axpy` (``csrc/pcg_axpy.cuh``), counted on
    ``wrapper``, in one launch, on ``x`` (``(M, *S)``) and each other
    operand with a member axis or shared (a member stride of 0); ``eps``
    and ``iD`` (a level's iD16) may be bf16.  ``s``: `pcg_axpy`'s upd, a
    number or a tensor (one value, or one a member), the third output each
    member's rho ``(M,)``; or `pcg_update`'s words (one run a member or
    shared), upd read from them, the third output the new words ``(M,
    WORDS)``.  New x and r are written (nothing in place), every member's
    in the order of its own launch."""
    name = wrapper.__name__
    M, S = x.shape[0], tuple(x.shape[1:])
    _check(name, S, bf16=("eps", "iD"), x=(x, (M,) + S),
           r=(r, _each(r, S, M)), eps=(eps, _each(eps, S, M)),
           z=(z, _each(z, S, M)), iD=(iD, _each(iD, S, M)))
    x_out = torch.empty((M,) + S, dtype=torch.float32, device=x.device)
    r_out = torch.empty_like(x_out)
    # one wave of blocks striding over the cells: a block a 256 cells would
    # leave ~67k partials at 258³, and as many atomics on the one counter
    # that elects the last block, which serialise; each member with the
    # one-field launch's grid
    blocks = min(_blocks(S), _axpy_coresident(x.device.index, _bf16(eps),
                                              _bf16(iD)))
    # the rhos, then one partial a block of a member
    buf = torch.empty(M * (1 + blocks), dtype=torch.float32, device=x.device)
    if wrapper is pcg_update:
        s, ss = _words_on(s, x, name, M)
        w_out = torch.empty((M, WORDS), dtype=torch.float32, device=x.device)
        scalars = (s, w_out)
    else:
        s, ss = _scalars_on(s, x, name, M)
        scalars = (s,)
    launch(f"wl_{name}", x, r, eps, z, iD, *scalars, x_out, r_out, buf[M:],
           _counter(x.device), buf[:M], _bf16(eps), _bf16(iD), blocks, M,
           _stride(x, 3), _stride(r, 3), _stride(eps, 3), _stride(z, 3),
           _stride(iD, 3), ss, *S)
    _count(wrapper, S, members, eps=eps, iD=iD)
    return x_out, r_out, scalars[-1] if wrapper is pcg_update else buf[:M]


def _axpy_rho(wrapper, plain, x, r, eps, z, iD, s):
    """`pcg_update`'s and `pcg_axpy`'s body (``wrapper``, its plain version
    ``plain``; ``s`` its words or upd): the member form under `vmap` alone,
    the plain version on the CPU, one launch on CUDA."""
    name = wrapper.__name__
    if vmap_only(x, r, eps, z, iD, s):
        return _by_members(name, x, r, eps, z, iD, s)
    if _on_cpu(name, x, r, eps, z, iD, s):
        return plain(x, r, eps, z, iD, s)
    xo, ro, out = _axpy_rho_launch(wrapper, x[None], r, eps, z, iD, s)
    return xo[0], ro[0], out[0]


@functools.cache
def _axpy_coresident(device_index, eps_bf16: int, iD_bf16: int) -> int:
    """Blocks of the axpy sweep's one-field kernel (its eps and iD types)
    the card holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    times the SMs)."""
    with torch.cuda.device(device_index):
        return library().wl_axpy_coresident(eps_bf16, iD_bf16)


@_counted
def pcg_update(x, r, eps, z, iD, words):
    """The fused iteration's second sweep, with the PCG's scalar step:
    ``(x + upd·eps, r − upd·z, words')``, upd read from ``words`` (the
    previous `pcg_dir_mult`'s), and the new words from them and the
    interior sum ``⟨r', r'∘iD⟩`` (its last block's step: dead, beta, rho);
    ``eps`` and ``iD`` may be bf16.  Under `vmap` alone, the member form
    (the words one run a member or shared)."""
    return _axpy_rho(pcg_update, _pcg_update_plain, x, r, eps, z, iD, words)


_member_function("pcg_update", (3, 3, 3, 3, 3, 1), 0, _pcg_update_plain,
                 functools.partial(_axpy_rho_launch, pcg_update))


def pcg_blocked(lev, x, r, it: int = 6):
    """Whole PCG smooth from the two fused-iteration sweeps, the
    restructure of `ops.poisson.pcg` by `waterlily_tpu.ops.attic.
    pcg_blocked`, `ops.poisson.smooth`'s route on blocked, non-periodic,
    non-banded levels: the denominator of iteration i+1 comes from the
    sweep that rebuilds eps at the end of iteration i, and each sweep takes
    the PCG's scalar step (the same dead-mask early exits) into the
    smooth's `WORDS` device words, which the next sweep reads.  ``2·it``
    launches (the seed's sweep, then ``it`` updates and ``it − 1``
    rebuilds), no other device work; on the CPU the sweeps' plain versions
    take the step in 0-d tensors, as `pcg` does.  A level with operator
    shadows applies L16/D16 and preconditions with iD16, as JAX's does.
    Non-periodic, non-banded levels only: the in-kernel eps rebuild fills
    no periodic ghosts and reads the dense coefficients.  Returns new
    ``(x, r)``.

    Under `torch.func.vmap` alone (an ensemble) the two sweeps take their
    member forms: two launches an iteration for all members, the words one
    run a member on the device (no host read), each member's ``(x, r)``
    bit for bit its own smooth's."""
    if lev.perdir or lev.banded:
        raise ValueError("pcg_blocked: the fused iteration takes dense, "
                         "non-periodic levels only (got perdir="
                         f"{lev.perdir}, banded={lev.banded})")
    from .poisson import _opLD, _iDk
    bf16 = lev.bf16_eps
    L, Dd = _opLD(lev)
    iD = _iDk(lev)
    eps, z, words = pcg_dir_mult(L, Dd, r, r, iD, None, bf16)
    for i in range(it):
        x, r, words = pcg_update(x, r, eps, z, iD, words)
        if i == it - 1:
            break
        eps, z, words = pcg_dir_mult(L, Dd, eps, r, iD, words, bf16)
    return x, r


# --- solver dots and the axpy sweep: dot3d, pcg_axpy ----------------------------

_DOT_MODES = {"aa": 0, "ab": 1, "rid": 2}
# dot3d's grid: at most DOT_BLOCKS_PER_SM blocks per SM, and at least
# DOT_ROWS_MIN interior rows a block, so that a small level is not cut into
# more blocks (and partials for the last block to sum) than its rows fill.
# Each block sums a contiguous run of whole rows and the last block sums the
# partials, so the order of the sum depends on the shape and the card's SM
# count alone (csrc/reduce.cu).
DOT_BLOCKS_PER_SM = 8
DOT_ROWS_MIN = 16


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    sum.  Under `vmap` alone, the member form (each member's dot, ``b``
    one a member or shared)."""
    if mode is None:
        mode = "aa" if b is a else "ab"
    if mode not in _DOT_MODES:
        raise ValueError(f"dot3d: mode {mode!r} is not one of "
                         f"{sorted(_DOT_MODES)}")
    if vmap_only(a, b):
        return _by_members("dot3d", a, None if mode == "aa" else b, mode)
    if _on_cpu("dot3d", a, b):
        return _dot3d_plain(a, b, mode)
    return _dot3d_launch(a[None], b, mode)[0]


def _dot3d_launch(a, b, mode, members=False):
    """The kernel on ``a`` (``(M, *S)``) and ``b`` (a member's each or
    shared; None in mode ``"aa"``): each member's dot, ``(M,)``, in the
    order of its own launch."""
    M, S = a.shape[0], tuple(a.shape[1:])
    ops = ({"a": (a, (M,) + S)} if mode == "aa"
           else {"a": (a, (M,) + S), "b": (b, _each(b, S, M))})
    _check("dot3d", S, bf16=("b",) if mode == "rid" else (), **ops)
    rows = (S[0] - 2) * (S[1] - 2)
    blocks = max(1, min(DOT_BLOCKS_PER_SM * _sm_count(a.device),
                        -(-rows // DOT_ROWS_MIN)))
    part = torch.empty(M * blocks, dtype=torch.float32, device=a.device)
    out = torch.empty(M, dtype=torch.float32, device=a.device)
    aa = mode == "aa"
    launch("wl_dot3d", a, None if aa else b, part, _counter(a.device), out,
           _DOT_MODES[mode], 0 if aa else _bf16(b), blocks, M,
           _stride(a, 3), 0 if aa else _stride(b, 3), *S)
    _count(dot3d, S, members, a=a, **({} if aa else {"b": b}))
    return out


_member_function("dot3d", (3, 3), 0, _dot3d_plain, _dot3d_launch)


@_counted
def pcg_axpy(x, r, eps, z, iD, upd):
    """The PCG iteration's axpy pair and next rho in one sweep: ``(x +
    upd·eps, r − upd·z, ⟨r', r'∘iD⟩)``; ``eps`` and ``iD`` may be bf16
    (upcast), ``upd`` is the dead-masked step."""
    return _axpy_rho(pcg_axpy, _axpy_rho_plain, x, r, eps, z, iD, upd)


_member_function("pcg_axpy", (3, 3, 3, 3, 3, 0), 0, _axpy_rho_plain,
                 functools.partial(_axpy_rho_launch, pcg_axpy))


# --- the carried-rows operator: mult3d_stream, increment3d_stream ----------

# The operator march's chunks (`mult3d_stream`'s and `mult3d`'s): (fewest,
# most) interior planes a block marches, as many chunks as a wave of the
# blocks the card holds at once needs (`stencil_kernels.march_planes` with
# `_stream_coresident` blocks).  On the H100 at 130³ 1024 blocks of 8
# planes take 0.023 ms against 0.029 for 512 of 16, at 258³ one wave of
# 64-plane chunks costs L16 3%; at 66³ and (98,66,66) chunks of 2 planes
# take 0.0048 and 0.0058 ms with the dot (0.0033, 0.0041 without) against
# 0.0053 and 0.0061 (0.0037, 0.0048) for chunks of 4, and chunks of 1
# lose with the dot (0.0058 at 66³)
STREAM_PLANES = (2, 32)

# increment3d_stream's rows: the fewest and the most axis-0 rows a block
# marches down, and the blocks a grid should give the card (about 2.6
# waves of the 132 SMs at 6 resident blocks each); they serve only the
# increment's kernel (csrc/stream_stencil.cu)
STREAM_ROWS = (4, 32)
STREAM_BLOCKS = 2048


@functools.cache
def _stream_tile() -> tuple[int, int]:
    """The (axis 1, axis 2) columns of one increment3d_stream block, as
    the kernel library was built with them (csrc/stream_stencil.cu ST_TJ,
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


@functools.cache
def _stream_coresident(device_index, L_bf16: int, x_bf16: int,
                       dot: int) -> int:
    """Blocks of `mult3d_stream`'s kernel (its L and x types, with the dot
    or without) the card holds at once (occupancy times the SMs)."""
    with torch.cuda.device(device_index):
        return library().wl_stream_coresident(L_bf16, x_bf16, dot)


def _stream_march(S, L, x, with_dot: bool, name: str = "mult3d_stream",
                  members: int = 1):
    """(planes, results and partials buffer or None) of the operator
    march (`mult3d_stream`'s and `stencil_kernels.mult3d`'s) at ``S``:
    chunks of at most ``STREAM_PLANES[1]`` planes, as many as one wave of
    resident blocks needs (at 258³ 8 chunks of 32 planes, 2048 blocks;
    130³ 16 of 8, 1024; 66³ 32 of 2, 512; (98,66,66) 48 of 2, 768), each
    of ``members`` members with these chunks.  ``name`` is the wrapper a
    refused shape's error names."""
    return _march(name, S, x.device, int(with_dot),
                  STREAM_PLANES, _stream_coresident(
                      x.device.index, _bf16(L), _bf16(x), int(with_dot)),
                  members)


def _mult3d_march(fn, L, Dd, x, with_dot: bool, members: bool = False):
    """z = A·x (and with ``with_dot`` ⟨A·x, x⟩) of CUDA tensors by the
    operator march (``csrc/stream_march.cu``), one launch counted on
    wrapper ``fn``: `mult3d_stream`, or `stencil_kernels.mult3d`, which
    shares the kernel and its chunk rule.  ``x`` carries a member axis
    (``(M, *S)``), ``L`` and ``Dd`` one or none (shared: a member stride of
    0); z is ``(M, *S)`` and the dot ``(M,)``, each member's in the order of
    its own launch; ``members``: a member form's launch (its form
    ``"members"``)."""
    M, S, name = x.shape[0], tuple(x.shape[1:]), fn.__name__
    _check(name, S, bf16=("L", "x"), L=(L, _each(L, (3,) + S, M)),
           D=(Dd, _each(Dd, S, M)), x=(x, (M,) + S))
    planes, buf = _stream_march(S, L, x, with_dot, name, M)
    z = torch.empty((M,) + S, dtype=torch.float32, device=x.device)
    launch("wl_mult3d_stream", L, Dd, x, z,
           *((buf[M:], _counter(x.device), buf[:M]) if with_dot
             else (None,) * 3),
           M, _stride(L, 4), _stride(Dd, 3), _stride(x, 3),
           _bf16(L), _bf16(x), planes, *S)
    _count(fn, S, members, L=L, x=x)
    return (z, buf[:M]) if with_dot else z


@_counted
def mult3d_stream(L, Dd, x, with_dot: bool = False):
    """z = A·x (and with ``with_dot`` ⟨A·x, x⟩ as a 0-d tensor), the
    function of `stencil_kernels.mult3d`, by the carried-rows kernel, a
    plane march: each thread marches its interior (axis 1, axis 2) column
    down a chunk of interior planes with x and L0 carried in registers, so
    every input row is read once; the dot is reduced in the same launch.
    ``L`` (a level's L16) and ``x`` may be bf16; every axis needs an
    interior.  Periodic ghosts of ``x`` must be filled by the caller.
    `stencil_kernels.mult3d` launches the same kernel; the two wrappers
    count their launches apart, so a path shows which one it took.  Under
    `vmap` alone, the member form (the same launch as `mult3d`'s)."""
    if vmap_only(L, Dd, x):
        return _by_members("mult3d_stream", L, Dd, x, bool(with_dot))
    if _on_cpu("mult3d_stream", x, L, Dd):
        return _mult3d_plain(L, Dd, x, with_dot)
    out = _mult3d_march(mult3d_stream, L, Dd, x[None], with_dot)
    return (out[0][0], out[1][0]) if with_dot else out[0]


_member_function("mult3d_stream", (4, 3, 3), 2, _mult3d_plain,
                 functools.partial(_mult3d_march, mult3d_stream))


def _increment3d_stream_launch(L, Dd, eps, x, r, members=False):
    """The kernel on ``x`` (``(M, *S)``) and each other operand with a
    member axis or shared (a member stride of 0): ``(x + eps, r − A·eps)``
    with the member axis."""
    M, S = x.shape[0], tuple(x.shape[1:])
    _check("increment3d_stream", S, bf16=("L", "eps"),
           L=(L, _each(L, (3,) + S, M)), D=(Dd, _each(Dd, S, M)),
           eps=(eps, _each(eps, S, M)), x=(x, (M,) + S),
           r=(r, _each(r, S, M)))
    rows = _stream_rows(S, _stream_tile())
    if M * -(-S[0] // rows) > 65535:
        raise ValueError(f"increment3d_stream: {M} members of {S} exceed "
                         f"the grid's 65535 chunks a launch")
    x_out = torch.empty((M,) + S, dtype=torch.float32, device=x.device)
    r_out = torch.empty_like(x_out)
    launch("wl_increment3d_stream", L, Dd, eps, x, r, x_out, r_out,
           _bf16(L), _bf16(eps), rows, M, _stride(L, 4), _stride(Dd, 3),
           _stride(eps, 3), _stride(x, 3), _stride(r, 3), *S)
    _count(increment3d_stream, S, members, L=L, eps=eps)
    return x_out, r_out


@_counted
def increment3d_stream(L, Dd, eps, x, r):
    """(x + eps, r − A·eps), the function of `stencil_kernels.increment3d`,
    by the carried-rows kernel, which also writes x + eps from the eps it
    reads once.  ``L`` and ``eps`` may be bf16.  Returns new tensors.
    Under `vmap` alone, the member form."""
    if vmap_only(L, Dd, eps, x, r):
        return _by_members("increment3d_stream", L, Dd, eps, x, r)
    if _on_cpu("increment3d_stream", x, L, Dd, eps, r):
        return _increment3d_plain(L, Dd, eps, x, r)
    xo, ro = _increment3d_stream_launch(L, Dd, eps, x[None], r)
    return xo[0], ro[0]


_member_function("increment3d_stream", (4, 3, 3, 3, 3), 3,
                 _increment3d_plain, _increment3d_stream_launch)


def kernel_wrappers() -> dict:
    """Name → wrapper of this module's kernels."""
    return {"pcg_dir_mult": pcg_dir_mult, "pcg_update": pcg_update,
            "dot3d": dot3d, "pcg_axpy": pcg_axpy,
            "mult3d_stream": mult3d_stream,
            "increment3d_stream": increment3d_stream}
