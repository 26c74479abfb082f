"""Wrapper, plain version, launch counter, launched shapes, level gate and
grid rule of the one-launch PCG smooth.

Counterpart of `waterlily_tpu.ops.pallas_kernels`: the whole ``it``-step
Jacobi-PCG smooth of a small multigrid level (matvecs, dots, axpys and the
early exits) runs as one CUDA launch (``csrc/pcg.cu``) instead of some 30
small tensor ops: a cooperative launch over a grid of blocks sized by the
level (`pcg_grid`), or one block for the smallest levels.  The plain
version is `ops.poisson.pcg`.

An ensemble under `torch.func.vmap` smooths every member of a level in
the same kernel (`pcg_members`, reached from `pcg_fused` through a `vmap`
rule): a grid of (blocks, members) blocks, each member with its own sums
and early exits, the operator shared or one a member.  The one-block form
carries every member in one launch; the cooperative grid form as many as
are co-resident on the card beside each other (`member_chunk`), one
launch for each chunk.  Its plain version is `vmap` of `ops.poisson.pcg`.
"""
from __future__ import annotations

import collections
import functools
import math

import torch

from ..kernels.build import launch, library

__all__ = ["PCG_MAX_CELLS", "PCG_THREADS", "PCG_ONE_BLOCK_THREADS",
           "PCG_ONE_BLOCK_MAX", "PCG_GRID_CELLS", "use_pcg_fused", "pcg_grid",
           "member_chunk", "launch_chunks", "pcg_members", "pcg_fused"]

# Level gate: the kernel serves levels of at most this many
# ghost-padded cells.  It picks the levels the JAX VMEM estimate picks for
# the sphere grids: (50,34,34) = 57,800 cells in, the (98,66,66) fine level
# out; at 258³ (the sphere's and the periodic Taylor-Green's) the 34³ level
# in and 66³ out; every level of the 2D cases, (98,66) and (130,130) fine
# levels included.
PCG_MAX_CELLS = 60_000

# Threads a block of the grid form and of the one-block form (csrc/pcg.cu
# PCG_THREADS, PCG_ONE_BLOCK_THREADS; checked against the library at the
# first launch), and the cells a thread may own in each (the kernel's
# instances).
PCG_THREADS = 256
PCG_ONE_BLOCK_THREADS = 1024
_CELLS_PER_THREAD = (1, 2)
# Levels of at most this many cells run on one block (__syncthreads()
# between the phases), larger ones on a cooperative grid (grid barriers);
# at most 2 * PCG_ONE_BLOCK_THREADS.
PCG_ONE_BLOCK_MAX = 2048
# Cells a thread owns on the grid form (more where the co-resident block
# count caps the grid): 1, from an A/B on the path shapes (H100 80GB HBM3,
# 700 W; PERF.md §6, PR 7): 2 and 4 were slower at 18³, (98,66) and 34³.
# Two cells a thread cover a `PCG_MAX_CELLS` level with 118 blocks, one
# an SM.
PCG_GRID_CELLS = 1


def use_pcg_fused(S, dtype, device) -> bool:
    """Gate: small f32 levels on a CUDA device (2D and 3D, as in JAX).
    Its caller (`ops.poisson.smooth`) also holds operands that autograd
    tracks off the kernel (`stencil_kernels.ad_tracked`)."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and len(S) >= 2 and math.prod(S) <= PCG_MAX_CELLS)


def pcg_grid(n_cells: int, coresident=lambda k: 2 ** 31) -> tuple:
    """``(blocks, cells a thread)`` of the kernel's launch on a level of
    ``n_cells`` cells: up to `PCG_ONE_BLOCK_MAX` cells one block of
    `PCG_ONE_BLOCK_THREADS` threads with the fewest cells a thread that
    cover the level; above it blocks of `PCG_THREADS` threads,
    `PCG_GRID_CELLS` cells a thread, as many blocks as cover the level,
    the cells a thread doubled while the grid exceeds ``coresident(k)``,
    the blocks of that form that fit on the card at once (a cooperative
    launch's limit)."""
    if n_cells <= PCG_ONE_BLOCK_MAX:
        k = next((k for k in _CELLS_PER_THREAD
                  if k * PCG_ONE_BLOCK_THREADS >= n_cells), None)
        blocks = 1
    else:
        k = next((k for k in _CELLS_PER_THREAD if k >= PCG_GRID_CELLS
                  and -(-n_cells // (k * PCG_THREADS)) <= coresident(k)),
                 None)
        blocks = -(-n_cells // (k * PCG_THREADS)) if k else 0
    if k is None:
        raise ValueError(f"pcg_fused: no launch of the kernel covers "
                         f"{n_cells} cells")
    return blocks, k


@functools.cache
def _launch_grid(n_cells: int, device_index: int, ndim: int) -> tuple:
    """`pcg_grid` on this card (worked out once a level size)."""
    return pcg_grid(n_cells, lambda k: _coresident(device_index, ndim, k))


@functools.cache
def _coresident(device_index: int, ndim: int, k: int) -> int:
    """Co-resident blocks of the grid form on this card (queried once)."""
    lib = library()
    threads = (lib.wl_pcg_threads(0), lib.wl_pcg_threads(1))
    if threads != (PCG_THREADS, PCG_ONE_BLOCK_THREADS):
        raise RuntimeError(f"pcg kernel block sizes {threads} != "
                           f"{(PCG_THREADS, PCG_ONE_BLOCK_THREADS)}")
    with torch.cuda.device(device_index):
        return lib.wl_pcg_coresident(ndim, k)


def member_chunk(blocks: int, members: int, coresident: int) -> int:
    """Members one launch of the member-axis smooth carries: on the
    one-block form (``blocks == 1``) all of them, on the grid form as many
    as fit on the card at once beside each other (``coresident //
    blocks``: a cooperative launch must be co-resident), at most the
    launch's 65535 grid rows."""
    cap = members if blocks == 1 else coresident // blocks
    if cap < 1:
        raise ValueError(f"pcg_fused: a member's {blocks} blocks exceed the "
                         f"{coresident} co-resident blocks of the card")
    return min(members, cap, 65535)


def launch_chunks(S, members: int, device) -> int:
    """Launches of the member-axis smooth of ``members`` members of shape
    ``S`` on CUDA ``device`` (one for each `member_chunk` of members)."""
    dev = torch.device(device)
    dev_index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    blocks, k = _launch_grid(math.prod(S), dev_index, len(S))
    co = _coresident(dev_index, len(S), k) if blocks > 1 else 0
    return -(-members // member_chunk(blocks, members, co))


def _plain_members(L, Dd, iD, x, r, it, perdir):
    """`vmap` of `ops.poisson.pcg` over the member axis (axis 0) of ``x``,
    ``r`` and of whichever operator arrays carry one."""
    from .poisson import PoissonLevel, pcg
    D = x.ndim - 1
    dims = (0 if L.ndim == D + 2 else None, 0 if Dd.ndim == D + 1 else None,
            0 if iD.ndim == D + 1 else None, 0, 0)
    return torch.func.vmap(
        lambda L, Dd, iD, x, r: pcg(PoissonLevel(L=L, D=Dd, iD=iD,
                                                 perdir=tuple(perdir)),
                                    x, r, it), in_dims=dims)(L, Dd, iD, x, r)


def _launch(L, Dd, iD, x, r, it, perdir, members: bool):
    """The kernel over the members of ``x`` and ``r`` (``(M, *S)``, new
    tensors it writes), in `member_chunk`s of members, one launch each;
    ``L``, ``Dd``, ``iD`` carry the member axis or are shared by every
    member (a member stride of 0)."""
    from .stencil_kernels import _check, _axis_bits
    M, S = x.shape[0], tuple(x.shape[1:])
    D = len(S)
    if math.prod(S) >= 2 ** 31:
        raise ValueError(f"pcg_fused: the kernel indexes levels of fewer "
                         f"than 2^31 cells, got S={S}")
    each = lambda t, shape: (M,) + shape if t.ndim > len(shape) else shape
    _check("pcg_fused", S, ranks=(2, 3), L=(L, each(L, (D,) + S)),
           D=(Dd, each(Dd, S)), iD=(iD, each(iD, S)), x=(x, (M,) + S),
           r=(r, (M,) + S))
    if (Dd.ndim > D) != (iD.ndim > D):
        raise ValueError("pcg_fused: D and iD must both carry the member "
                         "axis or neither")
    dev = x.device.index or 0
    blocks, k = _launch_grid(math.prod(S), dev, D)
    chunk = member_chunk(blocks, M,
                         _coresident(dev, D, k) if blocks > 1 else 0)
    N = math.prod(S)
    sL = L[0].numel() if L.ndim > D + 1 else 0
    sD = N if Dd.ndim > D else 0
    x = x.clone()
    r = r.clone()
    # the kernel's scratch: each member's search direction, z and partials
    work = torch.empty(2 * chunk * (N + blocks), dtype=torch.float32,
                       device=x.device)
    S3 = S + (1,) * (3 - D)
    for c0 in range(0, M, chunk):
        c1 = min(M, c0 + chunk)
        part = lambda t, s: t[c0:c1] if s else t
        launch("wl_pcg", part(L, sL), part(Dd, sD), part(iD, sD), x[c0:c1],
               r[c0:c1], work, D, *S3, int(it), _axis_bits(perdir), blocks,
               k, c1 - c0, sL, sD)
        pcg_fused.launches += 1
        pcg_fused.shapes[S] += 1
        if members:
            pcg_fused.members += 1
            pcg_fused.forms.add("members")
    return x, r


def pcg_members(L, Dd, iD, x, r, it: int = 6, perdir: tuple = ()):
    """The member-axis smooth: ``it`` PCG iterations of each member of
    ``x`` and ``r`` (``(M, *S)``) on its level, ``L`` (``(D, *S)``, or
    ``(M, D, *S)`` a member), ``Dd`` and ``iD`` (``S`` or ``(M, *S)``),
    each member with its own sums and early exits; returns new ``(x,
    r)``.  CPU tensors run the plain version, `vmap` of
    `ops.poisson.pcg`; CUDA tensors launch the kernel once for each
    `member_chunk` of members (raising where it does not take them)."""
    from .stencil_kernels import _on_cpu
    if _on_cpu("pcg_fused", x, r, L, Dd, iD):
        return _plain_members(L, Dd, iD, x, r, it, perdir)
    return _launch(L, Dd, iD, x, r, it, perdir, members=True)


def fold_members(t, d, member: bool, B: int, M: int):
    """``t`` with the batch axis ``d`` of a `vmap` rule of batch size
    ``B`` (None: not batched) folded into its member axis (``member``:
    whether ``t``, as the rule's function sees it, has one of ``M``
    members, first), giving ``(B*M, ...)``, contiguous; a ``t`` with
    neither stays as it is, shared by every member."""
    if d is None and not member:
        return t
    t = t.expand((B,) + tuple(t.shape)) if d is None else t.movedim(d, 0)
    if not member:
        t = t.unsqueeze(1).expand((B, M) + tuple(t.shape[1:]))
    return t.reshape((B * M,) + tuple(t.shape[2:])).contiguous()


class _Members(torch.autograd.Function):
    """`pcg_members` for `torch.func.vmap`: ``x`` and ``r`` carry a member
    axis first, the operator one where it has one.  The `vmap` rule folds
    its batch axis into the member axis (`fold_members`) and applies the
    Function again, so that nested `vmap` levels fold one by one and the
    kernel smooths every member of all of them."""

    @staticmethod
    def forward(L, Dd, iD, x, r, it, perdir):
        return pcg_members(L, Dd, iD, x, r, it, perdir)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("pcg_fused has no derivative: tracked fields "
                           "take ops.poisson.pcg")

    @staticmethod
    def vmap(info, in_dims, L, Dd, iD, x, r, it, perdir):
        B = info.batch_size
        dx = in_dims[3]
        M = x.shape[1 if dx == 0 else 0]
        D = x.ndim - (dx is not None) - 1
        has = lambda t, d, n: t.ndim - (d is not None) > n
        ops = [fold_members(t, d, has(t, d, n), B, M) for t, d, n in
               zip((L, Dd, iD), in_dims[:3], (D + 1, D, D))]
        x, r = (fold_members(t, d, True, B, M)
                for t, d in zip((x, r), in_dims[3:5]))
        out = _Members.apply(*ops, x, r, it, perdir)
        return tuple(o.reshape((B, M) + tuple(o.shape[1:]))
                     for o in out), (0, 0)


def pcg_fused(lev, x, r, it: int = 6):
    """One whole PCG smooth of level ``lev`` (2D or 3D, walls or periodic
    axes ``lev.perdir``, whose ghosts the kernel fills before each matvec);
    returns new ``(x, r)``.  CPU tensors run the plain version
    `ops.poisson.pcg`; a CUDA tensor launches the kernel on `pcg_grid`'s
    grid.  `use_pcg_fused` sends it the levels of at most
    `PCG_MAX_CELLS` cells: all of a 2D grid's levels up to (130,130), and
    34³ and below of a 258³ grid.

    Under `torch.func.vmap` (fields that carry `vmap` levels only, one or
    nested, `stencil_kernels.vmap_only`) the smooth is `pcg_members` on
    the members of every level, reached through `_Members`' `vmap` rule:
    on the card one launch for each `member_chunk` of members, each launch
    counted once."""
    from .stencil_kernels import _on_cpu, vmap_only
    if vmap_only(x, r, lev.L, lev.D, lev.iD):
        xs, rs = _Members.apply(lev.L, lev.D, lev.iD, x[None], r[None],
                                int(it), tuple(lev.perdir))
        return xs[0], rs[0]
    if _on_cpu("pcg_fused", x, r, lev.L, lev.D, lev.iD):
        from .poisson import pcg
        return pcg(lev, x, r, it)
    xs, rs = _launch(lev.L, lev.D, lev.iD, x[None], r[None], it, lev.perdir,
                     members=False)
    return xs[0], rs[0]


pcg_fused.launches = 0
pcg_fused.members = 0
pcg_fused.shapes = collections.Counter()
pcg_fused.forms = set()
pcg_fused.bases = collections.Counter()
