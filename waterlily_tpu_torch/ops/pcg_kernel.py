"""Wrapper, plain version, launch counter, launched shapes, level gate and
grid rule of the one-launch PCG smooth.

Counterpart of `waterlily_tpu.ops.pallas_kernels`: the whole ``it``-step
Jacobi-PCG smooth of a small multigrid level (matvecs, dots, axpys and the
early exits) runs as one CUDA launch (``csrc/pcg.cu``) instead of some 30
small tensor ops: a cooperative launch over a grid of blocks sized by the
level (`pcg_grid`), or one block for the smallest levels.  The plain
version is `ops.poisson.pcg`.
"""
from __future__ import annotations

import collections
import functools
import math

import torch

from ..kernels.build import launch, library

__all__ = ["PCG_MAX_CELLS", "PCG_THREADS", "PCG_ONE_BLOCK_THREADS",
           "PCG_ONE_BLOCK_MAX", "PCG_GRID_CELLS", "use_pcg_fused", "pcg_grid",
           "pcg_fused"]

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


def pcg_fused(lev, x, r, it: int = 6):
    """One whole PCG smooth of level ``lev`` (2D or 3D, walls or periodic
    axes ``lev.perdir``, whose ghosts the kernel fills before each matvec);
    returns new ``(x, r)``.  CPU tensors run the plain version
    `ops.poisson.pcg`; a CUDA tensor launches the kernel on `pcg_grid`'s
    grid.  `use_pcg_fused` sends it the levels of at most
    `PCG_MAX_CELLS` cells: all of a 2D grid's levels up to (130,130), and
    34³ and below of a 258³ grid."""
    from .stencil_kernels import _on_cpu, _check, _axis_bits
    S = tuple(x.shape)
    if _on_cpu("pcg_fused", x, r, lev.L, lev.D, lev.iD):
        from .poisson import pcg
        return pcg(lev, x, r, it)
    D = len(S)
    if math.prod(S) >= 2 ** 31:
        raise ValueError(f"pcg_fused: the kernel indexes levels of fewer "
                         f"than 2^31 cells, got S={S}")
    _check("pcg_fused", S, ranks=(2, 3), L=(lev.L, (D,) + S), D=(lev.D, S),
           iD=(lev.iD, S), x=(x, S), r=(r, S))
    blocks, k = _launch_grid(x.numel(), x.device.index or 0, D)
    x = x.clone()
    r = r.clone()
    # the kernel's scratch: the search direction, z and the dots' partials
    work = torch.empty(2 * x.numel() + 2 * blocks, dtype=torch.float32,
                       device=x.device)
    S3 = S + (1,) * (3 - D)
    launch("wl_pcg", lev.L, lev.D, lev.iD, x, r, work, D, *S3,
           int(it), _axis_bits(lev.perdir), blocks, k)
    pcg_fused.launches += 1
    pcg_fused.shapes[S] += 1
    return x, r


pcg_fused.launches = 0
pcg_fused.shapes = collections.Counter()
pcg_fused.forms = set()
pcg_fused.bases = collections.Counter()

