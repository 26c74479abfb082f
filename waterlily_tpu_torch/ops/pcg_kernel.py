"""Wrapper, plain version, launch counter, launched shapes and level gate
of the one-launch PCG smooth.

Counterpart of `waterlily_tpu.ops.pallas_kernels`: the whole ``it``-step
Jacobi-PCG smooth of a small multigrid level (matvecs, dots, axpys and the
early exits) runs as one CUDA launch (``csrc/pcg.cu``) instead of some 30
small tensor ops.  The plain version is `ops.poisson.pcg`.
"""
from __future__ import annotations

import math

import torch

from ..kernels.build import launch

__all__ = ["PCG_MAX_CELLS", "use_pcg_fused", "pcg_fused"]

# Level gate: the single-block kernel serves levels of at most this many
# ghost-padded cells.  It picks the levels the JAX VMEM estimate picks for
# the sphere grids: (50,34,34) = 57,800 cells in, the (98,66,66) fine level
# out; at 258³ (the sphere's and the periodic Taylor-Green's) the 34³ level
# in and 66³ out; every level of the 2D cases, (98,66) and (130,130) fine
# levels included.
PCG_MAX_CELLS = 60_000


def use_pcg_fused(S, dtype, device) -> bool:
    """Gate: small f32 levels on a CUDA device (2D and 3D, as in JAX)."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and len(S) >= 2 and math.prod(S) <= PCG_MAX_CELLS)


def pcg_fused(lev, x, r, it: int = 6):
    """One whole PCG smooth of level ``lev`` (2D or 3D, walls or periodic
    axes ``lev.perdir``, whose ghosts the kernel fills before each matvec);
    returns new ``(x, r)``.  CPU tensors run the plain version
    `ops.poisson.pcg`.  `use_pcg_fused` sends it the levels of at most
    `PCG_MAX_CELLS` cells: all of a 2D grid's levels up to (130,130), and
    34³ and below of a 258³ grid."""
    S = tuple(x.shape)
    if x.device.type == "cpu":
        from .poisson import pcg
        return pcg(lev, x, r, it)
    if x.device.type != "cuda":
        raise ValueError(f"pcg_fused: tensors on {x.device} are not supported")
    from .stencil_kernels import _check, _axis_bits
    D = len(S)
    if math.prod(S) >= 2 ** 31:
        raise ValueError(f"pcg_fused: the kernel indexes levels of fewer "
                         f"than 2^31 cells, got S={S}")
    _check("pcg_fused", S, ranks=(2, 3), L=(lev.L, (D,) + S), D=(lev.D, S),
           iD=(lev.iD, S), x=(x, S), r=(r, S))
    x = x.clone()
    r = r.clone()
    eps = torch.empty_like(x)
    z = torch.empty_like(x)
    S3 = S + (1,) * (3 - D)
    launch("wl_pcg", lev.L, lev.D, lev.iD, x, r, eps, z, D, *S3, int(it),
           _axis_bits(lev.perdir))
    pcg_fused.launches += 1
    pcg_fused.shapes.add(S)
    return x, r


pcg_fused.launches = 0
pcg_fused.shapes = set()

