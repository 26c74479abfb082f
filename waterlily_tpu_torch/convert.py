"""Carry state across from the JAX package as numpy arrays.

`flow_from_numpy` and `levels_from_numpy` take the fields of a
`waterlily_tpu` ``FlowState`` / ``PoissonLevel`` as numpy arrays (for
example ``{k: np.asarray(v) for k, v in state._asdict().items()}``) and
build the port's counterparts on ``device``, so both packages can be
stepped from one state.  No JAX import is needed.
"""
from __future__ import annotations

import numpy as np
import torch

from .flow import FlowState
from .ops.poisson import PoissonLevel
from .ops import stencil_kernels as sk

__all__ = ["flow_from_numpy", "levels_from_numpy"]

FLOW_FIELDS = ("u", "p", "V", "mu0", "mu1", "dt", "t")


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def flow_from_numpy(fields: dict, device) -> FlowState:
    """A `FlowState` from numpy arrays of the JAX state's fields (extra
    keys such as ``bbox`` are ignored)."""
    missing = [k for k in FLOW_FIELDS if k not in fields]
    if missing:
        raise KeyError(f"flow_from_numpy: missing fields {missing}")
    return FlowState(**{k: _t(fields[k], device) for k in FLOW_FIELDS})


def levels_from_numpy(levels: list, device, perdir: tuple = ()) -> tuple:
    """Poisson levels from numpy arrays of each JAX level's ``L``, ``D`` and
    ``iD``; the kernel gate is re-evaluated for ``device``."""
    out = []
    for lev in levels:
        L = _t(lev["L"], device)
        out.append(PoissonLevel(
            L=L, D=_t(lev["D"], device), iD=_t(lev["iD"], device),
            blocked=sk.use_blocked(tuple(L.shape[1:]), L.dtype, L.device),
            perdir=tuple(perdir)))
    return tuple(out)
