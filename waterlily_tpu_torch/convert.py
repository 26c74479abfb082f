"""Carry state across from the JAX package as numpy arrays, or between
devices.

`flow_from_numpy` and `levels_from_numpy` take the fields of a
`waterlily_tpu` ``FlowState`` / ``PoissonLevel`` as numpy arrays and plain
values (for example ``{k: np.asarray(v) for k, v in state._asdict().items()}``)
and build the port's counterparts on ``device``, so both packages can be
stepped from one state.  `flow_to` and `levels_to` copy the port's own
state to another device.  No JAX import is needed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .flow import FlowState
from .ops.poisson import make_level

__all__ = ["flow_from_numpy", "levels_from_numpy", "flow_to", "levels_to"]

FLOW_FIELDS = ("u", "p", "V", "mu0", "mu1", "dt", "t")
# per-level values besides L, D and iD (JAX's static level fields)
LEVEL_EXTRAS = ("banded", "c", "box_shape", "box_start", "bf16_eps")


def _t(a, device) -> torch.Tensor:
    """A tensor of numpy array ``a`` on ``device``, bit for bit (a bf16
    array, numpy's ``ml_dtypes`` bfloat16, through its 16-bit pattern)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _ints(v):
    return None if v is None else tuple(int(s) for s in np.asarray(v))


def flow_from_numpy(fields: dict, device) -> FlowState:
    """A `FlowState` from numpy arrays of the JAX state's fields; the
    window corner ``bbox``, where given, becomes host ints (only the banded
    path reads it)."""
    missing = [k for k in FLOW_FIELDS if k not in fields]
    if missing:
        raise KeyError(f"flow_from_numpy: missing fields {missing}")
    return FlowState(**{k: _t(fields[k], device) for k in FLOW_FIELDS},
                     bbox=_ints(fields.get("bbox")))


SHADOWS = ("L16", "D16", "iD16")


def _shadows(lev, device) -> dict:
    """``make_level`` arguments that carry a level's operator shadows bit
    for bit, or that give it none."""
    if lev.get("L16") is None:
        return {"op_bf16": False}
    return {"op_bf16": True, **{k: _t(lev[k], device) for k in SHADOWS}}


def levels_from_numpy(levels: list, device, perdir: tuple = ()) -> tuple:
    """Poisson levels from numpy arrays of each JAX level's ``L``, ``D``
    and ``iD``, its operator shadows ``L16``, ``D16``, ``iD16`` where given
    (bit for bit; a level given none gets none), and its ``banded``, ``c``,
    ``box_shape``, ``box_start`` and ``bf16_eps`` where given (the shadows
    and ``bf16_eps`` take effect on the levels the port's kernel gate makes
    blocked)."""
    return tuple(
        make_level(_t(lev["L"], device), perdir, Dd=_t(lev["D"], device),
                   iD=_t(lev["iD"], device), **_shadows(lev, device),
                   **{k: lev[k] for k in LEVEL_EXTRAS if k in lev})
        for lev in levels)


def flow_to(state: FlowState, device) -> FlowState:
    """A copy of ``state`` with every tensor on ``device``."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(device)
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def levels_to(levels: tuple, device) -> tuple:
    """Copies of ``levels`` on ``device``, the kernel gate re-evaluated:
    ``bf16_eps`` and the operator shadows are kept where the copy is
    blocked; a level that could not carry shadows (not blocked) gets them
    by the module default, as `multigrid.update_levels` decides."""
    def shadows(l):
        if l.L16 is None:
            return {"op_bf16": False if l.blocked else None}
        return {"op_bf16": True, **{k: getattr(l, k).to(device)
                                    for k in SHADOWS}}
    return tuple(
        make_level(l.L.to(device), l.perdir, l.banded, l.c, l.box_shape,
                   l.box_start, Dd=l.D.to(device), iD=l.iD.to(device),
                   bf16_eps=l.bf16_eps, **shadows(l))
        for l in levels)
