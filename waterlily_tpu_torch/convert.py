"""Carry state across from the JAX package as numpy arrays, or between
devices.

`to_numpy` brings a tensor (on any device) or a number to numpy.
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

__all__ = ["to_numpy", "flow_from_numpy", "levels_from_numpy", "flow_to",
           "levels_to"]

FLOW_FIELDS = ("u", "p", "V", "mu0", "mu1", "dt", "t")
# per-level values besides L, D and iD (JAX's static level fields)
LEVEL_EXTRAS = ("banded", "c", "box_shape", "box_start", "bf16_eps")


def to_numpy(a) -> np.ndarray:
    """``a`` as a numpy array: a tensor through the host (``.cpu()``; a
    CUDA tensor has no numpy view), anything else by `np.asarray`."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


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


def _corner(v, device, members: bool):
    """A window corner: host ints, or with ``members`` (JAX's batched
    corners, one a member) an ``(M, D)`` int64 tensor on ``device``."""
    if v is None or not members:
        return _ints(v)
    return torch.tensor(np.asarray(v), dtype=torch.int64, device=device)


def flow_from_numpy(fields: dict, device, members: bool = False) -> FlowState:
    """A `FlowState` from numpy arrays of the JAX state's fields; the
    window corner ``bbox``, where given, becomes host ints (only the banded
    path reads it), or with ``members`` (JAX's batched state, ``jax.vmap``
    of its step) an ``(M, D)`` int64 tensor, each member's own corner for
    `torch.func.vmap`."""
    missing = [k for k in FLOW_FIELDS if k not in fields]
    if missing:
        raise KeyError(f"flow_from_numpy: missing fields {missing}")
    return FlowState(**{k: _t(fields[k], device) for k in FLOW_FIELDS},
                     bbox=_corner(fields.get("bbox"), device, members))


SHADOWS = ("L16", "D16", "iD16")
# a level's values that carry JAX's batched stack's member axis
MEMBER_ARRAYS = ("L", "D", "iD", "box_start") + SHADOWS


def _shadows(lev, device) -> dict:
    """``make_level`` arguments that carry a level's operator shadows bit
    for bit, or that give it none."""
    if lev.get("L16") is None:
        return {"op_bf16": False}
    return {"op_bf16": True, **{k: _t(lev[k], device) for k in SHADOWS}}


def levels_from_numpy(levels: list, device, perdir: tuple = (),
                      members: bool = False) -> tuple:
    """Poisson levels from numpy arrays of each JAX level's ``L``, ``D``
    and ``iD``, its operator shadows ``L16``, ``D16``, ``iD16`` where given
    (bit for bit; a level given none gets none), and its ``banded``, ``c``,
    ``box_shape``, ``box_start`` and ``bf16_eps`` where given (the shadows
    and ``bf16_eps`` take effect on the levels the port's kernel gate makes
    blocked).

    With ``members`` the arrays carry JAX's batched stack's leading member
    axis (``jax.vmap`` of ``build_levels``): each level's flags (blocked,
    bf16 directions, shadows) are those `make_level` gives one member's
    arrays, its tensors keep the member axis for `torch.func.vmap` (through
    `ops.poisson.level_tensors`, as every field of `flow_from_numpy`), a
    banded level's corners among them (an ``(M, D)`` int64 tensor), and
    where the flags want shadows that JAX did not give, each member gets
    its own (`ops.poisson.operator_shadows`)."""
    from .ops.poisson import operator_shadows
    out = []
    for lev in levels:
        one = {k: (v[0] if members and k in MEMBER_ARRAYS and v is not None
                   else v) for k, v in lev.items()}
        level = make_level(_t(one["L"], device), perdir,
                           Dd=_t(one["D"], device), iD=_t(one["iD"], device),
                           **_shadows(one, device),
                           **{k: one[k] for k in LEVEL_EXTRAS if k in one})
        if members:
            full = {"L": _t(lev["L"], device), "D": _t(lev["D"], device),
                    "iD": _t(lev["iD"], device)}
            if level.banded:
                full["box_start"] = _corner(lev["box_start"], device, True)
            if level.L16 is not None:
                full.update({k: _t(lev[k], device) for k in SHADOWS}
                            if lev.get("L16") is not None else
                            zip(SHADOWS, torch.func.vmap(operator_shadows)(
                                full["L"])))
            level = dataclasses.replace(level, **full)
        out.append(level)
    return tuple(out)


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
                   l.box_start.to(device)
                   if isinstance(l.box_start, torch.Tensor) else l.box_start,
                   Dd=l.D.to(device), iD=l.iD.to(device),
                   bf16_eps=l.bf16_eps, **shadows(l))
        for l in levels)
