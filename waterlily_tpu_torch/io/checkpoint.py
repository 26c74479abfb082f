"""Checkpoint and restart of a Simulation's state (numpy ``.npz``).

PyTorch counterpart of `waterlily_tpu.io.checkpoint` with the same keys:
every `FlowState` field (``u``, ``p``, ``V``, ``mu0``, ``mu1``, ``dt``,
``t``, ``bbox``) plus the host histories ``dts`` and ``pois_n``, so that a
restart is bit for bit and a file written by either package restarts in
the other.  A tensor reaches numpy through ``.cpu()``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..body import _d_center
from ..convert import flow_from_numpy, to_numpy
from ..grid import band_box_start
from ..ops.multigrid import build_levels

__all__ = ["save_checkpoint", "load_checkpoint", "restart_sim"]

_FIELDS = ("u", "p", "V", "mu0", "mu1", "dt", "t", "bbox")


def save_checkpoint(fname: str, sim) -> None:
    """Save a Simulation's whole state and histories to ``fname`` (.npz).
    A dense state's window corner (None) is written as int32 zeros, as
    JAX writes it."""
    D = len(sim.cfg.S)
    arrays = {f: to_numpy(getattr(sim.flow, f)) for f in _FIELDS
              if f != "bbox"}
    bbox = sim.flow.bbox
    arrays["bbox"] = np.asarray((0,) * D if bbox is None else bbox, np.int32)
    arrays["dts"] = np.asarray(sim.dts)
    arrays["pois_n"] = np.asarray(sim.pois_n, np.int32).reshape(-1, 2)
    np.savez(fname, **arrays)


def load_checkpoint(fname: str) -> dict:
    """The arrays saved by `save_checkpoint` (either package's)."""
    with np.load(fname) as data:
        return {k: data[k] for k in data.files}


def _restored_bbox(sim, data, dtype):
    """Window corner of a restored state (host ints; None for a dense sim).

    A banded sim recomputes it from the body at the restored time: the
    file's corner may come from a dense run (zeros), which would park the
    BDIM window at the domain corner while the body sits mid-domain."""
    if sim.cfg.bbox_shape is None:
        return None
    t = torch.as_tensor(data["t"], dtype=dtype, device=sim.device)
    d = _d_center(sim.body, sim.cfg.S, t, dtype, sim.device)
    return tuple(band_box_start(d < (2.0 + sim.epsilon),
                                sim.cfg.bbox_shape).tolist())


def restart_sim(sim, fname: str):
    """Restore a Simulation in place from a checkpoint; the grid shape
    must match.  The Poisson levels are rebuilt from the restored μ₀."""
    data = load_checkpoint(fname)
    if tuple(data["p"].shape) != sim.cfg.S:
        raise ValueError(f"checkpoint grid {data['p'].shape} != sim grid "
                         f"{sim.cfg.S}")
    dtype = sim.cfg.dtype
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    flow = flow_from_numpy({k: np.array(data[k], np_dtype, order="C")
                            for k in _FIELDS if k != "bbox"}, sim.device)
    sim.flow = flow.replace(bbox=_restored_bbox(sim, data, dtype))
    sim.levels = build_levels(sim.flow.mu0, sim.cfg.perdir, sim._lv_box,
                              sim.flow.bbox, bf16_eps=sim._smoother_bf16,
                              op_bf16=sim._op_bf16)
    sim.dts = [float(x) for x in data["dts"]]
    sim.pois_n = [[int(v) for v in row] for row in data["pois_n"]]
    return sim
