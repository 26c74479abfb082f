"""Checkpoint and restart of a Simulation's state (numpy ``.npz``).

PyTorch counterpart of `waterlily_tpu.io.checkpoint` with the same keys:
every `FlowState` field (``u``, ``p``, ``V``, ``mu0``, ``mu1``, ``dt``,
``t``, ``bbox``) plus the host histories ``dts`` and ``pois_n``, so that a
restart is bit for bit and a file written by either package restarts in
the other.  A tensor reaches numpy through ``.cpu()``.

On a process mesh (`parallel.dist.ProcessMesh`, the port's counterpart of
JAX's per-shard Orbax pair) each shard is written by its rank of replica 0
to a file of its own, ``<prefix>.shard<s>.npz``: its blocks, its shard
coordinates, the mesh's shards and the grid ``S``, with ``dt``, ``t``,
``dts`` and ``pois_n``; every rank restarts from its shard's file.
`assemble_checkpoint` joins the files into the single-file npz that
`restart_sim` reads on one device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..body import _d_center
from ..convert import flow_from_numpy, to_numpy
from ..grid import band_box_start
from ..ops.multigrid import build_levels

__all__ = ["save_checkpoint", "load_checkpoint", "restart_sim",
           "assemble_checkpoint", "shard_file"]

_FIELDS = ("u", "p", "V", "mu0", "mu1", "dt", "t", "bbox")
# the spatial fields and their leading component axes
_LEAD = {"u": 1, "p": 0, "V": 1, "mu0": 1, "mu1": 2}


def _prefix(fname: str) -> str:
    return fname[:-4] if fname.endswith(".npz") else fname


def shard_file(fname: str, s: int) -> str:
    """The file of shard ``s`` of the per-rank checkpoint ``fname``."""
    return f"{_prefix(fname)}.shard{s}.npz"


def save_checkpoint(fname: str, sim) -> None:
    """Save a Simulation's whole state and histories to ``fname`` (.npz).
    A dense state's window corner (None) is written as int32 zeros, as
    JAX writes it.  On a process mesh every rank calls it: replica 0's
    ranks each write their shard's file (`shard_file`), and every rank
    returns when all are written."""
    D = len(sim.cfg.S)
    arrays = {f: to_numpy(getattr(sim.flow, f)) for f in _FIELDS
              if f != "bbox"}
    bbox = sim.flow.bbox
    arrays["bbox"] = np.asarray((0,) * D if bbox is None else bbox, np.int32)
    arrays["dts"] = np.asarray(sim.dts)
    arrays["pois_n"] = np.asarray(sim.pois_n, np.int32).reshape(-1, 2)
    mesh = sim.mesh
    if not getattr(mesh, "distributed", False):
        np.savez(fname, **arrays)
        return
    if mesh.replica == 0:
        np.savez(shard_file(fname, mesh.shard), **arrays,
                 shard=np.int32(mesh.shard),
                 coords=np.asarray(mesh.coords(mesh.shard), np.int32),
                 shards=np.asarray(mesh.shards, np.int32),
                 S=np.asarray(sim.cfg.S, np.int32))
    mesh.barrier()


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
    must match.  The Poisson levels are rebuilt from the restored μ₀.  On
    a process mesh every rank reads its shard's file (`shard_file`); a
    grid or mesh other than the sim's raises `ValueError` before anything
    is restored, and the levels are built from the μ₀ assembled from every
    shard."""
    mesh = sim.mesh
    distributed = getattr(mesh, "distributed", False)
    data = load_checkpoint(shard_file(fname, mesh.shard) if distributed
                           else fname)
    if distributed:
        S, shards = tuple(data["S"].tolist()), tuple(data["shards"].tolist())
        if S != sim.cfg.S or shards != mesh.shards:
            raise ValueError(f"checkpoint grid {S} on mesh {shards} != sim "
                             f"grid {sim.cfg.S} on mesh {mesh.shards}")
    elif tuple(data["p"].shape) != sim.cfg.S:
        raise ValueError(f"checkpoint grid {data['p'].shape} != sim grid "
                         f"{sim.cfg.S}")
    dtype = sim.cfg.dtype
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    flow = flow_from_numpy({k: np.array(data[k], np_dtype, order="C")
                            for k in _FIELDS if k != "bbox"}, sim.device)
    sim.flow = flow.replace(bbox=_restored_bbox(sim, data, dtype))
    mu0 = mesh.assemble([flow.mu0], 1) if distributed else sim.flow.mu0
    levels = build_levels(mu0, sim.cfg.perdir, sim._lv_box, sim.flow.bbox,
                          bf16_eps=sim._smoother_bf16, op_bf16=sim._op_bf16)
    if distributed:
        from ..parallel.shard_step import local_levels
        levels = local_levels(mesh, levels)
    sim.levels = levels
    sim.dts = [float(x) for x in data["dts"]]
    sim.pois_n = [[int(v) for v in row] for row in data["pois_n"]]
    return sim


def assemble_checkpoint(prefix: str, out: str) -> None:
    """Join the shard files of the per-rank checkpoint ``prefix`` (as
    given to `save_checkpoint`) into the single-file checkpoint ``out``,
    which `restart_sim` reads on one device (or an in-process mesh)."""
    from ..parallel.mesh import ShardMesh
    first = load_checkpoint(shard_file(prefix, 0))
    mesh = ShardMesh(tuple(first["shards"].tolist()), "cpu")
    parts = [first] + [load_checkpoint(shard_file(prefix, s))
                       for s in range(1, mesh.size)]
    for s, part in enumerate(parts):
        if int(part["shard"]) != s or tuple(part["S"]) != tuple(first["S"]):
            raise ValueError(f"{shard_file(prefix, s)} is not shard {s} of "
                             f"the grid {tuple(first['S'])}")
    arrays = {k: first[k] for k in ("dt", "t", "bbox", "dts", "pois_n")}
    for k, lead in _LEAD.items():
        arrays[k] = mesh.assemble([torch.from_numpy(p[k]) for p in parts],
                                  lead).numpy()
    np.savez(out, **arrays)
