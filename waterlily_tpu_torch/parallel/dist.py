"""The shard mesh over processes: one block a `torch.distributed` rank.

`ProcessMesh` implements `parallel.mesh.ShardMesh`'s interface for the
one block its rank holds: a sharded field is a one-item list (the rank's
block), ``local_shards`` is ``(shard,)``, and the collectives move tensors
between ranks:

- ``ppermute`` is one ``batch_isend_irecv`` a call (a rank that receives
  nothing gets ``None``, as on the in-process mesh);
- ``psum`` gathers every shard's value (``all_gather``) and sums them in
  row-major shard order from shard 0 (`mesh.ordered_sum`), never with
  ``all_reduce(SUM)``, whose order the backend chooses: the sums, and so
  the solver's iteration counts and ``dt``, are bit for bit the in-process
  mesh's, and every rank takes the same host decisions (the adaptive
  solve's stopping test, the CFL) on a value all ranks hold alike;
- ``pmax`` is ``all_reduce(MAX)`` (the max is exact in any order).

Transports.  NCCL, one rank a GPU, moves CUDA tensors between cards.
Gloo serves the CPU and several ranks sharing one card (NCCL refuses two
ranks on one device); gloo neither sends nor gathers CUDA tensors, so on a
CUDA device every exchange is staged through the host: the tensor is
copied to host memory, moved by gloo, and copied back to the card.

Replicas (JAX's ``"r"`` axis, ``mesh_for``'s remainder): a world of
``size * replicas`` ranks; rank ``r * size + s`` holds shard ``s`` of
replica ``r``.  Each replica computes the same blocks; the gathers and
reductions run within the rank's replica group, the point-to-point moves
between ranks of one replica.

The state of a `Simulation` on a process mesh is the rank's blocks
(`from_state`/`to_state` hand them through); `assemble` (a gather of
every block) builds a global array on every rank of the replica and
serves output only.  `torch.distributed`'s
point-to-point operations carry no autograd: no derivative crosses a
rank.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .mesh import ShardMesh, mesh_for

__all__ = ["ProcessMesh", "dist_mesh_for"]


class ProcessMesh(ShardMesh):
    """A mesh of ``prod(shards) * replicas`` ranks of the process group
    ``group`` (default: the world), this process one of them, its block on
    ``device``.  ``stats`` counts what the collectives moved: ``halo_bytes``
    (sent by ``ppermute``), ``gather_bytes`` (received by the gathers),
    ``calls`` and ``comm_s`` (wall seconds in the collectives, the host
    staging included)."""

    distributed = True

    def __init__(self, shards, device="cuda", replicas: int = 1,
                 names=None, group=None):
        super().__init__(shards, device, replicas, names)
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised "
                               "torch.distributed process group")
        world = dist.get_world_size(group)
        if world != self.size * self.replicas:
            raise ValueError(f"{world} ranks for {self.size} shards x "
                             f"{self.replicas} replicas")
        backend = dist.get_backend(group)
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the NCCL backend moves CUDA tensors only")
        self.rank = dist.get_rank(group)
        self.replica, self.shard = divmod(self.rank, self.size)
        self._global = [dist.get_global_rank(group, r) if group is not None
                        else r for r in range(world)]
        # gloo moves host tensors: stage a CUDA block through the host
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.group = group
        if self.replicas > 1:
            # every rank creates every replica's group, in one order
            for r in range(self.replicas):
                g = dist.new_group([self._global[r * self.size + s]
                                    for s in range(self.size)])
                if r == self.replica:
                    self.group = g
        self.stats = {"halo_bytes": 0, "gather_bytes": 0, "calls": 0,
                      "comm_s": 0.0}

    def __repr__(self):
        return (f"ProcessMesh(shards={self.shards}, device={self.device}, "
                f"replicas={self.replicas}, rank={self.rank}, "
                f"shard={self.shard})")

    @property
    def local_shards(self) -> tuple:
        return (self.shard,)

    def _peer(self, s: int) -> int:
        """Global rank of shard ``s`` of this rank's replica."""
        return self._global[self.replica * self.size + s]

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return (t.to("cpu") if self.staged else t).contiguous()

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def _done(self, t0: float) -> None:
        self.stats["calls"] += 1
        self.stats["comm_s"] += time.perf_counter() - t0

    # -- state ---------------------------------------------------------------

    def from_state(self, a: torch.Tensor, lead: int = 0) -> list:
        """The state is the rank's block: a one-item list of ``a``."""
        return [a]

    def to_state(self, blocks: list, lead: int = 0) -> torch.Tensor:
        (b,) = blocks
        return b

    # -- collectives ----------------------------------------------------------

    def ppermute(self, blocks: list, d: int, perm) -> list:
        """``jax.lax.ppermute`` along axis ``d`` between this replica's
        ranks: one ``batch_isend_irecv`` of this rank's sends and receive
        (a received block has the sent block's shape: blocks are
        uniform); ``[None]`` where this rank receives nothing."""
        t0 = time.perf_counter()
        (b,) = blocks
        c = list(self.coords(self.shard))
        ops, recv, out = [], None, None
        for src, dst in perm:
            if c[d] == src == dst:
                out = b
                continue
            if c[d] == src:
                to = c[:d] + [dst] + c[d + 1:]
                send = self._out(b)
                self.stats["halo_bytes"] += send.numel() * send.element_size()
                ops.append(dist.P2POp(dist.isend, send,
                                      self._peer(self.index(to))))
            if c[d] == dst:
                frm = c[:d] + [src] + c[d + 1:]
                recv = torch.empty(b.shape, dtype=b.dtype,
                                   device="cpu" if self.staged else b.device)
                ops.append(dist.P2POp(dist.irecv, recv,
                                      self._peer(self.index(frm))))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv is not None:
            out = self._back(recv)
        self._done(t0)
        return [out]

    def all_gather(self, values: list) -> list:
        """Every shard's value of this replica, in row-major shard order."""
        t0 = time.perf_counter()
        (v,) = values
        src = self._out(v.reshape(-1))
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        self.stats["gather_bytes"] += (self.size * src.numel()
                                       * src.element_size())
        out = [self._back(p).reshape(v.shape) for p in parts]
        out[self.shard] = v
        self._done(t0)
        return out

    def pmax(self, values: list) -> torch.Tensor:
        t0 = time.perf_counter()
        (v,) = values
        t = self._out(v.reshape(-1)).clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        self._done(t0)
        return self._back(t).reshape(v.shape)

    def barrier(self) -> None:
        """Every rank of the mesh's replica group reaches this point."""
        dist.barrier(group=self.group)


def dist_mesh_for(S: tuple, group=None, device="cuda") -> ProcessMesh:
    """`mesh_for`'s mesh choice for as many shards as ``group`` (default:
    the world) has ranks, as a `ProcessMesh` over the group."""
    m = mesh_for(S, dist.get_world_size(group), device)
    return ProcessMesh(m.shards, device, m.replicas, m.names, group)
