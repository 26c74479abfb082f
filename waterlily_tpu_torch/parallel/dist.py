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
every block) builds a global array on every rank of the replica.

Derivatives across ranks (``torch.autograd``) follow JAX's shard_map
typing.  A value is *varying* (a block, a halo plane: each rank its own)
or *invariant* (every rank holds it alike: a psum'd dot, ``dt``, ν, a
replicated coarse level, a dense field built on every rank).  A loss is
invariant and every rank calls ``backward`` on it alike; each rank's
gradient of an invariant leaf is then the whole gradient, and of a block
the rank's block of it.  The collectives' backward rules:

- ``psum`` (an ``all_gather`` and an ordered sum) and ``assemble``: each
  rank's value gets the invariant cotangent of its own slot, nothing
  crosses ranks (the gather's other slots drop theirs);
- ``pmax``: the cotangent goes to the rank or ranks holding the maximum,
  split among ties as ``amax`` splits it (the in-process mesh's pmax);
- ``ppermute``: the inverse permutation moves the cotangents back;
- ``pbroadcast`` (forward the identity), which marks an invariant value
  entering a block computation (the solver's step sizes, ``dt``, ν, the
  replicated coarse correction), and ``split`` of an invariant dense
  field: the ranks' partial cotangents summed (`mesh.ordered_sum` of an
  all-gather; a split's blocks joined), so every rank holds the same sum
  bit for bit.

Every rank must issue the backward pass's exchanges in one order: each
differentiated collective takes the token the previous one returned and
returns a new one, so autograd runs their backward rules in the reverse
order of the forward on every rank, and a rank whose own outputs of a
collective feed nothing still joins its backward exchange.  A backward
pass ends the chain: the next differentiated collective starts a new
one.  The in-process mesh needs
none of this: its collectives are plain tensor operations in one graph.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

from .mesh import ShardMesh, mesh_for, ordered_sum, _join

__all__ = ["ProcessMesh", "dist_mesh_for"]


def _tracked(*values) -> bool:
    """True where autograd records an operation on any of ``values``."""
    return torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in values)


class ProcessMesh(ShardMesh):
    """A mesh of ``prod(shards) * replicas`` ranks of the process group
    ``group`` (default: the world), this process one of them, its block on
    ``device``.  ``stats`` counts what the collectives moved: ``halo_bytes``
    (sent by ``ppermute``), ``gather_bytes`` (received by the gathers),
    ``calls`` and ``comm_s`` (wall seconds in the collectives, the host
    staging included), and the same four with a ``bwd_`` prefix for the
    exchanges of backward passes."""

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
        self.stats = {f"{p}{k}": v for p in ("", "bwd_") for k, v in
                      (("halo_bytes", 0), ("gather_bytes", 0), ("calls", 0),
                       ("comm_s", 0.0))}
        self._pre = ""          # "bwd_" inside a backward rule
        self._token = None      # the last differentiated collective's token

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

    def _count(self, key: str, n) -> None:
        self.stats[self._pre + key] += n

    def _done(self, t0: float) -> None:
        self._count("calls", 1)
        self._count("comm_s", time.perf_counter() - t0)

    # -- the backward pass's order ---------------------------------------------

    def _link(self) -> torch.Tensor:
        if self._token is None:
            self._token = torch.zeros((), device=self.device,
                                      requires_grad=True)
        return self._token

    def _chained(self, fn, *args):
        """``fn.apply(self, ..., token, ...)``: the outputs but the new
        token, which becomes the chain's last."""
        *out, self._token = fn.apply(self, self._link(), *args)
        return out

    @contextlib.contextmanager
    def _backward(self):
        """A backward rule's exchanges: counted apart; the chain ends."""
        self._token = None
        self._pre = "bwd_"
        try:
            yield
        finally:
            self._pre = ""

    # -- state ---------------------------------------------------------------

    def from_state(self, a: torch.Tensor, lead: int = 0) -> list:
        """The state is the rank's block: a one-item list of ``a``."""
        return [a]

    def to_state(self, blocks: list, lead: int = 0) -> torch.Tensor:
        (b,) = blocks
        return b

    def split(self, a: torch.Tensor, lead: int = 0) -> list:
        """The rank's block of the global array ``a``, which every rank
        holds alike; differentiated, the blocks' cotangents are joined
        into ``a``'s on every rank."""
        if _tracked(a):
            return self._chained(_Split, lead, a)
        return super().split(a, lead)

    # -- collectives ----------------------------------------------------------

    def _ppermute(self, b: torch.Tensor, d: int, perm):
        """The exchange of `ppermute` for this rank's tensor ``b`` (or a
        tensor of its shape where this rank sends nothing): the received
        tensor, or None."""
        t0 = time.perf_counter()
        c = list(self.coords(self.shard))
        ops, recv, out = [], None, None
        for src, dst in perm:
            if c[d] == src == dst:
                out = b
                continue
            if c[d] == src:
                to = c[:d] + [dst] + c[d + 1:]
                send = self._out(b)
                self._count("halo_bytes", send.numel() * send.element_size())
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
        return out

    def _gather(self, v: torch.Tensor) -> list:
        """Every shard's ``v`` of this replica, received (own slot too)."""
        t0 = time.perf_counter()
        src = self._out(v.reshape(-1))
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        self._count("gather_bytes", self.size * src.numel()
                    * src.element_size())
        out = [self._back(p).reshape(v.shape) for p in parts]
        self._done(t0)
        return out

    def ppermute(self, blocks: list, d: int, perm) -> list:
        """``jax.lax.ppermute`` along axis ``d`` between this replica's
        ranks: one ``batch_isend_irecv`` of this rank's sends and receive
        (a received block has the sent block's shape: blocks are
        uniform); ``[None]`` where this rank receives nothing."""
        (b,) = blocks
        if not _tracked(b):
            return [self._ppermute(b, d, perm)]
        (out,) = self._chained(_PPermute, d, tuple(perm), b)
        c = self.coords(self.shard)[d]
        return [out if any(c == dst for _src, dst in perm) else None]

    def all_gather(self, values: list) -> list:
        """Every shard's value of this replica, in row-major shard order
        (this rank's slot its own ``values[0]``)."""
        (v,) = values
        if _tracked(v):
            got = self._chained(_Gather, v)
            return got[:self.shard] + [v] + got[self.shard:]
        out = self._gather(v)
        out[self.shard] = v
        return out

    def pmax(self, values: list) -> torch.Tensor:
        (v,) = values
        if _tracked(v):
            (m,) = self._chained(_PMax, v)
            return m
        t0 = time.perf_counter()
        t = self._out(v.reshape(-1)).clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        self._done(t0)
        return self._back(t).reshape(v.shape)

    def pbroadcast(self, v):
        """An invariant value entering a block computation (module doc):
        the value itself; differentiated, its cotangent the sum of every
        rank's."""
        if not _tracked(v):
            return v
        (out,) = self._chained(_PBroadcast, v)
        return out

    def barrier(self) -> None:
        """Every rank of the mesh's replica group reaches this point."""
        dist.barrier(group=self.group)


# -- the differentiated collectives: (mesh, token, ...) -> (..., token) -----

def _token_grad(ctx):
    return torch.zeros((), device=ctx.mesh.device)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, tok, d, perm, b):
        ctx.mesh, ctx.d, ctx.perm = mesh, d, perm
        ctx.shape, ctx.dtype = b.shape, b.dtype
        out = mesh._ppermute(b, d, perm)
        if out is None:
            out = b.new_zeros(b.shape)      # never read (ppermute: None)
        elif out is b:
            out = b.clone()
        return out, tok.new_zeros(())

    @staticmethod
    def backward(ctx, g, _tok):
        mesh = ctx.mesh
        inverse = tuple((dst, src) for src, dst in ctx.perm)
        with mesh._backward():
            # a rank that received nothing sends nothing back; its tensor
            # only sizes the receive
            gb = mesh._ppermute(g.contiguous(), ctx.d, inverse)
        if gb is None:
            gb = torch.zeros(ctx.shape, dtype=ctx.dtype, device=g.device)
        return None, _token_grad(ctx), None, None, gb


class _Gather(torch.autograd.Function):
    """The other shards' values; their cotangents stay where they are."""

    @staticmethod
    def forward(ctx, mesh, tok, v):
        ctx.mesh = mesh
        parts = mesh._gather(v)
        del parts[mesh.shard]
        return (*parts, tok.new_zeros(()))

    @staticmethod
    def backward(ctx, *grads):
        ctx.mesh._token = None
        return None, _token_grad(ctx), None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, tok, v):
        ctx.mesh = mesh
        parts = torch.stack(mesh._gather(v))
        m = parts.amax(0)
        # amax's own rule: the cotangent over the count of ties
        ctx.save_for_backward((parts == m).sum(0), v == m)
        return m, tok.new_zeros(())

    @staticmethod
    def backward(ctx, g, _tok):
        ctx.mesh._token = None
        count, mask = ctx.saved_tensors
        return None, _token_grad(ctx), (g / count) * mask


class _PBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, tok, v):
        ctx.mesh = mesh
        return v.clone(), tok.new_zeros(())

    @staticmethod
    def backward(ctx, g, _tok):
        mesh = ctx.mesh
        with mesh._backward():
            total = ordered_sum(mesh._gather(g.contiguous()))
        return None, _token_grad(ctx), total


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, tok, lead, a):
        ctx.mesh, ctx.lead = mesh, lead
        (b,) = ShardMesh.split(mesh, a, lead)
        return b, tok.new_zeros(())

    @staticmethod
    def backward(ctx, g, _tok):
        mesh = ctx.mesh
        with mesh._backward():
            whole = _join(mesh._gather(g.contiguous()), mesh.shards,
                          ctx.lead)
        return None, _token_grad(ctx), None, whole


def dist_mesh_for(S: tuple, group=None, device="cuda") -> ProcessMesh:
    """`mesh_for`'s mesh choice for as many shards as ``group`` (default:
    the world) has ranks, as a `ProcessMesh` over the group."""
    m = mesh_for(S, dist.get_world_size(group), device)
    return ProcessMesh(m.shards, device, m.replicas, m.names, group)
