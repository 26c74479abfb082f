"""The shard mesh of the spatial decomposition and its collectives.

PyTorch counterpart of `waterlily_tpu.parallel.mesh` (the mesh choice of
`mesh_for`) and of the three `jax.lax` collectives its shard_map regions
call.  A `ShardMesh` here is an in-process mesh: every shard of one process
lives on one device, and a collective is a tensor move on that device (the
analog of JAX's virtual CPU devices).  A sharded field is a list of the
blocks a process holds (`ShardMesh.local_shards`: here every shard, in
row-major shard order); the local functions of this package take lists and
return lists, and each collective reads the whole list.  A value that every
shard holds alike (a dot, a coarse multigrid level) is one tensor.  The
mesh over processes (`parallel.dist.ProcessMesh`, a `torch.distributed`
rank a block) implements the same interface for the one block a rank
holds, and differentiates across ranks by JAX's shard_map typing: a
value every shard holds alike enters the blocks' computation through
`ShardMesh.pbroadcast`.

GSPMD's sharding constraints (`constrain_state`, `constrain_levels`,
`mom_step_auto`, `sharded_step_fn`) have no counterpart: the one-region
step (`parallel.shard_step`) is the port's only sharded step.
"""
from __future__ import annotations

import math

import torch

__all__ = ["ShardMesh", "mesh_for", "ordered_sum", "_spatial_names",
           "_local_shape"]

NAMES = ("x", "y", "z")


class ShardMesh:
    """Shards per spatial axis (``shards[d]`` for axis ``d``; axes past the
    tuple are unsharded), the device every block lives on, and a count of
    replicas (JAX's trailing mesh axis ``"r"``, over which fields are
    replicated: in one process the replicas are one computation).

    ``names`` are the mesh's spatial axis names (``x``, ``y``, ``z`` by
    default), one for each sharded axis, in JAX's positional mapping of
    names to spatial axes."""

    # a process mesh keeps a Simulation's state as the rank's blocks; this
    # one keeps it global (`from_state`, `to_state`)
    distributed = False

    def __init__(self, shards, device="cuda", replicas: int = 1,
                 names=None):
        self.shards = tuple(int(k) for k in shards)
        if not self.shards or min(self.shards) < 1 or replicas < 1:
            raise ValueError(f"bad mesh: shards {shards}, replicas "
                             f"{replicas}")
        self.device = torch.device(device)
        self.replicas = int(replicas)
        self.names = tuple(names) if names is not None else \
            NAMES[:len(self.shards)]

    def __repr__(self):
        return (f"ShardMesh(shards={self.shards}, device={self.device}, "
                f"replicas={self.replicas})")

    @property
    def axis_names(self) -> tuple:
        return self.names + (("r",) if self.replicas > 1 else ())

    @property
    def shape(self) -> dict:
        """Axis name → size, as JAX's ``Mesh.shape``."""
        sizes = dict(zip(self.names, self.shards))
        if self.replicas > 1:
            sizes["r"] = self.replicas
        return sizes

    @property
    def size(self) -> int:
        """Shards of a field (the replicas not counted)."""
        return math.prod(self.shards)

    @property
    def local_shards(self) -> tuple:
        """The shards whose blocks this process holds, in the order of a
        sharded field's list: every shard here."""
        return tuple(range(self.size))

    def k(self, d: int) -> int:
        """Shards along spatial axis ``d``."""
        return self.shards[d] if d < len(self.shards) else 1

    def coords(self, s: int) -> tuple:
        """Per-axis index of shard ``s`` (row-major order)."""
        out = []
        for k in reversed(self.shards):
            out.append(s % k)
            s //= k
        return tuple(reversed(out))

    def index(self, coords) -> int:
        s = 0
        for c, k in zip(coords, self.shards):
            s = s * k + c
        return s

    def axis_index(self, d: int) -> list:
        """Each local shard's index along axis ``d`` (JAX's
        ``axis_index``)."""
        return [self.coords(s)[d] if d < len(self.shards) else 0
                for s in self.local_shards]

    def base(self, s: int, S) -> tuple:
        """Global index of shard ``s``'s cell 0 on a grid of shape ``S``."""
        c = self.coords(s)
        return tuple((c[d] if d < len(c) else 0) * (S[d] // self.k(d))
                     for d in range(len(S)))

    # -- the shard_map region's in_specs and out_specs ---------------------

    def _slices(self, s: int, S, lead: int) -> tuple:
        b = self.base(s, S)
        return (slice(None),) * lead + tuple(
            slice(b[d], b[d] + S[d] // self.k(d)) for d in range(len(S)))

    def split(self, a: torch.Tensor, lead: int = 0) -> list:
        """The local blocks of global array ``a`` (``lead`` leading
        component axes, then the spatial axes), each a contiguous copy."""
        S = tuple(a.shape[lead:])
        return [a[self._slices(s, S, lead)].clone(
                    memory_format=torch.contiguous_format)
                for s in self.local_shards]

    def assemble(self, blocks: list, lead: int = 0) -> torch.Tensor:
        """The global array of a sharded field (every process gets it)."""
        return _join(self.all_gather(blocks), self.shards, lead)

    def from_state(self, a: torch.Tensor, lead: int = 0) -> list:
        """A state field, as a Simulation on this mesh keeps it (global
        here), as the list of local blocks."""
        return self.split(a, lead)

    def to_state(self, blocks: list, lead: int = 0) -> torch.Tensor:
        """The inverse of `from_state`."""
        return self.assemble(blocks, lead)

    # -- collectives --------------------------------------------------------

    def ppermute(self, blocks: list, d: int, perm) -> list:
        """``jax.lax.ppermute`` along axis ``d``: shard ``dst`` (its index on
        ``d``) receives the block of shard ``src`` for each ``(src, dst)``
        of ``perm``, the other coordinates kept.  A shard that receives
        nothing gets ``None`` (JAX gives zeros there; every caller selects
        another value at those shards)."""
        src_of = {dst: src for src, dst in perm}
        out = []
        for s in range(self.size):
            c = list(self.coords(s))
            if c[d] in src_of:
                c[d] = src_of[c[d]]
                out.append(blocks[self.index(c)])
            else:
                out.append(None)
        return out

    def all_gather(self, values: list) -> list:
        """Every shard's value (tensors of one shape), in row-major shard
        order, from the local shards' ``values``."""
        return list(values)

    def psum(self, values: list) -> torch.Tensor:
        """``jax.lax.psum`` over every spatial axis: the sum of the shards'
        values in row-major shard order (`ordered_sum`), one tensor every
        shard holds."""
        return ordered_sum(self.all_gather(values))

    def pmax(self, values: list) -> torch.Tensor:
        """``jax.lax.pmax`` over every spatial axis (``amax``: a
        derivative splits among tied shards evenly)."""
        return torch.stack(values).amax(0)

    def pbroadcast(self, v):
        """An invariant value (one every shard holds alike) entering the
        blocks' computation: ``v`` itself here, where autograd sums its
        cotangents over the blocks in one graph; a process mesh sums them
        over the ranks (`parallel.dist`)."""
        return v


def ordered_sum(values: list) -> torch.Tensor:
    """``values[0] + values[1] + ...`` from the first: the one order of
    every psum, so that a process mesh sums bit for bit as this one."""
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total


def _join(blocks: list, shards: tuple, lead: int) -> torch.Tensor:
    """The global array of every shard's block (row-major shard order):
    the blocks concatenated along the last mesh axis first."""
    for d in reversed(range(len(shards))):
        k = shards[d]
        blocks = [torch.cat(blocks[i:i + k], dim=lead + d) if k > 1
                  else blocks[i] for i in range(0, len(blocks), k)]
    return blocks[0]


def mesh_for(S: tuple, n: int, device="cuda") -> ShardMesh:
    """A mesh of ``n`` shards whose per-axis counts divide the padded grid
    shape ``S``, chosen as `waterlily_tpu.parallel.mesh.mesh_for` chooses:
    each axis in turn takes the largest power of 2 of what is left of
    ``n`` that divides ``S[d]``; what remains is the replica count.
    Ghost-padded multigrid sizes are 2 times an odd number, so each axis
    takes at most 2 (258³ over 8: (2, 2, 2), local blocks 129³)."""
    rem = int(n)
    dims, names = [], []
    for d, s in enumerate(S[:3]):
        f = 1
        while rem % 2 == 0 and s % (2 * f) == 0:
            f *= 2
            rem //= 2
        if f > 1:
            dims.append(f)
            names.append(NAMES[d])
    if not dims:
        dims, names = [1], ["x"]
    # JAX maps the mesh's spatial axes onto the grid's axes by position
    shards = tuple(dims[d] if d < len(dims) else 1 for d in range(len(S)))
    return ShardMesh(shards, device, replicas=rem, names=names)


def _spatial_names(mesh: ShardMesh) -> tuple:
    return tuple(n for n in mesh.axis_names if n != "r")


def _local_shape(mesh: ShardMesh, S: tuple) -> tuple:
    return tuple(S[k] // mesh.k(k) for k in range(len(S)))
