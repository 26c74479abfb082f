"""Wrappers, plain versions and launch counters of the 3D stencil kernels.

Counterpart of `waterlily_tpu.ops.pallas_stencil`.  Each wrapper below
launches its hand-written CUDA kernel (``csrc/``) when its tensors lie on a
CUDA device, and runs its plain PyTorch version when they lie on the CPU;
any other device raises.  There is no fallback: a CUDA tensor the kernel
does not take (dtype, shape, layout, an unported variant) raises.

Each wrapper counts its launches in a plain int attribute, ``.launches``,
incremented only where the kernel is launched (those of its member form
also in ``.members``), and its launches at each shape in a
`collections.Counter`, ``.shapes``; a wrapper with bf16 forms
also keeps
the forms it launched in ``.forms`` (each the names of the arguments that
were bf16, ``()`` for all f32); ``conv_diff3d``'s are its limiters' names,
``bc3d``'s ``"inplace"`` or ``"copy"``.

``bc3d``, ``div3d``, ``project3d`` and ``conv_diff3d`` also have the
shard-local forms of `waterlily_tpu.parallel`: given ``S_glob`` and
``base`` (host ints), the array is one shard's block (halo-extended for
the last three) of a grid of sizes ``S_glob`` whose cell 0 sits at global
index ``base``, and the boundary tests compare global positions;
``conv_diff3d`` also takes ``modular`` (periodic axes with modular wrap
halos).  Each such launch adds ``"base"`` (and ``"modular"``) to the
wrapper's ``.forms`` and counts ``(shape, S_glob, base, form)`` in its
``.bases``, a `collections.Counter`.

The plain versions are the package's own whole-array forms (the functions
`waterlily_tpu` runs through XLA on the CPU), with the same association as
the kernels: with ``--fmad=false`` every kernel without an in-kernel sum
equals its plain version bit for bit on the card.

The dispatch gates mirror the JAX package's, with "tensor on a CUDA device"
in place of "backend is TPU" and the same size, rank and dtype conditions.

The kernels have no derivatives.  A wrapper handed an operand that
autograd tracks (`ad_tracked`: ``requires_grad`` under grad mode, a
forward-AD dual, a `torch.func` transform's tensor) off the CPU raises a
`RuntimeError`; it never detaches.  The gates' callers (`kernel_ok`,
`ops.poisson`'s level branches, `pcg_kernel.use_pcg_fused`'s caller) send
a tracked field to the plain form on its own device instead, as the JAX
package keeps its AD programs on the XLA forms (``pallas_ok=False``): the
one route of a CUDA field off a kernel, visible in the launch counters,
which count kernel launches only.

A field under `torch.func.vmap` (an ensemble's member axis) counts as
tracked too (`ad_tracked`, `kernel_ok`), but one that `vmap` alone
batches (`vmap_only`) has member forms: every wrapper of a solver path
but `pcg_fused` (the eight here, `mult3d`, `increment3d`, `cfl3d`,
`bc3d`, `div3d`, `project3d`, `conv_diff3d`, whole grid, and
`ana_mult3d`, and the six of `ops.attic`, `dot3d`, `pcg_axpy`,
`pcg_dir_mult`, `pcg_update`, `mult3d_stream`, `increment3d_stream`)
takes it through an `autograd.Function` whose `vmap` rule folds every
`vmap` level into one member axis and launches the kernel once for all
members (`member_form`; a member's work, its sums included, is that of
its own launch, bit for bit; ``"members"`` in ``.forms``), and their
gates (`members_ok`, and `ops.poisson`'s level branches and seams) send
such a field there; the PCG smooth's caller (`ops.poisson.smooth`) sends
it to `pcg_kernel.pcg_fused`, whose `vmap` rule launches once for a
chunk of members, or on a blocked level to `ops.attic.pcg_blocked`,
two member-form launches an iteration.  `ana_mult3d`'s member form is a
batched banded level's far-field operator, each member its own window
fix-up around it (`ops.poisson._banded_ax`).  Inside `plain_forms` every
field counts as tracked: the primal loop of an adaptive solve that
`torch.func.jvp` differentiates under `vmap` runs there
(`ops.poisson._Loop`).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import math

import torch
from torch.autograd import forward_ad

from ..kernels.build import THREADS, launch, library
from .pcg_kernel import fold_members

__all__ = ["MIN_CELLS", "use_blocked", "tracked_by", "ad_tracked", "vmapped",
           "vmap_only", "plain_forms", "kernel_ok", "members_ok",
           "member_form", "COUNTERS",
           "mult3d", "increment3d", "ana_mult3d",
           "cfl3d", "bc3d", "div3d", "project3d", "conv_diff3d",
           "global_interior", "kernel_wrappers"]

# Minimum ghost-padded cell count for the kernel tier (the JAX gate's own
# floor): smaller levels run the plain forms on the device.
MIN_CELLS = 100_000


def use_blocked(S, dtype, device) -> bool:
    """Gate of every stencil kernel in this module: big 3D f32 fields on a
    CUDA device.  (JAX's separate `use_bc3d`/`use_project3d` gates differ
    from this one only by minimum axis-0 lengths that fit its TPU slabs;
    one-thread-per-cell kernels have no such minimum.)  A field that
    autograd tracks is held off the kernels by `kernel_ok`."""
    return (len(S) == 3 and dtype == torch.float32
            and torch.device(device).type == "cuda"
            and math.prod(S) >= MIN_CELLS)


_functorch = torch._C._functorch


def _kinds(v: torch.Tensor, grad_on: bool, duals: bool) -> set:
    """How ``v`` is tracked: ``"ad"`` for ``requires_grad`` under grad mode,
    for a forward-AD dual at any level (a ``jvp`` level's tensor is one)
    and inside `plain_forms`, ``"vmap"`` for each `torch.func.vmap` level
    that batches it, ``"wrapped"`` for any other `torch.func` level (a
    ``grad`` level's tensor that does not require grad: a cotangent in a
    backward pass)."""
    kinds = {"ad"} if _PLAIN or (grad_on and v.requires_grad) else set()
    # a dual's tangent sits on its own level's tensor, which may lie beneath
    # a vmap level (jvp of vmap); a batched tensor has none to unpack
    t = v
    while True:
        batched = _functorch.is_batchedtensor(t)
        if (duals and not batched
                and forward_ad.unpack_dual(t).tangent is not None):
            kinds.add("ad")
        if not _functorch.is_functorch_wrapped_tensor(t):
            break
        kinds.add("vmap" if batched else "wrapped")
        t = _functorch.get_unwrapped(t)
    if grad_on and t.requires_grad:
        kinds.add("ad")
    return kinds


# >0 inside `plain_forms()`
_PLAIN = 0


@contextlib.contextmanager
def plain_forms():
    """Inside the block every field counts as tracked by autograd
    (`tracked_by` adds ``"ad"``), so every gate sends it to the plain
    forms: the primal of an adaptive loop that `torch.func.jvp`
    differentiates runs there (`ops.poisson._Loop`), as the loop's
    tangent, and a member's own `jvp`, do."""
    global _PLAIN
    _PLAIN += 1
    try:
        yield
    finally:
        _PLAIN -= 1


def tracked_by(*values) -> set:
    """The union of the ways ``values`` are tracked (``"ad"``, ``"vmap"``,
    ``"wrapped"``; tuples and lists looked into, anything but a tensor
    untracked)."""
    grad_on = torch.is_grad_enabled()
    # unpack_dual's own test: no dual level open, no dual tensor
    duals = forward_ad._current_level >= 0
    kinds = set()
    for v in values:
        if isinstance(v, torch.Tensor):
            kinds |= _kinds(v, grad_on, duals)
        elif isinstance(v, (tuple, list)):
            kinds |= tracked_by(*v)
    return kinds


def ad_tracked(*values) -> bool:
    """True where autograd tracks any of ``values``: a tensor with
    ``requires_grad`` while grad mode is on, a forward-AD dual, or a
    `torch.func` transform's tensor (``jvp``, ``grad``, ``vmap``); tuples
    and lists are looked into, anything else is untracked."""
    return bool(tracked_by(*values))


def vmapped(*values) -> bool:
    """True where some of ``values`` carry `torch.func.vmap` levels."""
    return "vmap" in tracked_by(*values)


def vmap_only(*values) -> bool:
    """True where some of ``values`` carry `torch.func.vmap` levels (one or
    nested) and none is tracked otherwise (no ``grad``/``jvp`` level, no
    ``requires_grad`` under grad mode, no dual): an ensemble's fields,
    which a kernel with a member axis may take."""
    return tracked_by(*values) == {"vmap"}


def kernel_ok(S, dtype, device, *operands) -> bool:
    """`use_blocked`, closed to ``operands`` that autograd tracks or
    `vmap` batches (`ad_tracked`): such a field takes the plain form on
    its own device."""
    return use_blocked(S, dtype, device) and not ad_tracked(*operands)


# --- argument checks --------------------------------------------------------

def _on_cpu(name: str, t: torch.Tensor, *operands) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel);
    raises a `RuntimeError` where ``t`` or one of ``operands`` (tensors,
    scalars, tuples of them) is tracked by autograd off the CPU, and a
    `ValueError` for any device but the CPU and CUDA."""
    if t.device.type == "cpu":
        return True
    if ad_tracked(t, *operands):
        raise RuntimeError(
            f"{name}: an operand is tracked by autograd (requires_grad, a "
            f"forward-AD dual or a torch.func transform); the CUDA kernel "
            f"has no derivative and does not detach.  Tracked fields take "
            f"the plain forms through the kernel gates "
            f"(stencil_kernels.kernel_ok)")
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: tensors on {t.device} are not supported")


def _check(name: str, S: tuple, ranks=(3,), bf16=(), **tensors) -> None:
    """Kernel arguments: f32 (or bf16 for the arguments named in ``bf16``:
    search directions and a level's operator shadows), contiguous, one CUDA
    device, expected shape, a field rank in ``ranks``."""
    dev = None
    for arg, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype != torch.float32 and not (arg in bf16
                                             and t.dtype == torch.bfloat16):
            kinds = "float32 or bfloat16" if arg in bf16 else "float32"
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                            f"{kinds}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
    if len(S) not in ranks:
        raise ValueError(f"{name}: the kernel takes fields of rank "
                         f"{' or '.join(map(str, ranks))}, got S={S}")


def _scalar_on(v, like: torch.Tensor, name: str) -> torch.Tensor:
    """A (1,) f32 device tensor holding scalar ``v`` (a number or a
    one-element tensor on ``like``'s device); no host synchronisation."""
    if isinstance(v, torch.Tensor):
        if v.device != like.device or v.numel() != 1:
            raise ValueError(f"{name}: scalar operand must be a one-element "
                             f"tensor on {like.device}")
        return v.to(torch.float32).reshape(1).contiguous()
    return torch.full((1,), float(v), dtype=torch.float32, device=like.device)


def _vector_on(A, like: torch.Tensor, name: str) -> torch.Tensor:
    """A (3,) f32 device tensor of the BC values ``A`` (a (3,) tensor, or
    one-element tensors and numbers), with no host synchronisation."""
    if isinstance(A, torch.Tensor):
        if A.shape != (3,) or A.device != like.device:
            raise ValueError(f"{name}: A must be a (3,) tensor on "
                             f"{like.device}")
        return A.to(torch.float32).contiguous()
    return torch.cat([_scalar_on(a, like, name) for a in A])


def _axis_bits(perdir) -> int:
    """The kernels' periodic-axes argument: bit d set for each axis d in
    ``perdir``."""
    return sum(1 << d for d in set(perdir))


def _counted(fn):
    fn.launches = 0
    fn.members = 0      # of the launches, those of the member form
    fn.shapes = collections.Counter()
    fn.forms = set()
    fn.bases = collections.Counter()
    return fn


def _global(S, S_glob, base) -> tuple:
    """The six ints of a launch's global grid: its sizes and the global
    index of the array's cell 0 (``S`` and zeros for a whole-grid call)."""
    if base is None:
        return tuple(S) + (0,) * len(S)
    S_glob = tuple(S) if S_glob is None else tuple(int(g) for g in S_glob)
    base = tuple(int(b) for b in base)
    if len(S_glob) != len(S) or len(base) != len(S):
        raise ValueError(f"S_glob {S_glob} and base {base} must have one "
                         f"entry per axis of {S}")
    return S_glob + base


def _count_base(fn, S, glob, extra=()) -> None:
    """One shard-local launch of wrapper ``fn`` with the global grid
    ``glob`` (`_global`): ``"base"`` in ``.forms``, and its shape, global
    sizes, base and ``extra`` (the form's other arguments) in ``.bases``."""
    fn.forms.add("base")
    fn.bases[(tuple(S), glob[:3], glob[3:]) + tuple(extra)] += 1


def global_interior(S, S_glob, base, device=None) -> torch.Tensor:
    """Mask of the cells of an array of shape ``S`` at global index
    ``base`` that are interior in the grid of sizes ``S_glob``."""
    m = None
    for d in range(len(S)):
        view = [1] * len(S)
        view[d] = S[d]
        g = (torch.arange(S[d], device=device) + base[d]).reshape(view)
        md = (g >= 1) & (g <= S_glob[d] - 2)
        m = md if m is None else m & md
    return m


def _count(fn, S, members: bool = False, form=None, **streams) -> None:
    """One launch of wrapper ``fn`` at shape ``S``: a member form's
    (``members``) adds ``"members"`` to ``.forms``, a one-field launch
    ``form`` or, by default, the names of ``streams`` (the arguments that
    may be bf16) that are bf16."""
    fn.launches += 1
    fn.members += int(bool(members))
    fn.shapes[S] += 1
    fn.forms.add("members" if members else form if form is not None
                 else tuple(k for k, t in streams.items()
                            if t.dtype == torch.bfloat16))


# --- member forms: an ensemble under torch.func.vmap ------------------------
#
# Each of the eight stencil wrappers below (`mult3d`, `increment3d`,
# `ana_mult3d`, `cfl3d`, `bc3d`, `div3d`, `project3d`, `conv_diff3d`), and
# each of `ops.attic`'s six (`dot3d`, `pcg_axpy`, `pcg_dir_mult`,
# `pcg_update`, `mult3d_stream`, `increment3d_stream`), has a member form:
# its kernel over M members in one launch, whatever M (a grid axis runs
# over the members; each member's work, sums included, is a one-member
# launch's, bit for bit).  A wrapper handed operands that `vmap` batches
# and nothing else tracks (`vmap_only`) enters it through one
# `torch.autograd.Function` a wrapper, built by `_member_function`: the
# wrapper gives its main operand a member axis of 1, and the Function's
# `vmap` rule folds each `vmap` level's batch axis into that member axis
# (`pcg_kernel.fold_members`), an operand without one shared by every
# member (a member stride of 0), and applies the Function again, so that
# nested `vmap` levels fold one by one into one launch.  Its forward is
# `member_form`: on the CPU `vmap` of the wrapper's plain version, on CUDA
# the kernel (or a raise).


def members_ok(S, dtype, device, *operands) -> bool:
    """`kernel_ok`, open also to ``operands`` that `torch.func.vmap`
    batches and nothing else tracks (`vmap_only`: an ensemble's fields,
    which the member forms take); a field that autograd tracks still takes
    the plain form."""
    return use_blocked(S, dtype, device) and tracked_by(*operands) <= {"vmap"}


# wrapper name -> (ranks, main, plain, launch, inplace, Function)
_MEMBERS = {}


def _has_members(t, rank: int) -> bool:
    """True where operand ``t`` (of rank ``rank`` in the one-field form)
    carries a leading member axis."""
    return isinstance(t, torch.Tensor) and t.ndim > rank


def member_form(name: str, *args):
    """Wrapper ``name``'s member form on operands that carry a leading
    member axis (its main operand always; any other one shared by every
    member where it has none), then its other arguments: on the CPU
    `torch.func.vmap` of the wrapper's plain version over the member axis,
    on CUDA one launch of its kernel over every member (raising where the
    kernel does not take them).  Returns the outputs with a leading member
    axis."""
    ranks, main, plain, launch_fn = _MEMBERS[name][:4]
    ops, rest = args[:len(ranks)], args[len(ranks):]
    if _on_cpu(name, ops[main], *ops):
        dims = tuple(0 if _has_members(t, r) else None
                     for t, r in zip(ops, ranks))
        return torch.func.vmap(lambda *t: plain(*t, *rest),
                               in_dims=dims)(*ops)
    return launch_fn(*ops, *rest, members=True)


def _member_function(name, ranks, main, plain, launch_fn, inplace=None):
    """Register wrapper ``name``'s member form: ``ranks`` the one-field
    ranks of its operands (a scalar may be a number, the BC values numbers,
    an operand a wrapper does not read None: passed as they are), ``main``
    the index of
    the one the wrapper gives a member axis, ``plain`` its plain version
    and ``launch_fn`` its kernel launch (both on the operands, then the
    wrapper's other arguments; the launch with ``members=True`` on operands
    with a member axis), ``inplace`` (of the other arguments) whether the
    launch fills the main operand in place.  Builds its
    `torch.autograd.Function`: forward `member_form`, no derivative, a
    `vmap` rule that folds."""
    n = len(ranks)

    def forward(*args):
        return member_form(name, *args)

    def setup_context(ctx, inputs, output):
        pass

    def backward(ctx, *grads):
        raise RuntimeError(f"{name}'s member form has no derivative: "
                           f"tracked fields take its plain version")

    def vmap(info, in_dims, *args):
        B = info.batch_size
        ops, rest = args[:n], args[n:]
        d = in_dims[main]
        M = ops[main].shape[1 if d == 0 else 0]
        folded = [fold_members(t, dt, t.ndim - (dt is not None) > r, B, M)
                  if isinstance(t, torch.Tensor) else t
                  for t, dt, r in zip(ops, in_dims[:n], ranks)]
        out = fn.apply(*folded, *rest)
        if inplace is not None and inplace(*rest) and d is not None:
            # the fill reaches the batched field: where folding copied it,
            # the filled copy goes back into the field's own memory
            # (a nested level's field, a functorch tensor, always)
            mine = ops[main].movedim(d, 0)
            if (_functorch.is_functorch_wrapped_tensor(mine)
                    or not (mine.is_contiguous()
                            and mine.data_ptr() == out.data_ptr())):
                mine.copy_(out.reshape(mine.shape))
        if isinstance(out, tuple):
            return (tuple(o.reshape((B, M) + tuple(o.shape[1:]))
                          for o in out), (0,) * len(out))
        return out.reshape((B, M) + tuple(out.shape[1:])), 0

    fn = type(f"_{name}_members", (torch.autograd.Function,), {
        "forward": staticmethod(forward),
        "setup_context": staticmethod(setup_context),
        "backward": staticmethod(backward), "vmap": staticmethod(vmap)})
    _MEMBERS[name] = (tuple(ranks), main, plain, launch_fn, inplace, fn)


def _by_members(name: str, *args):
    """Wrapper ``name`` on operands under `vmap` alone: its member form
    through its Function, the main operand given a member axis of 1 (which
    the `vmap` rule folds the batch axes into), the outputs without it."""
    main = _MEMBERS[name][1]
    args = list(args)
    args[main] = args[main][None]
    out = _MEMBERS[name][5].apply(*args)
    return tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]


def _stride(t: torch.Tensor, rank: int) -> int:
    """A kernel operand's member stride (elements): one member's values,
    or 0 for an operand every member shares."""
    return t[0].numel() if t.ndim > rank else 0


def _each(t: torch.Tensor, shape, M: int) -> tuple:
    """The shape an operand of one-field shape ``shape`` must have: with
    its member axis of ``M`` where it carries one."""
    shape = tuple(shape)
    return (M,) + shape if t.ndim > len(shape) else shape


def _scalars_on(v, like: torch.Tensor, name: str, M: int):
    """``(values, stride)`` of a scalar operand for ``M`` members: a (1,)
    f32 device array of a number or one-element tensor ``v``, stride 0; of
    a member tensor ``v`` of ``M`` values, stride 1.  No host
    synchronisation."""
    if not isinstance(v, torch.Tensor) or v.numel() == 1:
        return _scalar_on(v, like, name), 0
    if tuple(v.shape) != (M,) or v.device != like.device:
        raise ValueError(f"{name}: a member scalar must be ({M},) on "
                         f"{like.device}, got {tuple(v.shape)} on {v.device}")
    return v.to(torch.float32).contiguous(), 1


# --- Poisson operator: mult3d / increment3d ---------------------------------

def _bf16(t: torch.Tensor) -> int:
    """The kernels' stream-type flag: 1 for a bf16 tensor, 0 for f32."""
    return int(t.dtype == torch.bfloat16)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor (a search direction stored in bf16, an operator
    shadow) upcast to f32 (exact), any other as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _blocks(S) -> int:
    """Blocks of `THREADS` one-thread-per-cell threads over shape ``S``."""
    return -(-math.prod(S) // THREADS)


def _mult3d_plain(L, Dd, x, with_dot=False):
    """A bf16 ``x`` (a search direction stored in bf16) and a bf16 ``L`` (a
    level's shadow L16) are upcast first and the operator applied in f32,
    as in the kernel."""
    from .poisson import _mult_interior_arrays
    from ..grid import pad_interior, field_dot
    x = _wide(x)
    z = pad_interior(_mult_interior_arrays(_wide(L), Dd, x))
    return (z, field_dot(z, x)) if with_dot else z


def _mult3d_launch(L, Dd, x, with_dot=False, members=False):
    from .attic import _mult3d_march    # attic imports this module
    return _mult3d_march(mult3d, L, Dd, x, with_dot, members)


@_counted
def mult3d(L, Dd, x, with_dot: bool = False):
    """z = A·x for the 7-point variable-coefficient Poisson operator with
    zero ghosts; with ``with_dot`` also ⟨A·x, x⟩ over the interior as a 0-d
    tensor, reduced in the same launch.  ``x`` may be bf16 and so may ``L``
    (a level's shadow L16, with the f32 D16): upcast in registers, z and
    the dot are f32.  Periodic ghosts of ``x`` must be filled by the
    caller.  Under `vmap` alone, the member form (one launch for every
    member, each its own dot).

    The kernel is `ops.attic.mult3d_stream`'s plane march
    (``csrc/stream_march.cu``), launched with its chunk rule; each wrapper
    keeps its own counts.  Like every march it refuses a shape with an
    axis under 3 cells or 3·N ≥ 2³¹ values (a ValueError): blocked levels
    are 3D and ghost-padded, so every axis has at least 3 cells, and a
    fine level past 2³¹/3 cells is refused by `cfl3d` on the same path."""
    if vmap_only(L, Dd, x):
        return _by_members("mult3d", L, Dd, x, bool(with_dot))
    if _on_cpu("mult3d", x, L, Dd):
        return _mult3d_plain(L, Dd, x, with_dot)
    out = _mult3d_launch(L, Dd, x[None], with_dot)
    return (out[0][0], out[1][0]) if with_dot else out[0]


_member_function("mult3d", (4, 3, 3), 2, _mult3d_plain, _mult3d_launch)


def _increment3d_plain(L, Dd, eps, x, r):
    # f32 x + bf16 eps promotes to f32 in PyTorch as in JAX (eps exact)
    return x + eps, r - _mult3d_plain(L, Dd, eps)


def _increment3d_launch(L, Dd, eps, x, r, members=False):
    """The kernel on ``x`` (``(M, *S)``) and each other operand with a
    member axis or shared (a member stride of 0): ``(x + eps, r − A·eps)``
    with the member axis."""
    M, S = x.shape[0], tuple(x.shape[1:])
    _check("increment3d", S, bf16=("L", "eps"), L=(L, _each(L, (3,) + S, M)),
           D=(Dd, _each(Dd, S, M)), eps=(eps, _each(eps, S, M)),
           x=(x, (M,) + S), r=(r, _each(r, S, M)))
    r_out = torch.empty((M,) + S, dtype=torch.float32, device=x.device)
    launch("wl_increment3d", L, Dd, eps, r, r_out, _bf16(L), _bf16(eps), M,
           _stride(L, 4), _stride(Dd, 3), _stride(eps, 3), _stride(r, 3), *S)
    _count(increment3d, S, members, L=L, eps=eps)
    return x + eps, r_out


@_counted
def increment3d(L, Dd, eps, x, r):
    """(x + eps, r − A·eps): the stencil half runs in the kernel, the axpy
    is a plain tensor op.  ``eps`` may be bf16 and so may ``L`` (a level's
    shadow L16): upcast, x and r stay f32.  Returns new tensors (nothing is
    updated in place).  Under `vmap` alone, the member form."""
    if vmap_only(L, Dd, eps, x, r):
        return _by_members("increment3d", L, Dd, eps, x, r)
    if _on_cpu("increment3d", x, L, Dd, eps, r):
        return _increment3d_plain(L, Dd, eps, x, r)
    xo, ro = _increment3d_launch(L, Dd, eps, x[None], r)
    return xo[0], ro[0]


_member_function("increment3d", (4, 3, 3, 3, 3), 3, _increment3d_plain,
                 _increment3d_launch)


# --- the plane-marching reductions: ana_mult3d, cfl3d ---------------------

# Planes of each block's march (csrc/march.cuh): the fewest chunks of at
# most MARCH_PLANES[1] interior planes, more where the column tiles alone
# would give the card fewer than MARCH_BLOCKS blocks, down to chunks of
# MARCH_PLANES[0].  A level of L2-resident planes is latency-bound: on the
# H100, at 66³ and (98,66,66), blocks marching at least 4 planes each
# (whose loads the compiler schedules together) beat 1-plane chunks by
# 7-10% and grids of 1024 blocks by 30-40%.
MARCH_PLANES = (4, 64)
MARCH_BLOCKS = 512


def march_planes(S, tile, planes=None, blocks=None) -> int:
    """Interior planes of each block's march at shape ``S`` with ``tile``
    (axis 1, axis 2) interior columns a block, balanced over the interior;
    ``planes`` the (fewest, most) planes of a chunk, `MARCH_PLANES` by
    default, and ``blocks`` the grid's blocks to reach, `MARCH_BLOCKS` by
    default.  With (8, 32) tiles 258³ marches 4 chunks of 64 planes (1024
    blocks), 130³ 8 of 16 (512), 66³ 16 of 4 (256), (98,66,66) 24 of 4
    (384).  A member form marches each member with these chunks."""
    lo, hi = planes or MARCH_PLANES
    n = S[0] - 2
    tiles = -(-(S[1] - 2) // tile[0]) * -(-(S[2] - 2) // tile[1])
    want = -(-(blocks or MARCH_BLOCKS) // tiles)
    chunks = max(-(-n // hi), min(want, -(-n // lo)))
    return -(-n // chunks)


def march_blocks(S, planes: int, tile) -> int:
    """Blocks of the march's grid: column tiles times chunks."""
    return (-(-(S[0] - 2) // planes) * -(-(S[1] - 2) // tile[0])
            * -(-(S[2] - 2) // tile[1]))


@functools.cache
def _march_tile() -> tuple[int, int]:
    """The (axis 1, axis 2) interior columns of one march block, as the
    kernel library was built with them (csrc/march.cuh MARCH_TJ,
    MARCH_TK)."""
    lib = library()
    return lib.wl_march_tile(1), lib.wl_march_tile(2)


# Counters of the one-launch reductions: one a member of a member form
# (the grids' member axes reach 65535)
COUNTERS = 65535


@functools.cache
def _counter(device: torch.device) -> torch.Tensor:
    """The zeroed counters that elect the last block of a one-launch
    reduction (`mult3d`, `cfl3d`, `ana_mult3d` and `ops.attic`'s `dot3d`,
    `pcg_dir_mult`, `pcg_update`, `pcg_axpy`, `mult3d_stream`) on
    ``device``, one a member of a member form (`COUNTERS`; a one-field
    launch uses the first); each kernel leaves them zeroed, and the
    reductions run on one stream."""
    return torch.zeros(COUNTERS, dtype=torch.int32, device=device)


def _march(name: str, S, device, results: int, planes=None, blocks=None,
           members: int = 1):
    """(planes, results and partials buffer or None) of a march of
    ``members`` members at ``S`` (chunks of `march_planes` with ``planes``
    and ``blocks``, each member's) reducing ``results`` sums or maxima a
    member: the buffer's first ``members * results`` elements are the
    results, member after member, then each member's partials of each
    result, one a block of a member."""
    if min(S) < 3 or 3 * math.prod(S) >= 2 ** 31:
        raise ValueError(f"{name}: the kernel takes axes of at least 3 "
                         f"cells and fewer than 2^31 values, got S={S}")
    tile = _march_tile()
    planes = march_planes(S, tile, planes, blocks)
    if members * -(-(S[0] - 2) // planes) > COUNTERS:
        raise ValueError(f"{name}: {members} members of {S} exceed the "
                         f"grid's 65535 chunks a launch")
    buf = (torch.empty(members * results * (1 + march_blocks(S, planes,
                                                             tile)),
                       dtype=torch.float32, device=device) if results
           else None)
    return planes, buf


def _ana_mult3d_plain(x, c, perdir=(), with_dot=False):
    """Plain version of `ana_mult3d`, in the TPU kernel's association:
    ``t = lo0·x[i-1] + hi0·x[i+1] + lo1·x[j-1] + …`` left to right,
    ``nf = lo0 + hi0 + …``, ``z = c·t − (c·nf)·x``."""
    from ..grid import interior_view, pad_interior, field_dot
    from .poisson import _wall_coeffs
    S, D = tuple(x.shape), x.ndim
    off = lambda d, v: tuple(v if a == d else 0 for a in range(D))
    t = nf = None
    for d in range(D):
        # 0/1 face flags: the far-field coefficients of c = 1
        lo, hi = _wall_coeffs(S, d, perdir, x.dtype, 1.0, x.device)
        a = lo * interior_view(x, D, off(d, -1))
        t = a if t is None else t + a
        t = t + hi * interior_view(x, D, off(d, +1))
        nf = lo if nf is None else nf + lo
        nf = nf + hi
    z = pad_interior(c * t - (c * nf) * interior_view(x, D))
    return (z, field_dot(z, x)) if with_dot else z


def _ana_mult3d_launch(x, c, perdir=(), with_dot=False, members=False):
    """The kernel on ``x`` (``(M, *S)``): z with the member axis, and with
    ``with_dot`` each member's dot, ``(M,)``."""
    M, S = x.shape[0], tuple(x.shape[1:])
    _check("ana_mult3d", S, x=(x, (M,) + S))
    planes, buf = _march("ana_mult3d", S, x.device, int(with_dot),
                         members=M)
    z = torch.empty_like(x)
    launch("wl_ana_mult3d", x, z, *((buf[M:], _counter(x.device), buf[:M])
                                    if with_dot else (None,) * 3),
           float(c), _axis_bits(perdir), planes, M, *S)
    _count(ana_mult3d, S, members)
    return (z, buf[:M]) if with_dot else z


@_counted
def ana_mult3d(x, c, perdir: tuple = (), with_dot: bool = False):
    """z = A·x for the constant-coefficient far-field operator of a banded
    level (face coefficient ``c``, wall faces zero from the index, no
    coefficient reads), zero ghosts; with ``with_dot`` also ⟨A·x, x⟩ over
    the interior as a 0-d tensor, in the same launch.  Periodic ghosts of
    ``x`` must be filled by the caller.  Under `vmap` alone, the member
    form (one launch for every member, each its own dot; ``c`` and
    ``perdir`` the level's, shared)."""
    if vmap_only(x):
        return _by_members("ana_mult3d", x, float(c), tuple(perdir),
                           bool(with_dot))
    if _on_cpu("ana_mult3d", x, c):
        return _ana_mult3d_plain(x, c, perdir, with_dot)
    out = _ana_mult3d_launch(x[None], c, perdir, with_dot)
    return (out[0][0], out[1][0]) if with_dot else out[0]


_member_function("ana_mult3d", (3,), 0, _ana_mult3d_plain,
                 _ana_mult3d_launch)


def _cfl3d_plain(u):
    from ..flow import cfl_flux_max
    return cfl_flux_max(u)


def _cfl3d_launch(u, members=False):
    """The kernel on ``u`` (``(M, 3, *S)``): each member's max, ``(M,)``."""
    M, S = u.shape[0], tuple(u.shape[2:])
    _check("cfl3d", S, u=(u, (M, 3) + S))
    planes, buf = _march("cfl3d", S, u.device, 1, members=M)
    launch("wl_cfl3d", u, buf[M:], _counter(u.device), buf[:M], planes, M,
           _stride(u, 4), *S)
    _count(cfl3d, S, members)
    return buf[:M]


@_counted
def cfl3d(u):
    """Interior max of the CFL flux-out sum as a 0-d tensor, in one
    launch; under `vmap` alone, the member form (each member's max, one
    launch)."""
    if vmap_only(u):
        return _by_members("cfl3d", u)
    if _on_cpu("cfl3d", u):
        return _cfl3d_plain(u)
    return _cfl3d_launch(u[None])[0]


_member_function("cfl3d", (4,), 0, _cfl3d_plain, _cfl3d_launch)


# --- boundary conditions ----------------------------------------------------------

def _bc3d_plain(u, A, save_exit, perdir, inplace):
    from .bc import bc_vector_planes
    return bc_vector_planes(u, A, save_exit, perdir, inplace)


def _bc3d_launch(u, A, save_exit, perdir, inplace, S_glob=None, base=None,
                 members=False):
    """The kernel on ``u`` (``(M, 3, *S)``, filled in place, or a clone of
    it) with the values ``A``: numbers, or a device array, ``(3,)`` or
    ``(M, 3)``."""
    M, S = u.shape[0], tuple(u.shape[2:])
    _check("bc3d", S, u=(u, (M, 3) + S))
    if 3 * math.prod(S) >= 2 ** 31:
        raise ValueError(f"bc3d: the kernel indexes fields of fewer than "
                         f"2^31 values, got S={S}")
    glob = _global(S, S_glob, base)
    out = u if inplace else u.clone()
    dev = isinstance(A, torch.Tensor)
    if dev:
        if tuple(A.shape) not in ((3,), (M, 3)) or A.device != u.device:
            raise ValueError(f"bc3d: A must be (3,) or ({M}, 3) on "
                             f"{u.device}")
        A = A.to(torch.float32).contiguous()
    launch("wl_bc3d", out, A if dev else None,
           *((0.0,) * 3 if dev else map(float, A)), _axis_bits(perdir),
           int(bool(save_exit)), M, _stride(A, 1) if dev else 0, *S, *glob)
    _count(bc3d, S, members, "inplace" if inplace else "copy")
    if base is not None:
        _count_base(bc3d, S, glob, (bool(save_exit),))
    return out


@_counted
def bc3d(u, A, save_exit: bool = False, perdir: tuple = (),
         inplace: bool = False, S_glob=None, base=None):
    """The (3, S0, S1, S2) velocity field with its boundary conditions, in
    one launch, equal to `ops.bc.bc_vector_planes` bit for bit: walls,
    periodic axes (``perdir``) and the convective outlet's kept plane
    (``save_exit``).  The kernel writes only the cells that change (ghost
    faces and the Dirichlet plane): with ``inplace`` into ``u``, which it
    returns, otherwise into a clone of ``u``.  Each launch adds its form,
    ``"inplace"`` or ``"copy"``, to ``bc3d.forms``.  With ``S_glob`` and
    ``base`` (walls and the outlet only) ``u`` is one shard's block and
    only the global faces in it are filled, from its planes 1 and S-2.

    Under `vmap` alone (whole grid) the member form fills every member in
    one launch (``"members"`` in ``.forms``), in place where ``inplace``
    and ``u`` is batched (a ``u`` that is not, with batched values, is
    filled in a copy)."""
    S = tuple(u.shape[1:])
    if base is not None and perdir:
        raise ValueError("bc3d: the periodic form is whole-grid only")
    member = base is None and vmap_only(u, A)
    if not member and _on_cpu("bc3d", u, A):
        from .bc import bc_vector_planes
        return bc_vector_planes(u, A, save_exit, perdir, inplace, S_glob,
                                base)
    if any(isinstance(a, torch.Tensor) for a in A):
        # the values as one (3,) tensor (batched under vmap) on the device,
        # with no host synchronisation
        A = torch.stack([a.to(u.dtype) if isinstance(a, torch.Tensor)
                         else torch.full((), float(a), dtype=u.dtype,
                                         device=u.device) for a in A])
    else:
        A = tuple(float(a) for a in A)
    if member:
        return _by_members("bc3d", u, A, bool(save_exit), tuple(perdir),
                           bool(inplace))
    out = _bc3d_launch(u[None], A, save_exit, perdir, inplace, S_glob,
                       base)[0]
    return u if inplace else out


_member_function("bc3d", (4, 1), 0, _bc3d_plain, _bc3d_launch,
                 inplace=lambda save_exit, perdir, inplace: inplace)


# --- projection head and tail -------------------------------------------------

def _div3d_plain(u, p, dt, S_glob=None, base=None):
    from ..flow import div
    z = div(u)
    if base is not None:
        z = torch.where(global_interior(tuple(p.shape), S_glob, base,
                                        p.device), z, 0.0)
    return z, p * dt


def _div3d_launch(u, p, dt, S_glob=None, base=None, members=False):
    """The kernel on ``u`` (``(M, 3, *S)``), ``p`` and the time step
    ``dt`` (a number or tensor, a member's each or shared)."""
    M, S = u.shape[0], tuple(u.shape[2:])
    _check("div3d", S, u=(u, (M, 3) + S), p=(p, _each(p, S, M)))
    glob = _global(S, S_glob, base)
    dts, sdt = _scalars_on(dt, u, "div3d", M)
    z = torch.empty((M,) + S, dtype=torch.float32, device=u.device)
    x = torch.empty_like(z)
    launch("wl_div3d", u, p, dts, z, x, M, _stride(u, 4), _stride(p, 3), sdt,
           *S, *glob)
    _count(div3d, S, members)
    if base is not None:
        _count_base(div3d, S, glob)
    return z, x


@_counted
def div3d(u, p, dt, S_glob=None, base=None):
    """(div(u) on the interior with zero ghosts, p·dt) in one sweep; ``dt``
    may be a one-element device tensor (no host synchronisation).  With
    ``S_glob`` and ``base`` the arrays are a shard's halo-extended block and
    div(u) is kept where a cell is interior in the array and in the global
    grid.  Under `vmap` alone (whole grid), the member form."""
    if base is None and vmap_only(u, p, dt):
        return _by_members("div3d", u, p, dt)
    if _on_cpu("div3d", u, p, dt):
        return _div3d_plain(u, p, dt, S_glob, base)
    z, x = _div3d_launch(u[None], p, dt, S_glob, base)
    return z[0], x[0]


_member_function("div3d", (4, 3, 0), 0, _div3d_plain, _div3d_launch)


def _project3d_plain(L, x, u, dt, S_glob=None, base=None):
    from .poisson import pressure_grad_arrays
    from ..grid import pad_interior
    un = u - pad_interior(pressure_grad_arrays(L, x), lead=1)
    if base is not None:
        un = torch.where(global_interior(tuple(x.shape), S_glob, base,
                                         x.device), un, u)
    return un, x / dt


def _project3d_launch(L, x, u, dt, S_glob=None, base=None, members=False):
    """The kernel on ``x`` (``(M, *S)``), ``L``, ``u`` and the time step
    ``dt`` (a number or tensor), each a member's or shared."""
    M, S = x.shape[0], tuple(x.shape[1:])
    _check("project3d", S, L=(L, _each(L, (3,) + S, M)), x=(x, (M,) + S),
           u=(u, _each(u, (3,) + S, M)))
    glob = _global(S, S_glob, base)
    dts, sdt = _scalars_on(dt, x, "project3d", M)
    u_out = torch.empty((M, 3) + S, dtype=torch.float32, device=x.device)
    p = torch.empty((M,) + S, dtype=torch.float32, device=x.device)
    launch("wl_project3d", L, x, u, dts, u_out, p, M, _stride(L, 4),
           _stride(x, 3), _stride(u, 4), sdt, *S, *glob)
    _count(project3d, S, members)
    if base is not None:
        _count_base(project3d, S, glob)
    return u_out, p


@_counted
def project3d(L, x, u, dt, S_glob=None, base=None):
    """(u − L∘∇x on the interior, ghosts passed through; x/dt) in one
    sweep.  Returns new tensors.  With ``S_glob`` and ``base`` the arrays
    are a shard's halo-extended block and u is corrected where a cell is
    interior in the array and in the global grid.  Under `vmap` alone
    (whole grid), the member form."""
    if base is None and vmap_only(L, x, u, dt):
        return _by_members("project3d", L, x, u, dt)
    if _on_cpu("project3d", x, L, u, dt):
        return _project3d_plain(L, x, u, dt, S_glob, base)
    un, p = _project3d_launch(L, x[None], u, dt, S_glob, base)
    return un[0], p[0]


_member_function("project3d", (4, 3, 4, 0), 1, _project3d_plain,
                 _project3d_launch)


# --- convection-diffusion ------------------------------------------------------

def _conv_diff3d_plain(u, nu, limiter, perdir=(), S_glob=None, base=None,
                       modular=False):
    from .convect import conv_core
    S = tuple(u.shape[1:])
    up = torch.nn.functional.pad(u, (2, 2) * len(S))
    return conv_core(up, S, nu, perdir, limiter, u_wrap=u, S_glob=S_glob,
                     base=base, modular=modular)


def _limiter_code(limiter) -> int:
    """The code of a limiter compiled into the kernel library (QUICK 0, van
    Leer 1); raises for any other."""
    from .convect import KERNEL_LIMITERS
    for code, known in enumerate(KERNEL_LIMITERS):
        if limiter is known:
            return code
    raise NotImplementedError(f"conv_diff3d has no compiled-in variant for "
                              f"the limiter {limiter!r}")


def _conv_diff3d_launch(u, nu, limiter, perdir, S_glob=None, base=None,
                        modular=False, members=False):
    """The kernel on ``u`` (``(M, 3, *S)``) with ``nu`` (a number, or
    for the member form a tensor, a member's each or shared)."""
    from .convect import KERNEL_LIMITERS
    M, S = u.shape[0], tuple(u.shape[2:])
    _check("conv_diff3d", S, u=(u, (M, 3) + S))
    glob = _global(S, S_glob, base)
    mod = int(bool(modular) and base is not None and bool(perdir))
    r = torch.empty((M, 3) + S, dtype=torch.float32, device=u.device)
    if members and isinstance(nu, torch.Tensor):
        (nus, snu), number = _scalars_on(nu, u, "conv_diff3d", M), 0.0
    else:
        # a number with the launch: the one-field kernel reads ν from its
        # parameters (a tensor ν is read on the host, as ever)
        nus, snu, number = None, 0, float(nu)
    common = (number, nus, snu, M, _stride(u, 4))
    if limiter in KERNEL_LIMITERS:
        launch("wl_conv_diff3d", u, r, *common, _limiter_code(limiter),
               _axis_bits(perdir), mod, *S, *glob)
    else:
        from ..kernels.limiter import ENTRY, entry_point
        launch(ENTRY, u, r, *common, _axis_bits(perdir), mod, *S, *glob,
               lib=entry_point(limiter))
    _count(conv_diff3d, S, members,
           getattr(limiter, "__name__", repr(limiter)))
    if base is not None:
        _count_base(conv_diff3d, S, glob, (tuple(perdir),))
    if mod:
        conv_diff3d.forms.add("modular")
    return r


@_counted
def conv_diff3d(u, nu, limiter, perdir: tuple = (), S_glob=None, base=None,
                modular: bool = False):
    """Full convection-diffusion tendency of all three components, zero
    wherever the reference writes nothing; periodic axes (``perdir``) take
    the ϕuP wrap and the top-face copy of face 1's flux.  QUICK and van
    Leer are compiled in; any other limiter is traced into the same kernel
    at its first launch (`kernels.limiter`), and one with no kernel form
    raises.  ``.forms`` keeps the names of the limiters launched.  ``nu``
    may be a 0-d tensor (under `vmap` a member's own, read by the member
    form's kernel on the device).

    With ``S_glob`` and ``base`` ``u`` is a shard's block halo-extended by
    two cells (the caller trims the output); a periodic axis then needs
    ``modular``: its halo planes hold the modular wrap values and its faces
    take the uniform periodic flux.  Under `vmap` alone (whole grid), the
    member form (``nu`` a member's each or shared)."""
    if perdir and base is not None and not modular:
        raise ValueError("conv_diff3d: a shard-local periodic call needs "
                         "modular wrap halos (modular=True)")
    if base is None and vmap_only(u, nu):
        return _by_members("conv_diff3d", u, nu, limiter, tuple(perdir))
    if _on_cpu("conv_diff3d", u, nu):
        return _conv_diff3d_plain(u, nu, limiter, perdir, S_glob, base,
                                  modular)
    return _conv_diff3d_launch(u[None], nu, limiter, perdir, S_glob, base,
                               modular)[0]


_member_function("conv_diff3d", (4, 0), 0, _conv_diff3d_plain,
                 _conv_diff3d_launch)


def kernel_wrappers() -> dict:
    """Name → wrapper of every kernel a solver path runs (each wrapper has
    a ``.launches`` counter, a ``.shapes`` counter and a ``.forms`` set): the
    blocked levels' PCG iteration and carried-rows operator (`ops.attic`)
    included.  The bandwidth probes run on no path (`kernels.probes`)."""
    from .pcg_kernel import pcg_fused
    from .attic import kernel_wrappers as attic_wrappers
    return {"mult3d": mult3d, "increment3d": increment3d, "cfl3d": cfl3d,
            "bc3d": bc3d, "div3d": div3d, "project3d": project3d,
            "conv_diff3d": conv_diff3d, "pcg_fused": pcg_fused,
            "ana_mult3d": ana_mult3d, **attic_wrappers()}
