"""A user-defined flux limiter compiled into the ``conv_diff3d`` kernel.

The JAX package traces any limiter into its Pallas conv kernel
(`waterlily_tpu.ops.convect.conv_diff`).  The port does the same for a
limiter written in torch operations on its three tensors (``u`` far
upwind, ``c`` upwind, ``d`` downwind): `lower` traces it with `torch.fx`
into a `Program`, a straight-line list of scalar operations; `source`
renders that program as the device function of a limiter type and an
entry point of the kernel template (``csrc/conv_diff.cuh``); `entry_point`
builds it (`kernels.build.build_source`), once per distinct program.

Each operation rounds as the limiter's own operation rounds on a CUDA
tensor, so that the kernel stays exact against the plain form
(`convect.conv_core` calling the limiter) with ``--fmad=false``:

- a Python number meets a tensor as an f32 value, and ``t / number`` is
  ``t`` times the f32 reciprocal of the number, ``number / t`` the
  reciprocal of ``t`` times the number (PyTorch's CUDA forms of the two);
  a tensor divided by a tensor (a constant made by ``torch.full`` or
  ``full_like`` included) is a true division;
- ``torch.maximum``/``minimum`` propagate NaN (`tmax`/`tmin`),
  ``torch.sign`` is ``(0 < a) - (a < 0)``, ``torch.clamp`` with number
  bounds passes NaN through.

A limiter with another operation, with control flow on tensor values, or
whose result is not an f32 field raises `NotImplementedError`: it has no
kernel, and `stencil_kernels.conv_diff3d` refuses it on the card.
`evaluate` runs a program with torch operations in the same order and
rounding, the form the CPU tests hold against the limiter itself.
"""
from __future__ import annotations

import dataclasses
import functools
import operator

import numpy as np
import torch

__all__ = ["Program", "lower", "evaluate", "source", "entry_point",
           "ENTRY"]

# the C entry point of a generated library (the signature of
# `wl_conv_diff3d` without the limiter code)
ENTRY = "wl_conv_diff3d_user"

_ARITH = {"add": "+", "sub": "-", "mul": "*", "div": "/"}
_COMPARE = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==",
            "ne": "!="}
_LOGIC = {"and": "&&", "or": "||"}

# call_function targets and call_method names → program operations
_FUNCTIONS = {
    operator.add: "add", torch.add: "add", operator.sub: "sub",
    torch.sub: "sub", operator.mul: "mul", torch.mul: "mul",
    operator.truediv: "div", torch.div: "div", torch.true_divide: "div",
    operator.neg: "neg", torch.neg: "neg", operator.abs: "abs",
    torch.abs: "abs", torch.maximum: "max", torch.minimum: "min",
    torch.max: "max", torch.min: "min", torch.where: "where",
    torch.sign: "sign", torch.clamp: "clamp", torch.clip: "clamp",
    torch.clamp_min: "clamp_min", torch.clamp_max: "clamp_max",
    operator.gt: "gt", torch.gt: "gt", operator.ge: "ge", torch.ge: "ge",
    operator.lt: "lt", torch.lt: "lt", operator.le: "le", torch.le: "le",
    operator.eq: "eq", torch.eq: "eq", operator.ne: "ne", torch.ne: "ne",
    operator.and_: "and", torch.logical_and: "and", operator.or_: "or",
    torch.logical_or: "or", operator.invert: "not",
    torch.logical_not: "not", torch.zeros_like: "zeros_like",
    torch.ones_like: "ones_like", torch.full_like: "full_like",
    torch.full: "full", getattr: "getattr",
}
_METHODS = {"add": "add", "sub": "sub", "mul": "mul", "div": "div",
            "true_divide": "div", "neg": "neg", "abs": "abs",
            "maximum": "max", "minimum": "min", "sign": "sign",
            "clamp": "clamp", "clip": "clamp", "clamp_min": "clamp_min",
            "clamp_max": "clamp_max", "gt": "gt", "ge": "ge", "lt": "lt",
            "le": "le", "eq": "eq", "ne": "ne", "logical_and": "and",
            "logical_or": "or", "logical_not": "not", "where": "where_m"}
# keyword arguments that change nothing of an elementwise f32 result
_INERT_KW = {"dtype", "device", "layout", "requires_grad", "memory_format",
             "pin_memory"}


@dataclasses.dataclass(frozen=True)
class Program:
    """Operations ``ops[i] = (name, *args)``: ``("in", k)`` for the
    limiter's k-th argument (ops 0-2), ``("const", value)`` (an f32 value),
    ``("clamp", a, lo, hi)`` with ``lo``/``hi`` an op or None, otherwise
    the indices of earlier ops; ``kinds[i]`` is ``"f"`` (f32) or ``"b"``
    (bool); ``out`` is the result's op."""
    ops: tuple
    kinds: tuple
    out: int


class _Emitter:
    def __init__(self):
        self.ops, self.kinds = [], []
        for k in range(3):
            self.add(("in", k), "f")

    def add(self, op, kind):
        self.ops.append(op)
        self.kinds.append(kind)
        return len(self.ops) - 1

    def const(self, v):
        return self.add(("const", _f32(v)), "f")

    def num(self, v):
        """A tensor operand: an op index kept, a Python number made an f32
        constant, a bool op converted to f32 (as PyTorch promotes it)."""
        if isinstance(v, _Op):
            return self.add(("float", v.i), "f") if v.kind == "b" else v.i
        return self.const(v)

    def cond(self, v):
        if not (isinstance(v, _Op) and v.kind == "b"):
            raise NotImplementedError("a where or logical operand that is "
                                      "not a comparison")
        return v.i


@dataclasses.dataclass(frozen=True)
class _Op:
    i: int
    kind: str


_META = object()   # a tensor's dtype or device: only a constant's keyword


def _f32(v) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise NotImplementedError(f"the operand {v!r} is not a number")
    return float(np.float32(v))


def _recip(v) -> float:
    """PyTorch's CUDA reciprocal of a Python divisor: 1 / f32(v) in f32."""
    with np.errstate(divide="ignore"):
        return float(np.float32(1.0) / np.float32(_f32(v)))


def _scalar(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _lower_call(b: _Emitter, name: str, args, kw):
    """One traced call as program operations; returns an `_Op`, a number
    or `_META`."""
    if name == "getattr":
        if args[1] in ("dtype", "device"):
            return _META
        raise NotImplementedError(f"the attribute {args[1]!r}")
    extra = set(kw) - _INERT_KW
    if name in ("clamp", "clamp_min", "clamp_max"):
        extra -= {"min", "max"}
    if name == "div" and kw.get("rounding_mode") is None:
        extra -= {"rounding_mode"}
    if extra:
        raise NotImplementedError(f"{name} with the keywords {sorted(extra)}")
    if any(v is _META for v in args):
        raise NotImplementedError(f"a dtype or device as an operand of "
                                  f"{name}")
    dt = kw.get("dtype", _META)
    if name in ("zeros_like", "ones_like", "full_like"):
        # a field of another dtype would promote the limiter's arithmetic
        if dt is not _META and dt != torch.float32:
            raise NotImplementedError(f"{name} with dtype {dt}")
        v = {"zeros_like": 0.0, "ones_like": 1.0}.get(name)
        return _Op(b.const(args[1] if v is None else v), "f")
    if name == "full":
        # a 0-d constant of a floating dtype takes the field's f32
        if tuple(args[0]) != () or not (
                dt is _META or getattr(dt, "is_floating_point", False)):
            raise NotImplementedError("torch.full other than a 0-d float")
        return _Op(b.const(args[1]), "f")
    if name in _ARITH:
        if len(args) != 2:
            raise NotImplementedError(f"{name} with {len(args)} operands")
        x, y = args
        if _scalar(x) and _scalar(y):
            raise NotImplementedError("arithmetic on two numbers")
        if name == "div" and _scalar(y):
            return _Op(b.add(("mul", b.num(x), b.const(_recip(y))), "f"),
                       "f")
        if name == "div" and _scalar(x):
            inv = b.add(("div", b.const(1.0), b.num(y)), "f")
            return _Op(b.add(("mul", inv, b.const(x)), "f"), "f")
        return _Op(b.add((name, b.num(x), b.num(y)), "f"), "f")
    if name in ("neg", "abs", "sign"):
        return _Op(b.add((name, b.num(args[0])), "f"), "f")
    if name in ("max", "min"):
        if len(args) != 2 or not all(isinstance(v, _Op) for v in args):
            raise NotImplementedError(f"torch.{name} of other than two "
                                      f"tensors")
        return _Op(b.add((name, b.num(args[0]), b.num(args[1])), "f"), "f")
    if name in ("clamp", "clamp_min", "clamp_max"):
        lo = kw.get("min", args[1] if len(args) > 1 else None)
        hi = kw.get("max", args[2] if len(args) > 2 else None)
        if name == "clamp_max":
            lo, hi = None, kw.get("max", args[1] if len(args) > 1 else None)
        if any(isinstance(v, _Op) for v in (lo, hi)):
            raise NotImplementedError("clamp with tensor bounds")
        return _Op(b.add(("clamp", b.num(args[0]),
                          None if lo is None else b.const(lo),
                          None if hi is None else b.const(hi)), "f"), "f")
    if name in ("where", "where_m"):
        c, x, y = args if name == "where" else (args[1], args[0], args[2])
        return _Op(b.add(("where", b.cond(c), b.num(x), b.num(y)), "f"), "f")
    if name in _COMPARE:
        x, y = args
        if (name in ("eq", "ne") and all(isinstance(v, _Op) and v.kind == "b"
                                         for v in (x, y))):
            return _Op(b.add((name, x.i, y.i), "b"), "b")
        return _Op(b.add((name, b.num(x), b.num(y)), "b"), "b")
    if name in _LOGIC:
        return _Op(b.add((name, b.cond(args[0]), b.cond(args[1])), "b"), "b")
    if name == "not":
        return _Op(b.add(("not", b.cond(args[0])), "b"), "b")
    raise NotImplementedError(name)


def lower(limiter) -> Program:
    """``limiter`` traced into a `Program`; raises `NotImplementedError`
    where it has no kernel form (see the module's docstring)."""
    try:
        gm = torch.fx.symbolic_trace(limiter)
    except (torch.fx.proxy.TraceError, TypeError, RuntimeError) as e:
        # control flow on tensor values, a tensor made a Python value
        raise NotImplementedError(
            f"the limiter {limiter!r} does not trace: {e}") from e
    b = _Emitter()
    env, n_in = {}, 0
    for node in gm.graph.nodes:
        look = lambda a: torch.fx.node.map_arg(a, lambda n: env[n])
        if node.op == "placeholder":
            if n_in == 3:
                raise NotImplementedError("a limiter takes (u, c, d)")
            env[node] = _Op(n_in, "f")
            n_in += 1
        elif node.op in ("call_function", "call_method"):
            table = _FUNCTIONS if node.op == "call_function" else _METHODS
            name = table.get(node.target)
            if name is None:
                raise NotImplementedError(
                    f"the limiter {limiter!r} calls {node.target!r}, which "
                    f"has no kernel form")
            env[node] = _lower_call(b, name, look(node.args),
                                    look(node.kwargs))
        elif node.op == "output":
            out = look(node.args[0])
            if _scalar(out):
                out = _Op(b.const(out), "f")
            if not (isinstance(out, _Op) and out.kind == "f"):
                raise NotImplementedError("the limiter's result is not an "
                                          "f32 field")
        else:
            raise NotImplementedError(f"{node.op} {node.target!r}")
    if n_in != 3:
        raise NotImplementedError("a limiter takes (u, c, d)")
    return Program(tuple(b.ops), tuple(b.kinds), out.i)


def evaluate(prog: Program, u, c, d) -> torch.Tensor:
    """``prog`` on f32 tensors, operation by operation in the kernel's
    order and rounding."""
    vals = []
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    for name, *a in prog.ops:
        arg = ([] if name in ("in", "const")
               else [None if i is None else vals[i] for i in a])
        if name == "in":
            v = (u, c, d)[a[0]]
        elif name == "const":
            v = f32(a[0])
        elif name == "float":
            v = arg[0].to(torch.float32)
        elif name in ("add", "sub", "mul", "div"):
            v = getattr(torch, name)(arg[0], arg[1])
        elif name in ("neg", "abs"):
            v = getattr(torch, name)(arg[0])
        elif name == "sign":
            v = ((0 < arg[0]).to(torch.float32)
                 - (arg[0] < 0).to(torch.float32))
        elif name in ("max", "min"):
            v = (torch.maximum if name == "max" else torch.minimum)(*arg)
        elif name == "clamp":
            x, lo, hi = arg
            y = x if lo is None else torch.maximum(x, lo)
            y = y if hi is None else torch.minimum(y, hi)
            v = torch.where(torch.isnan(x), x, y)
        elif name == "where":
            v = torch.where(*arg)
        elif name in _COMPARE:
            v = getattr(torch, name)(arg[0], arg[1])
        elif name in _LOGIC:
            v = (torch.logical_and if name == "and"
                 else torch.logical_or)(*arg)
        elif name == "not":
            v = torch.logical_not(arg[0])
        else:
            raise ValueError(name)
        vals.append(v)
    return vals[prog.out].to(torch.float32).expand(torch.broadcast_shapes(
        u.shape, c.shape, d.shape))


def _literal(v: float) -> str:
    if np.isfinite(v):
        return v.hex() + "f"
    bits = int(np.float32(v).view(np.uint32))
    return f"__int_as_float({bits:#x})"


def _expr(name, a, ref) -> str:
    if name == "const":
        return _literal(a[0])
    if name == "float":
        return f"(float){ref(a[0])}"
    if name in _ARITH:
        return f"{ref(a[0])} {_ARITH[name]} {ref(a[1])}"
    if name in _COMPARE:
        return f"{ref(a[0])} {_COMPARE[name]} {ref(a[1])}"
    if name in _LOGIC:
        return f"{ref(a[0])} {_LOGIC[name]} {ref(a[1])}"
    if name == "not":
        return f"!{ref(a[0])}"
    if name == "neg":
        return f"-{ref(a[0])}"
    if name == "abs":
        return f"fabsf({ref(a[0])})"
    if name == "sign":
        x = ref(a[0])
        return f"(float)((0.f < {x}) - ({x} < 0.f))"
    if name in ("max", "min"):
        return f"t{name}({ref(a[0])}, {ref(a[1])})"
    if name == "where":
        return f"{ref(a[0])} ? {ref(a[1])} : {ref(a[2])}"
    if name == "clamp":
        x, lo, hi = a
        y = ref(x) if lo is None else f"fmaxf({ref(x)}, {ref(lo)})"
        y = y if hi is None else f"fminf({y}, {ref(hi)})"
        return f"isnan({ref(x)}) ? {ref(x)} : {y}"
    raise ValueError(name)


def source(prog: Program) -> str:
    """The CUDA C++ source of ``conv_diff3d`` with ``prog`` as its limiter:
    a limiter type ``UserLimiter`` and the entry point `ENTRY`."""
    ref = lambda i: "ucd"[i] if i < 3 else f"v{i}"
    body = [f"    const {'float' if k == 'f' else 'bool'} v{i} = "
            f"{_expr(op[0], op[1:], ref)};"
            for i, (op, k) in enumerate(zip(prog.ops, prog.kinds)) if i >= 3]
    return "\n".join([
        "// conv_diff3d with a user-defined limiter, generated by",
        "// waterlily_tpu_torch/kernels/limiter.py from its torch operations.",
        '#include "conv_diff.cuh"',
        "",
        "struct UserLimiter {",
        "  static __device__ __forceinline__ float eval(float u, float c, "
        "float d) {",
        *body,
        f"    return {ref(prog.out)};",
        "  }",
        "};",
        "",
        f'extern "C" int {ENTRY}(const float* u, float* r, float nu, '
        "const float* nu_dev,",
        "                                   long long snu, int members, "
        "long long su,",
        "                                   int periodic, int modular, "
        "int S0, int S1,",
        "                                   int S2, int G0, int G1, int G2, "
        "int B0,",
        "                                   int B1, int B2, void* stream) {",
        "  return launch_conv<UserLimiter>(u, r, nu, nu_dev, snu, members, "
        "su,",
        "                                  periodic, modular, S0, S1, S2, "
        "G0, G1, G2,",
        "                                  B0, B1, B2, stream);",
        "}",
        ""])


@functools.lru_cache(maxsize=32)
def entry_point(limiter):
    """The loaded library of ``conv_diff3d`` compiled with ``limiter``
    (its `ENTRY` takes ``u, r, nu``, a device array of each member's nu
    or NULL and its member stride, the members and u's member stride,
    ``periodic, modular``, the array's shape, the global sizes, the global
    index of its cell 0 and ``stream``, as ``wl_conv_diff3d`` less its
    limiter code); built
    at the first call for each distinct program, from the checkout's
    ``csrc`` headers.  Raises `NotImplementedError` where the limiter has
    no kernel form."""
    import ctypes
    from .build import build_source
    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _L = ctypes.c_longlong
    return build_source(source(lower(limiter)), ENTRY,
                        (_P, _P, _F, _P, _L, _I, _L) + (_I,) * 11)
