"""Bandwidth probes: wrappers, plain versions and launch counters.

Counterpart of the TPU bandwidth probes of ``scripts/bench_kernels.py``:
`copy_probe` of ``copy_kernel`` (run by ``pal_copy``), ``o = C·x``, and
`roll_probe` of ``roll_kernel`` (run by ``pal_roll``), ``o = C·(x + 1e-30·(x
rolled by ±1 along axis 1 and ±1 along axis 2))``, the rolls wrapping as
``jnp.roll`` / `torch.roll` do.  Their kernels (``csrc/probes.cu``) measure
what a streaming kernel with one read and one write a cell can move on the
card: the yardstick beside which ``chip_smoke.py`` sets each stencil
kernel's bytes over its time.  No solver path calls them.

As in `ops.stencil_kernels`, each wrapper launches its kernel on a CUDA
tensor, runs its plain version on a CPU tensor, raises on anything else,
and counts its launches in ``.launches`` and its shapes in ``.shapes``.
"""
from __future__ import annotations

import torch

from .build import launch
from ..ops.stencil_kernels import _on_cpu, _check, _counted

__all__ = ["C", "copy_probe", "roll_probe", "kernel_wrappers"]

# the probes' scale factor (scripts/bench_kernels.py)
C = 0.99995


def _copy_probe_plain(x, c=C):
    return x * c


@_counted
def copy_probe(x, c=C):
    """``c·x`` of a contiguous 3D f32 field, as a new tensor (16-byte
    aligned on a CUDA device: the kernel moves four cells a thread)."""
    S = tuple(x.shape)
    if _on_cpu("copy_probe", x):
        return _copy_probe_plain(x, c)
    _check("copy_probe", S, x=(x, S))
    if x.data_ptr() % 16:
        raise ValueError("copy_probe: x must be 16-byte aligned")
    o = torch.empty_like(x)
    launch("wl_copy_probe", x, o, float(c), *S)
    copy_probe.launches += 1
    copy_probe.shapes.add(S)
    return o


def _roll_probe_plain(x, c=C):
    return c * (x + 1e-30 * (torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
                             + torch.roll(x, 1, 2) + torch.roll(x, -1, 2)))


@_counted
def roll_probe(x, c=C):
    """``c·(x + 1e-30·(x[j-1] + x[j+1] + x[k-1] + x[k+1]))`` of a 3D f32
    field, the in-plane neighbours wrapping around the (axis 1, axis 2)
    plane, as a new tensor."""
    S = tuple(x.shape)
    if _on_cpu("roll_probe", x):
        return _roll_probe_plain(x, c)
    _check("roll_probe", S, x=(x, S))
    o = torch.empty_like(x)
    launch("wl_roll_probe", x, o, float(c), *S)
    roll_probe.launches += 1
    roll_probe.shapes.add(S)
    return o


def kernel_wrappers() -> dict:
    """Name → wrapper of the probes."""
    return {"copy_probe": copy_probe, "roll_probe": roll_probe}
