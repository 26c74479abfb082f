"""The benchmark's frozen work model and the card's published peaks.

A kernel's least time is the larger of the bytes it must move over the
memory rate and its float operations over the f32 rate.  Bytes count each
f32 input field read once and each output field written once over the
padded grid; operations are counted per cell.  These numbers are frozen
here, so a roofline share reads the same whatever implements the call.
"""
from __future__ import annotations

import math

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS_PER_S", "WORK", "least_seconds"]

# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM3 rate and the f32
# rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# (f32 fields read or written once, float operations) per padded cell
WORK = {
    # u(3) in, r(3) out; nine face fluxes a cell (three components, three
    # axes), each 40 operations: two QUICK limiters of 16 (5 for
    # (5c + 2d - u) / 6, 3 for 10c - 9u, 4 min/max for each median), the
    # advecting velocity (2), the wall face's central value (2), the upwind
    # product and the diffusive term (4); then 3 differences and 3 sums a
    # component
    "conv_diff": (6, 9 * 40 + 3 * 6),
}


def least_seconds(name: str, S: tuple) -> tuple[float, str]:
    """The least time the card could take for one call of ``name`` at
    padded shape ``S``, and which of "bytes" and "operations" bounds it."""
    fields, ops = WORK[name]
    cells = math.prod(S)
    t_bytes = 4 * fields * cells / HBM_BYTES_PER_S
    t_ops = ops * cells / F32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
