"""`attic.pcg_blocked` with its scalar step in 0-d tensors between its
sweeps, the reference its folded step (the sweeps taking the step on the
smooth's device words) equals bit for bit, and levels and residuals that
trip each of the smoother's early exits.  Torch alone: the CPU parity
tests and the card's tests both use it."""
import dataclasses

import torch

from waterlily_tpu_torch.ops import attic as ta
from waterlily_tpu_torch.ops import poisson as tp


def chain(lev, x, r, it=6, exits=None):
    """`pcg_blocked` with its scalar step in 0-d tensors between the two
    sweeps (`pcg`'s chain): the reference the folded smooth equals bit for
    bit.  Each sweep is handed words that carry only the chain's beta or
    upd, and only its own sum (``W_SUM``) and, at the seed, rho are read
    back.  ``exits`` (a list) gets each early exit as it trips: "seed",
    "alpha", "rho2"."""
    dt = x.dtype
    teneps = 10 * torch.finfo(dt).eps
    L, Dd = tp._opLD(lev)
    iD, bf16 = tp._iDk(lev), lev.bf16_eps
    zero = torch.zeros((), dtype=dt, device=x.device)
    given = lambda upd=zero, beta=zero: torch.stack([zero, zero, zero, upd,
                                                     beta])
    note = (lambda k, was, now: exits.append(k)
            if exits is not None and bool(now) and not bool(was) else None)
    eps, z, w = ta.pcg_dir_mult(L, Dd, r, r, iD, None, bf16)
    denom, rho = w[ta.W_SUM], w[ta.W_RHO]
    dead = torch.abs(rho) < teneps
    note("seed", False, dead)
    for i in range(it):
        alpha = torch.where(dead | (denom == 0), 0.0,
                            rho / torch.where(denom == 0, 1.0, denom)).to(dt)
        was, dead = dead, (dead | (torch.abs(alpha) < 1e-2)
                           | (torch.abs(alpha) > 1e2))
        note("alpha", was, dead)
        upd = torch.where(dead, 0.0, alpha).to(dt)
        x, r, w = ta.pcg_update(x, r, eps, z, iD, given(upd=upd))
        rho2 = w[ta.W_SUM]
        if i == it - 1:
            break
        was, dead = dead, dead | (torch.abs(rho2) < teneps)
        note("rho2", was, dead)
        beta = torch.where(dead, 0.0,
                           rho2 / torch.where(rho == 0, 1.0, rho)).to(dt)
        eps, z, w = ta.pcg_dir_mult(L, Dd, eps, r, iD, given(beta=beta),
                                    bf16)
        denom = w[ta.W_SUM]
        rho = torch.where(dead, rho, rho2)
    return x, r


# the early exits, each made to trip: a zero residual (rho 0 at the seed,
# and denom 0), a level whose operator is zero (denom 0, rho not), iD
# scaled up and down (alpha under 1e-2, over 1e2), a residual scaled to a
# rho of 3.2 times 10 eps, which the first step takes under 10 eps; and a
# smooth that runs on
FOLD_CASES = {"live": (1.0, 1.0, None), "rho0": (0.0, 1.0, "seed"),
              "denom0": (1.0, None, "alpha"),
              "alpha_low": (1.0, 1e4, "alpha"),
              "alpha_high": (1.0, 1e-4, "alpha"),
              "rho2": ("rho", 1.0, "rho2")}


def fold_case(case, lev, r):
    """The level and residual of `FOLD_CASES`' ``case`` (a level's iD
    scaled, or its operator zeroed, its bf16 shadows too where it has
    them, and the residual scaled) and the exit it trips."""
    rs, ids, exit_ = FOLD_CASES[case]
    if rs == "rho":
        rho = float(torch.sum(r * (r * tp._iDk(lev).float())))
        rs = (3.2 * 10 * float(torch.finfo(r.dtype).eps) / abs(rho)) ** 0.5
    shadows = lev.L16 is not None
    if ids is None:
        zero = dict(L=torch.zeros_like(lev.L), D=torch.zeros_like(lev.D),
                    iD=torch.ones_like(lev.iD))
        if shadows:
            zero.update(L16=torch.zeros_like(lev.L16),
                        D16=torch.zeros_like(lev.D16),
                        iD16=torch.ones_like(lev.iD16))
        lev = dataclasses.replace(lev, **zero)
    else:
        lev = dataclasses.replace(lev, iD=lev.iD * ids)
        if shadows:
            lev = dataclasses.replace(
                lev, iD16=(lev.iD16.float() * ids).to(torch.bfloat16))
    return lev, r * rs, exit_
