"""The plane march of the blocked levels' first PCG sweep (`ops.attic.
pcg_dir_mult`, ``csrc/pcg_iter.cu``) and the one-launch sums of the fused
iteration, on the CPU.

A CUDA kernel cannot run here, so its cell ownership is emulated in numpy:
the grid of `stencil_kernels.march_planes` with the (8, 32) column tiles of
``csrc/march.cuh`` and the kernel's write rule (each interior column
writes its cells of its chunk and, through `march_ghosts`, the ghost cells
beside them; the first and last chunks also the ghost planes).  Every cell
of ``eps`` and ``z``, ghosts included, must be written exactly once, and
every interior cell's two dot terms counted once.  The wrappers' CPU forms
return the plain forms' sums as 0-d tensors.
"""
import numpy as np
import pytest
import torch

from waterlily_tpu_torch.ops import attic as ta
from waterlily_tpu_torch.ops import poisson as tp
from waterlily_tpu_torch.ops import stencil_kernels as sk

from _torch_parity import (normal, interior_only, tt, bc_coeffs,
                           march_ownership)

TILE = (8, 32)   # csrc/march.cuh MARCH_TJ, MARCH_TK


# the blocked levels of the 256³ sphere and the dense slice's fine level,
# then ragged shapes: an axis 0 of one and two interior planes, axes 1 and
# 2 off the (8, 32) tiles, a ragged last chunk
@pytest.mark.parametrize("S", [(258, 258, 258), (130, 130, 130),
                               (66, 66, 66), (98, 66, 66), (3, 37, 70),
                               (4, 9, 40), (37, 29, 35), (70, 41, 67)])
def test_dir_mult_march_writes_each_cell_once(S):
    writes, terms, _ = march_ownership(
        S, sk.march_planes(S, TILE, ta.DIR_PLANES), TILE)
    assert writes.min() == 1 and writes.max() == 1
    inner = np.zeros(S, bool)
    inner[1:-1, 1:-1, 1:-1] = True
    assert np.array_equal(terms, inner.astype(np.int32))


def _level(S, seed=0):
    lev = tp.make_level(tt(bc_coeffs(seed, S)))
    r = tt(interior_only(normal(seed + 1, S, scale=0.1)))
    eps = tt(interior_only(normal(seed + 2, S, scale=0.1)))
    return lev, r, eps


# (beta, previous direction bf16, eps bf16, operator shadows): the six
# forms the fused iteration launches
FORMS = {"f32": (0.37, False, False, False),
         "b0": (0.0, False, False, False),
         "bf16": (0.37, True, True, False),
         "b0_bf16": (0.0, False, True, False),
         "L16": (0.37, False, False, True),
         "b0_L16": (0.0, False, False, True)}


def _words(beta):
    """A smooth's words in flight (`attic.WORDS`) carrying ``beta``."""
    return torch.tensor([0.8, 1.3, 0.0, 0.3, beta])


@pytest.mark.parametrize("form", FORMS)
def test_pcg_dir_mult_cpu_sums_are_0d(form):
    """The CPU wrapper returns eps and z and the words (its sum and scalar
    step, one run of `attic.WORDS`), equal to the plain form's, in each
    form; beta read from the words, or 0 at the seed (no words)."""
    beta, prev16, bf16, op16 = FORMS[form]
    S = (12, 10, 14)
    lev, r, eps = _level(S)
    L, Dd, iD = (tp.operator_shadows(lev.L) if op16
                 else (lev.L, lev.D, lev.iD))
    prev = r if beta == 0.0 else (eps.to(torch.bfloat16) if prev16 else eps)
    w = None if beta == 0.0 else _words(beta)
    ref = ta._pcg_dir_mult_plain(L, Dd, prev, r, iD, w, bf16)
    got = ta.pcg_dir_mult(L, Dd, prev, r, iD, w, bf16)
    assert got[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert got[2].shape == (ta.WORDS,)
    for a, e in zip(got, ref):
        assert torch.equal(a, e)


@pytest.mark.parametrize("name", ["pcg_update", "pcg_axpy"])
def test_axpy_rho_cpu_sum_is_0d(name):
    """`pcg_axpy` returns its rho as a 0-d tensor, `pcg_update` its words
    (upd read from the words it is handed), each equal to the plain
    form's."""
    S = (12, 10, 14)
    lev, r, eps = _level(S)
    x = tt(normal(5, S))
    z = tt(interior_only(normal(6, S)))
    if name == "pcg_update":
        s, plain, shape = _words(0.37), ta._pcg_update_plain, (ta.WORDS,)
    else:
        s, plain, shape = torch.tensor(0.37), ta._axpy_rho_plain, ()
    got = getattr(ta, name)(x, r, eps, z, lev.iD, s)
    ref = plain(x, r, eps, z, lev.iD, s)
    assert got[2].shape == shape
    for a, e in zip(got, ref):
        assert torch.equal(a, e)
