"""The plane march of the carried-rows operator (`ops.attic.mult3d_stream`,
``csrc/stream_march.cu``) and the row-band grid of the roll probe
(`kernels.probes.roll_probe`, ``csrc/probes.cu``), on the CPU.

A CUDA kernel cannot run here, so each grid's cell ownership is emulated
in numpy.  The operator: the (8, 32) column tiles of ``csrc/march.cuh``
over the chunks the wrapper computes, each interior column writing its
cells of its chunk and the ghost cells beside them; every cell of z,
ghosts included, must be written exactly once, every interior dot term
counted once, and the wrapper's partials buffer must hold one float a
block of that grid.  The roll probe: every thread one column of a band of
rows, its k±1 taps from the neighbouring lanes where they hold this row's
next columns; every output cell must be written once, and every tap must
read the cell `torch.roll` reads.  The wrappers' CPU forms return the
plain forms' sums as 0-d tensors.  `stencil_kernels.mult3d` launches the
operator march too: its launches, recorded instead of run, must be
`mult3d_stream`'s.
"""
import numpy as np
import pytest
import torch

from waterlily_tpu_torch.kernels import probes
from waterlily_tpu_torch.ops import attic as ta
from waterlily_tpu_torch.ops import poisson as tp
from waterlily_tpu_torch.ops import stencil_kernels as sk

from _torch_parity import (normal, interior_only, tt, bc_coeffs,
                           march_ownership)

TILE = (8, 32)   # csrc/march.cuh MARCH_TJ, MARCH_TK
# blocks of the march an H100 holds at once (8 an SM at its 32 registers)
WAVE = 8 * 132
ROLL_ROWS = 8    # csrc/probes.cu ROLL_ROWS

# the blocked levels of the 256³ sphere, the dense slice's fine level, the
# ragged march shapes of chip_smoke.py (MARCH_RAGGED) and the old carried-
# rows kernel's test shapes (a one-row interior along axis 1)
STREAM_SHAPES = [(258, 258, 258), (130, 130, 130), (66, 66, 66),
                 (98, 66, 66), (3, 37, 70), (4, 9, 40), (37, 29, 35),
                 (70, 41, 67), (67, 130, 130), (7, 9, 40), (65, 3, 33)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk_planes(S):
    """The march's planes a chunk by the rule stated in `_stream_march`'s
    terms: the fewest chunks of at most ``STREAM_PLANES[1]`` planes that
    give the grid a wave of `WAVE` blocks, unless chunks of
    ``STREAM_PLANES[0]`` planes come first, balanced over the interior."""
    lo, hi = ta.STREAM_PLANES
    n = S[0] - 2
    tiles = -(-(S[1] - 2) // TILE[0]) * -(-(S[2] - 2) // TILE[1])
    for chunks in range(1, n + 1):
        planes = -(-n // chunks)
        if planes <= hi and (chunks * tiles >= WAVE or planes <= lo):
            return planes
    raise AssertionError(S)


@pytest.fixture
def card(monkeypatch):
    """The library's tile and the card's wave (`_march_tile` and
    `_stream_coresident` ask the built library) as the H100 gives them."""
    monkeypatch.setattr(sk, "_march_tile", lambda: TILE)
    monkeypatch.setattr(ta, "_stream_coresident", lambda *a: WAVE)


@pytest.mark.parametrize("S", STREAM_SHAPES)
def test_stream_march_writes_each_cell_once(S, card):
    x = torch.zeros(S)
    planes, buf = ta._stream_march(S, torch.zeros((3,) + S), x, True)
    assert planes == _chunk_planes(S)
    writes, terms, blocks = march_ownership(S, planes, TILE)
    assert buf.shape == (1 + blocks,)   # the dot, then a partial a block
    assert ta._stream_march(S, torch.zeros((3,) + S), x, False) == (planes,
                                                                    None)
    assert writes.min() == 1 and writes.max() == 1
    inner = np.zeros(S, bool)
    inner[1:-1, 1:-1, 1:-1] = True
    assert np.array_equal(terms, inner.astype(np.int32))


def test_stream_march_refuses_shapes_without_interior(card):
    for S in ((2, 9, 40), (7, 2, 40), (7, 9, 2)):
        with pytest.raises(ValueError, match="at least 3"):
            ta._stream_march(S, torch.zeros((3,) + S), torch.zeros(S), True)


@pytest.mark.parametrize("S", [(258, 258, 258), (130, 130, 130),
                               (98, 66, 66), (3, 37, 70)])
def test_mult3d_launches_the_operator_march(S, card, monkeypatch):
    """`stencil_kernels.mult3d` on the card launches the entry point of
    `mult3d_stream` with the same chunks, buffers and type flags, in all
    eight forms, and counts each launch on itself alone (CPU tensors stand
    in for the card's, and the launches are recorded, not run)."""
    launched = []
    monkeypatch.setattr(sk, "_on_cpu", lambda name, t, *operands: False)
    monkeypatch.setattr(ta, "_on_cpu", lambda name, t, *operands: False)
    monkeypatch.setattr(ta, "launch", lambda *a: launched.append(a))
    arg = lambda a: ((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
                     else a)
    Dd = torch.empty(S)
    for lt, xt in ((torch.float32, torch.float32),
                   (torch.bfloat16, torch.float32),
                   (torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.bfloat16)):
        L, x = torch.empty((3,) + S, dtype=lt), torch.empty(S, dtype=xt)
        for dot in (True, False):
            n = sk.mult3d.launches, ta.mult3d_stream.launches
            out = sk.mult3d(L, Dd, x, dot)
            assert (sk.mult3d.launches, ta.mult3d_stream.launches) == (
                n[0] + 1, n[1])
            ta.mult3d_stream(L, Dd, x, dot)
            assert ta.mult3d_stream.launches == n[1] + 1
            one, two = launched[-2:]
            assert one[0] == "wl_mult3d_stream"
            assert list(map(arg, one)) == list(map(arg, two))
            assert one[-6:] == (lt == torch.bfloat16, xt == torch.bfloat16,
                                _chunk_planes(S), *S)
            if dot:
                assert out[1].shape == ()
    assert sk.mult3d.shapes[S] >= 8


def _roll_grid(S):
    """The roll kernel's grid at ``S`` in numpy: per output cell the count
    of its writes and the flat index each of its four taps (j-1, j+1, k-1,
    k+1) reads, as the kernel takes it: each thread a column of a band of
    `ROLL_ROWS` rows, with x at the band's rows and the one above and
    below held; k±1 from the neighbouring lane where it holds this row's
    next column, else loaded with the wrap."""
    S0, S1, S2 = S
    R = ROLL_ROWS
    bands = -(-S1 // R)
    n = S0 * bands * S2
    v = np.arange(-(-n // 32) * 32)        # whole warps
    live = v < n
    ib = v // S2
    i, k = ib // bands, np.where(live, v % S2, 0)
    j0 = np.where(live, ib % bands * R, 0)
    rows = np.where(live, np.minimum(R, S1 - j0), 0)
    base = np.where(live, i * S1 * S2 + k, 0)
    lane = v % 32
    lo = (lane > 0) & (k > 0)
    hi = (lane < 31) & (k < S2 - 1)
    dm = np.where(k == 0, S2 - 1, -1)
    dp = np.where(k == S2 - 1, 1 - S2, 1)
    N = S0 * S1 * S2
    writes = np.zeros(N, np.int64)
    taps = np.full((4, N), -1, np.int64)
    held = [base + ((j0 - 1 + r) % S1) * S2 for r in range(R + 2)]
    for r in range(R):
        on = r < rows
        w = held[r + 1].reshape(-1, 32)      # each lane's x[j], by warp
        up = np.concatenate([w[:, :1], w[:, :-1]], 1).ravel()
        down = np.concatenate([w[:, 1:], w[:, -1:]], 1).ravel()
        c = base + (j0 + r) * S2
        km = np.where(lo, up, c + dm)
        kp = np.where(hi, down, c + dp)
        np.add.at(writes, c[on], 1)
        for t, src in enumerate((held[r], held[r + 2], km, kp)):
            taps[t, c[on]] = src[on]
    return writes.reshape(S), taps.reshape((4,) + S)


# ragged shapes (a short last band, warps across bands and planes, a
# one-row and a one-column plane) and 258² planes
@pytest.mark.parametrize("S", [(5, 9, 13), (4, 258, 37), (3, 37, 70),
                               (37, 29, 35), (6, 1, 33), (5, 17, 1),
                               (3, 258, 258)])
def test_roll_probe_grid_reads_what_torch_roll_reads(S):
    writes, taps = _roll_grid(S)
    assert writes.min() == 1 and writes.max() == 1
    idx = torch.arange(int(np.prod(S))).reshape(S)
    for t, (shift, axis) in enumerate(((1, 1), (-1, 1), (1, 2), (-1, 2))):
        assert np.array_equal(taps[t], torch.roll(idx, shift, axis).numpy())
    # the kernel's arithmetic on those taps, in f32: the plain form's bits
    x = normal(3, S)
    f = np.float32
    t = (x.ravel()[taps[0]] + x.ravel()[taps[1]]) + x.ravel()[taps[2]]
    t = t + x.ravel()[taps[3]]
    o = f(probes.C) * (x + f(1e-30) * t)
    assert torch.equal(torch.from_numpy(o), probes._roll_probe_plain(tt(x)))


@pytest.mark.parametrize("op16", [False, True])
@pytest.mark.parametrize("x16", [False, True])
def test_mult3d_stream_cpu_sum_is_0d(op16, x16):
    """The CPU wrapper returns z and the dot as a 0-d tensor, the plain
    form's, with the f32 operator and the shadows, an f32 and a bf16 x."""
    S = (12, 10, 14)
    lev = tp.make_level(tt(bc_coeffs(0, S)))
    L, Dd = (tp.operator_shadows(lev.L)[:2] if op16 else (lev.L, lev.D))
    x = tt(interior_only(normal(1, S)))
    if x16:
        x = x.to(torch.bfloat16)
    z, dot = ta.mult3d_stream(L, Dd, x, with_dot=True)
    zr, dr = sk._mult3d_plain(L, Dd, x, with_dot=True)
    assert z.dtype == torch.float32 and dot.shape == ()
    assert torch.equal(z, zr) and torch.equal(dot, dr)
    assert torch.equal(ta.mult3d_stream(L, Dd, x), zr)
