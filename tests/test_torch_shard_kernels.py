"""Port parity: the shard-local forms of bc3d, div3d, project3d and
conv_diff3d (``S_glob``/``base``, and ``modular`` for conv).

The plain versions run against the JAX Pallas kernels in interpret mode on
small blocks of a 3 x 3 x 3 shard layout, at the corner shard, an
interior shard, the top shard and a mixed one; the ``cuda`` cases hold
each kernel against its plain version on the card (skipped here; run them
with ``python -m pytest --noconftest -m cuda tests/test_torch_shard_kernels.py``).
The JAX side and the parity helpers are imported inside the CPU tests:
collecting this file imports neither, so it changes nothing (not
PyTorch's thread count) for the tests collected beside it on the card.
"""
import numpy as np
import pytest
import torch

# local blocks of (6, 5, 7) cells, three shards an axis
LOC = (6, 5, 7)
S_GLOB = tuple(3 * n for n in LOC)
# shard coordinates: the corner, an interior shard, the top, a mixed one
SHARDS = [(0, 0, 0), (1, 1, 1), (2, 2, 2), (0, 1, 2)]


def _base(c):
    return tuple(ci * n for ci, n in zip(c, LOC))


@pytest.fixture(scope="module")
def par():
    """The parity helpers (`_torch_parity`) on one CPU thread, the thread
    count restored after the module."""
    n = torch.get_num_threads()
    import _torch_parity
    torch.set_num_threads(1)
    yield _torch_parity
    torch.set_num_threads(n)


@pytest.mark.parametrize("save_exit", [False, True])
@pytest.mark.parametrize("c", SHARDS)
def test_bc3d_base_plain_vs_pallas(c, save_exit, par):
    """bc3d on a block: only the global faces in it, bit for bit."""
    from waterlily_tpu.ops.pallas_stencil import bc3d_pallas
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    u = par.normal(11, (3,) + LOC)
    A = (1.0, -0.25, 0.5)
    ref = bc3d_pallas(par.jj(u), A, save_exit, interpret=True, block=1,
                      S_glob=S_GLOB,
                      base=par.jj(np.asarray(_base(c), np.int32)))
    out = sk.bc3d(par.tt(u), A, save_exit, S_glob=S_GLOB, base=_base(c))
    par.assert_exact(out, ref)
    if c == (1, 1, 1):
        par.assert_exact(out, u)    # a block with no global face: unchanged


@pytest.mark.parametrize("c", SHARDS)
def test_div3d_base_plain_vs_pallas(c, par):
    """div3d on a halo-extended block, the interior mask in global
    positions (the caller trims the halo ring)."""
    from waterlily_tpu.ops.pallas_stencil import div3d_pallas
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    S = tuple(n + 2 for n in LOC)
    base = tuple(b - 1 for b in _base(c))
    u, p = par.normal(12, (3,) + S), par.normal(13, S)
    dt = np.float32(0.42)
    zj, xj = div3d_pallas(par.jj(u), par.jj(p), par.jj(dt), interpret=True,
                          block=1, S_glob=S_GLOB,
                          base=par.jj(np.asarray(base, np.int32)))
    z, x = sk.div3d(par.tt(u), par.tt(p), torch.tensor(dt), S_glob=S_GLOB,
                    base=base)
    tr = (slice(1, -1),) * 3
    par.assert_exact(par.npy(z)[tr], np.asarray(zj)[tr])
    par.assert_exact(x, xj)


@pytest.mark.parametrize("c", SHARDS)
def test_project3d_base_plain_vs_pallas(c, par):
    from waterlily_tpu.ops.pallas_stencil import project3d_pallas
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    S = tuple(n + 2 for n in LOC)
    base = tuple(b - 1 for b in _base(c))
    L = np.abs(par.normal(14, (3,) + S)) + 0.5
    x, u = par.normal(15, S), par.normal(16, (3,) + S)
    dt = np.float32(0.37)
    uj, pj = project3d_pallas(par.jj(L), par.jj(x), par.jj(u), par.jj(dt),
                              interpret=True, block=1, S_glob=S_GLOB,
                              base=par.jj(np.asarray(base, np.int32)))
    ut, pt = sk.project3d(par.tt(L), par.tt(x), par.tt(u), torch.tensor(dt),
                          S_glob=S_GLOB, base=base)
    tr = (slice(None),) + (slice(1, -1),) * 3
    # the Pallas kernel may contract an FMA
    par.assert_rel(par.npy(ut)[tr], np.asarray(uj)[tr], 1e-6)
    par.assert_exact(pt, pj)


@pytest.mark.parametrize("perdir", [(), (0,), (1, 2), (0, 1, 2)])
@pytest.mark.parametrize("c", SHARDS)
def test_conv_diff3d_base_plain_vs_pallas(c, perdir, par):
    """conv_diff3d on a block halo-extended by two cells, the boundary
    variants and support in global positions; periodic axes in the modular
    form (uniform periodic flux)."""
    from waterlily_tpu.ops import convect as jc
    from waterlily_tpu.ops.pallas_stencil import conv_diff3d_pallas
    from waterlily_tpu_torch.ops import convect as tc
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    S = tuple(n + 4 for n in LOC)
    base = tuple(b - 2 for b in _base(c))
    u = par.normal(17, (3,) + S)
    rj = conv_diff3d_pallas(par.jj(u), 0.05, jc.quick, S, interpret=True,
                            S_glob=S_GLOB,
                            base=par.jj(np.asarray(base, np.int32)),
                            perdir=perdir, modular=True)
    rt = sk.conv_diff3d(par.tt(u), 0.05, tc.quick, perdir, S_glob=S_GLOB,
                        base=base, modular=True)
    tr = (slice(None),) + (slice(2, -2),) * 3
    par.assert_rel(par.npy(rt)[tr], np.asarray(rj)[tr], 1e-6)


def test_shard_forms_refuse_periodic_without_modular(par):
    from waterlily_tpu_torch.ops import convect as tc
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    u = par.tt(par.normal(18, (3,) + LOC))
    with pytest.raises(ValueError):
        sk.bc3d(u, (0.0,) * 3, perdir=(0,), S_glob=S_GLOB, base=(0, 0, 0))
    with pytest.raises(ValueError):
        sk.conv_diff3d(u, 0.05, tc.quick, (0,), S_glob=S_GLOB,
                       base=(0, 0, 0))


# --- on the card -------------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_forms(name, loc, k):
    """The shard-local forms of ``name`` at every shard of a ``k`` x ``k``
    x ``k`` layout of ``loc`` blocks: (array shape, form)."""
    import itertools
    S_glob = tuple(k * n for n in loc)
    w = {"bc3d": 0, "div3d": 1, "project3d": 1, "conv_diff3d": 2}[name]
    S = tuple(n + 2 * w for n in loc)
    out = []
    for c in itertools.product(range(k), repeat=3):
        base = tuple(ci * n - w for ci, n in zip(c, loc))
        if name == "bc3d":
            out += [(S, (S_glob, base, e)) for e in (False, True)]
        elif name == "conv_diff3d":
            out += [(S, (S_glob, base, p)) for p in ((), (0,), (0, 1, 2))]
        else:
            out.append((S, (S_glob, base)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bc3d", "div3d", "project3d",
                                  "conv_diff3d"])
@pytest.mark.parametrize("loc", [(6, 5, 7), (33, 33, 33)])
def test_shard_kernel_matches_plain(name, loc, device):
    """Every shard of a 3 x 3 x 3 layout (2 x 2 x 2 at 33³, the blocks of
    tgv_3d(64)): the kernel equals its plain version bit for bit."""
    from waterlily_tpu_torch.kernels.check import compare
    k = 3 if loc == (6, 5, 7) else 2
    bad = []
    for S, form in _card_forms(name, loc, k):
        bad += [r for r in compare(name, S, 1, device, form=form)
                if not r["ok"]]
    assert not bad, bad
