"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: without a CUDA device every case skips.  On a GPU machine
(which need not have JAX) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The kernels build from ``waterlily_tpu_torch/csrc`` at first use.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

# the slice's shapes: the (96,64,64) fine level, a non-cubic shape whose
# cell count leaves a ragged last block, and the PCG kernel's level
FINE = (98, 66, 66)
RAGGED = (37, 29, 35)
STENCILS = ["mult3d", "increment3d", "cfl3d", "bc3d", "div3d", "project3d",
            "conv_diff3d"]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(name, S, device):
    from waterlily_tpu_torch.kernels.check import compare
    rows = compare(name, S, 1, device)
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad


@pytest.mark.parametrize("name", STENCILS)
@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_stencil_kernel_matches_plain(name, S, device):
    _check(name, S, device)


@pytest.mark.parametrize("S", [(50, 34, 34), (23, 17, 29), (34, 34, 34),
                               (10, 10, 10)])
def test_pcg_kernel_matches_plain(S, device):
    """Walls and periodic axes (0, 1, 2), within 1e-5."""
    _check("pcg_fused", S, device)


@pytest.mark.parametrize("S", [(98, 66), (50, 34), (37, 29), (10, 14)])
def test_pcg_kernel_2d_matches_plain(S, device):
    """The 2D smooth: walls and periodic axes (1,) and (0, 1), within
    1e-5 (the 2D circle's levels, a ragged shape, JAX's test shape)."""
    _check("pcg_fused", S, device)


@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_ana_mult3d_matches_plain(S, device):
    """c = 1 and 2, with and without the dot, and a periodic axis."""
    _check("ana_mult3d", S, device)


@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_periodic_and_exit_forms_launch(S, device):
    """The periodic and save_exit bc3d, the periodic conv_diff3d and the
    2D and periodic pcg_fused launch their kernels on CUDA tensors (their
    values are held by the cases above); f64 still raises (bf16 and f64
    streams are not kernel forms)."""
    from waterlily_tpu_torch.kernels.check import inputs
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    from waterlily_tpu_torch.ops import convect
    u = inputs(S, 0, device)["u"]
    n_bc, n_conv = sk.bc3d.launches, sk.conv_diff3d.launches
    sk.bc3d(u, (0.0, 0.0, 0.0), perdir=(0,))
    sk.bc3d(u, (1.0, 0.0, 0.0), save_exit=True)
    sk.conv_diff3d(u, 0.01, convect.quick, perdir=(1,))
    assert sk.bc3d.launches == n_bc + 2
    assert sk.conv_diff3d.launches == n_conv + 1
    d2 = inputs((10, 14), 0, device)
    lev, r = d2["level"]((1,))
    n_pcg = pk.pcg_fused.launches
    pk.pcg_fused(lev, torch.zeros_like(r), r)
    assert pk.pcg_fused.launches == n_pcg + 1
    with pytest.raises(TypeError, match="float32"):
        sk.cfl3d(u.double())
