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


@pytest.mark.parametrize("S", [(50, 34, 34), (23, 17, 29)])
def test_pcg_kernel_matches_plain(S, device):
    _check("pcg_fused", S, device)


@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_ana_mult3d_matches_plain(S, device):
    """c = 1 and 2, with and without the dot, and a periodic axis."""
    _check("ana_mult3d", S, device)


def test_unported_variants_raise(device):
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    from waterlily_tpu_torch.ops import convect
    u = torch.zeros((3,) + RAGGED, device=device)
    with pytest.raises(NotImplementedError, match="B10"):
        sk.bc3d(u, (0.0, 0.0, 0.0), perdir=(0,))
    with pytest.raises(NotImplementedError, match="B12"):
        sk.bc3d(u, (0.0, 0.0, 0.0), save_exit=True)
    with pytest.raises(NotImplementedError, match="B10"):
        sk.conv_diff3d(u, 0.01, convect.quick, perdir=(1,))
    with pytest.raises(TypeError, match="float32"):
        sk.cfl3d(u.double())
