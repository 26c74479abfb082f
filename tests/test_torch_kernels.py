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
# the blocked-level PCG iteration (ops/attic.py) and its composite smoother
PCG_ITERATION = ["pcg_dir_mult", "pcg_update", "dot3d", "pcg_axpy",
                 "pcg_blocked"]
# the carried-rows operator (ops/attic.py) and the bandwidth probes
# (kernels/probes.py)
STREAMS = ["mult3d_stream", "increment3d_stream"]
PROBES = ["copy_probe", "roll_probe"]


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


@pytest.mark.parametrize("name", PCG_ITERATION)
@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_pcg_iteration_kernel_matches_plain(name, S, device):
    """Every form (f32 and bf16 directions, beta 0 and not, the three dot
    modes): elementwise outputs exact, sums within 1e-5 relative,
    pcg_blocked within 1e-5 of the per-pass pcg."""
    _check(name, S, device)


def test_bf16_forms_launch_and_refuse(device):
    """mult3d and increment3d launch on a bf16 x / eps and on a bf16 L (a
    level's L16; their values are held by the cases above) and record the
    forms; a bf16 D, L16 without iD16 in pcg_dir_mult and a bf16 b in
    dot3d's ab mode raise."""
    from waterlily_tpu_torch.kernels.check import inputs
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    from waterlily_tpu_torch.ops import attic as at
    d = inputs(FINE, 0, device)
    L, Dd, x16 = d["lev"].L, d["lev"].D, d["x"].to(torch.bfloat16)
    n_mult = sk.mult3d.launches
    z = sk.mult3d(L, Dd, x16)
    z16 = sk.mult3d(d["L16"], d["D16"], d["x"])
    assert z.dtype == z16.dtype == torch.float32
    assert sk.mult3d.launches == n_mult + 2
    assert {("x",), ("L",)} <= sk.mult3d.forms
    with pytest.raises(TypeError, match="float32"):
        sk.mult3d(d["L16"], d["D16"].to(torch.bfloat16), d["x"])
    with pytest.raises(TypeError, match="iD16"):
        at.pcg_dir_mult(d["L16"], d["D16"], d["eps"], d["r"], d["lev"].iD,
                        0.5)
    with pytest.raises(TypeError, match="float32"):
        at.dot3d(d["x"], d["iD16"], "ab")


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("S", [FINE, RAGGED, (7, 9, 40), (65, 3, 33)])
def test_stream_kernel_matches_plain(name, S, device):
    """The carried-rows operator with and without the dot, f32 and bf16 L,
    at every shape (ragged tiles and chunks, a one-column interior): z, x
    and r exact, the dot within 1e-5 relative."""
    _check(name, S, device)


@pytest.mark.parametrize("name", PROBES)
@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_probe_matches_plain(name, S, device):
    """The bandwidth probes exact (RAGGED's cell count leaves the copy a
    tail of three cells)."""
    _check(name, S, device)


def test_stream_seam_launches_and_refuses(device, monkeypatch):
    """Under ``poisson.STREAM`` a blocked level's mult, residual, increment
    and pcg launch the carried-rows kernels and not the halo-row ones, on
    the f32 operator and on the shadows; a level the kernel cannot take
    (f64) raises."""
    import dataclasses
    from waterlily_tpu_torch.kernels.check import inputs
    from waterlily_tpu_torch.ops import poisson
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    from waterlily_tpu_torch.ops import attic as at
    d = inputs(FINE, 0, device)
    monkeypatch.setattr(poisson, "STREAM", True)
    lev, r = d["lev"], d["r"]
    lev16 = poisson.make_level(lev.L, op_bf16=True)
    assert lev.blocked and lev16.L16 is not None
    counts = lambda: (sk.mult3d.launches, sk.increment3d.launches,
                      at.mult3d_stream.launches,
                      at.increment3d_stream.launches)
    for lv in (lev, lev16):
        before = counts()
        poisson.residual(lv, d["x"], r)
        poisson.increment(lv, d["x"], r, d["eps"])
        poisson.pcg(lv, torch.zeros_like(r), r, it=2)
        after = counts()
        assert after[:2] == before[:2]
        assert after[2] == before[2] + 3 and after[3] == before[3] + 1
    assert ("L",) in at.mult3d_stream.forms
    bad = dataclasses.replace(lev, L=lev.L.double(), D=lev.D.double())
    with pytest.raises(TypeError, match="float32"):
        poisson.mult(bad, d["x"].double())


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
