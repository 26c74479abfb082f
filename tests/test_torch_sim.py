"""Port parity of the slice as a whole: `sphere_3d` constructed and stepped
by both packages (torch vs JAX, f32 on the CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.models.cases import sphere_3d as jsphere
from waterlily_tpu_torch import sphere_3d as tsphere, Simulation
from waterlily_tpu_torch.convert import flow_from_numpy, levels_from_numpy
from waterlily_tpu_torch.utils.perf import mlups, time_steps, idle_share

from _torch_parity import npy


def _pois_ok(a, b):
    """Equal iteration counts, or within ±2 per solve and ≤4 in total."""
    a, b = np.asarray(a, int), np.asarray(b, int)
    d = np.abs(a - b)
    return bool((d == 0).all() or ((d <= 2).all() and d.sum() <= 4))


@pytest.fixture(scope="module")
def pair():
    """JAX sphere_3d(24, 16) and the port's, the port's state carried
    across from the JAX one."""
    js = jsphere(24, 16, dtype=jnp.float32)
    ts = tsphere(24, 16, device="cpu")
    return js, ts


def test_construction_matches(pair):
    js, ts = pair
    for k in ("u", "p", "V", "mu0", "mu1"):
        np.testing.assert_allclose(npy(getattr(ts.flow, k)),
                                   np.asarray(getattr(js.flow, k)), atol=1e-6)
    assert len(ts.levels) == len(js.levels)
    for a, b in zip(ts.levels, js.levels):
        np.testing.assert_allclose(npy(a.D), np.asarray(b.D), atol=1e-5)


def test_five_steps_from_one_state(pair):
    """Five steps from one state: pois_n equal (or the ±2/≤4 rule), dt to
    1e-5 relative, u and p to 1e-4."""
    js, ts = pair
    ts.flow = flow_from_numpy(
        {k: np.asarray(v) for k, v in js.flow._asdict().items()}, "cpu")
    ts.levels = levels_from_numpy(
        [{"L": np.asarray(l.L), "D": np.asarray(l.D), "iD": np.asarray(l.iD)}
         for l in js.levels], "cpu")
    js.steps(5, remeasure=False)
    ts.steps(5, remeasure=False)
    pj = [[int(v) for v in r] for r in js.pois_n]
    assert _pois_ok(ts.pois_n, pj), (ts.pois_n, pj)
    np.testing.assert_allclose(ts.dts, js.dts, rtol=1e-5)
    np.testing.assert_allclose(npy(ts.flow.u), np.asarray(js.flow.u),
                               atol=1e-4)
    np.testing.assert_allclose(npy(ts.flow.p), np.asarray(js.flow.p),
                               atol=1e-4)
    assert np.isfinite(npy(ts.flow.u)).all()


def test_remeasure_step_matches_static():
    """A static body re-measured every step gives the same fields, so both
    stepping modes agree (the JAX default remeasures)."""
    a = tsphere(16, 16, device="cpu")
    b = tsphere(16, 16, device="cpu")
    a.steps(2, remeasure=True)
    b.steps(2, remeasure=False)
    assert a.pois_n == b.pois_n
    assert torch.equal(a.flow.u, b.flow.u)


def test_step_and_steps_histories():
    a = tsphere(16, 16, device="cpu")
    b = tsphere(16, 16, device="cpu")
    a.step(remeasure=False)
    a.step(remeasure=False)
    b.steps(2, remeasure=False)
    assert a.dts == b.dts and len(a.dts) == 3
    assert a.pois_n == b.pois_n
    assert a.sim_time == b.sim_time > 0


def test_run_until():
    s = tsphere(16, 16, device="cpu")
    s.run_until(0.1, chunk=2, remeasure=False)
    assert s.sim_time >= 0.1 and len(s.dts) % 2 == 1


def test_banded_sizes_refuse():
    """The size gate: a body on a grid of at least 600k interior cells
    takes the banded path, as in JAX (``bbox=False`` keeps it dense and
    ``"force"`` bands at any size); checked through the gate's constant and
    ``bbox="force"``, without building a 96³ grid here."""
    from waterlily_tpu_torch.simulation import BANDED_MIN_CELLS
    assert BANDED_MIN_CELLS == 600_000
    assert 96 ** 3 >= BANDED_MIN_CELLS > 96 * 64 * 64
    assert tsphere(48, 32, device="cpu").cfg.bbox_shape is None
    forced = tsphere(48, 32, bbox="force", device="cpu")
    js = jsphere(48, 32, bbox="force", dtype=jnp.float32)
    assert forced.cfg.bbox_shape == js.cfg.bbox_shape is not None
    assert not any(l.banded for l in forced.levels)   # levels stay dense


def test_device_is_required():
    """The device defaults to the card: ``device="cuda"`` on `Simulation`
    and on every case; without a card the default construction fails with
    torch's own CUDA error (no fallback to the CPU)."""
    import inspect
    from waterlily_tpu_torch import heaving_sphere_3d
    for fn in (Simulation, tsphere, heaving_sphere_3d):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        Simulation((16, 16, 16), (1, 0, 0), 4.0)


def test_perf_helpers():
    assert mlups((96, 64, 64), 10, 1.0) == pytest.approx(3.93216)
    with pytest.raises(ValueError, match="CUDA"):
        time_steps(tsphere(16, 16, device="cpu"), 1)
    with pytest.raises(ValueError, match="CUDA"):
        idle_share(tsphere(16, 16, device="cpu"), 1)


def test_periodic_tgv_through_simulation():
    """The constructor's other keywords (ulam, perdir, U) on the plain
    path: JAX's fully periodic 3D Taylor-Green case and its port twin
    agree over three steps."""
    import math
    from waterlily_tpu.models.cases import tgv_3d
    L, Re = 16, 1600
    kappa = 2 * math.pi / L

    def ulam(i, x):
        xs, ys, zs = x[0] * kappa, x[1] * kappa, x[2] * kappa
        if i == 0:
            return torch.sin(xs) * torch.cos(ys) * torch.cos(zs)
        if i == 1:
            return -torch.cos(xs) * torch.sin(ys) * torch.cos(zs)
        return torch.zeros_like(xs)

    js = tgv_3d(L, Re, dtype=jnp.float32)
    ts = Simulation((L, L, L), (0, 0, 0), L, U=1, nu=1 / (kappa * Re),
                    perdir=(0, 1, 2), ulam=ulam, device="cpu")
    np.testing.assert_allclose(npy(ts.flow.u), np.asarray(js.flow.u),
                               atol=1e-6)
    js.steps(3)
    ts.steps(3)
    assert _pois_ok(ts.pois_n, [[int(v) for v in r] for r in js.pois_n])
    np.testing.assert_allclose(ts.dts, js.dts, rtol=1e-5)
    np.testing.assert_allclose(npy(ts.flow.u), np.asarray(js.flow.u),
                               atol=1e-4)


def test_fixed_iters():
    s = tsphere(16, 16, device="cpu", fixed_iters=2)
    s.steps(2, remeasure=False)
    assert s.pois_n == [[2, 2], [2, 2]]
