"""Port parity of `metrics` (torch vs JAX on the CPU): the kinetic
energy, the strain rate, λ₂ and the vorticity fields (f32 and f64), the
body forces in every sampling and the pressure moment on a stepped 2D
circle and on a 3D sphere (f32), and the reference's oracles
(maintests.jl:318-370) on both packages (f64)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import metrics as jm
from waterlily_tpu.body import AutoBody as JAutoBody
from waterlily_tpu.grid import apply_field as japply
from waterlily_tpu.models import cases as jcases
import waterlily_tpu_torch as wt
from waterlily_tpu_torch import metrics as tm
from waterlily_tpu_torch.grid import apply_field as tapply, loc_grid

from _torch_parity import F32, F64, JAX, TORCH, normal, tt, jj, npy, assert_rel

f32 = jnp.float32
f64 = jnp.float64
RTOL = 1e-5
# the vortex fields: |Δ| <= tol·max|ref|
VORTEX_RTOL = {F32: 1e-5, F64: 1e-12}
SAMPLINGS = ("center", "surface", "extrap")


@pytest.mark.parametrize("S", [(12, 10), (10, 9, 12)])
def test_ke_and_strain_rate(S):
    """1e-5 of each field's scale (exact up to the order XLA fuses the
    sums in)."""
    D = len(S)
    u = normal(4, (D,) + S)
    U = tuple(0.25 * (i + 1) for i in range(D))
    assert_rel(tm.ke(tt(u)), jm.ke(jj(u)), RTOL)
    assert_rel(tm.ke(tt(u), U), jm.ke(jj(u), U), RTOL)
    assert_rel(tm.grad_tensor(tt(u)), jm.grad_tensor(jj(u)), RTOL)
    assert_rel(tm.strain_rate(tt(u)), jm.strain_rate(jj(u)), RTOL)


@pytest.fixture(scope="module", params=["circle_2d", "sphere_3d"])
def stepped(request):
    """A JAX case stepped from rest (the circle 5 steps, the sphere 2) and
    the port's twin on the CPU, holding the same body."""
    if request.param == "circle_2d":
        js = jcases.circle_2d(48, 32, dtype=f32)
        ts = wt.circle_2d(48, 32, device="cpu")
        js.steps(5, remeasure=False)
    else:
        js = jcases.sphere_3d(24, 16, dtype=f32)
        ts = wt.sphere_3d(24, 16, device="cpu")
        js.steps(2, remeasure=False)
    return js, ts, np.asarray(js.flow.u), np.asarray(js.flow.p), js.time


def test_nds(stepped):
    js, ts, _u, p, t = stepped
    S = p.shape
    assert_rel(tm.nds(ts.body, S, t, device="cpu"), jm.nds(js.body, S, t, f32),
               RTOL)


def test_forces(stepped):
    """Each force within 1e-5 of its largest component."""
    js, ts, u, p, t = stepped
    nu = js.cfg.nu
    assert_rel(tm.pressure_force(tt(p), ts.body, t),
               jm.pressure_force(jj(p), js.body, t), RTOL)
    assert_rel(tm.viscous_force(tt(u), nu, ts.body, t),
               jm.viscous_force(jj(u), nu, js.body, t), RTOL)
    ft = tm.total_force(tt(u), tt(p), nu, ts.body, t)
    assert_rel(ft, jm.total_force(jj(u), jj(p), nu, js.body, t), RTOL)
    assert ft.shape == (u.shape[0],) and bool(ft.isfinite().all())


@pytest.mark.parametrize("sampling", ["extrap", "surface"])
def test_unported_sampling_raises(sampling):
    """The samplings that raised before `grid.interp` was ported now give a
    finite force equal to JAX's; an unknown sampling raises `ValueError`,
    as in JAX."""
    ts = wt.circle_2d(16, 16, device="cpu")
    js = jcases.circle_2d(16, 16, dtype=f32)
    p = npy(ts.flow.p)
    f = tm.pressure_force(tt(p), ts.body, sampling=sampling)
    assert f.shape == (2,) and bool(f.isfinite().all())
    assert_rel(f, jm.pressure_force(jj(p), js.body, sampling=sampling),
               RTOL)
    with pytest.raises(ValueError, match="unknown sampling"):
        tm.pressure_force(ts.flow.p, ts.body, sampling=sampling + "_bogus")
    with pytest.raises(ValueError, match="unknown sampling"):
        tm.total_force(ts.flow.u, ts.flow.p, 0.01, ts.body,
                       sampling=sampling + "_bogus")


@pytest.mark.parametrize("sampling", ["surface", "extrap"])
def test_forces_sampled(stepped, sampling):
    """The surface and extrapolated forces within 1e-5 of the largest
    component (the tolerance of ``"center"``)."""
    js, ts, u, p, t = stepped
    nu = js.cfg.nu
    assert_rel(tm.pressure_force(tt(p), ts.body, t, sampling),
               jm.pressure_force(jj(p), js.body, t, sampling), RTOL)
    assert_rel(tm.viscous_force(tt(u), nu, ts.body, t, sampling),
               jm.viscous_force(jj(u), nu, js.body, t, sampling), RTOL)
    ft = tm.total_force(tt(u), tt(p), nu, ts.body, t, sampling)
    assert_rel(ft, jm.total_force(jj(u), jj(p), nu, js.body, t, sampling),
               RTOL)
    assert ft.shape == (u.shape[0],) and bool(ft.isfinite().all())


def test_pressure_moment_stepped(stepped):
    """A scalar in 2D, a 3-vector in 3D, within 1e-5 of the largest."""
    js, ts, _u, p, t = stepped
    D = p.ndim
    x0 = tuple(0.5 * s - 1.0 for s in p.shape)
    m = tm.pressure_moment(x0, tt(p), ts.body, t)
    assert m.shape == (() if D == 2 else (3,))
    assert_rel(m, jm.pressure_moment(x0, jj(p), js.body, t), RTOL)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_vortex_fields(dtype):
    """λ₂, ω, |ω| and ω·θ̂ within 1e-5·max|ref| (f32), 1e-12 (f64); the
    edge curl exact."""
    S = (12, 10, 9)
    u = normal(11, (3,) + S, dtype)
    tol = VORTEX_RTOL[dtype]
    assert_rel(tm.lambda2(tt(u)), jm.lambda2(jj(u)), tol)
    assert_rel(tm.omega(tt(u)), jm.omega(jj(u)), tol)
    assert_rel(tm.omega_mag(tt(u)), jm.omega_mag(jj(u)), tol)
    center = (5.0, 4.5, 3.0)
    assert_rel(tm.omega_theta(tt(u), (0, 0, 1), center),
               jm.omega_theta(jj(u), (0, 0, 1), center), tol)
    for i in range(3):
        np.testing.assert_array_equal(npy(tm.curl(i, tt(u))),
                                      np.asarray(jm.curl(i, jj(u))))
    u2 = normal(12, (2, 11, 9), dtype)
    np.testing.assert_array_equal(npy(tm.curl(2, tt(u2))),
                                  np.asarray(jm.curl(2, jj(u2))))
    with pytest.raises(ValueError, match="z-component"):
        tm.curl(0, tt(u2))


def test_lambda2_weak_gradients():
    """Velocity gradients of ~1e-8 over half the grid (the far field a
    few steps after the start): where ``p³`` underflows in f32 JAX's λ₂ is
    0/0 = NaN and the port's finite, within the f64 field's scale; over
    the other half (gradients of ~1) the two agree (1e-5·max|ref|)."""
    u = normal(13, (3, 12, 10, 9), F32)
    u[:, 5:] *= 1e-8
    ref = np.asarray(jm.lambda2(jj(u)))
    ref64 = np.asarray(jm.lambda2(jj(u.astype(F64))))
    got = npy(tm.lambda2(tt(u)))
    bad = np.isnan(ref)
    assert bad.any() and (~bad[1:-1, 1:-1, 1:-1]).any()
    assert np.isfinite(got).all()
    fin = ~bad
    assert (np.abs(got[fin] - ref[fin]).max()
            <= VORTEX_RTOL[F32] * np.abs(ref[fin]).max())
    assert np.abs(got[bad]).max() <= 2 * np.abs(ref64[bad]).max()


def _setup_u():
    """u[i] = loc_i + prod(loc) on a (3,4,5) grid (maintests.jl:322), f64
    on both packages."""
    f = lambda i, x: x[i] + x[0] * x[1] * x[2]
    ut = tapply(f, (3, 3, 4, 5), torch.float64, vector=True)
    uj = japply(lambda i, x: x[i] + jnp.prod(x), (3, 3, 4, 5), f64,
                vector=True)
    J = (1, 2, 3)  # reference CartesianIndex(2,3,4), 1-based
    x = npy(loc_grid((3, 4, 5), None, torch.float64)[J])
    return ut, uj, J, x, np.prod(x)


def test_lambda2_curl_omega_oracles():
    """maintests.jl:318-340 on the port, and each field against JAX."""
    ut, uj, J, x, px = _setup_u()
    assert np.isclose(float(tm.lambda2(ut)[J]), 1.0, atol=1e-6)
    w = np.cross(1.0 / x, np.repeat(px, 3))
    assert np.isclose(float(tm.curl(1, ut)[J]), w[1])
    assert np.allclose(npy(tm.omega(ut))[(slice(None),) + J], w)
    assert np.isclose(float(tm.omega_mag(ut)[J]), np.sqrt(np.sum(w ** 2)))
    th = tm.omega_theta(ut, (0, 0, 1), x + np.array([0, 1, 2]))
    assert np.isclose(float(th[J]), w[0])
    tol = VORTEX_RTOL[F64]
    assert_rel(tm.lambda2(ut), jm.lambda2(uj), tol)
    assert_rel(tm.omega(ut), jm.omega(uj), tol)
    assert_rel(th, jm.omega_theta(uj, (0, 0, 1), x + np.array([0, 1, 2])),
               tol)


def _circles(N):
    jb_ = JAutoBody(lambda x, t: jnp.sqrt(jnp.sum((x - N / 2) ** 2)) - N // 4)
    tb_ = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - N / 2) ** 2))
                      - N // 4)
    return jb_, tb_


def test_force_sampling_variants():
    """The JAX test's oracle (hydrostatic buoyancy in every sampling, a
    linear shear's viscous force equal in every sampling) on the port, f64,
    and each force against JAX's."""
    N = 32
    jb_, tb_ = _circles(N)
    p = tapply(lambda x: x[1], (N, N), torch.float64)
    for sampling in SAMPLINGS:
        force = npy(tm.pressure_force(p, tb_, sampling=sampling))
        assert np.sum(np.abs(force / (np.pi * (N / 4) ** 2)
                             - np.array([0, 1]))) < 2e-3, sampling
        assert_rel(force, jm.pressure_force(jj(npy(p)), jb_,
                                            sampling=sampling), RTOL)
    u = tapply(lambda i, x: x[(i + 1) % 2], (2, N, N), torch.float64,
               vector=True)
    ref = npy(tm.viscous_force(u, 0.7, tb_))
    for sampling in ("surface", "extrap"):
        v = npy(tm.viscous_force(u, 0.7, tb_, sampling=sampling))
        assert np.allclose(v, ref, atol=1e-8), sampling
        # both ~1e-15 (the shear's force cancels round the circle)
        np.testing.assert_allclose(v, np.asarray(jm.viscous_force(
            jj(npy(u)), 0.7, jb_, sampling=sampling)), atol=1e-12)
    tf = npy(tm.total_force(u, p, 0.7, tb_, sampling="extrap"))
    assert tf.shape == (2,) and np.all(np.isfinite(tf))


def test_pressure_moment_oracle():
    """maintests.jl:365-368: hydrostatic pressure has no moment about the
    centre (2D scalar, 3D vector), on the port and against JAX."""
    N = 32
    jb_, tb_ = _circles(N)
    p2 = tapply(lambda x: x[1], (N, N), torch.float64)
    m2 = tm.pressure_moment((N / 2, N / 2), p2, tb_)
    assert m2.shape == () and np.isclose(float(m2), 0.0, atol=1e-8)
    np.testing.assert_allclose(
        float(m2), float(jm.pressure_moment((N / 2, N / 2), jj(npy(p2)),
                                            jb_)), atol=1e-10)
    p3 = tapply(lambda x: x[1], (N, N, N), torch.float64)
    m3 = npy(tm.pressure_moment((N / 2,) * 3, p3, tb_))
    assert m3.shape == (3,) and np.allclose(m3, 0, atol=1e-7)
    np.testing.assert_allclose(
        m3, np.asarray(jm.pressure_moment((N / 2,) * 3, jj(npy(p3)), jb_)),
        atol=1e-10)
