"""Port parity of `metrics` (torch vs JAX, f32 on the CPU): the kinetic
energy, the strain rate and the body forces with ``sampling="center"`` on
a stepped 2D circle and on a 3D sphere."""
import jax.numpy as jnp
import numpy as np
import pytest

from waterlily_tpu import metrics as jm
from waterlily_tpu.models import cases as jcases
import waterlily_tpu_torch as wt
from waterlily_tpu_torch import metrics as tm

from _torch_parity import normal, tt, jj, npy, assert_rel

f32 = jnp.float32
RTOL = 1e-5


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
    assert_rel(tm.nds(ts.body, S, t), jm.nds(js.body, S, t, f32), RTOL)


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
    ts = wt.circle_2d(16, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        tm.pressure_force(ts.flow.p, ts.body, sampling=sampling)
    with pytest.raises(NotImplementedError, match="A14"):
        tm.total_force(ts.flow.u, ts.flow.p, 0.01, ts.body,
                       sampling=sampling)
