"""The reference's physics oracles on the port (maintests.jl:172-180,
244-253, 280-316, 392-411): each run of `waterlily_tpu_torch` on the CPU
held against its analytic answer with the tolerance of the JAX package's
twin of the test (tests/test_flow.py:68, 97, 109; tests/test_body.py:110;
tests/test_sim.py:45, 63).  No JAX run: the answer is the oracle."""
import math

import numpy as np
import pytest
import torch

from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch import flow as tf
from waterlily_tpu_torch.grid import apply_field, l2
from waterlily_tpu_torch.metrics import pressure_force
from waterlily_tpu_torch.ops.multigrid import build_levels

CPU = torch.device("cpu")
f32, f64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def norm2(x):
    return torch.sqrt(torch.sum(x * x))


def test_impulsive_flow():
    """A uniform impulsive flow stays uniform after a step."""
    U = (2 / 3, -1 / 3)
    cfg = tf.FlowConfig(D=2, S=(18, 18), device=CPU, U=U, dtype=f32)
    state = tf.flow_init(cfg)
    state, _ = tf.mom_step(cfg, build_levels(state.mu0), state)
    assert float(l2(state.u[0] - U[0])) < 2e-5
    assert float(l2(state.u[1] - U[1])) < 1e-5


def test_tgv_decay():
    """The 2D Taylor-Green vortex against its analytic decay."""
    L, Re = 64, 1e8
    kappa = 2 * math.pi / L
    nu = 1 / (kappa * Re)

    def tgv(i, xy, t):
        x, y = xy[0] * kappa, xy[1] * kappa
        decay = math.exp(-2 * kappa ** 2 * nu * t)
        if i == 0:
            return -torch.sin(x) * torch.cos(y) * decay
        return torch.cos(x) * torch.sin(y) * decay

    sim = Simulation((L, L), (0, 0), L, U=1, nu=nu, dtype=f32, perdir=(0, 1),
                     ulam=lambda i, x: tgv(i, x, 0.0), device=CPU)
    sim.sim_step(math.pi / 100)
    t = sim.time
    ue = apply_field(lambda i, x: tgv(i, x, t), (2,) + sim.cfg.S, f32,
                     vector=True)
    u = sim.flow.u
    assert float(l2(u[0] - ue[0])) < 1e-4
    assert float(l2(u[1] - ue[1])) < 1e-4


def test_accelerating_flow():
    """Constant jerk in f64: u = u₀ + ½·jerk·t² exactly."""
    N, jerk = 8, 4
    Uscale = math.sqrt(N)
    g = lambda i, t: t * jerk if i == 0 else 0.0
    sim = Simulation((N, N), (Uscale, 0.0), N, nu=0.001, g=g, dt=0.001,
                     perdir=(0,), dtype=f64, device=CPU)
    sim.sim_step(1.0)
    u_final = Uscale + 0.5 * jerk * sim.time ** 2
    assert float(l2(sim.flow.u[0] - u_final)) < 1e-4
    assert float(l2(sim.flow.u[1])) < 1e-4


def test_accelerating_circle():
    """The added-mass force of a circle in a flow accelerating from rest,
    driven by a callable ``u_BC`` whose second component is a number (the
    JAX test's 16-radius circle with the reference's 32-radii blockage:
    the coefficient within 4% of -π)."""
    radius, H = 16, 16
    dims = (2 * H * radius, 2 * H * radius)
    body = AutoBody(lambda x, t: norm2(x - H * radius) - radius)
    sim = Simulation(dims, lambda i, t: t if i == 0 else 0.0, radius, U=1,
                     body=body, device=CPU)
    sim.sim_step()
    force = pressure_force(sim.flow.p, sim.body, sim.time).numpy()
    assert np.allclose(force / (math.pi * sim.L ** 2), [-1, 0], atol=0.04)
    u = sim.flow.u
    assert float(u.max() / u[0, 1, 1]) > 1.80   # ≈ 2U slip at the surface
    for _ in range(3):
        sim.sim_step()
    pn = np.array(sim.pois_n)
    assert (pn <= 2).all()


RADIUS = 8
NU = RADIUS / 250
NM = (4 * RADIUS, 4 * RADIUS)


def circle(x, t):
    return norm2(x - 2 * RADIUS) - RADIUS


def plate(x, t):
    c = torch.clamp(x[0], -RADIUS + 2, RADIUS - 2)
    return norm2(x - torch.stack([c, torch.zeros_like(c)])) - 2


@pytest.mark.parametrize("exitBC", [True, False])
def test_moving_body_translating(exitBC):
    """A circle translating with the flow (V = U = 1) leaves it uniform;
    one accelerating from rest drives it, with the reference's iteration
    counts."""
    move = lambda x, t: x - torch.stack([t + torch.zeros_like(x[0]),
                                         torch.zeros_like(x[0])])
    sim = Simulation(NM, (1, 0), RADIUS, body=AutoBody(circle, move),
                     nu=NU, dtype=f32, exitBC=exitBC, device=CPU)
    sim.sim_step()
    u = sim.flow.u.numpy()
    assert np.allclose(u[0, :, RADIUS - 1], 1, atol=1e-4)

    accel = lambda x, t: x - torch.stack([2 * t ** 2 + torch.zeros_like(x[0]),
                                          torch.zeros_like(x[0])])
    sim = Simulation(NM, (0, 0), RADIUS, U=1, body=AutoBody(circle, accel),
                     nu=NU, dtype=f32, exitBC=exitBC, device=CPU)
    sim.sim_step()
    assert list(sim.pois_n[0]) == [2, 1]
    assert float(sim.flow.u.max()) > float(sim.flow.V.max()) > 0


def test_moving_body_deforming():
    """A rotating plate (non-uniform body velocity) and a bending one
    (divergent body velocity): the reference's iteration counts and
    time-step ranges."""
    def rotate(x, t):
        a = t / RADIUS + 1
        s, c = torch.sin(a), torch.cos(a)
        y = x - 2 * RADIUS
        return torch.stack([c * y[0] + s * y[1], -s * y[0] + c * y[1]])

    sim = Simulation(NM, (0, 0), RADIUS, U=1, body=AutoBody(plate, rotate),
                     nu=NU, dtype=f32, device=CPU)
    sim.sim_step()
    assert list(sim.pois_n[0]) == [2, 1]
    assert 1 > sim.dts[-1] > 0.5

    def bend(xy, t):
        x, y = xy[0] - 2 * RADIUS, xy[1] - 2 * RADIUS
        k = 2 * t / RADIUS ** 2 + 0.2 / RADIUS
        return torch.stack([x + x ** 3 * k ** 2 / 6, y - x ** 2 * k / 2])

    sim = Simulation(NM, (0, 0), RADIUS, U=1, body=AutoBody(plate, bend),
                     nu=NU, dtype=f32, device=CPU)
    sim.sim_step()
    assert list(sim.pois_n[0]) == [2, 1]
    assert 1.2 > sim.dts[-1] > 0.8
