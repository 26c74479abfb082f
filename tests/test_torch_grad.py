"""Port parity: differentiating the solver without the implicit solve.

Twins of `tests/test_grad.py` (reverse mode through a ``fixed_iters``
step, ``test_fixed_iters_matches_adaptive`` :53, ``test_reverse_grad_
ke_wrt_nu`` :70, ``test_reverse_grad_through_body_measurement`` :92) and of
`tests/test_sim.py`'s forward-mode tests (``test_grad_ke_wrt_re`` :111,
``test_grad_lift_wrt_spin`` :162): the port's gradient by
``torch.autograd.grad``, its jvp by `torch.func.jvp`, each against central
finite differences of the same program at the JAX tests' tolerances, and
against JAX's `jax.grad`/`jax.jvp` of the same program on the same inputs
(f64 on both sides, JAX's references computed once per module)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import flow as jf
from waterlily_tpu.body import AutoBody as JBody, measure_fields as jmeasure
from waterlily_tpu.metrics import ke as jke, total_force as jforce
from waterlily_tpu.ops.multigrid import build_levels as jbuild
from waterlily_tpu.ops.multigrid import ml_solve as jsolve
from waterlily_tpu_torch import flow as tf
from waterlily_tpu_torch.body import AutoBody, measure_fields
from waterlily_tpu_torch.metrics import ke, total_force
from waterlily_tpu_torch.ops.multigrid import build_levels, ml_solve

from _torch_parity import assert_rel, npy

f64 = torch.float64
jf64 = jnp.float64
L = 8
KAPPA = 2 * np.pi / L


def _tgv(i, x):
    xs, ys = x[0] * KAPPA, x[1] * KAPPA
    if i == 0:
        return -torch.sin(xs) * torch.cos(ys)
    return torch.cos(xs) * torch.sin(ys)


def _jtgv(i, x, kappa=KAPPA):
    xs, ys = x[0] * kappa, x[1] * kappa
    return jnp.where(i == 0, -jnp.sin(xs) * jnp.cos(ys),
                     jnp.cos(xs) * jnp.sin(ys))


def ke_after(nu, n_steps=2, fixed=1):
    """The kinetic energy after ``n_steps`` TGV steps (JAX's `_ke_after`,
    tests/test_grad.py:35)."""
    cfg = tf.FlowConfig(D=2, S=(L + 2, L + 2), device="cpu", nu=nu,
                        U=(0.0, 0.0), perdir=(0, 1), dtype=f64,
                        fixed_iters=fixed)
    state = tf.flow_init(cfg, _tgv)
    levels = build_levels(state.mu0, cfg.perdir)
    for _ in range(n_steps):
        state, _aux = tf.mom_step(cfg, levels, state)
    return torch.sum(ke(state.u))


def _jke_after(nu, n_steps=2, fixed=1):
    cfg = jf.FlowConfig(D=2, S=(L + 2, L + 2), nu=nu, U=(0.0, 0.0),
                        perdir=(0, 1), dtype=jf64, fixed_iters=fixed)
    state = jf.flow_init(cfg, _jtgv)
    levels = jbuild(state.mu0, cfg.perdir)

    def body(s, _):
        s, _aux = jf.mom_step(cfg, levels, s)
        return s, None

    state, _ = jax.lax.scan(body, state, None, length=n_steps)
    return jnp.sum(jke(state.u))


NU0 = 1.0 / (KAPPA * 100.0)


def grad_and_value(f, p):
    """``(f(p), df/dp)`` by ``torch.autograd.grad``, as floats."""
    p = torch.tensor(p, dtype=f64, requires_grad=True)
    v = f(p)
    (g,) = torch.autograd.grad(v, p)
    return float(v.detach()), float(g)


def jvp_and_value(f, p):
    v, d = torch.func.jvp(f, (torch.tensor(p, dtype=f64),),
                          (torch.ones((), dtype=f64),))
    return float(v), float(d)


def central_fd(f, p, h):
    with torch.no_grad():
        return float((f(torch.tensor(p + h, dtype=f64))
                      - f(torch.tensor(p - h, dtype=f64))) / (2 * h))


# --- reverse mode through fixed_iters ----------------------------------------

def test_fixed_iters_matches_adaptive():
    """The unrolled solve given the adaptive solve's iteration count lands
    on the adaptive answer (tests/test_grad.py:53), and both equal JAX's."""
    cfg = tf.FlowConfig(D=2, S=(L + 2, L + 2), device="cpu", nu=0.01,
                        U=(0.0, 0.0), perdir=(0, 1), dtype=f64)
    state = tf.flow_init(cfg, _tgv)
    levels = build_levels(state.mu0, cfg.perdir)
    z = tf.div(state.u)
    x0 = torch.zeros_like(state.p)
    xa, _ra, na = ml_solve(levels, x0, z)
    xf, _rf, nf = ml_solve(levels, x0, z, fixed=na)
    assert nf == na
    assert np.allclose(npy(xa), npy(xf), atol=1e-12)
    jcfg = jf.FlowConfig(D=2, S=(L + 2, L + 2), nu=0.01, U=(0.0, 0.0),
                         perdir=(0, 1), dtype=jf64)
    js = jf.flow_init(jcfg, _jtgv)
    jx, _jr, jn = jsolve(jbuild(js.mu0, jcfg.perdir), jnp.zeros_like(js.p),
                         jf.div(js.u))
    assert int(jn) == na
    assert_rel(xa, jx, 1e-10)


@pytest.fixture(scope="module")
def jax_ke_nu():
    """JAX's value, grad and jvp of the KE after 2 steps in ν."""
    v, g = jax.jit(jax.value_and_grad(_jke_after))(jnp.asarray(NU0, jf64))
    d = jax.jit(lambda nu: jax.jvp(_jke_after, (nu,),
                                   (jnp.ones((), jf64),))[1])(
        jnp.asarray(NU0, jf64))
    return float(v), float(g), float(d)


def test_reverse_grad_ke_wrt_nu(jax_ke_nu):
    """d(KE)/dν by ``torch.autograd.grad`` through 2 ``fixed_iters=1``
    steps equals central FD (rtol 1e-4) and `torch.func.jvp` of the same
    program (1e-9), as JAX's does (tests/test_grad.py:70); value, gradient
    and jvp within 1e-8 of JAX's."""
    v, g = grad_and_value(ke_after, NU0)
    h = NU0 * 1e-3
    fd = central_fd(ke_after, NU0, h)
    assert np.isfinite(g)
    assert np.isclose(g, fd, rtol=1e-4), (g, fd)
    _, d = jvp_and_value(ke_after, NU0)
    assert np.isclose(g, d, rtol=1e-9), (g, d)
    jv, jg, jd = jax_ke_nu
    assert np.isclose(v, jv, rtol=1e-8), (v, jv)
    assert np.isclose(g, jg, rtol=1e-8), (g, jg)
    assert np.isclose(d, jd, rtol=1e-8), (d, jd)


# --- the spinning cylinder (body measurement under AD) ------------------------

DM, RE, U = 8, 500, 1.0
R = DM // 2
SC = (2 * DM + 2, 2 * DM + 2)


def spin_body(xi):
    """The spinning cylinder: a rotation by ``xi·U·t/R`` about its centre
    in the map, the spin ratio ``xi`` captured by the closure."""
    def sdf(x, t):
        return torch.sqrt(torch.sum(x * x)) - R

    def mp(x, t):
        a = xi * U * t / R
        s, c = torch.sin(a), torch.cos(a)
        Rm = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
        return Rm.to(x.dtype) @ (x - DM)

    return AutoBody(sdf, mp)


def _jspin_body(xi):
    def sdf(x, t):
        return jnp.sqrt(jnp.sum(x * x)) - R

    def mp(x, t):
        a = xi * U * t / R
        s, c = jnp.sin(a), jnp.cos(a)
        Rm = jnp.array([[c, -s], [s, c]], x.dtype)
        return Rm @ (x - DM)

    return JBody(sdf, mp)


def spin_lift(xi, steps=3, fixed=1, t_end=None, **kw):
    """Normalised lift of the spinning cylinder after ``steps`` steps, or
    at ``t_end`` (tU/D) with the adaptive solve (``fixed=None``): the
    port's `lift` of tests/test_grad.py:101 and tests/test_sim.py:174."""
    xi = torch.as_tensor(xi, dtype=f64)
    body = spin_body(xi)
    cfg = tf.FlowConfig(D=2, S=SC, device="cpu", nu=U * DM / RE,
                        U=(U, 0.0), dtype=f64, fixed_iters=fixed, **kw)
    state = tf.flow_init(cfg)
    V, m0, m1, _ = measure_fields(body, SC, 0.0, 1.0, (), False, f64, "cpu")
    state = state.replace(V=V, mu0=m0, mu1=m1)
    levels = build_levels(m0)
    if t_end is None:
        for _ in range(steps):
            state, _aux = tf.mom_step(cfg, levels, state)
    else:
        k = 0
        while float(state.t) * U / DM < t_end and k < 60:
            state, _aux = tf.mom_step(cfg, levels, state)
            k += 1
    f = total_force(state.u, state.p, cfg.nu, body, state.t)
    return f[1] / (xi ** 2 * U ** 2 * DM)


def _jspin_lift(xi, steps=3, fixed=1):
    xi = jnp.asarray(xi, jf64)
    body = _jspin_body(xi)
    cfg = jf.FlowConfig(D=2, S=SC, nu=U * DM / RE, U=(U, 0.0), dtype=jf64,
                        fixed_iters=fixed)
    state = jf.flow_init(cfg)
    V, m0, m1, _ = jmeasure(body, SC, 0.0, 1.0, (), False, jf64)
    state = state._replace(V=V, mu0=m0, mu1=m1)
    levels = jbuild(m0)

    def step(s, _):
        s, _aux = jf.mom_step(cfg, levels, s)
        return s, None

    state, _ = jax.lax.scan(step, state, None, length=steps)
    f = jforce(state.u, state.p, cfg.nu, body, state.t)
    return f[1] / (xi ** 2 * U ** 2 * DM)


def test_reverse_grad_through_body_measurement():
    """d(lift)/d(spin ratio) by ``torch.autograd.grad`` through
    `measure_fields` (the spin ratio captured in the map, under the
    measurement's own vmap(grad)), `build_levels`, 3 ``fixed_iters=1``
    steps and `total_force` equals central FD (rtol 1e-3,
    tests/test_grad.py:92); value and gradient within 1e-8 of JAX's."""
    xi0 = 2.0
    v, g = grad_and_value(spin_lift, xi0)
    fd = central_fd(spin_lift, xi0, 1e-5)
    assert np.isfinite(g)
    assert np.isclose(g, fd, rtol=1e-3), (g, fd)
    jv, jg = jax.jit(jax.value_and_grad(_jspin_lift))(jnp.asarray(xi0, jf64))
    assert np.isclose(v, float(jv), rtol=1e-8), (v, float(jv))
    assert np.isclose(g, float(jg), rtol=1e-8), (g, float(jg))


# --- forward mode through the adaptive step (tests/test_sim.py) ---------------

LR = 32
KR = 2 * np.pi / LR


def ke_of_re(Re):
    """KE of the 32² TGV at t = π/100 with ν = 1/(κ·Re), the adaptive
    solve (tests/test_sim.py:111)."""
    nu = 1 / (KR * Re)

    def ulam(i, x):
        xs, ys = x[0] * KR, x[1] * KR
        if i == 0:
            return -torch.sin(xs) * torch.cos(ys)
        return torch.cos(xs) * torch.sin(ys)

    cfg = tf.FlowConfig(D=2, S=(LR + 2, LR + 2), device="cpu", nu=nu,
                        U=(0.0, 0.0), perdir=(0, 1), dtype=f64)
    state = tf.flow_init(cfg, ulam)
    levels = build_levels(state.mu0, cfg.perdir)
    k = 0
    while float(state.t) < math.pi / 100 and k < 50:
        state, _aux = tf.mom_step(cfg, levels, state)
        k += 1
    return torch.sum(ke(state.u))


def _jke_of_re(Re):
    nu = 1 / (KR * Re)
    cfg = jf.FlowConfig(D=2, S=(LR + 2, LR + 2), nu=nu, U=(0, 0),
                        perdir=(0, 1), dtype=jf64)
    state = jf.flow_init(cfg, lambda i, x: _jtgv(i, x, KR))
    levels = jbuild(state.mu0, cfg.perdir)

    def cond(c):
        s, k = c
        return (s.t < np.pi / 100) & (k < 50)

    def body(c):
        s, k = c
        return jf.mom_step(cfg, levels, s)[0], k + 1

    state, _ = jax.lax.while_loop(cond, body, (state, 0))
    return jnp.sum(jke(state.u))


def test_jvp_ke_wrt_re():
    """d(KE)/d(Re) by `torch.func.jvp` through the adaptive step (its host
    convergence checks included) equals FD at JAX's 1e-1
    (tests/test_sim.py:111); value and jvp within 1e-8 of JAX's."""
    re0 = 100.0
    v, d = jvp_and_value(ke_of_re, re0)
    fd = central_fd(ke_of_re, re0, 1.0)
    assert np.isclose(d, fd, rtol=1e-1), (d, fd)
    jv, jd = jax.jit(lambda r: jax.jvp(_jke_of_re, (r,),
                                       (jnp.ones((), jf64),)))(
        jnp.asarray(re0, jf64))
    assert np.isclose(v, float(jv), rtol=1e-8), (v, float(jv))
    assert np.isclose(d, float(jd), rtol=1e-8), (d, float(jd))


def test_jvp_lift_wrt_spin():
    """d(lift)/d(spin ratio) by `torch.func.jvp` through the measurement
    and the adaptive step to tU/D = 0.5 equals FD at JAX's rtol
    (√h·10 = 1e-2, tests/test_sim.py:162)."""
    xi0, h = 2.0, 1e-6
    lift = lambda xi: spin_lift(xi, fixed=None, t_end=0.5)
    _, d = jvp_and_value(lift, xi0)
    fd = central_fd(lift, xi0, h)
    assert np.isclose(d, fd, rtol=math.sqrt(h) * 10), (d, fd)
