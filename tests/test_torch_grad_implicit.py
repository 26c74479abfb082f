"""Port parity: implicit differentiation and the kernels' tracking guard.

Twins of `tests/test_grad.py`'s implicit-solve tests (:151, :199, :230,
:254, :304): the gradient of `ml_solve_implicit` (one adjoint solve a
projection) against central finite differences of the same adaptive
program at the JAX tests' tolerances and against JAX's `jax.grad` of the
same program on the same inputs (f64 on both sides, equal forward
iteration counts), `Simulation(implicit_diff=True)`'s checks and the
linearity of the gradient in the loss scale.

Then the guard: every kernel wrapper raises on an operand that autograd
tracks off the CPU (``meta`` stands in for the card), and the gates send a
tracked field to the plain forms (the gates forced open on the CPU, the
wrappers spied on), while the implicit solves still reach the kernels'
wrappers with untracked tensors, in the forward and in the backward
pass."""
import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from waterlily_tpu import flow as jf
from waterlily_tpu.body import AutoBody as JBody, measure_fields as jmeasure
from waterlily_tpu.grid import field_dot as jdot
from waterlily_tpu.metrics import ke as jke, total_force as jforce
from waterlily_tpu.ops.bc import bc_vector as jbc
from waterlily_tpu.ops.multigrid import (build_levels as jbuild,
                                         ml_solve_implicit as jimplicit)
from waterlily_tpu_torch import Simulation
from waterlily_tpu_torch import flow as tf
from waterlily_tpu_torch.body import AutoBody, measure_fields
from waterlily_tpu_torch.grid import field_dot
from waterlily_tpu_torch.kernels import probes
from waterlily_tpu_torch.metrics import ke, total_force
from waterlily_tpu_torch.ops import attic as at
from waterlily_tpu_torch.ops import pcg_kernel as pk
from waterlily_tpu_torch.ops import poisson as tp
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.ops.bc import bc_vector
from waterlily_tpu_torch.ops.convect import quick
from waterlily_tpu_torch.ops.multigrid import build_levels, ml_solve_implicit

from _torch_parity import tt, jj

f64 = torch.float64
jf64 = jnp.float64


def grad_and_value(f, p):
    p = torch.tensor(p, dtype=f64, requires_grad=True)
    v = f(p)
    (g,) = torch.autograd.grad(v, p)
    return float(v.detach()), float(g)


def central_fd(f, p, h):
    with torch.no_grad():
        return float((f(torch.tensor(p + h, dtype=f64))
                      - f(torch.tensor(p - h, dtype=f64))) / (2 * h))


# --- the solve alone, with a dead-cell block (tests/test_grad.py:151) --------

SD = (10, 10)
GX, GY = np.meshgrid(np.arange(SD[0], dtype=np.float64),
                     np.arange(SD[1], dtype=np.float64), indexing="ij")
DEAD = (GX >= 4) & (GX <= 7) & (GY >= 4) & (GY <= 7)   # faces to zero
IMASK = np.zeros(SD, bool)
IMASK[1:-1, 1:-1] = True
LIVE = IMASK & ~DEAD


def _zero_mean_live(a):
    v = np.where(LIVE, a, 0.0)
    return np.where(LIVE, v - v.sum() / LIVE.sum(), 0.0)


ZD = _zero_mean_live(np.sin(1.3 * GX) * np.sin(0.9 * GY))
WD = _zero_mean_live(np.cos(0.8 * GX + 0.3) * np.cos(1.1 * GY))
MODD = np.sin(0.7 * GX) * np.cos(0.5 * GY)


def dead_block_loss(th):
    """``⟨x*(θ), w⟩`` of the solve with coefficients modulated by ``θ``
    and a dead block (cells 5-6 lose every face): the port's ``loss``."""
    mod = 1.0 + 0.25 * th * tt(MODD)
    m = torch.where(tt(DEAD), 0.0, mod)[None] * torch.ones((2,) + SD,
                                                            dtype=f64)
    levels = build_levels(bc_vector(m, (0.0, 0.0)))
    x, n = ml_solve_implicit(levels, torch.zeros(SD, dtype=f64), tt(ZD),
                             tol=1e-24, itmx=200)
    dead_block_loss.n = n
    return field_dot(x, tt(WD))


def _jdead_block_loss(th):
    mod = 1.0 + 0.25 * th * jj(MODD)
    m = jnp.where(jj(DEAD), 0.0, mod)[None] * jnp.ones((2,) + SD, jf64)
    levels = jbuild(jbc(m, (0.0, 0.0), save_exit=False, perdir=()))
    x, n = jimplicit(levels, jnp.zeros(SD, jf64), jj(ZD), tol=1e-24,
                     itmx=200)
    return jdot(x, jj(WD)), n


def test_implicit_solve_grad_matches_fd():
    """The implicit gradient through the coefficient chain (θ → μ₀ →
    `build_levels` → L, D) and the dead-cell mask equals central FD of the
    same adaptive program (rtol 1e-5) and JAX's (1e-6), with JAX's forward
    iteration count."""
    th0 = 0.8
    v, g = grad_and_value(dead_block_loss, th0)
    n = dead_block_loss.n
    fd = central_fd(dead_block_loss, th0, 1e-6)
    assert np.isfinite(g) and abs(g) > 1e-12
    assert np.isclose(g, fd, rtol=1e-5), (g, fd)
    (jv, jn), jg = jax.jit(jax.value_and_grad(_jdead_block_loss,
                                              has_aux=True))(
        jnp.asarray(th0, jf64))
    assert n == int(jn)
    assert np.isclose(v, float(jv), rtol=1e-6), (v, float(jv))
    assert np.isclose(g, float(jg), rtol=1e-6), (g, float(jg))


def test_implicit_has_no_forward_mode():
    """Forward mode through the implicit solve raises with the way out, as
    JAX's custom_vjp refuses a jvp."""
    with pytest.raises(RuntimeError, match="fixed_iters"):
        torch.func.jvp(dead_block_loss, (torch.tensor(0.8, dtype=f64),),
                       (torch.ones((), dtype=f64),))


# --- two TGV steps with the adaptive solve (tests/test_grad.py:199) ----------

L = 8
KAPPA = 2 * np.pi / L
NU0 = 1.0 / (KAPPA * 100.0)


def ke_after(nu):
    def ulam(i, x):
        xs, ys = x[0] * KAPPA, x[1] * KAPPA
        if i == 0:
            return -torch.sin(xs) * torch.cos(ys)
        return torch.cos(xs) * torch.sin(ys)

    cfg = tf.FlowConfig(D=2, S=(L + 2, L + 2), device="cpu", nu=nu,
                        U=(0.0, 0.0), perdir=(0, 1), dtype=f64, tol=1e-12,
                        itmx=64, implicit_diff=True)
    state = tf.flow_init(cfg, ulam)
    levels = build_levels(state.mu0, cfg.perdir)
    ke_after.pois_n = []
    for _ in range(2):
        state, aux = tf.mom_step(cfg, levels, state)
        ke_after.pois_n.append(aux["pois_n"])
    return torch.sum(ke(state.u))


def _jke_after(nu):
    cfg = jf.FlowConfig(D=2, S=(L + 2, L + 2), nu=nu, U=(0.0, 0.0),
                        perdir=(0, 1), dtype=jf64, tol=1e-12, itmx=64,
                        implicit_diff=True)

    def ulam(i, x):
        xs, ys = x[0] * KAPPA, x[1] * KAPPA
        return jnp.where(i == 0, -jnp.sin(xs) * jnp.cos(ys),
                         jnp.cos(xs) * jnp.sin(ys))

    state = jf.flow_init(cfg, ulam)
    levels = jbuild(state.mu0, cfg.perdir)

    def body(s, _):
        s, aux = jf.mom_step(cfg, levels, s)
        return s, aux["pois_n"]

    state, pois = jax.lax.scan(body, state, None, length=2)
    return jnp.sum(jke(state.u)), pois


def test_implicit_full_step_grad_matches_fd():
    """d(KE)/dν through 2 periodic steps with the adaptive solve (one
    adjoint solve a projection, its periodic ghosts folded) equals central
    FD (rtol 1e-4) and JAX's (1e-6), with JAX's pois_n."""
    v, g = grad_and_value(ke_after, NU0)
    pois = ke_after.pois_n
    h = NU0 * 1e-3
    fd = central_fd(ke_after, NU0, h)
    assert np.isfinite(g)
    assert np.isclose(g, fd, rtol=1e-4), (g, fd)
    (jv, jpois), jg = jax.jit(jax.value_and_grad(_jke_after, has_aux=True))(
        jnp.asarray(NU0, jf64))
    assert pois == np.asarray(jpois).tolist()
    assert np.isclose(v, float(jv), rtol=1e-6), (v, float(jv))
    assert np.isclose(g, float(jg), rtol=1e-6), (g, float(jg))


def test_simulation_implicit_diff_plumbs_and_validates(tmp_path):
    """`Simulation(implicit_diff=True)` steps like the default (the
    Function is transparent to the primal) and refuses what JAX refuses
    (tests/test_grad.py:230); under the in-process mesh it steps on the
    per-phase path, and a `ProcessMesh` steps it on the rank's blocks,
    bit for bit the in-process mesh's block step."""
    from waterlily_tpu_torch.parallel.shard_step import shardmap_mom_step
    from waterlily_tpu_torch.parallel.dist import ProcessMesh
    from waterlily_tpu_torch.parallel.mesh import mesh_for
    from _torch_dist_ranks import one_rank_world
    kw = dict(device="cpu")
    with pytest.raises(ValueError):
        Simulation((8, 8), (1.0, 0.0), 8, implicit_diff=True, fixed_iters=1,
                   **kw)
    with pytest.raises(ValueError):
        Simulation((8, 8), (1.0, 0.0), 8, implicit_diff=True, log=True, **kw)
    with pytest.raises(ValueError):
        Simulation((8, 8), (1.0, 0.0), 8, implicit_diff=True, op_bf16=True,
                   **kw)
    meshed = Simulation((64, 32, 32), (1.0, 0.0, 0.0), 8, implicit_diff=True,
                        mesh=mesh_for((66, 34, 34), 8, "cpu"), **kw)
    assert not meshed._sharded and meshed.cfg.mesh is meshed.mesh
    meshed.step()
    assert torch.isfinite(meshed.flow.u).all() and len(meshed.pois_n) == 1
    with one_rank_world(tmp_path):
        proc = Simulation((64, 32, 32), (1.0, 0.0, 0.0), 8,
                          implicit_diff=True,
                          mesh=ProcessMesh((1, 1, 1), "cpu"), **kw)
        assert proc._sharded
        proc.step()
    dense = Simulation((64, 32, 32), (1.0, 0.0, 0.0), 8, implicit_diff=True,
                       **kw)
    twin, aux = shardmap_mom_step(dense.cfg, mesh_for((66, 34, 34), 1, "cpu"),
                                  dense.levels, dense.flow)
    assert proc.pois_n == [aux["pois_n"]] and torch.equal(proc.flow.u, twin.u)
    sim = Simulation((8, 8), (1.0, 0.0), 8, implicit_diff=True, **kw)
    assert sim._op_bf16 is False and sim.cfg.implicit_diff
    sim = Simulation((8, 8), (1.0, 0.0), 8, nu=0.1, implicit_diff=True, **kw)
    ref = Simulation((8, 8), (1.0, 0.0), 8, nu=0.1, **kw)
    sim.step()
    ref.step()
    assert torch.isfinite(sim.flow.u).all()
    assert len(sim.pois_n) == 1 and len(sim.dts) == 2
    assert torch.equal(sim.flow.u, ref.flow.u) and sim.pois_n == ref.pois_n


# --- the spinning cylinder (tests/test_grad.py:254) --------------------------

DM, RE, U = 8, 500, 1.0
R = DM // 2
SC = (2 * DM + 2, 2 * DM + 2)


def spin_lift(xi):
    xi = torch.as_tensor(xi, dtype=f64)

    def sdf(x, t):
        return torch.sqrt(torch.sum(x * x)) - R

    def mp(x, t):
        a = xi * U * t / R
        s, c = torch.sin(a), torch.cos(a)
        return torch.stack([torch.stack([c, -s]),
                            torch.stack([s, c])]).to(x.dtype) @ (x - DM)

    body = AutoBody(sdf, mp)
    cfg = tf.FlowConfig(D=2, S=SC, device="cpu", nu=U * DM / RE,
                        U=(U, 0.0), dtype=f64, implicit_diff=True, tol=1e-12,
                        itmx=64)
    state = tf.flow_init(cfg)
    V, m0, m1, _ = measure_fields(body, SC, 0.0, 1.0, (), False, f64, "cpu")
    state = state.replace(V=V, mu0=m0, mu1=m1)
    levels = build_levels(m0)
    spin_lift.pois_n = []
    for _ in range(3):
        state, aux = tf.mom_step(cfg, levels, state)
        spin_lift.pois_n.append(aux["pois_n"])
    f = total_force(state.u, state.p, cfg.nu, body, state.t)
    return 2 * f[1] / (U ** 2 * DM)


def _jspin_lift(xi):
    xi = jnp.asarray(xi, jf64)

    def sdf(x, t):
        return jnp.sqrt(jnp.sum(x * x)) - R

    def mp(x, t):
        a = xi * U * t / R
        s, c = jnp.sin(a), jnp.cos(a)
        return jnp.array([[c, -s], [s, c]], x.dtype) @ (x - DM)

    body = JBody(sdf, mp)
    cfg = jf.FlowConfig(D=2, S=SC, nu=U * DM / RE, U=(U, 0.0), dtype=jf64,
                        implicit_diff=True, tol=1e-12, itmx=64)
    state = jf.flow_init(cfg)
    V, m0, m1, _ = jmeasure(body, SC, 0.0, 1.0, (), False, jf64)
    state = state._replace(V=V, mu0=m0, mu1=m1)
    levels = jbuild(m0)

    def step(s, _):
        s, aux = jf.mom_step(cfg, levels, s)
        return s, aux["pois_n"]

    state, pois = jax.lax.scan(step, state, None, length=3)
    f = jforce(state.u, state.p, cfg.nu, body, state.t)
    return 2 * f[1] / (U ** 2 * DM), pois


def test_implicit_grad_through_body_measurement():
    """The implicit gradient through the moving-body chain (spin ratio →
    measurement → BDIM fields → level coefficients → converged solves →
    surface force) equals central FD (rtol 1e-4) and JAX's (1e-6), with
    JAX's pois_n."""
    xi0 = 1.0
    v, g = grad_and_value(spin_lift, xi0)
    pois = spin_lift.pois_n
    fd = central_fd(spin_lift, xi0, 1e-6)
    assert np.isfinite(g)
    assert np.isclose(g, fd, rtol=1e-4), (g, fd)
    (jv, jpois), jg = jax.jit(jax.value_and_grad(_jspin_lift,
                                                 has_aux=True))(
        jnp.asarray(xi0, jf64))
    assert pois == np.asarray(jpois).tolist()
    assert np.isclose(v, float(jv), rtol=1e-6), (v, float(jv))
    assert np.isclose(g, float(jg), rtol=1e-6), (g, float(jg))


# --- linearity in the loss scale (tests/test_grad.py:304) --------------------

SL = (34, 34)
LX, LY = np.meshgrid(np.arange(SL[0], dtype=np.float64),
                     np.arange(SL[1], dtype=np.float64), indexing="ij")
LMOD = 1.0 + 0.9 * np.sin(0.7 * LX) * np.cos(0.5 * LY)
LZ = np.sin(1.3 * LX) * np.sin(0.9 * LY)
LZ = LZ - LZ.mean()
LW = np.cos(0.8 * LX + 0.3) * np.cos(1.1 * LY)


def scaled_loss(th, c):
    mu0 = bc_vector(tt(LMOD)[None] * torch.ones((2,) + SL, dtype=f64),
                    (0.0, 0.0))
    x, _n = ml_solve_implicit(build_levels(mu0), torch.zeros(SL, dtype=f64),
                              th * tt(LZ), tol=1e-4, itmx=64)
    return c * field_dot(x, tt(LW))


def _jscaled_loss(th, c):
    mu0 = jbc(jj(LMOD)[None] * jnp.ones((2,) + SL, jf64), (0.0, 0.0),
              save_exit=False)
    x, _n = jimplicit(jbuild(mu0), jnp.zeros(SL, jf64), th * jj(LZ),
                      tol=1e-4, itmx=64)
    return c * jdot(x, jj(LW))


def test_implicit_grad_linear_in_loss_scale():
    """At the DEFAULT tol the adjoint's right-hand side is normalised:
    g(1e-6·f) = 1e-6·g(f) (rtol 1e-6) and a zero cotangent gives exactly
    zero; g(f) within 1e-6 of JAX's."""
    g = lambda c: grad_and_value(lambda th: scaled_loss(th, c), 1.0)[1]
    g1, g2, g0 = g(1.0), g(1e-6), g(0.0)
    assert np.isfinite(g1) and abs(g1) > 1e-12
    assert np.isclose(g2, 1e-6 * g1, rtol=1e-6), (g1, g2)
    assert g0 == 0.0
    jg1 = float(jax.grad(_jscaled_loss)(jnp.asarray(1.0, jf64), 1.0))
    assert np.isclose(g1, jg1, rtol=1e-6), (g1, jg1)


# --- the guard: kernel wrappers raise on tracked operands off the CPU ---------

SG = (6, 6, 6)


def _meta(*shape):
    return torch.zeros(shape, device="meta")


def _guard_calls():
    """Name → ``call(T)``, a launch of each wrapper on ``meta`` tensors
    (the card's stand-in) whose one operand is passed through ``T``: a
    field, or (``[...]``) the scalar or BC value."""
    f, v = (lambda: _meta(*SG)), (lambda: _meta(3, *SG))
    s, w = (lambda: _meta()), (lambda: _meta(5))
    lev = lambda L: tp.PoissonLevel(L=L, D=f(), iD=f())
    return {
        "mult3d": lambda T: sk.mult3d(v(), f(), T(f())),
        "mult3d[L]": lambda T: sk.mult3d(T(v()), f(), f()),
        "increment3d": lambda T: sk.increment3d(v(), f(), T(f()), f(), f()),
        "ana_mult3d": lambda T: sk.ana_mult3d(T(f()), 1.0),
        "cfl3d": lambda T: sk.cfl3d(T(v())),
        "bc3d": lambda T: sk.bc3d(T(v()), (0.0, 0.0, 0.0)),
        "bc3d[A]": lambda T: sk.bc3d(v(), (T(s()), 0.0, 0.0)),
        "div3d": lambda T: sk.div3d(T(v()), f(), 0.5),
        "div3d[dt]": lambda T: sk.div3d(v(), f(), T(s())),
        "project3d": lambda T: sk.project3d(v(), T(f()), v(), 0.5),
        "project3d[dt]": lambda T: sk.project3d(v(), f(), v(), T(s())),
        "conv_diff3d": lambda T: sk.conv_diff3d(T(v()), 0.1, quick),
        "conv_diff3d[nu]": lambda T: sk.conv_diff3d(v(), T(s()), quick),
        "pcg_fused": lambda T: pk.pcg_fused(lev(v()), T(f()), f()),
        "pcg_fused[L]": lambda T: pk.pcg_fused(lev(T(v())), f(), f()),
        # the fused iteration's sweeps read beta and upd from their words
        "pcg_dir_mult": lambda T: at.pcg_dir_mult(v(), f(), f(), T(f()), f()),
        "pcg_dir_mult[beta]": lambda T: at.pcg_dir_mult(v(), f(), f(), f(),
                                                        f(), T(w())),
        "pcg_update": lambda T: at.pcg_update(T(f()), f(), f(), f(), f(),
                                              w()),
        "pcg_update[upd]": lambda T: at.pcg_update(f(), f(), f(), f(), f(),
                                                   T(w())),
        "dot3d": lambda T: at.dot3d(T(f()), f()),
        "pcg_axpy": lambda T: at.pcg_axpy(f(), T(f()), f(), f(), f(), 0.5),
        "pcg_axpy[upd]": lambda T: at.pcg_axpy(f(), f(), f(), f(), f(),
                                               T(s())),
        "mult3d_stream": lambda T: at.mult3d_stream(v(), f(), T(f())),
        "increment3d_stream": lambda T: at.increment3d_stream(
            v(), f(), T(f()), f(), f()),
        "copy_probe": lambda T: probes.copy_probe(T(f())),
        "copy_probe[c]": lambda T: probes.copy_probe(f(), T(s())),
        "roll_probe": lambda T: probes.roll_probe(T(f())),
        "roll_probe[c]": lambda T: probes.roll_probe(f(), T(s())),
    }


GUARD = sorted(_guard_calls())


def test_guard_covers_every_wrapper():
    """The guard table names every kernel wrapper of a path and both
    probes."""
    names = {n.split("[")[0] for n in GUARD}
    assert names == set(sk.kernel_wrappers()) | set(probes.kernel_wrappers())


@pytest.mark.parametrize("mode", ["requires_grad", "dual"])
@pytest.mark.parametrize("name", GUARD)
def test_wrapper_raises_on_tracked(name, mode):
    """A wrapper handed a tracked operand off the CPU raises a
    RuntimeError naming itself (it never launches, never detaches, never
    reads a tracked scalar on the host); the same call untracked raises
    only for the device (meta is not a card)."""
    call = _guard_calls()[name]
    with pytest.raises(ValueError, match="not supported"):
        call(lambda t: t)
    wrapper = name.split("[")[0]
    if mode == "requires_grad":
        with pytest.raises(RuntimeError, match=f"{wrapper}: .*tracked"):
            call(lambda t: t.requires_grad_())
        with torch.no_grad(), pytest.raises(ValueError):
            call(lambda t: t.requires_grad_())    # grad mode off: untracked
    else:
        with forward_ad.dual_level():
            with pytest.raises(RuntimeError, match=f"{wrapper}: .*tracked"):
                call(lambda t: forward_ad.make_dual(t, torch.zeros_like(t)))


def test_ad_tracked():
    """`ad_tracked` and `kernel_ok`: requires_grad under grad mode, duals
    and torch.func tensors are tracked, nested in tuples too; the gate of
    a CUDA-shaped field closes for a tracked one."""
    a = torch.ones(3)
    assert not sk.ad_tracked(a, 1.0, (a, 2.0), None)
    b = torch.ones(3, requires_grad=True)
    assert sk.ad_tracked(a, (1.0, b))
    with torch.no_grad():
        assert not sk.ad_tracked(b)
    with forward_ad.dual_level():
        assert sk.ad_tracked(forward_ad.make_dual(a, a))
    seen = []
    torch.func.jvp(lambda x: seen.append(sk.ad_tracked(x)) or x, (a,), (a,))
    torch.func.vmap(lambda x: seen.append(sk.ad_tracked(x)) or x)(a)
    assert seen == [True, True]
    S = (66, 66, 66)
    assert sk.kernel_ok(S, torch.float32, "cuda", a)
    assert not sk.kernel_ok(S, torch.float32, "cuda", a, b)
    assert not sk.kernel_ok(S, torch.float32, "cpu", a)


# --- the gates on a step (CPU with the gates forced open) ---------------------

KERNELS = ("mult3d", "increment3d", "bc3d", "div3d", "project3d",
           "conv_diff3d", "cfl3d")
# the blocked-level PCG seams' wrappers (`ops.attic`), spied on too, and
# the seams that route a blocked level through them
SEAM_KERNELS = ("dot3d", "pcg_axpy", "pcg_dir_mult", "pcg_update",
                "mult3d_stream", "increment3d_stream")
# (``PCG_BLOCKED``, the retired seam's name, is now the default smoother
# of blocked non-periodic levels, `attic.pcg_blocked`, under no flag; KDOT
# and KAXPY act in the plain `pcg`, the smoother of periodic levels: their
# channel is periodic across the stream)
SEAMS = {"KDOT+KAXPY": ({"KDOT": True, "KAXPY": True}, ("dot3d", "pcg_axpy"),
                        (1, 2)),
         "PCG_BLOCKED": ({}, ("pcg_dir_mult", "pcg_update"), ()),
         "STREAM": ({"STREAM": True}, ("mult3d_stream",
                                       "increment3d_stream"), ())}
S3 = (18, 10, 10)


@pytest.fixture
def spies(monkeypatch):
    """Every stencil gate forced open on this CPU (levels blocked, small
    levels on `pcg_fused`), each wrapper replaced by a spy that counts its
    calls with untracked and with tracked operands, then runs the wrapper
    (its plain version here)."""
    calls = collections.Counter()

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name, sk.ad_tracked(*args, *kw.values())] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(sk, "use_blocked", lambda S, dtype, device:
                        len(S) == 3 and math.prod(S) >= 1000)
    monkeypatch.setattr(pk, "use_pcg_fused", lambda S, dtype, device:
                        math.prod(S) < 1000)
    for name in KERNELS:
        monkeypatch.setattr(sk, name, spy(name, getattr(sk, name)))
    for name in SEAM_KERNELS:
        monkeypatch.setattr(at, name, spy(name, getattr(at, name)))
    monkeypatch.setattr(pk, "pcg_fused", spy("pcg_fused", pk.pcg_fused))
    return calls


def _step3(nu, **kw):
    """The KE after one 3D channel step with a wavy start, differentiable
    in ``nu``."""
    def ulam(i, x):
        return 1.0 + 0.1 * torch.sin(0.5 * x[0] + i) * torch.cos(0.7 * x[1])

    cfg = tf.FlowConfig(D=3, S=S3, device="cpu", nu=nu, U=(1.0, 0.0, 0.0),
                        dtype=f64, **kw)
    state = tf.flow_init(cfg, ulam)
    levels = build_levels(state.mu0, cfg.perdir)
    state, _aux = tf.mom_step(cfg, levels, state)
    return torch.sum(ke(state.u))


def test_gates_route_tracked_fields_to_the_plain_forms(spies, monkeypatch):
    """With every gate open, an untracked step calls each kernel wrapper;
    a tracked ``fixed_iters`` step under ``torch.autograd`` and one under
    `torch.func.jvp` hand none of them a tracked operand (on the card they
    would raise), and the gradient equals the one with the gates shut."""
    with torch.no_grad():
        _step3(torch.tensor(0.05, dtype=f64), fixed_iters=2)
    assert all(spies[k, False] for k in KERNELS + ("pcg_fused",)), spies
    assert not any(t for (_, t) in spies)
    spies.clear()
    _, g = grad_and_value(lambda nu: _step3(nu, fixed_iters=2), 0.05)
    _, d = torch.func.jvp(lambda nu: _step3(nu, fixed_iters=2),
                          (torch.tensor(0.05, dtype=f64),),
                          (torch.ones((), dtype=f64),))
    assert not any(t for (_, t) in spies), spies
    assert np.isclose(float(d), g, rtol=1e-9)
    monkeypatch.setattr(sk, "use_blocked", lambda S, dtype, device: False)
    monkeypatch.setattr(pk, "use_pcg_fused", lambda S, dtype, device: False)
    _, g_shut = grad_and_value(lambda nu: _step3(nu, fixed_iters=2), 0.05)
    assert np.isclose(g, g_shut, rtol=1e-12), (g, g_shut)


def test_implicit_solves_reach_the_kernels(spies):
    """Under ``implicit_diff`` the forward solve and the adjoint solve
    call `mult3d`, `increment3d` and `pcg_fused` with untracked tensors
    (the detached level stack), the step's other kernels are never called
    with a tracked field, and the gradient equals central FD."""
    nu = torch.tensor(0.05, dtype=f64, requires_grad=True)
    v = _step3(nu, implicit_diff=True, tol=1e-14, itmx=64)
    fwd = collections.Counter(spies)
    (g,) = torch.autograd.grad(v, nu)
    bwd = spies - fwd
    for k in ("mult3d", "increment3d", "pcg_fused"):
        assert fwd[k, False] and bwd[k, False], (k, fwd, bwd)
    assert not any(t for (_, t) in spies), spies
    assert not any(bwd[k, False] for k in ("bc3d", "div3d", "project3d",
                                           "conv_diff3d", "cfl3d")), bwd
    fd = central_fd(lambda nu: _step3(nu, implicit_diff=True, tol=1e-14,
                                      itmx=64), 0.05, 1e-5)
    assert np.isclose(float(g), fd, rtol=1e-5), (float(g), fd)


@pytest.mark.parametrize("seam", sorted(SEAMS))
def test_seam_gates_route_tracked_fields_to_the_plain_forms(spies, seam,
                                                            monkeypatch):
    """Under each blocked-level PCG seam, with every gate open: an
    untracked step calls the seam's `ops.attic` wrappers; a tracked
    ``fixed_iters`` step under ``torch.autograd`` and one under
    `torch.func.jvp` hand none of the wrappers a tracked operand (on the
    card they would raise), and the gradient equals the one with the
    seam off."""
    flags, kernels, perdir = SEAMS[seam]
    for k, v in flags.items():
        monkeypatch.setattr(tp, k, v)
    with torch.no_grad():
        _step3(torch.tensor(0.05, dtype=f64), fixed_iters=2, perdir=perdir)
    assert all(spies[k, False] for k in kernels), spies
    assert not any(t for (_, t) in spies)
    spies.clear()
    _, g = grad_and_value(lambda nu: _step3(nu, fixed_iters=2,
                                            perdir=perdir), 0.05)
    _, d = torch.func.jvp(lambda nu: _step3(nu, fixed_iters=2,
                                            perdir=perdir),
                          (torch.tensor(0.05, dtype=f64),),
                          (torch.ones((), dtype=f64),))
    assert not any(t for (_, t) in spies), spies
    assert np.isclose(float(d), g, rtol=1e-9)
    for k in flags:
        monkeypatch.setattr(tp, k, False)
    _, g_off = grad_and_value(lambda nu: _step3(nu, fixed_iters=2,
                                                perdir=perdir), 0.05)
    assert g == g_off, (g, g_off)
