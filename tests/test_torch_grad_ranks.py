"""Port parity: reverse mode through the step on the shards' blocks
(`parallel.shard_step.shardmap_mom_step`), the step a `Simulation` on a
process mesh takes for ``fixed_iters``, ``implicit_diff`` and ``log``.

On the in-process mesh (`mesh_for((18, 18, 18), 8)`, eight blocks of one
process) the block step's gradient of the kinetic energy after two steps
(``dt`` carries ν into the second) is held against JAX's `jax.grad` of
the same program and against the port's dense step, on a walls case and
a periodic case, with the same numpy inputs; a body's radius gradient
against the dense step.  JAX's reference is its dense step, run eagerly.
Its sharded `jax.grad` on the 8-device virtual mesh (the per-phase path
of `tests/test_sharding.py:400`'s ``g8``, in 3D) takes minutes a case
on one CPU core: on the walls ``fixed_iters=2`` case, run eagerly, 495 s
for -3.557429685061323 (its dense gradient and the port's read the same
to 2e-15, central differences of the port's step -3.5574296); under
`jax.jit`, 488 s for -3.47791.  Then the
gates: a tracked block hands no kernel wrapper a tracked operand, and
the implicit solves reach the kernels' wrappers with detached blocks,
forward and backward.  The process mesh's side (8 gloo ranks) is in
`tests/test_torch_dist.py`.
"""
import collections
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import flow as jf
from waterlily_tpu.metrics import ke as jke
from waterlily_tpu.ops.bc import bc_vector as jbc
from waterlily_tpu.ops.multigrid import build_levels as jbuild
from waterlily_tpu_torch import flow as tf
from waterlily_tpu_torch.body import AutoBody, measure_fields
from waterlily_tpu_torch.metrics import ke, total_force
from waterlily_tpu_torch.ops import pcg_kernel as pk
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.ops.bc import bc_vector
from waterlily_tpu_torch.ops.multigrid import build_levels, ml_solve_implicit
from waterlily_tpu_torch.parallel import launch
from waterlily_tpu_torch.parallel.mesh import mesh_for
from waterlily_tpu_torch.parallel.shard_step import shardmap_mom_step

from _torch_parity import tt, jj

f64 = torch.float64
jf64 = jnp.float64
S = (18, 18, 18)
NU = 0.02
STEPS = 2
CASES = {"walls": (), "periodic": (0, 1, 2)}
MODES = {"fixed_iters": (dict(fixed_iters=2), 1e-9),
         "implicit_diff": (dict(implicit_diff=True, tol=1e-12, itmx=64),
                           1e-6)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def start_velocity(perdir):
    """The initial velocity (numpy, ghost-free): a uniform stream on the
    walls case, none on the periodic one, plus smooth modes of seeded
    phases."""
    rng = np.random.default_rng(19)
    x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in S),
                    indexing="ij")
    u = np.zeros((3,) + S)
    for i in range(3):
        ph = rng.uniform(0, 2 * np.pi, 3)
        u[i] = (0.0 if perdir else float(i == 0)) + 0.1 * (
            np.sin(2 * np.pi * x[0] / 16 + ph[0])
            * np.cos(2 * np.pi * x[1] / 16 + ph[1])
            * np.cos(2 * np.pi * x[2] / 16 + ph[2]))
    return u


def _U(perdir):
    return (0.0, 0.0, 0.0) if perdir else (1.0, 0.0, 0.0)


def port_ke(nu, perdir, mesh, **mode):
    """KE after `STEPS` steps: the block step on ``mesh``, or the dense
    step (``mesh=None``)."""
    cfg = tf.FlowConfig(D=3, S=S, device="cpu", nu=nu, U=_U(perdir),
                        perdir=perdir, dtype=f64, **mode)
    state = tf.flow_init(cfg)
    state = state.replace(u=bc_vector(tt(start_velocity(perdir)),
                                      _U(perdir), False, perdir))
    levels = build_levels(state.mu0, perdir)
    for _ in range(STEPS):
        if mesh is None:
            state, _aux = tf.mom_step(cfg, levels, state)
        else:
            state, _aux = shardmap_mom_step(cfg, mesh, levels, state)
    return torch.sum(ke(state.u))


def jax_ke(nu, perdir, **mode):
    """JAX's KE after `STEPS` steps of its dense step."""
    cfg = jf.FlowConfig(D=3, S=S, nu=nu, U=_U(perdir), perdir=perdir,
                        dtype=jf64, **mode)
    state = jf.flow_init(cfg)
    state = state._replace(u=jbc(jj(start_velocity(perdir)), _U(perdir),
                                 save_exit=False, perdir=perdir))
    levels = jbuild(state.mu0, perdir)
    for _ in range(STEPS):
        state, _aux = jf.mom_step(cfg, levels, state)
    return jnp.sum(jke(state.u))


def port_grad(perdir, mesh, **mode):
    nu = torch.tensor(NU, dtype=f64, requires_grad=True)
    (g,) = torch.autograd.grad(port_ke(nu, perdir, mesh, **mode), nu)
    return float(g)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(CASES))
def test_block_step_grad_matches_jax_and_dense(case, mode):
    """d(KE)/dν through two block steps on the in-process 8-block mesh
    equals JAX's ``jax.grad`` of the same program (its dense step, eager)
    and the port's dense step (rtol 1e-9 with ``fixed_iters=2``, 1e-6
    with ``implicit_diff`` at tol 1e-12: the adjoint is exact only at
    convergence)."""
    perdir = CASES[case]
    kw, rtol = MODES[mode]
    g_jax = float(jax.grad(lambda nu: jax_ke(nu, perdir, **kw))(
        jnp.asarray(NU, jf64)))
    g_block = port_grad(perdir, mesh_for(S, 8, "cpu"), **kw)
    g_dense = port_grad(perdir, None, **kw)
    assert np.isfinite(g_block) and abs(g_block) > 1.0
    assert np.isclose(g_block, g_jax, rtol=rtol), (g_block, g_jax)
    assert np.isclose(g_block, g_dense, rtol=rtol), (g_block, g_dense)


# --- a body's radius ---------------------------------------------------------

SPHERE_S = (34, 18, 18)
RADIUS, CENTRE = 4.0, (11.0, 8.0, 8.0)


def sphere_drag(nu, radius, mesh, **mode):
    """The drag on a sphere of ``radius`` after two steps from rest, by
    the block step on ``mesh`` or the dense step."""
    c = torch.tensor(CENTRE, dtype=f64)
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - c) ** 2))
                    - radius)
    cfg = tf.FlowConfig(D=3, S=SPHERE_S, device="cpu", nu=nu,
                        U=(1.0, 0.0, 0.0), dtype=f64, **mode)
    state = tf.flow_init(cfg)
    V, m0, m1, _ = measure_fields(body, SPHERE_S, 0.0, 1.0, (), False, f64,
                                  "cpu")
    state = state.replace(V=V, mu0=m0, mu1=m1)
    levels = build_levels(m0)
    for _ in range(STEPS):
        if mesh is None:
            state, _aux = tf.mom_step(cfg, levels, state)
        else:
            state, _aux = shardmap_mom_step(cfg, mesh, levels, state)
    return total_force(state.u, state.p, nu, body, state.t)[0]


@pytest.mark.parametrize("mode", list(MODES))
def test_block_step_radius_grad_matches_dense(mode):
    """d(drag)/d(radius) and d(drag)/dν through the body's measurement,
    `build_levels` and two block steps equal the dense step's (rtol 1e-9
    with ``fixed_iters``, 1e-6 with ``implicit_diff``)."""
    kw, rtol = MODES[mode]
    out = []
    for mesh in (mesh_for(SPHERE_S, 8, "cpu"), None):
        nu = torch.tensor(0.1, dtype=f64, requires_grad=True)
        radius = torch.tensor(RADIUS, dtype=f64, requires_grad=True)
        g = torch.autograd.grad(sphere_drag(nu, radius, mesh, **kw),
                                (nu, radius))
        out.append([float(v) for v in g])
    assert all(np.isfinite(v) and v != 0.0 for v in out[0]), out
    np.testing.assert_allclose(out[0], out[1], rtol=rtol)


# --- the gates (CPU with the gates forced open) -------------------------------

WRAPPERS = ("mult3d", "increment3d", "bc3d", "div3d", "project3d",
            "conv_diff3d", "cfl3d")


@pytest.fixture
def spies(monkeypatch):
    """Every stencil gate forced open on this CPU (a 3D block of at least
    1000 cells takes the kernel forms, a small level `pcg_fused`), each
    wrapper replaced by a spy that counts its calls with untracked and
    with tracked operands, then runs the wrapper (its plain version
    here)."""
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
    for name in WRAPPERS:
        monkeypatch.setattr(sk, name, spy(name, getattr(sk, name)))
    monkeypatch.setattr(pk, "pcg_fused", spy("pcg_fused", pk.pcg_fused))
    return calls


GATE_S = (26, 26, 26)     # blocks (13, 13, 13), 15³ halo-extended: kernels


def _gate_ke(nu, **mode):
    cfg = tf.FlowConfig(D=3, S=GATE_S, device="cpu", nu=nu,
                        U=(1.0, 0.0, 0.0), dtype=f64, exitBC=True, **mode)

    def ulam(i, x):
        return 1.0 + 0.1 * torch.sin(0.5 * x[0] + i) * torch.cos(0.7 * x[1])

    state = tf.flow_init(cfg, ulam)
    levels = build_levels(state.mu0)
    state, _aux = shardmap_mom_step(cfg, mesh_for(GATE_S, 8, "cpu"), levels,
                                    state)
    return torch.sum(ke(state.u))


def test_tracked_block_step_takes_the_plain_forms(spies, monkeypatch):
    """With every gate open, an untracked block step with the outlet calls
    the shard-local wrappers (``mult3d``, ``conv_diff3d``, ``div3d``,
    ``project3d``) and ``pcg_fused`` on the coarse level; a tracked
    ``fixed_iters`` step hands no wrapper a tracked operand (on the card
    it would raise; the outlet's and the BC's local forms are plain), and
    its gradient equals the one with the gates shut."""
    with torch.no_grad():
        _gate_ke(torch.tensor(0.05, dtype=f64), fixed_iters=2)
    for k in ("mult3d", "conv_diff3d", "div3d", "project3d", "pcg_fused"):
        assert spies[k, False], (k, spies)
    assert not any(t for (_, t) in spies)
    spies.clear()
    nu = torch.tensor(0.05, dtype=f64, requires_grad=True)
    (g,) = torch.autograd.grad(_gate_ke(nu, fixed_iters=2), nu)
    assert not any(t for (_, t) in spies), spies
    monkeypatch.setattr(sk, "use_blocked", lambda S, dtype, device: False)
    monkeypatch.setattr(pk, "use_pcg_fused", lambda S, dtype, device: False)
    nu = torch.tensor(0.05, dtype=f64, requires_grad=True)
    (g_shut,) = torch.autograd.grad(_gate_ke(nu, fixed_iters=2), nu)
    assert np.isclose(float(g), float(g_shut), rtol=1e-12), (g, g_shut)


def test_implicit_block_solves_reach_the_kernels(spies):
    """Under ``implicit_diff`` the block step's forward and adjoint solves
    call ``mult3d`` on the halo-extended blocks and ``pcg_fused`` on the
    replicated coarse level with untracked operands; no wrapper ever gets
    a tracked one, and the backward pass calls none of the step's other
    stencils.  The adjoint solves' counts are recorded."""
    ml_solve_implicit.adjoint_n.clear()
    nu = torch.tensor(0.05, dtype=f64, requires_grad=True)
    v = _gate_ke(nu, implicit_diff=True, tol=1e-12, itmx=64)
    fwd = collections.Counter(spies)
    (g,) = torch.autograd.grad(v, nu)
    bwd = spies - fwd
    for k in ("mult3d", "pcg_fused"):
        assert fwd[k, False] and bwd[k, False], (k, fwd, bwd)
    assert not any(t for (_, t) in spies), spies
    assert not any(bwd[k, False] for k in ("bc3d", "div3d", "project3d",
                                           "conv_diff3d", "cfl3d")), bwd
    assert len(ml_solve_implicit.adjoint_n) == 2
    assert all(n >= 1 for n in ml_solve_implicit.adjoint_n)
    assert np.isfinite(float(g)) and float(g) != 0.0


# --- the launcher's device ------------------------------------------------------

def test_run_ranks_defaults_to_the_card():
    """`run_ranks` runs its ranks on the card unless asked for another
    device, as the port's other entry points do."""
    assert inspect.signature(launch.run_ranks).parameters[
        "device"].default == "cuda"
    assert launch._rank_device("cuda:0", 5) == torch.device("cuda", 0)
    assert launch._rank_device("cpu", 5) == torch.device("cpu")
