"""Port parity: ensembles, the whole pipeline under `torch.func.vmap`.

Twins of `tests/test_ensemble.py` (:63, :82, :93): the spinning-cylinder
force as a pure function of the spin ratio batched over members against
the port's own per-member runs (1e-12 relative, as JAX holds its own) and
JAX's batched program (1e-10), its gradient batched over members, and
`vmap(grad)` through ``implicit_diff``'s adjoint solve.  Then the pieces:
the adaptive loops' member form (each member stops by its own test and is
left bit for bit as its own run leaves it), `pcg_fused`'s member form on
the CPU (its plain version, `vmap` of `pcg`), the gate that sends a field
under `vmap` alone to it and a differentiated one to `pcg`, and the
entry points' device defaults.  f64 on both sides, as JAX's tests."""
import collections
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.flow import (FlowConfig as JConfig, flow_init as jinit,
                                mom_step as jstep)
from waterlily_tpu.metrics import ke as jke
from waterlily_tpu.ops.multigrid import build_levels as jbuild
from waterlily_tpu_torch import flow as tf
from waterlily_tpu_torch import metrics as tm
from waterlily_tpu_torch.body import (AutoBody, band_box_shape, measure_fields,
                                      measure_fields_banded, measure_sdf)
from waterlily_tpu_torch.kernels.check import member_inputs, member_variants
from waterlily_tpu_torch.metrics import ke, total_force
from waterlily_tpu_torch.ops import pcg_kernel as pk
from waterlily_tpu_torch.ops import poisson as tp
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.ops.multigrid import (build_levels, ml_solve,
                                               ml_solve_implicit)

from _torch_parity import npy, assert_rel
from test_ensemble import _make_force_fn as _jax_force_fn

f64 = torch.float64
XIS = [0.5, 1.5, 3.0]


def _cylinder(xi, fixed=1):
    """``(cfg, body, levels, state)`` of `tests/test_ensemble.py`'s
    spinning cylinder at spin ratio ``xi`` (``fixed=None``: the adaptive
    solve), the port's twin of its ``_make_force_fn``'s set-up."""
    Dm, Re, U = 8, 500, 1.0
    R = Dm // 2
    S = (2 * Dm + 2, 2 * Dm + 2)

    def sdf(x, t):
        return torch.sqrt(torch.sum(x * x)) - R

    def mp(x, t):
        a = xi * U * t / R
        s, c = torch.sin(a), torch.cos(a)
        Rm = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
        return Rm.to(x.dtype) @ (x - Dm)

    body = AutoBody(sdf, mp)
    cfg = tf.FlowConfig(D=2, S=S, device="cpu", nu=U * Dm / Re, U=(U, 0.0),
                        dtype=f64, fixed_iters=fixed)
    state = tf.flow_init(cfg)
    V, m0, m1, _ = measure_fields(body, S, 0.0, 1.0, (), False, f64, "cpu")
    return cfg, body, build_levels(m0), state.replace(V=V, mu0=m0, mu1=m1)


def _force_fn(n_steps=2, fixed=1):
    """The force after ``n_steps`` steps as a pure function of the spin
    ratio (the twin of ``_make_force_fn``)."""
    def force(xi):
        cfg, body, levels, state = _cylinder(xi, fixed)
        for _ in range(n_steps):
            state, _aux = tf.mom_step(cfg, levels, state)
        return total_force(state.u, state.p, cfg.nu, body, state.t)
    return force


def test_vmap_ensemble_matches_individual():
    """Twin of :63: the batched force equals the per-member runs within
    1e-12 (JAX's own tolerance between its batched and single programs)
    and JAX's batched program within 1e-10; lift grows with spin."""
    force = _force_fn()
    xis = torch.tensor(XIS, dtype=f64)
    batched = torch.func.vmap(force)(xis)
    singles = torch.stack([force(x) for x in xis])
    assert batched.shape == (3, 2)
    assert np.allclose(npy(batched), npy(singles), rtol=1e-12, atol=1e-12)
    ref = jax.jit(jax.vmap(_jax_force_fn()))(jnp.asarray(XIS, jnp.float64))
    assert_rel(batched, ref, 1e-10)
    lift = np.abs(npy(batched)[:, 1])
    assert lift[0] < lift[-1]


def test_vmap_composes_with_grad():
    """Twin of :82: a batched gradient sweep d(force_y)/d(xi) equals the
    per-member `torch.func.grad`s within 1e-12 and JAX's derivative of
    the same function at each member within 1e-10.  JAX's side is its
    forward mode (`jax.jvp`, one program for both members): the function
    maps one scalar to the force, so the tangent is the same derivative
    that `jax.grad` gives, without tracing a reverse pass, which is what
    keeps JAX's `vmap(grad)` of :82 out of tier-1."""
    force = _force_fn(n_steps=1)
    lift = lambda x: force(x)[1]
    xis = torch.tensor([1.0, 2.0], dtype=f64)
    g = torch.func.vmap(torch.func.grad(lift))(xis)
    gs = torch.stack([torch.func.grad(lift)(x) for x in xis])
    assert g.shape == (2,) and bool(torch.isfinite(g).all())
    assert_rel(g, gs, 1e-12)
    jforce = _jax_force_fn(n_steps=1)
    dlift = jax.jit(lambda x: jax.jvp(lambda y: jforce(y)[1], (x,),
                                      (jnp.ones_like(x),))[1])
    ref = np.asarray([float(dlift(jnp.asarray(float(x), jnp.float64)))
                      for x in xis])
    assert_rel(g, ref, 1e-10)


L_TGV = 8
KAPPA = 2 * np.pi / L_TGV


def _ke_after(nu):
    """Twin of :93's ``ke_after``: the kinetic energy after one
    ``implicit_diff`` step of the periodic Taylor-Green vortex, as a
    function of ν."""
    def ulam(i, x):
        if i == 0:
            return -torch.sin(KAPPA * x[0]) * torch.cos(KAPPA * x[1])
        return torch.cos(KAPPA * x[0]) * torch.sin(KAPPA * x[1])

    cfg = tf.FlowConfig(D=2, S=(L_TGV + 2, L_TGV + 2), device="cpu", nu=nu,
                        U=(0.0, 0.0), perdir=(0, 1), dtype=f64, tol=1e-12,
                        itmx=64, implicit_diff=True)
    state = tf.flow_init(cfg, ulam)
    levels = build_levels(state.mu0, cfg.perdir)
    state, _aux = tf.mom_step(cfg, levels, state)
    return torch.sum(ke(state.u))


def _jax_ke_after(nu):
    def ulam(i, x):
        return jnp.where(i == 0,
                         -jnp.sin(KAPPA * x[0]) * jnp.cos(KAPPA * x[1]),
                         jnp.cos(KAPPA * x[0]) * jnp.sin(KAPPA * x[1]))

    cfg = JConfig(D=2, S=(L_TGV + 2, L_TGV + 2), nu=nu, U=(0.0, 0.0),
                  perdir=(0, 1), dtype=jnp.float64, tol=1e-12, itmx=64,
                  implicit_diff=True)
    state = jinit(cfg, ulam)
    levels = jbuild(state.mu0, cfg.perdir)
    state, _ = jstep(cfg, levels, state)
    return jnp.sum(jke(state.u))


def test_vmap_grad_composes_with_implicit_diff():
    """Twin of :93: vmap(grad) over ν through the adaptive solve's adjoint
    (`ml_solve_implicit`, its forward and adjoint solves in the member
    form) equals the per-member gradients within 1e-12 and JAX's batched
    gradients within 1e-10; each member's adjoint solves take the counts
    of its own run."""
    nus = [0.005, 0.01, 0.02]
    ml_solve_implicit.adjoint_n.clear()
    gs = torch.stack([torch.func.grad(_ke_after)(torch.tensor(n, dtype=f64))
                      for n in nus])
    alone = list(ml_solve_implicit.adjoint_n)
    ml_solve_implicit.adjoint_n.clear()
    gb = torch.func.vmap(torch.func.grad(_ke_after))(
        torch.tensor(nus, dtype=f64))
    batched = list(ml_solve_implicit.adjoint_n)
    assert bool(torch.isfinite(gb).all())
    assert_rel(gb, gs, 1e-12)
    ref = jax.jit(jax.vmap(jax.grad(_jax_ke_after)))(
        jnp.asarray(nus, jnp.float64))
    assert_rel(gb, ref, 1e-10)
    # a solve a projection: each member's counts, in the order of its own
    per_solve = len(batched)
    assert all(len(b) == len(nus) for b in batched)
    assert [alone[m * per_solve + k] for k in range(per_solve)
            for m in range(len(nus))] == [c for b in batched for c in b]


# --- the adaptive loops' member form ---------------------------------------

S_LOOP = (34, 18)
RADII = [2.5, 4.0, 5.5]


def _mu0(rad):
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum(
        (x - torch.tensor([10.0, 9.0], dtype=f64)) ** 2)) - rad)
    return measure_fields(body, S_LOOP, 0.0, 1.0, (), False, f64, "cpu")[1]


def _solve(kind, rad, z):
    levels = build_levels(_mu0(rad))
    if kind == "poisson_solve":
        lev = levels[2]
        zz = z[:lev.D.shape[0], :lev.D.shape[1]] * 1.0
        return tp.poisson_solve(lev, torch.zeros_like(lev.D), zz, tol=1e-4,
                                itmx=30)
    return ml_solve(levels, torch.zeros_like(z), z, tol=1e-3, itmx=8,
                    trace=kind == "ml_solve trace")


@pytest.mark.parametrize("kind", ["ml_solve", "ml_solve trace",
                                  "poisson_solve"])
def test_adaptive_members_equal_per_member(kind):
    """Under `vmap` the adaptive loops stop each member by its own test:
    every output (x, r, the counts, the residual trace) equals the
    member's own run bit for bit, members that stop at different counts
    included (a stopped member does not move; ml_solve's counts are 1, 2
    and 8, the last at ``itmx``)."""
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (len(RADII),) + S_LOOP) * 0.1)
    rads = torch.tensor(RADII, dtype=f64)
    batched = torch.func.vmap(lambda r, zz: _solve(kind, r, zz))(rads, z)
    counts = []
    for m in range(len(RADII)):
        own = _solve(kind, rads[m], z[m])
        assert int(batched[2][m]) == own[2]
        counts.append(own[2])
        for b, o in zip(batched[:2] + batched[3:], own[:2] + own[3:]):
            assert torch.equal(b[m], o)
    assert len(set(counts)) > 1, counts


def test_adaptive_step_pois_n_per_member():
    """`mom_step` with the adaptive solve under `vmap`: ``pois_n`` is
    each member's, a (2,) tensor a member equal to the member's own host
    ints, and the forces equal the members' own within 1e-12."""
    def step(xi):
        cfg, body, levels, state = _cylinder(xi, fixed=None)
        state, aux = tf.mom_step(cfg, levels, state)
        return aux["pois_n"], total_force(state.u, state.p, cfg.nu, body,
                                          state.t)

    xis = torch.tensor(XIS, dtype=f64)
    pois, forces = torch.func.vmap(step)(xis)
    assert pois.shape == (3, 2) and pois.dtype == torch.int64
    for m, xi in enumerate(xis):
        own_pois, own_force = step(xi)
        assert all(isinstance(n, int) for n in own_pois)
        assert pois[m].tolist() == own_pois
        assert_rel(forces[m], own_force, 1e-12)


# --- pcg_fused's member form on the CPU, and its gate ----------------------

@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("S", [(18, 10), (10, 10, 10)])
def test_pcg_members_plain_equals_per_member(S, shared):
    """On the CPU the member form is `vmap` of `poisson.pcg`: each member
    (an operator shared or one a member; member 1's zero residual stays
    zero) equals its own `pcg` bit for bit, and `pcg_fused` under `vmap`
    reaches the same through its `vmap` rule."""
    d = member_inputs(S, 3, shared, 5, "cpu")
    for route, kern, _plain in member_variants(d):
        x, r = kern()
        for m, lev in enumerate(d["levels"]):
            own = tp.pcg(lev, d["x"][m], d["r"][m])
            assert torch.equal(x[m], own[0]) and torch.equal(r[m], own[1])
        assert not x[1].any() and not r[1].any()


@pytest.fixture
def routes(monkeypatch):
    """`smooth`'s gate opened on the CPU for the levels below 1000 cells,
    with spies counting the smooths that reach the member form's `vmap`
    rule (`pcg_members`), the kernel wrapper and the plain `pcg`."""
    calls = collections.Counter()

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(pk, "use_pcg_fused", lambda S, dtype, device:
                        math.prod(S) < 1000)
    monkeypatch.setattr(pk, "pcg_members", spy("members",
                                               pk.pcg_members))
    monkeypatch.setattr(pk, "pcg_fused", spy("pcg_fused", pk.pcg_fused))
    monkeypatch.setattr(tp, "pcg", spy("pcg", tp.pcg))
    return calls


def test_gate_routes_vmap_to_the_member_form(routes):
    """With the gate open, a level under `vmap` alone goes to
    `pcg_fused`'s member form (every smooth); one under `vmap` of `grad`
    or of `jvp`, and under `grad` alone, goes to the plain `pcg` and never
    to the kernel's wrapper."""
    force = _force_fn(n_steps=1)
    xis = torch.tensor(XIS[:2], dtype=f64)
    torch.func.vmap(force)(xis)
    assert routes["members"] > 0
    assert routes["members"] == routes["pcg_fused"], routes
    lift = lambda x: force(x)[1]
    for run in (lambda: torch.func.vmap(torch.func.grad(lift))(xis),
                lambda: torch.func.vmap(lambda x: torch.func.jvp(
                    lift, (x,), (torch.ones_like(x),))[1])(xis),
                lambda: torch.func.grad(lift)(xis[0])):
        routes.clear()
        run()
        assert routes["pcg"] > 0 and not routes["pcg_fused"], routes


# the batching of a nested vmap's operator: the levels that batch it
NEST = {"none": (), "outer": (0,), "inner": (1,), "both": (0, 1)}


@pytest.mark.parametrize("op", list(NEST))
def test_nested_vmap_smooths_every_member_at_once(routes, monkeypatch, op):
    """`vmap` of `vmap` (2 × 3 members) through `smooth` with the gate
    open: the member form's rules fold both levels into one member axis,
    so `pcg_members` runs once on all six members, and each equals its own
    `pcg` bit for bit, whichever levels batch the operator (none, the
    outer, the inner or both; member (0, 1)'s zero residual stays
    zero)."""
    S, B, levels = (18, 10), (2, 3), NEST[op]
    d = member_inputs(S, 6, False, 5, "cpu")
    seen, members = [], pk.pcg_members
    monkeypatch.setattr(pk, "pcg_members", lambda L, Dd, iD, x, r, *a: (
        seen.append(x.shape[0]) or members(L, Dd, iD, x, r, *a)))
    grid = lambda t: t.reshape(B + tuple(t.shape[1:]))
    # the operator keeps the axes of the levels that batch it
    keep = lambda t: grid(t)[tuple(slice(None) if k in levels else 0
                                   for k in (0, 1))]
    ops = [keep(d[f]) for f in ("L", "D", "iD")]
    dims = lambda lv: tuple(0 if lv in levels else None for _ in ops)
    fn = lambda L, Dd, iD, x, r: tp.smooth(
        tp.PoissonLevel(L=L, D=Dd, iD=iD), x, r)
    x, r = torch.func.vmap(torch.func.vmap(fn, in_dims=dims(1) + (0, 0)),
                           in_dims=dims(0) + (0, 0))(
        *ops, grid(d["x"]), grid(d["r"]))
    assert seen == [6] and routes["pcg_fused"] == 1, (seen, routes)
    for i in range(B[0]):
        for j in range(B[1]):
            at = tuple((i, j)[k] for k in levels)
            lev = tp.PoissonLevel(L=ops[0][at], D=ops[1][at], iD=ops[2][at])
            own = tp.pcg(lev, grid(d["x"])[i, j], grid(d["r"])[i, j])
            assert torch.equal(x[i, j], own[0])
            assert torch.equal(r[i, j], own[1])
    assert not x[0, 1].any() and not r[0, 1].any()


def test_nested_vmap_adaptive_loop():
    """`vmap` of `vmap` (2 × 2 members) through the adaptive `ml_solve`:
    the loop's rules fold both levels into one member axis and each
    member's x, r and count equal its own run bit for bit."""
    rads = torch.tensor([[2.5, 4.0], [5.5, 3.0]], dtype=f64)
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 2) + S_LOOP) * 0.1)
    solve = lambda r, zz: _solve("ml_solve", r, zz)
    x, r, n = torch.func.vmap(torch.func.vmap(solve))(rads, z)
    assert n.shape == (2, 2)
    for i in range(2):
        for j in range(2):
            own = solve(rads[i, j], z[i, j])
            assert int(n[i, j]) == own[2]
            assert torch.equal(x[i, j], own[0])
            assert torch.equal(r[i, j], own[1])


@pytest.mark.parametrize("transform", ["vmap", "vmap(grad)", "vmap(jvp)",
                                       "grad", "jvp", "requires_grad"])
def test_vmap_only(transform):
    """`stencil_kernels.vmap_only` holds for a field under `vmap` alone;
    `ad_tracked` (the 3D kernels' gate) for every transform, `vmap`
    included."""
    seen = []
    probe = lambda x: seen.append((sk.vmap_only(x), sk.ad_tracked(x),
                                   sk.vmapped(x))) or x.sum()
    a = torch.ones(2, 3, dtype=f64)
    run = {"vmap": lambda: torch.func.vmap(probe)(a),
           "vmap(grad)": lambda: torch.func.vmap(torch.func.grad(probe))(a),
           "vmap(jvp)": lambda: torch.func.vmap(
               lambda x: torch.func.jvp(probe, (x,), (x,)))(a),
           "grad": lambda: torch.func.grad(probe)(a[0]),
           "jvp": lambda: torch.func.jvp(probe, (a[0],), (a[0],)),
           "requires_grad": lambda: probe(a[0].clone().requires_grad_())}
    run[transform]()
    only, tracked, batched = seen[0]
    assert only == (transform == "vmap")
    assert tracked
    assert batched == transform.startswith("vmap")


def test_vmap_over_jvp_through_the_adaptive_solve():
    """`vmap` of `jvp` through the adaptive solve (the loop's `jvp` rule,
    each member's tangent carried beside its primal for its primal's
    count) equals each member's own `jvp` through the unbatched loop within
    1e-12 relative, primal and tangent; `jvp` of `vmap` gives the same
    (`tests/test_torch_ensemble_banded.py` holds both against JAX)."""
    force = _force_fn(n_steps=1, fixed=None)
    lift = lambda x: force(x)[1]
    xis = torch.tensor(XIS[:2], dtype=f64)
    p, d = torch.func.vmap(lambda x: torch.func.jvp(
        lift, (x,), (torch.ones_like(x),)))(xis)
    own = [torch.func.jvp(lift, (x,), (torch.ones_like(x),)) for x in xis]
    assert bool(torch.isfinite(d).all())
    assert_rel(p, torch.stack([o[0] for o in own]), 1e-12)
    assert_rel(d, torch.stack([o[1] for o in own]), 1e-12)
    p2, d2 = torch.func.jvp(torch.func.vmap(lift), (xis,),
                            (torch.ones_like(xis),))
    assert torch.equal(p2, p) and torch.equal(d2, d)


# --- the entry points' device -----------------------------------------------

@pytest.mark.parametrize("fn", [measure_fields, measure_sdf, tm.nds,
                                measure_fields_banded, band_box_shape])
def test_entry_points_default_to_the_card(fn, monkeypatch):
    """`measure_fields`, `measure_sdf`, `metrics.nds`,
    `measure_fields_banded` and `band_box_shape` run on the card unless
    asked for another device, as `FlowConfig` and the cases do; asked for
    ``meta`` (standing in for the card) every output lies there, `nds`
    and the banded measurement under `vmap` too (the whole-grid
    measurement; the window corner of each member, which a single run
    reads to the host, stays on the device).  `band_box_shape` returns
    host ints: its one full-grid pass runs on the device asked for."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum(x * x)) - 3.0)
    S = (10, 12)
    if fn is band_box_shape:
        import waterlily_tpu_torch.body as tb
        seen, real = [], tb._d_center
        monkeypatch.setattr(tb, "_d_center", lambda b, S, t, dt, dev: (
            seen.append((torch.device(dev), t.device.type))
            or real(b, S, torch.zeros((), dtype=dt), dt, "cpu")))
        assert fn(body, S, device="meta") == fn(body, S, device="cpu")
        assert seen[0] == (torch.device("meta"), "meta")
        return
    if fn in (tm.nds, measure_fields_banded):
        rads = torch.ones(2, device="meta")
        sphere = lambda c: AutoBody(
            lambda x, t: torch.sqrt(torch.sum(x * x)) - 3.0 * c)
        call = ((lambda c: fn(sphere(c), S, device="meta")) if fn is tm.nds
                else (lambda c: fn(sphere(c), S, 0.0, 1.0, (), False,
                                   torch.float32, (6, 6), device="meta")))
        out = torch.func.vmap(call)(rads)
        if fn is tm.nds:
            assert out.shape == (2, 2) + S
        else:
            assert out[-1].shape == (2, 2) and out[-1].dtype == torch.int64
    else:
        out = fn(body, S, 0.0, device="meta")
    for o in (out if isinstance(out, tuple) else (out,)):
        assert o.device.type == "meta"


@pytest.mark.parametrize("perdir", [(), (1,)])
def test_batched_solve_against_jax(perdir):
    """JAX's batched level stack (`jax.vmap` of `build_levels` over three
    bodies' μ₀) carried across with its member axis
    (`convert.levels_from_numpy`, ``perdir`` passed on) and solved under
    `torch.func.vmap`: each member's count equals JAX's batched
    `while_loop`'s and the solution JAX's within 1e-10."""
    from waterlily_tpu.ops.multigrid import ml_solve as jsolve
    from waterlily_tpu_torch.convert import levels_from_numpy
    m0 = np.stack([npy(_mu0(r)) for r in RADII])
    if perdir:
        m0[:, 1, :, 0] = m0[:, 1, :, -2]     # a periodic axis-1 ghost
        m0[:, 1, :, -1] = m0[:, 1, :, 1]
    z = np.random.default_rng(1).standard_normal((len(RADII),) + S_LOOP)
    z[:, 0], z[:, -1], z[:, :, 0], z[:, :, -1] = 0, 0, 0, 0
    z *= 0.1
    jl = jax.vmap(lambda m: jbuild(m, perdir))(jnp.asarray(m0))
    jx, _jr, jn = jax.vmap(lambda lv, zz: jsolve(
        lv, jnp.zeros_like(zz), zz, tol=1e-3, itmx=8))(jl, jnp.asarray(z))
    levels = levels_from_numpy(
        [{k: np.asarray(getattr(lv, k)) for k in ("L", "D", "iD")}
         for lv in jl], "cpu", perdir)
    spec, ops = tp.level_tensors(levels)
    x, _r, n = torch.func.vmap(lambda zz, *ops: ml_solve(
        tp.with_level_tensors(spec, ops), torch.zeros_like(zz), zz,
        tol=1e-3, itmx=8))(torch.from_numpy(z), *ops)
    assert n.tolist() == np.asarray(jn).tolist()
    assert_rel(x, jx, 1e-10)
