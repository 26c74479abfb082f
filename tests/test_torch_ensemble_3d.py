"""Port parity: the 3D ensemble under `torch.func.vmap` and the member forms
of the seven 3D stencils (`mult3d`, `increment3d`, `cfl3d`, `bc3d`,
`div3d`, `project3d`, `conv_diff3d`).

(a) Each member form on the CPU (its wrapper under `torch.func.vmap`,
which enters the member form's `autograd.Function`: `vmap` of the plain
version) against `jax.vmap` of the JAX Pallas kernel in interpret mode,
three members of a ragged shape, the operator (and dt, ν, the BC values)
shared and one a member: bit for bit for BC, div and CFL; mult,
increment's residual, project's velocity and conv within 1e-6 relative
(f32 rounding: the single-member tests hold the same kernels to the same
tolerances, since XLA contracts an FMA inside the interpret-mode kernel
and the conv kernel sums its sweeps in another order); the mult dot 1e-5.
In f64 each member form against `jax.vmap` of JAX's XLA form, as the
single-member tests hold them (bitwise for BC, div, CFL, the increment's
x and project's p; 1e-12 elsewhere).
(b) The (26,18,18) sphere's pipeline (`measure_fields` → `build_levels`
→ `flow_init` → 2 `mom_step`s → `total_force`), f64, under `vmap` over
the radius and over ν with the stencil gates open on this CPU (so every
member form is on the path), against JAX's `jit(vmap(...))` of the same
function: forces within 1e-10 relative, `pois_n` equal per member.
(c) The port's `vmap` pipeline equal to its per-member runs bit for bit.
(d) The gates: a field under `vmap` alone reaches each member form once
a call (`stencil_kernels.member_form`), nested `vmap` folds into one
call, a field under `grad` or `jvp` takes the plain form; `bc3d`'s fill
in place is seen by the batched caller.
"""
import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import flow as jf
from waterlily_tpu.body import AutoBody as JBody, measure_fields as jmeasure
from waterlily_tpu.flow import FlowConfig as JConfig
from waterlily_tpu.metrics import total_force as jforce
from waterlily_tpu.ops import bc as jbc
from waterlily_tpu.ops import convect as jc
from waterlily_tpu.ops import pallas_stencil as ps
from waterlily_tpu.ops import poisson as jp
from waterlily_tpu.ops.multigrid import build_levels as jbuild
from waterlily_tpu_torch import flow as tf
from waterlily_tpu_torch.body import AutoBody, measure_fields
from waterlily_tpu_torch.convert import levels_from_numpy
from waterlily_tpu_torch.metrics import total_force
from waterlily_tpu_torch.ops import convect as tc
from waterlily_tpu_torch.ops import poisson as tp
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.ops.multigrid import build_levels

from _torch_parity import (F32, F64, normal, tt, jj, npy, assert_exact,
                           assert_rel, bc_coeffs, interior_only)

M = 3
RAGGED = (13, 9, 11)
SEVEN = ("mult3d", "increment3d", "cfl3d", "bc3d", "div3d", "project3d",
         "conv_diff3d")
# the member forms a blocked level's smooth reaches (`attic.pcg_blocked`,
# the default smoother of blocked non-periodic levels)
SMOOTH = ("pcg_dir_mult", "pcg_update")


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread (the sums' order, and so the bits, of a plain form
    can depend on the thread count), the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def member_calls(monkeypatch):
    """Spy on `stencil_kernels.member_form`: the member count of each of
    its calls, by wrapper."""
    calls = collections.defaultdict(list)
    real = sk.member_form

    def spy(name, *args):
        ranks, main = sk._MEMBERS[name][:2]
        calls[name].append(args[main].shape[0])
        return real(name, *args)
    monkeypatch.setattr(sk, "member_form", spy)
    return calls


def _stack(make, shared):
    """``M`` members' numpy arrays ``make(m)`` stacked, or member 0's alone
    where ``shared``."""
    return make(0) if shared else np.stack([make(m) for m in range(M)])


def _levels(S, shared, dtype=F32):
    """(L, D) numpy arrays of ``M`` members' levels (JAX's `make_level`
    of seeded face coefficients), or member 0's where ``shared``."""
    def lev(m):
        lj = jp.make_level(jj(bc_coeffs(40 + m, S, dtype)), bf16_eps=False)
        return np.asarray(lj.L), np.asarray(lj.D)
    return (_stack(lambda m: lev(m)[0], shared),
            _stack(lambda m: lev(m)[1], shared))


def _fields(seed, shape, dtype=F32, interior=False):
    make = lambda m: normal(seed + m, shape, dtype)
    return np.stack([interior_only(make(m)) if interior else make(m)
                     for m in range(M)])


def _dims(shared, n_op, n_fields):
    """in_dims / in_axes: ``n_op`` operator arguments (None where shared)
    then ``n_fields`` member fields."""
    return (None if shared else 0,) * n_op + (0,) * n_fields


def _port(fn, dims, *args):
    return torch.func.vmap(fn, in_dims=dims)(*map(tt, args))


def _jax(fn, dims, *args):
    return jax.vmap(fn, in_axes=dims)(*map(jj, args))


# --- (a) the member forms against JAX's batched kernels ---------------------

@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("with_dot", [False, True])
def test_mult3d_members_vs_pallas(member_calls, shared, with_dot):
    L, Dd = _levels(RAGGED, shared)
    x = _fields(1, RAGGED)
    dims = _dims(shared, 2, 1)
    got = _port(lambda L, Dd, x: sk.mult3d(L, Dd, x, with_dot), dims, L, Dd,
                x)
    ref = _jax(lambda L, Dd, x: ps.mult3d_pallas(
        L, Dd, x, RAGGED, interpret=True, with_dot=with_dot, block=2),
        dims, L, Dd, x)
    assert member_calls["mult3d"] == [M]
    if with_dot:
        assert_rel(got[0], ref[0], 1e-6)
        for m in range(M):
            assert_rel(got[1][m], ref[1][m], 1e-5)
    else:
        assert_rel(got, ref, 1e-6)


@pytest.mark.parametrize("shared", [True, False])
def test_increment3d_members_vs_pallas(member_calls, shared):
    L, Dd = _levels(RAGGED, shared)
    eps = _fields(2, RAGGED, interior=True) * np.float32(0.1)
    x, r = _fields(3, RAGGED), _fields(4, RAGGED, interior=True)
    dims = _dims(shared, 2, 3)
    xt, rt = _port(sk.increment3d, dims, L, Dd, eps, x, r)
    xj, rj = _jax(lambda L, Dd, e, x, r: ps.increment3d_pallas(
        L, Dd, e, x, r, RAGGED, interpret=True, block=2), dims, L, Dd, eps,
        x, r)
    assert member_calls["increment3d"] == [M]
    assert_exact(xt, xj)
    assert_rel(rt, rj, 1e-6)


@pytest.mark.parametrize("S", [RAGGED, (3, 37, 70), (21, 10, 99)])
def test_cfl3d_members_vs_pallas(member_calls, S):
    u = _fields(5, (3,) + S)
    u[1, 0, S[0] // 2, 1, 1] = np.nan      # member 1's max is NaN
    got = _port(sk.cfl3d, (0,), u)
    ref = _jax(lambda u: ps.cfl3d_pallas(u, S, interpret=True, block=4),
               (0,), u)
    assert member_calls["cfl3d"] == [M]
    assert got.shape == (M,) and bool(torch.isnan(got[1]))
    assert np.array_equal(npy(got), npy(ref), equal_nan=True)


@pytest.mark.parametrize("form", [((), False), ((), True), ((1,), False),
                                  ((0, 2), False)])
@pytest.mark.parametrize("shared", [True, False])
def test_bc3d_members_vs_pallas(member_calls, form, shared):
    """In place through the member form (the batched field itself filled),
    bit for bit `jax.vmap` of the Pallas kernel; the BC values numbers
    every member shares, or one (3,) vector a member."""
    perdir, save_exit = form
    u = _fields(6, (3,) + RAGGED)
    A = np.array([[1.0 + 0.1 * m, 0.5 - 0.2 * m, -0.25 * m]
                  for m in range(M)], F32)
    if shared:
        A0 = (1.0, 0.5, -0.25)
        fill = lambda u: sk.bc3d(u, A0, save_exit, perdir, inplace=True)
        ut = tt(u)
        got = torch.func.vmap(fill)(ut)
        ref = jax.vmap(lambda u: ps.bc3d_pallas(
            u, A0, save_exit, perdir, interpret=True))(jj(u))
    else:
        fill = lambda u, a: sk.bc3d(u, tuple(a), save_exit, perdir,
                                    inplace=True)
        ut = tt(u)
        got = torch.func.vmap(fill)(ut, tt(A))
        ref = jax.vmap(lambda u, a: ps.bc3d_pallas(
            u, (a[0], a[1], a[2]), save_exit, perdir,
            interpret=True))(jj(u), jj(A))
    assert member_calls["bc3d"] == [M]
    assert_exact(got, ref)
    assert_exact(ut, ref)          # the batched field itself, in place


@pytest.mark.parametrize("shared", [True, False])
def test_div3d_members_vs_pallas(member_calls, shared):
    u, p = _fields(7, (3,) + RAGGED), _fields(8, RAGGED)
    dt = (np.float32(0.42) if shared
          else np.array([0.42, 0.37, 0.5], F32))
    dims = (0, 0, None if shared else 0)
    z, x = _port(sk.div3d, dims, u, p, dt)
    zj, xj = _jax(lambda u, p, dt: ps.div3d_pallas(u, p, dt, interpret=True,
                                                  block=2), dims, u, p, dt)
    assert member_calls["div3d"] == [M]
    assert_exact(z, zj)
    assert_exact(x, xj)


@pytest.mark.parametrize("shared", [True, False])
def test_project3d_members_vs_pallas(member_calls, shared):
    L = _stack(lambda m: bc_coeffs(9 + m, RAGGED), shared)
    x, u = _fields(10, RAGGED), _fields(11, (3,) + RAGGED)
    dt = (np.float32(0.37) if shared
          else np.array([0.37, 0.3, 0.45], F32))
    dims = (None if shared else 0, 0, 0, None if shared else 0)
    ut, pt = _port(sk.project3d, dims, L, x, u, dt)
    uj, pj = _jax(lambda L, x, u, dt: ps.project3d_pallas(
        L, x, u, dt, interpret=True, block=1), dims, L, x, u, dt)
    assert member_calls["project3d"] == [M]
    assert_rel(ut, uj, 1e-6)   # the Pallas kernel may contract an FMA
    assert_exact(pt, pj)


@pytest.mark.parametrize("limiter", ["quick", "vanleer"])
@pytest.mark.parametrize("shared", [True, False])
def test_conv_diff3d_members_vs_pallas(member_calls, limiter, shared):
    """ν shared (a number), or one a member: the Pallas kernel closes over
    ν, so `jax.vmap` batches it over u alone and a member's own ν is held
    against that member's own Pallas call."""
    jl, tl = {"quick": (jc.quick, tc.quick),
              "vanleer": (jc.vanleer, tc.vanleer)}[limiter]
    u = _fields(12, (3,) + RAGGED)
    nus = [0.05, 0.02, 0.08]
    if shared:
        got = _port(lambda u: sk.conv_diff3d(u, 0.05, tl), (0,), u)
        ref = jax.vmap(lambda u: ps.conv_diff3d_pallas(
            u, 0.05, jl, RAGGED, interpret=True))(jj(u))
    else:
        got = _port(lambda u, nu: sk.conv_diff3d(u, nu, tl), (0, 0), u,
                    np.array(nus, F32))
        ref = np.stack([np.asarray(ps.conv_diff3d_pallas(
            jj(u[m]), np.float32(nus[m]), jl, RAGGED, interpret=True))
            for m in range(M)])
    assert member_calls["conv_diff3d"] == [M]
    assert_rel(got, ref, 1e-6)


class _gates_open:
    """The stencil gates open on this CPU for 3D fields of at least 1000
    cells (`stencil_kernels.use_blocked`), as on the card, restored
    after."""

    def __enter__(self):
        self.gate = sk.use_blocked
        sk.use_blocked = lambda S, dtype, device: (len(S) == 3
                                                   and math.prod(S) >= 1000)

    def __exit__(self, *exc):
        sk.use_blocked = self.gate


# the f64 forms, against jax.vmap of JAX's XLA forms (as the one-member
# f64 tests: bitwise for BC, div, CFL, x + eps and x / dt; 1e-12 else)
S64 = (14, 12, 10)


def test_members_f64_vs_jax(member_calls):
    L, Dd = _levels(S64, False, F64)
    lev = lambda L, Dd: jp.PoissonLevel(L=L, D=Dd, iD=Dd)
    x, u = _fields(20, S64, F64), _fields(21, (3,) + S64, F64)
    eps = _fields(22, S64, F64, interior=True) * 0.1
    r, p = _fields(23, S64, F64, interior=True), _fields(24, S64, F64)
    dt = np.array([0.42, 0.37, 0.5])
    A = (1.0, 0.5, -0.25)
    z = _port(sk.mult3d, (0, 0, 0), L, Dd, x)
    assert_rel(z, _jax(lambda L, Dd, x: jp.mult(lev(L, Dd), x), (0, 0, 0),
                       L, Dd, x), 1e-12)
    xt, rt = _port(sk.increment3d, (0,) * 5, L, Dd, eps, x, r)
    xj, rj = _jax(lambda L, Dd, e, x, r: jp.increment(lev(L, Dd), x, r, e),
                  (0,) * 5, L, Dd, eps, x, r)
    assert_exact(xt, xj)
    assert_rel(rt, rj, 1e-12)
    # the gate's member form of cfl3d, through `flow.cfl` as the step
    # calls it (JAX's `cfl`, its XLA form)
    with _gates_open():
        assert_exact(_port(lambda u: tf.cfl(u, 0.04), (0,), u),
                     _jax(lambda u: jf.cfl(u, 0.04), (0,), u))
    ut = tt(u)
    got = torch.func.vmap(lambda u: sk.bc3d(u, A, inplace=True))(ut)
    ref = jax.vmap(lambda u: jbc.bc_vector(u, A))(jj(u))
    assert_exact(got, ref)
    assert_exact(ut, ref)
    zt, xt = _port(sk.div3d, (0, 0, 0), u, p, dt)
    assert_exact(zt, jax.vmap(jf.div)(jj(u)))
    assert_exact(xt, jj(p) * jj(dt)[:, None, None, None])
    Lc = np.stack([bc_coeffs(30 + m, S64, F64) for m in range(M)])
    ut, pt = _port(sk.project3d, (0,) * 4, Lc, x, u, dt)
    from waterlily_tpu.grid import pad_interior as jpad
    uj = jax.vmap(lambda L, x, u: u - jpad(jp.pressure_grad_interior(
        jp.make_level(L, bf16_eps=False), x), lead=1))(jj(Lc), jj(x), jj(u))
    assert_exact(ut, uj)
    assert_exact(pt, jj(x) / jj(dt)[:, None, None, None])
    nus = np.array([0.05, 0.02, 0.08])
    got = _port(lambda u, nu: sk.conv_diff3d(u, nu, tc.quick), (0, 0), u,
                nus)
    ref = _jax(lambda u, nu: jc.conv_diff(u, nu, (), jc.quick), (0, 0), u,
               nus)
    assert_rel(got, ref, 1e-12)
    for name in SEVEN:
        assert member_calls[name], name


# --- (b), (c): the 3D sphere's pipeline under vmap --------------------------

S_PIPE = (26, 18, 18)
CENTRE = 8.0
SWEEPS = {"radius": [3.0, 3.5, 4.0], "nu": [0.05, 0.1, 0.2]}


def _params(kind):
    """(radius, ν) of a member of sweep ``kind`` with parameter ``v``."""
    return lambda v: (v, 0.1) if kind == "radius" else (3.5, v)


def _port_sphere(kind, steps=2, fixed=None):
    """The port's drag force after ``steps`` steps and each step's
    pois_n, ``(steps, 2)``, as a pure function of the sweep's parameter
    (f64, the CPU)."""
    f64 = torch.float64

    def force(v):
        radius, nu = _params(kind)(v)
        body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - CENTRE) ** 2))
                        - radius)
        cfg = tf.FlowConfig(D=3, S=S_PIPE, device="cpu", nu=nu,
                            U=(1.0, 0.0, 0.0), dtype=f64, fixed_iters=fixed)
        V, m0, m1, _ = measure_fields(body, S_PIPE, 0.0, 1.0, (), False, f64,
                                      "cpu")
        levels = build_levels(m0)
        state = tf.flow_init(cfg).replace(V=V, mu0=m0, mu1=m1)
        pois = []
        for _ in range(steps):
            state, aux = tf.mom_step(cfg, levels, state)
            pois.append(torch.as_tensor(aux["pois_n"]))
        return (total_force(state.u, state.p, cfg.nu, body, state.t),
                torch.stack(pois))
    return force


def _jax_sphere(kind, steps=2):
    """The same function built from `waterlily_tpu`'s `measure_fields`,
    `build_levels`, `flow_init`, `mom_step` and `total_force`."""
    f64 = jnp.float64

    def force(v):
        radius, nu = _params(kind)(v)
        body = JBody(lambda x, t: jnp.sqrt(jnp.sum((x - CENTRE) ** 2))
                     - radius)
        cfg = JConfig(D=3, S=S_PIPE, nu=nu, U=(1.0, 0.0, 0.0), dtype=f64)
        V, m0, m1, _ = jmeasure(body, S_PIPE, 0.0, 1.0, (), False, f64)
        levels = jbuild(m0)
        state = jf.flow_init(cfg)._replace(V=V, mu0=m0, mu1=m1)
        pois = []
        for _ in range(steps):
            state, aux = jf.mom_step(cfg, levels, state)
            pois.append(aux["pois_n"])
        return jforce(state.u, state.p, cfg.nu, body, state.t), jnp.stack(pois)
    return force


@pytest.mark.parametrize("kind", ["radius", "nu"])
def test_sphere_sweep_against_jax(member_calls, kind):
    """(b) The sweep under `torch.func.vmap` with the member forms on the
    path (every one of the seven called, and the two sweeps of the blocked
    levels' smoother, each call on all three members)
    against JAX's `jit(vmap(...))`: forces within 1e-10 relative, each
    member's pois_n equal."""
    vs = SWEEPS[kind]
    with _gates_open():
        forces, pois = torch.func.vmap(_port_sphere(kind))(
            torch.tensor(vs, dtype=torch.float64))
    jforces, jpois = jax.jit(jax.vmap(_jax_sphere(kind)))(
        jnp.asarray(vs, jnp.float64))
    assert sorted(member_calls) == sorted(SEVEN + SMOOTH)
    assert all(n == M for c in member_calls.values() for n in c)
    assert pois.tolist() == np.asarray(jpois).tolist()
    assert_rel(forces, jforces, 1e-10)


@pytest.mark.parametrize("fixed", [None, 2])
@pytest.mark.parametrize("kind", ["radius", "nu"])
def test_sphere_sweep_equals_its_members(kind, fixed):
    """(c) Each member of the batched sweep (member forms on the path)
    equals its own run (the one-field forms) bit for bit, forces and
    pois_n."""
    vs = torch.tensor(SWEEPS[kind], dtype=torch.float64)
    force = _port_sphere(kind, fixed=fixed)
    with _gates_open():
        forces, pois = torch.func.vmap(force)(vs)
        for m in range(M):
            own_f, own_p = force(vs[m])
            assert torch.equal(forces[m], own_f), (kind, m)
            assert torch.equal(pois[m], own_p), (kind, m)


# --- (d) the gates ----------------------------------------------------------

def test_gates_route_transforms(member_calls):
    """With the gates open, a step under `vmap` alone reaches each of the
    seven member forms (and the smoother's two sweeps), `vmap` of `vmap` (2 × 2 radii) folds every call
    into one on all four members, and under `vmap(grad)`, `vmap(jvp)` and
    `grad` (``fixed_iters=2``) no member form is called: tracked fields
    take the plain forms."""
    force = _port_sphere("radius", steps=1, fixed=2)
    radii = torch.tensor([[3.0, 3.5], [4.0, 3.2]], dtype=torch.float64)
    with _gates_open():
        torch.func.vmap(force)(radii[0])
        assert sorted(member_calls) == sorted(SEVEN + SMOOTH)
        member_calls.clear()
        nested = torch.func.vmap(torch.func.vmap(force))(radii)[0]
        assert sorted(member_calls) == sorted(SEVEN + SMOOTH)
        assert all(n == 4 for c in member_calls.values() for n in c)
        for i in range(2):
            for j in range(2):
                assert torch.equal(nested[i, j], force(radii[i, j])[0])
        drag = lambda r: force(r)[0][0]
        for run in (lambda: torch.func.vmap(torch.func.grad(drag))(radii[0]),
                    lambda: torch.func.vmap(lambda r: torch.func.jvp(
                        drag, (r,), (torch.ones_like(r),))[1])(radii[0]),
                    lambda: torch.func.grad(drag)(radii[0, 0])):
            member_calls.clear()
            out = run()
            assert not member_calls, dict(member_calls)
            assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("name", SEVEN)
def test_member_checks_on_the_cpu(member_calls, name, shared):
    """`kernels.check.compare_stencil_members`, the card's check of every
    member form, run here (the member form is `vmap` of the plain
    version): every form equal to `vmap` of the plain version and to each
    member's own call, the member form reached once a form."""
    from waterlily_tpu_torch.kernels.check import (compare_stencil_members,
                                                   stencil_member_variants,
                                                   stencil_member_inputs)
    rows = compare_stencil_members(name, RAGGED, M, shared, 1, "cpu")
    assert rows and all(r["ok"] and r["single_err"] == 0 for r in rows)
    forms = stencil_member_variants(name, stencil_member_inputs(
        RAGGED, M, shared, 1, "cpu"))
    assert member_calls[name] == [M] * len(forms)


@pytest.mark.parametrize("name", SEVEN)
def test_nested_vmap_folds_into_one_call(member_calls, name):
    """`vmap` of `vmap` (2 × 3 members, an operator a member) through each
    wrapper: one member-form call on all six members, each member equal
    to its own call bit for bit (`bc3d` filled in place in the batched
    field)."""
    from waterlily_tpu_torch.kernels.check import (
        stencil_member_inputs, stencil_member_variants, member_args)
    d = stencil_member_inputs(RAGGED, 6, False, 1, "cpu")
    _outputs, fn, _plain, args, dims = stencil_member_variants(name, d)[0]
    grid = lambda a, dd: (a.reshape((2, 3) + tuple(a.shape[1:]))
                          if dd == 0 else a)
    nested = [grid(a, dd) for a, dd in zip(member_args(args), dims)]
    out = torch.func.vmap(torch.func.vmap(fn, in_dims=dims),
                          in_dims=dims)(*nested)
    assert member_calls[name] == [6]
    out = out if isinstance(out, tuple) else (out,)
    own_args = member_args(args)
    for m in range(6):
        own = fn(*[a[m] if dd == 0 else a for a, dd in zip(own_args, dims)])
        own = own if isinstance(own, tuple) else (own,)
        for got, want in zip(out, own):
            assert torch.equal(got[m // 3, m % 3], want), (name, m)
        if name == "bc3d":
            assert torch.equal(nested[0][m // 3, m % 3], own[0])


def test_bc3d_fills_an_unbatched_field_in_a_copy(member_calls):
    """Batched BC values and a field that `vmap` does not batch: the member
    form fills a copy a member (a batched value cannot go into the shared
    field), and the field is left as it was."""
    u = tt(normal(50, (3,) + RAGGED))
    keep = u.clone()
    A = torch.tensor([[1.0, 0.0, 0.0], [2.0, 0.5, 0.0], [3.0, 0.0, 1.0]])
    got = torch.func.vmap(lambda a: sk.bc3d(u, tuple(a), inplace=True))(A)
    assert member_calls["bc3d"] == [M]
    assert torch.equal(u, keep)
    for m in range(M):
        assert torch.equal(got[m], sk.bc3d(u.clone(), tuple(A[m])))


def test_march_members_fit_the_grid(monkeypatch):
    """A march's member form launches once for all members: its buffer
    holds each member's result and partials, and a member count whose
    chunks would pass the grid's 65535 rows is refused before any launch."""
    monkeypatch.setattr(sk, "_march_tile", lambda: (8, 32))
    S = (98, 66, 66)
    planes, buf = sk._march("cfl3d", S, "cpu", 1, members=8)
    chunks = -(-(S[0] - 2) // planes)
    assert buf.shape == (8 * (1 + sk.march_blocks(S, planes, (8, 32))),)
    with pytest.raises(ValueError, match="65535"):
        sk._march("cfl3d", S, "cpu", 1, members=65535 // chunks + 1)


def test_levels_from_numpy_members_solve_against_jax(member_calls):
    """JAX's batched level stack (`jax.vmap` of `build_levels`, three
    bodies' μ₀ at (18,10,10)) carried across with ``members=True``: each
    level's flags are one member's (the fine level blocked with the gates
    open), its tensors keep the member axis, and `ml_solve` under
    `torch.func.vmap` runs the member forms of `mult3d` and
    `increment3d`, each member's count equal to JAX's and its solution
    within 1e-10."""
    from waterlily_tpu.ops.multigrid import ml_solve as jsolve
    from waterlily_tpu_torch.ops.multigrid import ml_solve
    S = (18, 10, 10)
    f64 = torch.float64

    def mu0(r):
        body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - 6.0) ** 2))
                        - r)
        return measure_fields(body, S, 0.0, 1.0, (), False, f64, "cpu")[1]
    m0 = np.stack([npy(mu0(r)) for r in (2.5, 3.0, 3.5)])
    z = interior_only(normal(3, (M,) + S, F64) * 0.1)
    z = np.stack([interior_only(zm) for zm in z])
    jl = jax.vmap(jbuild)(jnp.asarray(m0))
    jx, _jr, jn = jax.vmap(lambda lv, zz: jsolve(
        lv, jnp.zeros_like(zz), zz, tol=1e-6, itmx=16))(jl, jnp.asarray(z))
    with _gates_open():
        levels = levels_from_numpy(
            [{k: np.asarray(getattr(lv, k)) for k in ("L", "D", "iD")}
             for lv in jl], "cpu", members=True)
        assert levels[0].blocked and levels[0].L.shape == (M, 3) + S
        spec, ops = tp.level_tensors(levels)
        x, _r, n = torch.func.vmap(lambda zz, *ops: ml_solve(
            tp.with_level_tensors(spec, ops), torch.zeros_like(zz), zz,
            tol=1e-6, itmx=16))(tt(z), *ops)
    assert member_calls["mult3d"] and member_calls["increment3d"]
    assert n.tolist() == np.asarray(jn).tolist()
    assert_rel(x, jx, 1e-10)
