"""Port parity: the member forms of the blocked-level PCG seams' kernels
(`ops.attic`: `pcg_dir_mult`, `pcg_update`, `dot3d`, `pcg_axpy`,
`mult3d_stream`, `increment3d_stream`) and the seams (``KDOT``, ``KAXPY``,
``STREAM``) and the default smoother `pcg_blocked` under
`torch.func.vmap`.

(a) Each wrapper under `torch.func.vmap` (its member form: `vmap` of the
plain version on the CPU), three members, the operator and the scalars
(β, upd) shared and one a member, against `jax.vmap` of the JAX Pallas
kernel in interpret mode, at `tests/test_torch_attic.py`'s tolerances:
elementwise outputs within 1e-6 absolute (f32 rounding: XLA may contract
an FMA inside the interpret-mode kernel), a bf16 direction within one
bf16 ulp, the carried-rows operator within the stencils' 1e-6 relative,
every dot within 1e-5 relative.
(b) `attic.pcg_blocked` under `vmap` against `jax.vmap` of JAX's, member
1's residual zero (its own dead mask): x and r within 2e-5 absolute (the
tolerance of the one-field test), each member bit for bit its own port
smooth.
(c) `pcg` on a blocked level with ``KDOT``, ``KAXPY`` and both, under
`vmap`, against `jax.vmap` of JAX's `pcg` with the same flags (its Pallas
kernels in interpret mode): x and r within 2e-5 absolute.
(d) A small 3D sphere sweep (f64, the stencil gates open on this CPU, so
the fine levels are blocked) under (b) ``KDOT = KAXPY = True`` (the pipe
periodic across the stream, so that its levels smooth with `pcg`, in which
the two seams act), (c) the default path (`pcg_blocked` smooths the blocked levels; once the
``PCG_BLOCKED`` seam) and (g) ``STREAM``: the `vmap` pipeline equal to its
per-member runs bit for bit, the seam wrappers reached in their member
forms, and each member's pois_n within the ±2 a solve / ≤ 4 in all rule of
JAX's `jit(vmap)` step (whose CPU levels are not blocked).
(e) The gates: a field under `vmap` alone reaches each member form once a
call (`stencil_kernels.member_form`: on the card, one launch counted in
the wrapper's ``.members``), nested `vmap` folds into one call, and a
field under `grad` takes the plain forms; `kernels.check`'s member checks
(the card's phase 3) pass here.
"""
import collections
import dataclasses
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
from waterlily_tpu.ops import attic as ja
from waterlily_tpu.ops import pallas_stencil as ps
from waterlily_tpu.ops import poisson as jp
from waterlily_tpu.ops.multigrid import build_levels as jbuild
from waterlily_tpu_torch import flow as tf
from waterlily_tpu_torch.body import AutoBody, measure_fields
from waterlily_tpu_torch.metrics import total_force
from waterlily_tpu_torch.ops import attic as ta
from waterlily_tpu_torch.ops import poisson as tp
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.ops.multigrid import build_levels

from _torch_parity import (F32, normal, interior_only, tt, jj, npy,
                           assert_rel, bc_coeffs)

M = 3
S = (12, 9, 10)       # 12 rows: JAX's carried-rows kernels run at block 2
BETAS = np.array([0.37, 0.21, 0.55], F32)
SEAMS = ("dot3d", "pcg_axpy", "pcg_dir_mult", "pcg_update", "mult3d_stream",
         "increment3d_stream")


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
        main = sk._MEMBERS[name][1]
        calls[name].append(args[main].shape[0])
        return real(name, *args)
    monkeypatch.setattr(sk, "member_form", spy)
    return calls


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(a, ref, atol):
    a, ref = _f32(a), _f32(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    err = float(np.max(np.abs(a - ref)))
    assert err <= atol, f"max err {err} > {atol}"


def _sums_close(a, ref, rtol=1e-5):
    a, ref = _f32(a), _f32(ref)
    assert a.shape == ref.shape == (M,), (a.shape, ref.shape)
    assert np.all(np.abs(a - ref) <= rtol * np.abs(ref)), (a, ref)


def _within_bf16_ulp(a, ref):
    a, ref = _f32(a), _f32(ref)
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(a - ref) <= ulp), float(np.max(np.abs(a - ref)))


def _stack(make, shared):
    return make(0) if shared else np.stack([make(m) for m in range(M)])


def _level(shared, shape=S):
    """(L, D, iD) numpy arrays of ``M`` members' levels (JAX's
    `make_level` of seeded face coefficients), member 0's where
    ``shared``."""
    def lev(m):
        lj = jp.make_level(jj(bc_coeffs(40 + m, shape)), bf16_eps=False)
        return tuple(np.asarray(a) for a in (lj.L, lj.D, lj.iD))
    return tuple(_stack(lambda m, i=i: lev(m)[i], shared) for i in range(3))


def _fields(seed, shape=S, interior=True, scale=1.0):
    make = lambda m: normal(seed + m, shape, scale=scale)
    return np.stack([interior_only(make(m)) if interior else make(m)
                     for m in range(M)])


def _dims(shared, n_op, n_fields, n_scalar=0):
    """in_dims / in_axes: ``n_op`` operator arguments (None where shared),
    ``n_fields`` member fields, ``n_scalar`` scalars (None where
    shared)."""
    od = None if shared else 0
    return (od,) * n_op + (0,) * n_fields + (od,) * n_scalar


def _port(fn, dims, *args):
    return torch.func.vmap(fn, in_dims=dims)(
        *(tt(a) if isinstance(a, np.ndarray) else a for a in args))


def _jax(fn, dims, *args):
    return jax.vmap(fn, in_axes=dims)(*(jj(a) if isinstance(a, np.ndarray)
                                        else a for a in args))


def _words(shared, upd=None, beta=None):
    """The fused iteration's words in flight (`attic.WORDS`), one run a
    member or, ``shared``, member 0's, carrying each member's ``upd`` or
    ``beta`` (`BETAS`)."""
    def run(m):
        w = np.array([0.8, 1.3, 0.0, 0.0, 0.0], F32)
        if upd is not None:
            w[ta.W_UPD] = np.broadcast_to(upd, (M,))[m]
        else:
            w[ta.W_BETA] = np.broadcast_to(beta, (M,))[m]
        return w
    return tt(_stack(run, shared))


# --- (a) the six member forms against JAX's batched Pallas kernels ----------

@pytest.mark.parametrize("form", ["beta", "b0", "beta_bf16"])
@pytest.mark.parametrize("shared", [True, False])
def test_pcg_dir_mult_members_vs_pallas(member_calls, shared, form):
    """The iteration's form (β a member's or shared, read from the words,
    f32 or bf16 directions) and the preamble's (no words: β = 0, eps_prev
    the residual).  The sums are in the port's words: <z, eps> its own
    sum, the rho the preamble's (it depends on r and iD alone)."""
    L, Dd, iD = _level(shared)
    r = _fields(1, scale=0.1)
    bf16 = form == "beta_bf16"
    ep = r if form == "b0" else _fields(2, scale=0.1)
    if form == "b0":
        beta, bd, words = 0.0, None, None
    else:
        beta, bd = ((np.float32(BETAS[0]), None) if shared else (BETAS, 0))
        words = _words(shared, beta=beta)
    dims = _dims(shared, 2, 2) + (None if shared else 0, bd)
    dir_mult = lambda L, Dd, e, r, iD, w: ta.pcg_dir_mult(
        L, Dd, e.to(torch.bfloat16) if bf16 else e, r, iD, w, bf16)
    et, zt, wt = _port(dir_mult, dims, L, Dd, ep, r, iD, words)
    seed = wt if form == "b0" else _port(
        dir_mult, dims[:5] + (None,), L, Dd, r, r, iD, None)[2]
    dt, rt = wt[:, ta.W_SUM], seed[:, ta.W_RHO]
    ej, zj, dj, rj = _jax(
        lambda L, Dd, e, r, iD, b: ja.pcg_dir_mult(
            L, Dd, e.astype(jnp.bfloat16) if bf16 else e, r, iD, b, S,
            bf16=bf16, interpret=True, block=2),
        dims, L, Dd, ep, r, iD, beta)
    assert member_calls["pcg_dir_mult"] == [M] * (1 if form == "b0" else 2)
    assert et.dtype == (torch.bfloat16 if bf16 else torch.float32)
    if bf16:
        _within_bf16_ulp(et, ej)
    else:
        _close(et, ej, 1e-6)
    _close(zt, zj, 1e-6)
    _sums_close(dt, dj)
    _sums_close(rt, rj)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("name", ["pcg_update", "pcg_axpy"])
def test_axpy_rho_members_vs_pallas(member_calls, name, shared, bf16):
    """The fused iteration's second sweep (upd read from its words, its
    rho its own sum in the new words) and the axpy-pair sweep (one kernel,
    two TPU kernels), eps in f32 or bf16, iD and upd shared or one a
    member."""
    _, _, iD = _level(shared)
    x, r = _fields(3, interior=False), _fields(4, scale=0.1)
    eps, z = _fields(5, scale=0.1), _fields(6)
    upd = np.float32(BETAS[1]) if shared else BETAS
    dims = (0, 0, 0, 0) + (None if shared else 0,) * 2
    xt, rt, ht = _port(
        lambda x, r, e, z, iD, u: getattr(ta, name)(
            x, r, e.to(torch.bfloat16) if bf16 else e, z, iD, u),
        dims, x, r, eps, z, iD,
        _words(shared, upd=upd) if name == "pcg_update"
        else tt(np.asarray(upd)))
    if name == "pcg_update":
        ht = ht[:, ta.W_SUM]

    def jax_one(x, r, e, z, iD, u):
        e = e.astype(jnp.bfloat16) if bf16 else e
        if name == "pcg_update":
            return ja.pcg_update(x, r, e, z, iD, u, S, interpret=True,
                                 block=2)
        return ja.pcg_axpy_pallas(x, r, e, z, iD, u, interpret=True,
                                  block=8)
    xj, rj, hj = _jax(jax_one, dims, x, r, eps, z, iD, jnp.asarray(upd))
    assert member_calls[name] == [M]
    _close(xt, xj, 1e-6)
    _close(rt, rj, 1e-6)
    _sums_close(ht, hj)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("mode", ["aa", "ab", "rid"])
def test_dot3d_members_vs_pallas(member_calls, mode, shared):
    """Interior dots: ``aa`` (the default of a field with itself), ``ab``
    on a field with non-zero ghosts against a member field or a shared
    one, ``rid`` against the level's iD, shared or a member's."""
    _, _, iD = _level(shared)
    a = _fields(7, interior=mode != "aa")
    b = {"aa": None, "ab": _stack(lambda m: normal(8 + m, S), shared),
         "rid": iD}[mode]
    if mode == "aa":
        got = _port(lambda a: ta.dot3d(a, a), (0,), a)
        ref = _jax(lambda a: ja.dot3d_pallas(a, a, S, interpret=True,
                                             mode="aa"), (0,), a)
    else:
        dims = (0, None if shared else 0)
        got = _port(lambda a, b: ta.dot3d(a, b, mode), dims, a, b)
        ref = _jax(lambda a, b: ja.dot3d_pallas(a, b, S, interpret=True,
                                                mode=mode), dims, a, b)
    assert member_calls["dot3d"] == [M]
    _sums_close(got, ref)


@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("shared", [True, False])
def test_mult3d_stream_members_vs_pallas(member_calls, shared, with_dot):
    L, Dd, _ = _level(shared)
    x = _fields(9, interior=False)
    dims = _dims(shared, 2, 1)
    got = _port(lambda L, Dd, x: ta.mult3d_stream(L, Dd, x, with_dot), dims,
                L, Dd, x)
    ref = _jax(lambda L, Dd, x: ja.mult3d_stream(
        L, Dd, x, S, interpret=True, block=2, with_dot=with_dot), dims, L,
        Dd, x)
    assert member_calls["mult3d_stream"] == [M]
    if with_dot:
        assert_rel(got[0], ref[0], 1e-6)
        _sums_close(got[1], ref[1])
    else:
        assert_rel(got, ref, 1e-6)


@pytest.mark.parametrize("shared", [True, False])
def test_increment3d_stream_members_vs_pallas(member_calls, shared):
    """(x + eps, r − A·eps): x exactly, r within the stencils' 1e-6
    relative."""
    L, Dd, _ = _level(shared)
    eps = _fields(10, scale=0.1)
    x, r = _fields(11, interior=False), _fields(12)
    dims = _dims(shared, 2, 3)
    xt, rt = _port(ta.increment3d_stream, dims, L, Dd, eps, x, r)
    xj, rj = _jax(lambda L, Dd, e, x, r: ja.increment3d_stream(
        L, Dd, e, x, r, S, interpret=True, block=2), dims, L, Dd, eps, x, r)
    assert member_calls["increment3d_stream"] == [M]
    assert np.array_equal(npy(xt), np.asarray(xj))
    assert_rel(rt, rj, 1e-6)


# --- (b) the fused-iteration smoother under vmap ----------------------------

def _residuals(shared):
    """Each member's consistent residual of its level (zero ghosts,
    mean-corrected), member 1's zero."""
    L = _stack(lambda m: bc_coeffs(40 + m, S), shared)
    rs = []
    for m in range(M):
        lev = tp.make_level(tt(L if shared else L[m]))
        rs.append(npy(tp.residual(lev, torch.zeros(S),
                                  tt(interior_only(normal(20 + m, S))))))
    rs[1] = np.zeros(S, F32)
    return np.stack(rs)


@pytest.mark.parametrize("shared", [True, False])
def test_pcg_blocked_members_vs_jax(member_calls, shared):
    L, Dd, iD = _level(shared)
    r = _residuals(shared)
    x = _fields(21, interior=False)
    dims = _dims(shared, 3, 2)

    def port(L, Dd, iD, x, r):
        return ta.pcg_blocked(tp.PoissonLevel(L=L, D=Dd, iD=iD, blocked=True),
                              x, r)

    def jax_one(L, Dd, iD, x, r):
        return ja.pcg_blocked(jp.PoissonLevel(L=L, D=Dd, iD=iD, blocked=True),
                              x, r, it=6, interpret=True)
    xt, rt = _port(port, dims, L, Dd, iD, x, r)
    xj, rj = _jax(jax_one, dims, L, Dd, iD, x, r)
    # two member-form calls an iteration, 6 of each in a 6-iteration smooth
    assert member_calls["pcg_dir_mult"] == [M] * 6
    assert member_calls["pcg_update"] == [M] * 6
    _close(xt, xj, 2e-5)
    _close(rt, rj, 2e-5)
    # member 1's zero residual: dead from the start, x unchanged
    assert torch.equal(xt[1], tt(x[1])) and not bool(rt[1].any())
    for m in range(M):
        own = port(*(tt(a) if shared and i < 3 else tt(a[m])
                     for i, a in enumerate((L, Dd, iD, x, r))))
        assert torch.equal(xt[m], own[0]) and torch.equal(rt[m], own[1])


# --- (c) pcg under the KDOT / KAXPY seams, under vmap -------------------------

def _interpret(monkeypatch):
    """JAX's blocked levels run their Pallas kernels in interpret mode."""
    for mod, name in ((ps, "mult3d_pallas"), (ps, "increment3d_pallas"),
                      (ja, "dot3d_pallas"), (ja, "pcg_axpy_pallas")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, **k: _o(
            *a, **{**k, "interpret": True}))


@pytest.mark.parametrize("flags", [("KDOT",), ("KAXPY",), ("KDOT", "KAXPY")])
def test_pcg_seams_members_vs_jax(member_calls, flags, monkeypatch):
    """`pcg` on a blocked level, an operator a member, under `vmap` with
    the flags set in both packages: the dots and axpys reach their member
    forms once a call (rho, then rho2 each iteration but the last under
    ``KDOT``; the axpy pair of each iteration but the last under
    ``KAXPY``), x and r within 2e-5 of `jax.vmap` of JAX's `pcg`."""
    _interpret(monkeypatch)
    for f in flags:
        monkeypatch.setattr(jp, f, True)
        monkeypatch.setattr(tp, f, True)
    L, Dd, iD = _level(False)
    r = _residuals(False)
    x = _fields(22, interior=False)
    dims = (0,) * 5
    xt, rt = _port(lambda L, Dd, iD, x, r: tp.pcg(
        tp.PoissonLevel(L=L, D=Dd, iD=iD, blocked=True), x, r), dims,
        L, Dd, iD, x, r)
    xj, rj = _jax(lambda L, Dd, iD, x, r: jp.pcg(
        jp.PoissonLevel(L=L, D=Dd, iD=iD, blocked=True), x, r), dims,
        L, Dd, iD, x, r)
    kaxpy = "KAXPY" in flags
    assert member_calls["dot3d"] == (
        [M] * (1 + (0 if kaxpy else 5)) if "KDOT" in flags else [])
    assert member_calls["pcg_axpy"] == ([M] * 5 if kaxpy else [])
    assert member_calls["mult3d"] == [M] * 6
    _close(xt, xj, 2e-5)
    _close(rt, rj, 2e-5)


# --- (d) a 3D sphere sweep under the seams ----------------------------------

S_PIPE = (26, 18, 18)
CENTRE = 8.0
RADII = [3.0, 3.5, 4.0]
NU = 0.1
STEPS = 2
# phase 6.4's seam configurations and the wrappers each routes the fine
# level through: (c), once the ``PCG_BLOCKED`` seam, is the default path,
# `pcg_blocked` the smoother of every blocked non-periodic level; KDOT and
# KAXPY act in the plain `pcg`, the smoother of periodic levels
CONFIGS = {"b": ({"KDOT": True, "KAXPY": True}, ("dot3d", "pcg_axpy")),
           "c": ({}, ("pcg_dir_mult", "pcg_update")),
           "g": ({"STREAM": True}, ("mult3d_stream", "increment3d_stream"))}
# the sweep's periodic axes under each configuration: (b)'s pipe is
# periodic across the stream (z), so that its levels smooth with `pcg`
SWEEP_PERDIR = {"b": (2,), "c": (), "g": ()}


class _gates_open:
    """The stencil gates open on this CPU for 3D fields of at least 1000
    cells (`stencil_kernels.use_blocked`), as on the card, restored
    after: the fine levels are blocked."""

    def __enter__(self):
        self.gate = sk.use_blocked
        sk.use_blocked = lambda S, dtype, device: (len(S) == 3
                                                   and math.prod(S) >= 1000)

    def __exit__(self, *exc):
        sk.use_blocked = self.gate


def _port_sphere(v, perdir=()):
    """The port's drag force after `STEPS` steps and each step's pois_n,
    ``(STEPS, 2)``, as a pure function of the radius (f64, the CPU), the
    pipe periodic along ``perdir``."""
    f64 = torch.float64
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - CENTRE) ** 2))
                    - v)
    cfg = tf.FlowConfig(D=3, S=S_PIPE, device="cpu", nu=NU,
                        U=(1.0, 0.0, 0.0), dtype=f64, perdir=perdir)
    V, m0, m1, _ = measure_fields(body, S_PIPE, 0.0, 1.0, perdir, False,
                                  f64, "cpu")
    levels = build_levels(m0, perdir)
    state = tf.flow_init(cfg).replace(V=V, mu0=m0, mu1=m1)
    pois = []
    for _ in range(STEPS):
        state, aux = tf.mom_step(cfg, levels, state)
        pois.append(torch.as_tensor(aux["pois_n"]))
    return (total_force(state.u, state.p, cfg.nu, body, state.t),
            torch.stack(pois))


@pytest.fixture(scope="module")
def jax_sweep():
    """JAX's `jit(vmap)` of the same sweep (its default path: its CPU
    levels are not blocked), the pipe periodic along the argument: each
    member's pois_n, ``(M, STEPS, 2)``."""
    f64 = jnp.float64
    done = {}

    def sweep(perdir=()):
        def force(v):
            body = JBody(lambda x, t: jnp.sqrt(jnp.sum((x - CENTRE) ** 2))
                         - v)
            cfg = JConfig(D=3, S=S_PIPE, nu=NU, U=(1.0, 0.0, 0.0),
                          dtype=f64, perdir=perdir)
            V, m0, m1, _ = jmeasure(body, S_PIPE, 0.0, 1.0, perdir, False,
                                    f64)
            levels = jbuild(m0, perdir)
            state = jf.flow_init(cfg)._replace(V=V, mu0=m0, mu1=m1)
            pois = []
            for _ in range(STEPS):
                state, aux = jf.mom_step(cfg, levels, state)
                pois.append(aux["pois_n"])
            return jforce(state.u, state.p, cfg.nu, body, state.t), \
                jnp.stack(pois)
        if perdir not in done:
            _, pois = jax.jit(jax.vmap(force))(jnp.asarray(RADII, f64))
            done[perdir] = np.asarray(pois).tolist()
        return done[perdir]
    return sweep


def _pois_ok(a, b):
    d = [abs(x - y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return all(v <= 2 for v in d) and sum(d) <= 4


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_sphere_sweep_under_seams(member_calls, jax_sweep, config,
                                  monkeypatch):
    """(d) The sweep under the seam with the member forms on the path
    (each seam wrapper called, each call on all three members) equals its
    per-member runs bit for bit (forces and pois_n), and each member's
    pois_n is within the ±2/≤4 rule of JAX's `jit(vmap)` step."""
    flags, seam = CONFIGS[config]
    perdir = SWEEP_PERDIR[config]
    # the blocked non-periodic levels' smoother, `pcg_blocked`, under every
    # seam; none where the pipe is periodic (its levels smooth with `pcg`)
    smooth = () if perdir else CONFIGS["c"][1]
    for k, v in flags.items():
        monkeypatch.setattr(tp, k, v)
    vs = torch.tensor(RADII, dtype=torch.float64)
    port = lambda v: _port_sphere(v, perdir)
    with _gates_open():
        forces, pois = torch.func.vmap(port)(vs)
        batched = {k: list(c) for k, c in member_calls.items()}
        for m in range(M):
            own_f, own_p = port(vs[m])
            assert torch.equal(forces[m], own_f), (config, m)
            assert torch.equal(pois[m], own_p), (config, m)
    assert all(batched.get(k) for k in seam + smooth), batched
    assert not any(batched.get(k) for k in CONFIGS["c"][1]
                   if k not in smooth), batched
    assert all(n == M for c in batched.values() for n in c)
    jpois = jax_sweep(perdir)
    for m in range(M):
        assert _pois_ok(pois[m].tolist(), jpois[m]), (
            m, pois[m].tolist(), jpois[m])


# --- (e) the gates ----------------------------------------------------------

@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("name", SEAMS + ("pcg_blocked",))
def test_member_checks_on_the_cpu(member_calls, name, shared):
    """`kernels.check.compare_stencil_members`, the card's phase-3 check
    of every member form (here `vmap` of the plain version), passes: each
    form equal to `vmap` of the plain version within the kernel's
    tolerance and to each member's own call bit for bit, the member form
    reached once a form (`pcg_blocked`: its two sweeps six times each)."""
    from waterlily_tpu_torch.kernels.check import (compare_stencil_members,
                                                   stencil_member_variants,
                                                   stencil_member_inputs)
    rows = compare_stencil_members(name, (13, 9, 11), M, shared, 1, "cpu")
    assert rows and all(r["ok"] and r["single_err"] == 0 for r in rows)
    forms = len(stencil_member_variants(name, stencil_member_inputs(
        (13, 9, 11), M, shared, 1, "cpu")))
    if name == "pcg_blocked":
        assert member_calls["pcg_dir_mult"] == [M] * 6 * forms
        assert member_calls["pcg_update"] == [M] * 6 * forms
    else:
        assert member_calls[name] == [M] * forms


@pytest.mark.parametrize("name", SEAMS)
def test_nested_vmap_folds_into_one_call(member_calls, name):
    """`vmap` of `vmap` (2 × 3 members, an operator and scalars a member)
    through each wrapper: one member-form call on all six members, each
    member equal to its own call bit for bit."""
    from waterlily_tpu_torch.kernels.check import (
        stencil_member_inputs, stencil_member_variants, member_args)
    d = stencil_member_inputs((13, 9, 11), 6, False, 1, "cpu")
    _outputs, fn, _plain, args, dims = stencil_member_variants(name, d)[0]
    grid = lambda a, dd: (a.reshape((2, 3) + tuple(a.shape[1:]))
                          if dd == 0 else a)
    nested = [grid(a, dd) for a, dd in zip(member_args(args), dims)]
    out = torch.func.vmap(torch.func.vmap(fn, in_dims=dims),
                          in_dims=dims)(*nested)
    assert member_calls[name] == [6]
    out = out if isinstance(out, tuple) else (out,)
    for m in range(6):
        own = fn(*[a[m] if dd == 0 else a for a, dd in zip(args, dims)])
        own = own if isinstance(own, tuple) else (own,)
        for got, want in zip(out, own):
            assert torch.equal(got[m // 3, m % 3], want), (name, m)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_seam_gates_route_transforms(member_calls, config, monkeypatch):
    """Under each seam, the smoother of a blocked level: under `vmap`
    alone it reaches the seam's member forms (each call on all members);
    under `grad` (and `vmap(grad)`) no member form is called, every
    wrapper runs its plain version, and the gradient equals the one with
    the seams off."""
    flags, seam = CONFIGS[config]
    L, Dd, iD = (tt(a) for a in _level(False))
    r, x = tt(_residuals(False)), tt(_fields(23, interior=False))
    # KDOT and KAXPY act in `pcg`, the smoother of a periodic level
    per = (0,) if config == "b" else ()
    lev = lambda L, Dd, iD: tp.PoissonLevel(L=L, D=Dd, iD=iD, blocked=True,
                                            perdir=per)

    def smoothed(L, Dd, iD, x, r):
        if config == "g":       # STREAM's wrappers: the residual, a Jacobi
            x, r = tp.jacobi(lev(L, Dd, iD), x, r)
            r = tp.residual(lev(L, Dd, iD), x, r)
        return tp.smooth(lev(L, Dd, iD), x, r)[0]

    loss = lambda s, m=0: torch.sum(smoothed(L[m] * s, Dd[m] * s, iD[m] / s,
                                             x[m], r[m]) ** 2)
    for k, v in flags.items():
        monkeypatch.setattr(tp, k, v)
    torch.func.vmap(smoothed)(L, Dd, iD, x, r)
    assert all(member_calls[k] for k in seam), dict(member_calls)
    assert all(n == M for c in member_calls.values() for n in c)
    member_calls.clear()
    one = torch.tensor(1.0)
    g = torch.func.grad(loss)(one)
    gv = torch.func.vmap(torch.func.grad(loss))(torch.ones(2))
    assert not member_calls, dict(member_calls)
    for k in flags:
        monkeypatch.setattr(tp, k, False)
    g_off = torch.func.grad(loss)(one)
    assert torch.equal(g, g_off)
    assert torch.equal(gv, torch.stack([g_off, g_off]))
