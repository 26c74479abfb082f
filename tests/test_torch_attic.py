"""Port parity of the blocked-level PCG iteration (`waterlily_tpu_torch.
ops.attic`): the kernels' plain versions against the JAX package's Pallas
kernels in interpret mode, the fused-iteration smoother `pcg_blocked`
against JAX's, and `pcg` with the ``KDOT``/``KAXPY`` seams against JAX's
with the same flags.  Outputs within 1e-6 absolute, sums within 1e-5
relative, a bf16 direction within one bf16 ulp (XLA on the CPU may contract
``beta*eps + r*iD`` into an FMA that the port does not)."""
import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.ops import attic as ja
from waterlily_tpu.ops import poisson as jp
from waterlily_tpu.ops import pallas_stencil as ps
from waterlily_tpu_torch.ops import attic as ta
from waterlily_tpu_torch.ops import poisson as tp

from _torch_parity import normal, interior_only, tt, jj, npy, bc_coeffs
from _pcg_chain import FOLD_CASES, chain, fold_case

S = (20, 18, 22)
RAGGED = (21, 13, 17)   # 21 rows: a ragged last slab at JAX's block 8
BETA = 0.37


def _f32(a):
    """numpy f32 of a torch or JAX array of any float type (bf16 too)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(a, ref, atol):
    a, ref = _f32(a), _f32(ref)
    assert a.shape == ref.shape
    err = float(np.max(np.abs(a - ref)))
    assert err <= atol, f"max err {err} > {atol}"


def _sum_close(a, ref, rtol=1e-5):
    a, ref = float(a), float(ref)
    assert abs(a - ref) <= rtol * abs(ref), (a, ref)


def _within_bf16_ulp(a, ref):
    a, ref = _f32(a), _f32(ref)
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(a - ref) <= ulp), float(np.max(np.abs(a - ref)))


def _inputs(shape=S, seed=0):
    L = bc_coeffs(seed, shape)
    lj = jp.make_level(jj(L), bf16_eps=False)
    lt = tp.make_level(tt(L))
    return {"lj": lj, "lt": lt,
            "r": interior_only(normal(seed + 1, shape, scale=0.1)),
            "eps": interior_only(normal(seed + 2, shape, scale=0.1)),
            "x": normal(seed + 3, shape),
            "z": interior_only(normal(seed + 4, shape))}


def _dir(a, bf16):
    """A previous direction as the iteration hands it on (bf16 or f32)."""
    return (jj(a).astype(jnp.bfloat16), tt(a).to(torch.bfloat16)) if bf16 \
        else (jj(a), tt(a))


def _words(upd=0.0, beta=0.0):
    """A smooth's words in flight (`attic.WORDS`) carrying ``upd`` and
    ``beta``, which the sweeps read."""
    return torch.tensor([0.8, 1.3, 0.0, upd, beta])


# --- the kernels' plain versions against the Pallas kernels ---------------

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("beta", [0.0, BETA])
def test_pcg_dir_mult_plain_vs_jax(beta, bf16):
    """beta = 0 (the preamble, no words: eps_prev is r, eps = r*iD) and
    beta != 0 (read from the words; eps_prev the previous direction, bf16
    on a bf16 level).  The port's sums are in its words: <z, eps> its own
    sum, the rho the seed's (it depends on r and iD alone)."""
    d = _inputs()
    lj, lt = d["lj"], d["lt"]
    ej_prev, et_prev = _dir(d["r"] if beta == 0 else d["eps"],
                            bf16 and beta != 0)
    ej, zj, denj, rhoj = ja.pcg_dir_mult(lj.L, lj.D, ej_prev, jj(d["r"]),
                                         lj.iD, beta, S, bf16=bf16,
                                         interpret=True, block=2)
    et, zt, wt = ta.pcg_dir_mult(lt.L, lt.D, et_prev, tt(d["r"]), lt.iD,
                                 None if beta == 0 else _words(beta=beta),
                                 bf16)
    seed = wt if beta == 0 else ta.pcg_dir_mult(
        lt.L, lt.D, tt(d["r"]), tt(d["r"]), lt.iD, None, bf16)[2]
    dent, rhot = wt[ta.W_SUM], seed[ta.W_RHO]
    assert et.dtype == (torch.bfloat16 if bf16 else torch.float32)
    if bf16:
        _within_bf16_ulp(et, ej)
    else:
        _close(et, ej, 1e-6)
    _close(zt, zj, 1e-6)
    _sum_close(dent, denj)
    _sum_close(rhot, rhoj)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", ["pcg_update", "pcg_axpy"])
def test_axpy_rho_plain_vs_jax(name, bf16):
    """The fused iteration's second sweep (upd from its words, the rho its
    own sum in the new words) and the axpy-pair sweep (one function, two
    TPU kernels), eps in f32 or bf16."""
    d = _inputs()
    lj, lt = d["lj"], d["lt"]
    ej, et = _dir(d["eps"], bf16)
    upd = np.float32(BETA)
    if name == "pcg_update":
        xj, rj, rhoj = ja.pcg_update(jj(d["x"]), jj(d["r"]), ej, jj(d["z"]),
                                     lj.iD, jnp.float32(upd), S,
                                     interpret=True, block=2)
    else:
        xj, rj, rhoj = ja.pcg_axpy_pallas(jj(d["x"]), jj(d["r"]), ej,
                                          jj(d["z"]), lj.iD, jnp.float32(upd),
                                          interpret=True, block=8)
    xt, rt, rhot = getattr(ta, name)(
        tt(d["x"]), tt(d["r"]), et, tt(d["z"]), lt.iD,
        _words(upd=upd) if name == "pcg_update" else torch.tensor(upd))
    if name == "pcg_update":
        rhot = rhot[ta.W_SUM]
    _close(xt, xj, 1e-6)
    _close(rt, rj, 1e-6)
    _sum_close(rhot, rhoj)


@pytest.mark.parametrize("shape", [S, RAGGED])
@pytest.mark.parametrize("mode", ["aa", "ab", "rid"])
def test_dot3d_plain_vs_jax(mode, shape):
    """Interior dots; ``ab`` on a field with non-zero ghosts, which both
    forms mask."""
    d = _inputs(shape, seed=5)
    lj, lt = d["lj"], d["lt"]
    a, b = {"aa": (d["r"], d["r"]), "ab": (d["x"], d["eps"]),
            "rid": (d["r"], None)}[mode]
    aj, at_ = jj(a), tt(a)
    bj, bt = (lj.iD, lt.iD) if mode == "rid" else (
        (aj, at_) if mode == "aa" else (jj(b), tt(b)))
    ref = ja.dot3d_pallas(aj, bj, shape, interpret=True, mode=mode)
    _sum_close(ta.dot3d(at_, bt, mode), ref)
    if mode == "aa":    # the default mode of a dot of a field with itself
        _sum_close(ta.dot3d(at_, at_), ref)


def test_dot3d_rejects_an_unknown_mode():
    d = _inputs()
    with pytest.raises(ValueError, match="mode"):
        ta.dot3d(tt(d["r"]), tt(d["r"]), "ba")


# --- the fused-iteration smoother ----------------------------------------

def _blocked(d, bf16):
    """The level as a blocked one on both sides (`pcg_blocked` reads the
    level's flags, not the kernel gate)."""
    return (d["lj"].replace(blocked=True, bf16_eps=bf16),
            dataclasses.replace(d["lt"], blocked=True, bf16_eps=bf16))


def _residual(d):
    """A consistent residual of the level (zero ghosts, mean-corrected)."""
    x0 = torch.zeros(S)
    return npy(tp.residual(d["lt"], x0, tt(d["eps"])))


def _mean_close(a, ref, tol):
    err = float(np.mean(np.abs(_f32(a) - _f32(ref))))
    assert err <= tol, f"mean err {err} > {tol}"


def test_pcg_blocked_vs_jax():
    """f32 directions, 6 iterations: x and r within 2e-5 (the tolerance of
    the JAX package's own test of it against `pcg`)."""
    d = _inputs()
    lj, lt = _blocked(d, False)
    r = _residual(d)
    xj, rj = ja.pcg_blocked(lj, jj(d["x"]), jj(r), it=6, interpret=True)
    xt, rt = ta.pcg_blocked(lt, tt(d["x"]), tt(r), it=6)
    _close(xt, xj, 2e-5)
    _close(rt, rj, 2e-5)


def test_pcg_blocked_bf16_vs_jax():
    """bf16 directions, 3 iterations.  From the second direction on, JAX's
    f32 value (FMA-contracted, other sum order in beta) can round to the
    neighbouring bf16 value at a few cells, so the fields are held on
    their mean difference (2e-6); an f32 × bf16 product rounded to bf16
    moves every cell by ~2^-9 of the update (mean ~3e-5 here) and fails."""
    d = _inputs()
    lj, lt = _blocked(d, True)
    r = _residual(d)
    xj, rj = ja.pcg_blocked(lj, jj(d["x"]), jj(r), it=3, interpret=True)
    xt, rt = ta.pcg_blocked(lt, tt(d["x"]), tt(r), it=3)
    _mean_close(xt, xj, 2e-6)
    _mean_close(rt, rj, 2e-6)


def test_pcg_blocked_refuses_periodic_and_banded():
    d = _inputs()
    _, lt = _blocked(d, False)
    x, r = tt(d["x"]), tt(_residual(d))
    with pytest.raises(ValueError, match="non-periodic"):
        ta.pcg_blocked(dataclasses.replace(lt, perdir=(0,)), x, r)
    with pytest.raises(ValueError, match="non-periodic"):
        ta.pcg_blocked(dataclasses.replace(lt, banded=True), x, r)


# --- the seams (KDOT, KAXPY) and the smoother's routes ----------------------

def _interpret(monkeypatch):
    """JAX's blocked levels run their Pallas kernels in interpret mode."""
    for mod, name in ((ps, "mult3d_pallas"), (ps, "increment3d_pallas"),
                      (ja, "dot3d_pallas"), (ja, "pcg_axpy_pallas")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, **k: _o(
            *a, **{**k, "interpret": True}))


def _spy(monkeypatch, name):
    """Count the port's calls of `ops.attic.<name>` made by `ops.poisson`."""
    calls = []
    orig = getattr(ta, name)
    monkeypatch.setattr(tp.at, name, lambda *a, **k: (calls.append(1),
                                                      orig(*a, **k))[1])
    return calls


@pytest.mark.parametrize("flags", [("KDOT",), ("KAXPY",), ("KDOT", "KAXPY")])
def test_pcg_seams_vs_jax(flags, monkeypatch):
    """`pcg` on a blocked level with the flags set in both packages: the
    port's dots and axpys go through `ops.attic`, and x, r stay within
    2e-5 of JAX's."""
    _interpret(monkeypatch)
    for f in flags:
        monkeypatch.setattr(jp, f, True)
        monkeypatch.setattr(tp, f, True)
    dots, axpys = _spy(monkeypatch, "dot3d"), _spy(monkeypatch, "pcg_axpy")
    d = _inputs()
    lj, lt = _blocked(d, False)
    r = _residual(d)
    xj, rj = jp.pcg(lj, jj(d["x"]), jj(r))
    xt, rt = tp.pcg(lt, tt(d["x"]), tt(r))
    _close(xt, xj, 2e-5)
    _close(rt, rj, 2e-5)
    # rho, then rho2 each iteration but the last (KDOT); the axpy pair of
    # each iteration but the last, whose rho2 it carries (KAXPY)
    assert len(dots) == (1 + (5 if "KAXPY" not in flags else 0)
                         if "KDOT" in flags else 0)
    assert len(axpys) == (5 if "KAXPY" in flags else 0)
    assert float(tp.fdot(lt, tt(r), tt(r))) == pytest.approx(
        float(jp.fdot(lj, jj(r), jj(r))), rel=1e-5)


def test_smooth_pcg_blocked_seam(monkeypatch):
    """A blocked dense non-periodic level goes to `pcg_blocked` by default
    (no flag: ``PCG_BLOCKED`` is gone), within 2e-5 of JAX's
    `attic.pcg_blocked`, and ``smooth.routes`` counts it; periodic and
    unblocked levels keep `pcg`."""
    assert not hasattr(tp, "PCG_BLOCKED")
    d = _inputs()
    lj, lt = _blocked(d, False)
    x, r = tt(d["x"]), tt(_residual(d))
    xb, rb = ta.pcg_blocked(lt, x, r)
    calls = _spy(monkeypatch, "pcg_blocked")
    monkeypatch.setattr(tp.smooth, "routes", collections.Counter())
    xs, rs = tp.smooth(lt, x, r)
    assert len(calls) == 1
    assert torch.equal(xs, xb) and torch.equal(rs, rb)
    xj, rj = ja.pcg_blocked(lj, jj(d["x"]), jj(_residual(d)), it=6,
                            interpret=True)
    _close(xs, xj, 2e-5)
    _close(rs, rj, 2e-5)
    for lv in (dataclasses.replace(lt, perdir=(1,)), d["lt"]):
        tp.smooth(lv, x, r)
    assert len(calls) == 1
    assert tp.smooth.routes == {("pcg_blocked", S): 1, ("pcg", S): 2}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_pcg_blocked_plain_step_equals_the_chain(case):
    """On the CPU (the sweeps' plain versions taking the scalar step on
    the words) `pcg_blocked` equals the 0-d-tensor chain bit for bit, in
    each early exit, and the exit trips."""
    d = _inputs()
    _, lt = _blocked(d, False)
    lev, r, exit_ = fold_case(case, lt, tt(_residual(d)))
    exits = []
    want = chain(lev, tt(d["x"]), r, exits=exits)
    got = ta.pcg_blocked(lev, tt(d["x"]), r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert exits[:1] == ([exit_] if exit_ else []), exits


@pytest.mark.parametrize("route", ["periodic", "banded", "tracked",
                                   "pcg_fused", "vmap"])
def test_smooth_routes(route, monkeypatch):
    """`smooth` keeps `pcg` on periodic, banded and tracked levels (a
    ``fixed_iters`` solve under autograd: ``x`` requires grad), sends a
    `pcg_fused`-sized level there, and a blocked level under `vmap` alone
    to `pcg_blocked` (its member forms); ``smooth.routes`` counts each."""
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    d = _inputs()
    _, lt = _blocked(d, False)
    x, r = tt(d["x"]), tt(_residual(d))
    taken = []
    for name, mod in (("pcg", tp), ("pcg_fused", pk)):
        monkeypatch.setattr(mod, name, lambda lev, x, r, it=6, _n=name: (
            taken.append(_n), (x, r))[1])
    monkeypatch.setattr(tp.smooth, "routes", collections.Counter())
    want = "pcg"
    if route == "periodic":
        tp.smooth(dataclasses.replace(lt, perdir=(0, 2)), x, r)
    elif route == "banded":
        tp.smooth(dataclasses.replace(lt, banded=True), x, r)
    elif route == "tracked":
        tp.smooth(lt, x.requires_grad_(), r)
    elif route == "pcg_fused":
        monkeypatch.setattr(pk, "use_pcg_fused", lambda S, dt, dev: True)
        tp.smooth(lt, x, r)
        want = "pcg_fused"
    else:
        X, R = torch.stack([x, x]), torch.stack([r, 0 * r])
        own = [ta.pcg_blocked(lt, X[m], R[m]) for m in range(2)]
        calls = _spy(monkeypatch, "pcg_blocked")
        out = torch.func.vmap(lambda x, r: tp.smooth(lt, x, r))(X, R)
        assert len(calls) == 1 and not taken
        assert all(torch.equal(out[i][m], own[m][i])
                   for m in range(2) for i in range(2))
        assert tp.smooth.routes == {("pcg_blocked", S): 1}
        return
    assert taken == [want]
    assert tp.smooth.routes == {(want, S): 1}
