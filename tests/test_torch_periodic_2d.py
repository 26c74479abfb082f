"""Port parity of the periodic, 2D and outlet paths (torch vs JAX, f32 on
the CPU): the plain forms of the periodic and ``save_exit`` `bc3d`, the
periodic `conv_diff3d` and the 2D and periodic `pcg_fused` against the
Pallas kernels in interpret mode; the periodic, 2D and outlet cases
constructed by both packages and stepped from one state."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.models import cases as jcases
from waterlily_tpu.ops import convect as jc
from waterlily_tpu.ops import poisson as jp
from waterlily_tpu.ops.pallas_kernels import pcg_pallas
from waterlily_tpu.ops.pallas_stencil import bc3d_pallas, conv_diff3d_pallas
import waterlily_tpu_torch as wt
from waterlily_tpu_torch.convert import flow_from_numpy, levels_from_numpy
from waterlily_tpu_torch.kernels import check
from waterlily_tpu_torch.ops import convect as tc
from waterlily_tpu_torch.ops import pcg_kernel as pk
from waterlily_tpu_torch.ops import poisson as tp
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.ops.bc import bc_vector_planes

from _torch_parity import (F32, normal, uniform, interior_only, tt, jj, npy,
                           assert_exact, assert_rel)

f32 = jnp.float32
LIMITERS = {"quick": (jc.quick, tc.quick), "vanleer": (jc.vanleer, tc.vanleer)}


# --- the kernels' plain forms against the Pallas kernels -------------------

@pytest.mark.parametrize("perdir", [(), (1,), (0, 2), (0, 1, 2)])
@pytest.mark.parametrize("save_exit", [False, True])
def test_bc3d_plain_vs_pallas_periodic_exit(perdir, save_exit):
    """bit for bit, ghost corners included, at a ragged shape (10 % 4)."""
    S = (10, 9, 12)
    u = normal(3, (3,) + S)
    A = (1.0, 0.5, -0.25)
    ref = bc3d_pallas(jj(u), A, save_exit, perdir, interpret=True, block=4)
    assert_exact(sk.bc3d(tt(u), A, save_exit, perdir), ref)


@pytest.mark.parametrize("perdir", [(0,), (1,), (2,), (0, 2), (0, 1, 2)])
@pytest.mark.parametrize("name", ["quick", "vanleer"])
def test_conv_diff3d_plain_vs_pallas_periodic(perdir, name):
    """The ϕuP wrap and the top-face copy: atol 1e-5, as JAX's own test
    (the Pallas kernel sums its sweeps in another order); the velocity's
    periodic ghosts are filled, as on the step."""
    jl, tl = LIMITERS[name]
    S = (16, 14, 18)
    u = npy(bc_vector_planes(tt(normal(1, (3,) + S)), (0.0,) * 3, False,
                             perdir))
    rj = conv_diff3d_pallas(jj(u), 0.05, jl, S, interpret=True, perdir=perdir)
    rt = sk.conv_diff3d(tt(u), 0.05, tl, perdir)
    np.testing.assert_allclose(npy(rt), np.asarray(rj), atol=1e-5)


def _pcg_pair(S, perdir, seed):
    """One level (positive coefficients, periodic ghosts filled along
    ``perdir``, the others zeroed) built by both packages, and a residual
    with zero ghosts."""
    D = len(S)
    L = npy(bc_vector_planes(tt(uniform(seed, (D,) + S, 0.5, 1.5)),
                             (0.0,) * D, False, perdir))
    lt = tp.make_level(tt(L), perdir)
    lj = jp.make_level(jj(L), perdir, bf16_eps=False)
    z = interior_only(normal(seed + 1, S, scale=0.1))
    x0 = np.zeros(S, F32)
    r = npy(tp.residual(lt, tt(x0), tt(z)))
    return lj, lt, x0, r


@pytest.mark.parametrize("S,perdir", [((18, 18), ()), ((10, 14), (1,)),
                                      ((18, 18), (0, 1)),
                                      ((10, 10, 10), (0, 1, 2))])
def test_pcg_fused_plain_vs_pallas_2d_periodic(S, perdir):
    """The 2D and periodic smooths' plain form (`pcg_fused` on CPU
    tensors) against the Pallas whole-smooth kernel: atol 1e-5, as
    tests/test_pallas.py."""
    lj, lt, x0, r = _pcg_pair(S, perdir, 7)
    xj, rj = pcg_pallas(lj, jj(x0), jj(r), interpret=True)
    xt, rt = pk.pcg_fused(lt, tt(x0), tt(r))
    np.testing.assert_allclose(npy(xt), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(npy(rt), np.asarray(rj), atol=1e-5)
    # the kernel's x moves its periodic ghosts with eps: so does the plain
    xp, _ = tp.pcg(lt, tt(x0), tt(r))
    assert torch.equal(xt, xp)


def test_gates_send_2d_to_plain_forms_and_pcg_fused():
    """2D fields take the plain BC and convection forms on the card (JAX:
    kernels only for D == 3), and every level of the 2D cases and the 34³
    level of a 258³ grid take the one-launch smooth."""
    cuda, f = torch.device("cuda"), torch.float32
    assert not sk.use_blocked((130, 130), f, cuda)
    assert sk.use_blocked((66, 66, 66), f, cuda)
    for S in ((98, 66), (130, 130), (66, 66), (34, 34, 34), (5, 4)):
        assert pk.use_pcg_fused(S, f, cuda)
    assert not pk.use_pcg_fused((66, 66, 66), f, cuda)


def test_check_variants_cover_every_form():
    """`kernels.check` holds every form the path runs against its plain
    version: on CPU tensors each wrapper is its plain form, so every
    variant agrees exactly and each output has a stated tolerance."""
    for S in ((12, 10, 14), (10, 14)):
        d = check.inputs(S, 2, "cpu")
        for name in check.KERNELS:
            for outputs, kern, plain in check.variants(name, d):
                k, p = kern(), plain()
                k, p = (k, p) if isinstance(k, tuple) else ((k,), (p,))
                for o, a, b in zip(outputs or ("",), k, p):
                    assert ".".join(filter(None, (name, o))) in check.TOLERANCE
                    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    n = {name: len(check.variants(name, check.inputs((12, 10, 14), 0, "cpu")))
         for name in ("bc3d", "conv_diff3d", "pcg_fused", "ana_mult3d")}
    # bc3d: its 16 forms (8 periodic masks, with and without save_exit);
    # conv_diff3d: the two compiled-in limiters and
    # a user's own, walls and all seven periodic masks; ana_mult3d: with
    # the dot, then walls and the seven periodic masks without it
    assert n == {"bc3d": 16, "conv_diff3d": 24, "pcg_fused": 2,
                 "ana_mult3d": 9}
    assert len(check.variants("pcg_fused",
                              check.inputs((10, 14), 0, "cpu"))) == 3
    assert check.bound_ms("pcg_fused", (98, 66))[1] == "bytes"


# --- the cases: construction and steps from one state -----------------------

CASES = {
    "circle_2d": (lambda: jcases.circle_2d(48, 32, dtype=f32),
                  lambda: wt.circle_2d(48, 32, device="cpu"), ()),
    "tgv_2d": (lambda: jcases.tgv_2d(32, dtype=f32),
               lambda: wt.tgv_2d(32, device="cpu"), (0, 1)),
    "tgv_3d": (lambda: jcases.tgv_3d(16, dtype=f32),
               lambda: wt.tgv_3d(16, device="cpu"), (0, 1, 2)),
    "oscillating_plate_2d": (
        lambda: jcases.oscillating_plate_2d(16, dtype=f32),
        lambda: wt.oscillating_plate_2d(16, device="cpu"), ()),
    "donut_3d": (lambda: jcases.donut_3d(16, dtype=f32),
                 lambda: wt.donut_3d(16, device="cpu"), ()),
    "sphere_3d_exit": (
        lambda: jcases.sphere_3d(24, 16, exitBC=True, dtype=f32),
        lambda: wt.sphere_3d(24, 16, exitBC=True, device="cpu"), ()),
}


@pytest.mark.parametrize("case", ["circle_2d", "tgv_2d", "tgv_3d",
                                  "oscillating_plate_2d", "donut_3d"])
def test_case_construction(case):
    """Fields within 1e-6, the same level stack (diagonals within 1e-5)."""
    jmake, tmake, perdir = CASES[case]
    js, ts = jmake(), tmake()
    assert ts.cfg.perdir == tuple(js.cfg.perdir) == perdir
    for k in ("u", "p", "V", "mu0", "mu1"):
        np.testing.assert_allclose(npy(getattr(ts.flow, k)),
                                   np.asarray(getattr(js.flow, k)), atol=1e-6)
    assert len(ts.levels) == len(js.levels)
    for a, b in zip(ts.levels, js.levels):
        assert a.perdir == perdir
        np.testing.assert_allclose(npy(a.D), np.asarray(b.D), atol=1e-5)
    assert ts.L == js.L and ts.U == js.U
    assert ts.cfg.nu == pytest.approx(js.cfg.nu, rel=1e-12)


def _pois_ok(a, b):
    """Equal iteration counts, or within ±2 per solve and ≤4 in total."""
    d = np.abs(np.asarray(a, int) - np.asarray(b, int))
    return bool((d == 0).all() or ((d <= 2).all() and d.sum() <= 4))


@pytest.mark.parametrize("case,n,remeasure", [
    ("circle_2d", 5, False), ("tgv_2d", 3, False),
    ("oscillating_plate_2d", 3, True), ("sphere_3d_exit", 3, False)])
def test_steps_from_one_state(case, n, remeasure):
    """``n`` steps from the JAX state carried across: pois_n by the ±2/≤4
    rule, dt to 1e-5 relative, u to 1e-4 and p to 1e-4 of its scale (the
    impulsive start's pressure reaches ~40; the solvers' sums round in
    another order)."""
    jmake, tmake, perdir = CASES[case]
    js, ts = jmake(), tmake()
    ts.flow = flow_from_numpy(
        {k: np.asarray(v) for k, v in js.flow._asdict().items()}, "cpu")
    ts.levels = levels_from_numpy(
        [{"L": np.asarray(l.L), "D": np.asarray(l.D), "iD": np.asarray(l.iD)}
         for l in js.levels], "cpu", perdir)
    js.steps(n, remeasure=remeasure)
    ts.steps(n, remeasure=remeasure)
    pj = [[int(v) for v in r] for r in js.pois_n]
    assert _pois_ok(ts.pois_n, pj), (ts.pois_n, pj)
    np.testing.assert_allclose(ts.dts, js.dts, rtol=1e-5)
    np.testing.assert_allclose(npy(ts.flow.u), np.asarray(js.flow.u),
                               atol=1e-4)
    assert_rel(ts.flow.p, js.flow.p, 1e-4)
    assert np.isfinite(npy(ts.flow.u)).all()


def test_new_cases_default_to_the_card():
    for fn in (wt.circle_2d, wt.tgv_2d, wt.tgv_3d, wt.oscillating_plate_2d,
               wt.donut_3d):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    jsig = inspect.signature(jcases.oscillating_plate_2d).parameters
    tsig = inspect.signature(wt.oscillating_plate_2d).parameters
    assert [k for k in tsig if k != "device"] == list(jsig)
