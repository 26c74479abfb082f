"""Port parity of the banded (sparse immersed-boundary) path.

Three kinds of check, as `tests/test_banded.py` makes them for JAX:
- the port's banded operators and narrow-band measurement equal the
  port's dense ones bit for bit (value equality: the sign of zero may
  differ, as in JAX);
- the port's band window helpers give JAX's ints, and `ana_mult3d`'s plain
  version equals JAX's Pallas kernel in interpret mode;
- the slice: both packages stepped from one state, banded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import body as jb
from waterlily_tpu.grid import band_box_start as j_band_box_start
from waterlily_tpu.models.cases import sphere_3d as jsphere
from waterlily_tpu.ops.pallas_stencil import ana_mult3d_pallas
from waterlily_tpu.simulation import Simulation as JSim
from waterlily_tpu_torch import body as tb
from waterlily_tpu_torch import sphere_3d as tsphere, heaving_sphere_3d
from waterlily_tpu_torch.simulation import Simulation as TSim
from waterlily_tpu_torch.grid import band_box_start
from waterlily_tpu_torch.ops import poisson as P
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.ops.multigrid import (vcycle, build_levels,
                                               update_levels)
from waterlily_tpu_torch.convert import flow_from_numpy, levels_from_numpy

from _torch_parity import normal, tt, jj, npy, assert_rel


def _pois_ok(a, b):
    a, b = np.asarray(a, int), np.asarray(b, int)
    return bool((a == b).all())


# --- window helpers against JAX ---------------------------------------------

def _masks():
    m1 = np.zeros((32, 24), bool)
    m1[10:15, 7:12] = True
    m2 = np.zeros((32, 24), bool)
    m2[25:31, 0:5] = True          # hugs the walls: the clamp
    m3 = np.random.default_rng(4).random((14, 12, 10)) > 0.97
    return [(m1, (8, 8)), (m2, (8, 8)), (m3, (6, 5, 4)),
            (np.zeros((14, 12, 10), bool), (6, 5, 4))]


@pytest.mark.parametrize("case", range(4))
def test_band_box_start_matches_jax(case):
    mask, box = _masks()[case]
    got = band_box_start(torch.from_numpy(mask), box).tolist()
    assert got == np.asarray(j_band_box_start(jnp.asarray(mask), box)).tolist()


def _sphere_bodies(c, r, D):
    cj = jnp.asarray([c] * D, jnp.float32)
    ct = torch.tensor([c] * D, dtype=torch.float32)
    return (jb.AutoBody(lambda x, t: jnp.sqrt(jnp.sum((x - cj) ** 2)) - r),
            tb.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ct) ** 2)) - r))


@pytest.mark.parametrize("c,r,S", [(16.0, 14.0, (34, 34)),
                                   (16.0, 4.0, (34, 34)),
                                   (14.0, 4.0, (34, 30, 30))])
def test_band_box_shape_matches_jax(c, r, S):
    bj, bt = _sphere_bodies(c, r, len(S))
    want = jb.band_box_shape(bj, S, dtype=jnp.float32)
    assert tb.band_box_shape(bt, S, dtype=torch.float32,
                             device="cpu") == want
    assert tb.band_box_shape(None, S) is None


# --- narrow-band measurement --------------------------------------------------

def _moving_2d():
    def mj(x, t):
        return x - jnp.stack([20.0 + 2 * t, jnp.asarray(16.0, x.dtype)])

    def mt(x, t):
        return x - torch.stack([20.0 + 2 * t, torch.full_like(t, 16.0)])
    return (jb.AutoBody(lambda x, t: jnp.sqrt(jnp.sum(x * x)) - 4.0, mj),
            tb.AutoBody(lambda x, t: torch.sqrt(torch.sum(x * x)) - 4.0, mt))


@pytest.mark.parametrize("case", ["2d_moving_t0", "2d_moving_t1.3",
                                  "3d_periodic"])
def test_measure_fields_banded(case):
    """Window-only measurement equals the port's dense measurement bit for
    bit, and JAX's banded measurement to the dense measure's tolerance."""
    if case.startswith("2d"):
        (bj, bt), S, t, perdir, exit_ = _moving_2d(), (50, 42), \
            float(case.split("_t")[1]), (), True
    else:
        (bj, bt), S, t, perdir, exit_ = _sphere_bodies(14.0, 4.0, 3), \
            (34, 30, 30), 0.0, (1,), False
    box = tb.band_box_shape(bt, S, t, dtype=torch.float32, device="cpu")
    assert box is not None
    dense = tb.measure_fields(bt, S, t, 1.0, perdir, exit_, torch.float32,
                               "cpu")
    *band, start = tb.measure_fields_banded(bt, S, t, 1.0, perdir, exit_,
                                            torch.float32, box, "cpu")
    assert start == tuple(band_box_start(band[3] < 3.0, box).tolist())
    ref = jb.measure_fields_banded(bj, S, t, 1.0, perdir, exit_, jnp.float32,
                                   box)
    for a, b, r in zip(band, dense, ref):
        assert torch.equal(a, b)
        np.testing.assert_allclose(npy(a), np.asarray(r), atol=1e-6)


# --- banded operators equal the dense ones -----------------------------------

@pytest.fixture(scope="module")
def sphere_pair():
    a = tsphere(32, 32, bbox="force", banded_levels=True, device="cpu")
    b = tsphere(32, 32, bbox=False, device="cpu")
    return a, b


OPS = ["mult", "residual", "rid", "pressure_grad", "pcg", "vcycle"]


@pytest.mark.parametrize("op", OPS)
def test_banded_ops_bitwise_equal(sphere_pair, op):
    a, b = sphere_pair
    la, lb = a.levels[0], b.levels[0]
    assert la.banded and not lb.banded and la.c == 1.0
    S = tuple(la.D.shape)
    x, z = tt(normal(1, S)), tt(normal(2, S))
    ra, rb = P.residual(la, x, z), P.residual(lb, x, z)
    got, want = {
        "mult": lambda: (P.mult(la, x), P.mult(lb, x)),
        "residual": lambda: (ra, rb),
        "rid": lambda: (P._rid(la, x), x * lb.iD),
        "pressure_grad": lambda: (P.pressure_grad_interior(la, x),
                                  P.pressure_grad_interior(lb, x)),
        "pcg": lambda: (torch.stack(P.pcg(la, x, ra)),
                        torch.stack(P.pcg(lb, x, rb))),
        "vcycle": lambda: (torch.stack(vcycle(a.levels, 0, x, ra)),
                           torch.stack(vcycle(b.levels, 0, x, rb))),
    }[op]()
    assert torch.equal(got, want)


def test_update_levels_moves_the_window(sphere_pair):
    a, _ = sphere_pair
    start = tuple(s + 1 for s in a.levels[0].box_start)
    moved = update_levels(a.levels, a.flow.mu0, start)
    ref = build_levels(a.flow.mu0, (), a.levels[0].box_shape, start)
    assert moved[0].box_start == start
    assert [l.banded for l in moved] == [l.banded for l in ref]
    assert all(torch.equal(l.L, m.L) for l, m in zip(moved, ref))


# --- ana_mult3d: the plain version against the Pallas kernel ----------------

@pytest.mark.parametrize("S", [(13, 9, 11), (3, 37, 70), (37, 29, 35)])
@pytest.mark.parametrize("block", [2, 5])
@pytest.mark.parametrize("c", [1.0, 2.0])
@pytest.mark.parametrize("with_dot", [False, True])
def test_ana_mult3d_plain_vs_pallas(S, block, c, with_dot):
    """Interpret mode; 13 rows at block 5 leave a ragged tail slab, and the
    other shapes are the kernel's ragged cases (one interior plane; axes 1
    and 2 off its (8, 32) column tiles).  XLA's
    CPU backend contracts ``c·t − (c·nf)·x`` into one FMA, which the
    plain version (and the kernel, built without contraction) does not: z
    differs by at most that one rounding (atol/rtol 1e-6).  The dot sums in
    another order (rtol 1e-5)."""
    x = normal(5, S)
    ref = ana_mult3d_pallas(jj(x), c, with_dot=with_dot, interpret=True,
                            block=block)
    out = sk.ana_mult3d(tt(x), c, with_dot=with_dot)
    z, zj = (out[0], ref[0]) if with_dot else (out, ref)
    np.testing.assert_allclose(npy(z), np.asarray(zj), rtol=1e-6, atol=1e-6)
    if with_dot:
        assert_rel(out[1], ref[1], 1e-5)


def test_ana_mult3d_periodic_vs_pallas():
    """A periodic axis has no wall faces (same tolerance as above)."""
    S = (12, 10, 9)
    x = normal(6, S)
    ref = ana_mult3d_pallas(jj(x), 2.0, (1,), interpret=True, block=4)
    np.testing.assert_allclose(npy(sk.ana_mult3d(tt(x), 2.0, (1,))),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


# --- the slice: both packages from one state --------------------------------

def _moving_sphere_pair(**kw):
    """A radius-4 sphere heaving ±4 cells on a 32³ grid.  (The case
    `heaving_sphere_3d(radius=8)` fills a 32³ grid too, but its box would
    cover more than half the grid, so neither package bands it.)"""
    def mj(x, t):
        y = 4.0 * jnp.sin(0.2 * t)
        return x - jnp.stack([jnp.asarray(12.0, x.dtype), 16.0 + y,
                              jnp.asarray(16.0, x.dtype)])

    def mt(x, t):
        y = 4.0 * torch.sin(0.2 * t)
        return x - torch.stack([torch.full_like(y, 12.0), 16.0 + y,
                                torch.full_like(y, 16.0)])
    js = JSim((32, 32, 32), (1, 0, 0), 8.0, nu=0.04, dtype=jnp.float32,
              body=jb.AutoBody(lambda x, t: jnp.sqrt(jnp.sum(x * x)) - 4.0,
                               mj), **kw)
    ts = TSim((32, 32, 32), (1, 0, 0), 8.0, nu=0.04, device="cpu",
              body=tb.AutoBody(lambda x, t: torch.sqrt(torch.sum(x * x))
                               - 4.0, mt), **kw)
    return js, ts


@pytest.mark.parametrize("case", ["sphere_banded_levels", "moving_sphere"])
def test_slice_matches_jax(case):
    """Three steps from one state (carried across with `convert`): equal
    pois_n, dt to 1e-5 relative, u and p to 1e-4; the moving body is
    re-measured every step and its window must follow it."""
    if case == "sphere_banded_levels":
        kw = dict(bbox="force", banded_levels=True)
        js = jsphere(32, 32, dtype=jnp.float32, **kw)
        ts = tsphere(32, 32, device="cpu", **kw)
        remeasure = False
    else:
        js, ts = _moving_sphere_pair(bbox="force")
        remeasure = True
    assert ts.cfg.bbox_shape == js.cfg.bbox_shape is not None
    ts.flow = flow_from_numpy(
        {k: np.asarray(v) for k, v in js.flow._asdict().items()}, "cpu")
    ts.levels = levels_from_numpy(
        [{"L": np.asarray(l.L), "D": np.asarray(l.D), "iD": np.asarray(l.iD),
          "banded": l.banded, "c": l.c, "box_shape": l.box_shape,
          "box_start": None if l.box_start is None
          else np.asarray(l.box_start)} for l in js.levels], "cpu")
    assert [l.banded for l in ts.levels] == [l.banded for l in js.levels]
    for _ in range(3):
        js.step(remeasure=remeasure)
        ts.step(remeasure=remeasure)
    assert _pois_ok(ts.pois_n, [[int(v) for v in r] for r in js.pois_n]), \
        (ts.pois_n, js.pois_n)
    np.testing.assert_allclose(ts.dts, js.dts, rtol=1e-5)
    np.testing.assert_allclose(npy(ts.flow.u), np.asarray(js.flow.u),
                               atol=1e-4)
    np.testing.assert_allclose(npy(ts.flow.p), np.asarray(js.flow.p),
                               atol=1e-4)
    assert list(ts.flow.bbox) == np.asarray(js.flow.bbox).tolist()


def test_heaving_sphere_case_matches_jax():
    """The case constructor builds JAX's body: equal fields at a remeasure
    time, and at 32³ neither package bands it."""
    from waterlily_tpu.models.cases import heaving_sphere_3d as jheave
    js = jheave(radius=8, amp=4, bbox="force", dtype=jnp.float32)
    ts = heaving_sphere_3d(radius=8, amp=4, bbox="force", device="cpu")
    assert ts.cfg.bbox_shape is None and js.cfg.bbox_shape is None
    js.measure(t=1.7)
    ts.measure(t=1.7)
    for k in ("V", "mu0", "mu1"):
        np.testing.assert_allclose(npy(getattr(ts.flow, k)),
                                   np.asarray(getattr(js.flow, k)), atol=1e-6)


def test_band_outgrowing_window_raises():
    """A band that grows past its t=0-sized window is a hard error, and a
    measure past it leaves the state and the levels as they were."""
    def grow(x, t):  # radius 3 -> the band outgrows the margin-3 window
        return torch.sqrt(torch.sum((x - 12.0) ** 2)) - (3.0 + 4.0 * t)

    sim = TSim((24, 24, 24), (1, 0, 0), 6.0, nu=0.1, body=tb.AutoBody(grow),
               bbox="force", device="cpu")
    assert sim.cfg.bbox_shape is not None
    with pytest.raises(RuntimeError, match="band outgrew"):
        for _ in range(12):
            sim.step(remeasure=True)
    lev0, mu0 = sim.levels, sim.flow.mu0
    with pytest.raises(RuntimeError, match="band outgrew"):
        sim.measure(t=10.0)
    assert sim.levels is lev0 and sim.flow.mu0 is mu0
