"""Port parity: immersion kernels, point measurement and BDIM
rasterization (torch vs JAX)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import body as jb
from waterlily_tpu_torch import body as tb
from waterlily_tpu_torch.grid import loc_grid

from _torch_parity import (F32, F64, TORCH, JAX, normal, tt, jj, npy,
                           assert_rel, assert_exact)

RADIUS, CENTER = 3.0, np.array([7.0, 5.5, 4.0])


def _spheres(dtype):
    cj = jnp.asarray(CENTER, JAX[dtype])
    ct = torch.tensor(CENTER, dtype=TORCH[dtype])
    sj = jb.AutoBody(lambda x, t: jnp.sqrt(jnp.sum((x - cj) ** 2)) - RADIUS)
    st = tb.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ct) ** 2)) - RADIUS)
    return sj, st


def _heaving(dtype):
    """A sphere on a time-dependent map: exercises jacfwd and the jvp."""
    def mj(x, t):
        return x - jnp.stack([jnp.asarray(7.0, x.dtype),
                              5.5 + 2.0 * jnp.sin(0.3 * t),
                              jnp.asarray(4.0, x.dtype)])

    def mt(x, t):
        return x - torch.stack([torch.tensor(7.0, dtype=x.dtype),
                                5.5 + 2.0 * torch.sin(0.3 * t),
                                torch.tensor(4.0, dtype=x.dtype)])
    sj = jb.AutoBody(lambda x, t: jnp.sqrt(jnp.sum(x * x)) - RADIUS, mj)
    st = tb.AutoBody(lambda x, t: torch.sqrt(torch.sum(x * x)) - RADIUS, mt)
    return sj, st


@pytest.mark.parametrize("dtype", [F32, F64])
def test_kernel_moments(dtype):
    d = np.linspace(-3, 3, 61).astype(dtype)
    for f in ("kern", "kern0", "kern1"):
        assert_rel(getattr(tb, f)(tt(d)), getattr(jb, f)(jj(d)),
                   1e-6 if dtype is F32 else 1e-12)
    for f in ("mu0", "mu1"):
        assert_rel(getattr(tb, f)(tt(d), 1.5), getattr(jb, f)(jj(d), 1.5),
                   1e-6 if dtype is F32 else 1e-12)


@pytest.mark.parametrize("make", [_spheres, _heaving])
def test_measure_points(make):
    sj, st = make(F64)
    pts = normal(1, (64, 3), F64, 4.0) + CENTER
    pts[0] = CENTER if make is _spheres else pts[0]   # NaN-gradient guard
    t = 1.3
    dj, nj, Vj = jax.vmap(lambda x: jb.measure(sj, x, t, 9.0))(jj(pts))
    dt_, nt, Vt = torch.func.vmap(lambda x: tb.measure(st, x, t, 9.0))(tt(pts))
    for a, b in ((dt_, dj), (nt, nj), (Vt, Vj)):
        np.testing.assert_allclose(npy(a), npy(b), atol=1e-12)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("make", [_spheres, _heaving])
def test_measure_fields(dtype, make):
    S = (16, 13, 10)
    sj, st = make(dtype)
    outj = jb.measure_fields(sj, S, 0.7, 1.0, dtype=JAX[dtype])
    outt = tb.measure_fields(st, S, 0.7, 1.0, dtype=TORCH[dtype],
                             device="cpu")
    atol = 1e-6 if dtype is F32 else 1e-12
    for a, b in zip(outt, outj):
        assert a.dtype == TORCH[dtype]
        np.testing.assert_allclose(npy(a), npy(b), atol=atol)
    # the near-body band carries moving-body velocity for the heaving map
    if make is _heaving:
        assert float(outt[0].abs().max()) > 0


def test_measure_fields_chunked(monkeypatch):
    """Chunked evaluation gives the same fields as one batch."""
    S = (12, 10, 8)
    _, st = _spheres(F32)
    whole = tb.measure_fields(st, S, 0.0, 1.0, device="cpu")
    monkeypatch.setattr(tb, "CHUNK", 97)
    chunked = tb.measure_fields(st, S, 0.0, 1.0, device="cpu")
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_nobody_fields():
    S = (10, 9, 8)
    outj = jb.measure_fields(jb.NoBody(), S)
    outt = tb.measure_fields(tb.NoBody(), S, device="cpu")
    for a, b in zip(outt, outj):
        assert np.array_equal(npy(a), npy(b))


# --- CSG bodies (reference maintests.jl:199-225) ---

def _norm2j(x):
    return jnp.sqrt(jnp.sum(x * x))


def _norm2t(x):
    return torch.sqrt(torch.sum(x * x))


def _oracle_bodies():
    """maintests.jl:190-206's two bodies, on both packages."""
    j1 = jb.AutoBody(lambda x, t: _norm2j(x) - 2 - t)
    j2 = jb.AutoBody(lambda x, t: _norm2j(x) - 2, lambda x, t: x + t ** 2)
    t1 = tb.AutoBody(lambda x, t: _norm2t(x) - 2 - t)
    t2 = tb.AutoBody(lambda x, t: _norm2t(x) - 2, lambda x, t: x + t ** 2)
    return j1, j2, t1, t2


def _same_measure(got, ref, atol=1e-12):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(npy(a), npy(b), atol=atol)


def test_measure_csg():
    """The reference's oracles for union, difference and flat `Bodies` on
    the port, each measurement against JAX's."""
    j1, j2, t1, t2 = _oracle_bodies()
    x = np.array([-np.sqrt(2), -np.sqrt(2)])
    s2, s = np.sqrt(2), np.sqrt(0.5)
    cases = [((t1 + t2), (j1 + j2), (-s2, [-s, -s], [-2, -2])),
             (t1.union(t2), j1.union(j2), (-s2, [-s, -s], [-2, -2])),
             ((t1 - t2), (j1 - j2), (s2, [s, s], [-2, -2])),
             (tb.Bodies([t1, t2]), jb.Bodies([j1, j2]), None),
             (tb.Bodies([t1, t2], "-"), jb.Bodies([j1, j2], "-"), None),
             (t1.intersect(t2), j1.intersect(j2), None),
             (-t1, -j1, None)]
    for bt_, bj_, want in cases:
        got = tb.measure(bt_, tt(x), 1.0)
        _same_measure(got, jb.measure(bj_, jj(x), 1.0))
        if want is not None:
            _same_measure(got, tuple(np.asarray(w, float) for w in want),
                          atol=1e-6)
    _same_measure(tb.measure(tb.Bodies([t1, t2]), tt(x), 1.0),
                  tb.measure(t1 + t2, tt(x), 1.0), atol=0)
    _same_measure(tb.measure(tb.Bodies([t1, t2], "diff"), tt(x), 1.0),
                  tb.measure(t1 - t2, tt(x), 1.0), atol=0)
    with pytest.raises(ValueError, match="unsupported CSG op"):
        tb.Bodies([t1, t2], "xor")
    with pytest.raises(ValueError, match="len"):
        tb.Bodies([t1, t2], ["+", "-"])


def test_bodies_chain():
    """Nested operators equal a flat `Bodies` (maintests.jl:208-213), and
    both equal JAX's on random points."""
    radii = [1.0, 0.75, 0.5, 0.25]
    tc = [tb.AutoBody(lambda x, t, r=r: _norm2t(x) - r) for r in radii]
    jc = [jb.AutoBody(lambda x, t, r=r: _norm2j(x) - r) for r in radii]
    body = tc[0] - tc[1] + tc[2] - tc[3]
    flat = tb.Bodies(tc, ["-", "+", "-"])
    pts = np.random.default_rng(1).uniform(-1.2, 1.2, (40, 2))
    a = torch.func.vmap(lambda x: tb.measure(body, x, 1.0))(tt(pts))
    b = torch.func.vmap(lambda x: tb.measure(flat, x, 1.0))(tt(pts))
    _same_measure(a, b, atol=0)
    ref = jax.vmap(lambda x: jb.measure(jb.Bodies(jc, ["-", "+", "-"]), x,
                                        1.0))(jj(pts))
    _same_measure(a, ref)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_curvature(dtype):
    """maintests.jl:217-218, exact against JAX."""
    for A in (np.eye(2), np.array([[2., 1, 0], [1, 2, 1], [0, 1, 2]])):
        A = A.astype(dtype)
        got, ref = tb.curvature(tt(A)), jb.curvature(jj(A))
        for a, b in zip(got, ref):
            assert npy(a).dtype == dtype
            np.testing.assert_array_equal(npy(a), np.asarray(b))
    H, K = tb.curvature(tt(np.array([[2., 1, 0], [1, 2, 1], [0, 1, 2]])))
    assert float(H) == 3.0 and float(K) == 10.0


def test_measure_sdf():
    """maintests.jl:221-225 on the port, and the field against JAX's."""
    j1, _, t1, _ = _oracle_bodies()
    p = tb.measure_sdf(t1, (4, 5), dtype=torch.float64, device="cpu")
    I = (1, 2)  # reference CartesianIndex(2,3), 1-based
    x = loc_grid((4, 5), None, torch.float64)[I]
    assert float(p[I]) == float(t1.sdf(x, 0.0))
    assert p[0].abs().max() == 0 and p[:, -1].abs().max() == 0
    np.testing.assert_allclose(npy(p), np.asarray(
        jb.measure_sdf(j1, (4, 5), dtype=jnp.float64)), atol=1e-15)


def _boxes(dtype):
    """Three boxes (sdf max|x-c|-h: subtractions, abs and max only, so
    both packages round alike) as a union minus a box, on both packages."""
    spec = [((7.3, 6.1, 5.2), (3.1, 2.4, 2.7)),
            ((10.2, 6.6, 5.7), (2.2, 1.9, 2.3)),
            ((8.7, 7.35, 6.15), (1.3, 1.1, 1.45))]
    J = [jb.AutoBody(lambda x, t, c=c, h=h: jnp.max(
        jnp.abs(x - jnp.asarray(c, x.dtype)) - jnp.asarray(h, x.dtype)))
        for c, h in spec]
    T = [tb.AutoBody(lambda x, t, c=c, h=h: torch.max(
        torch.abs(x - torch.tensor(c, dtype=x.dtype))
        - torch.tensor(h, dtype=x.dtype))) for c, h in spec]
    return J, T


CSG_OPS = {"union-minus": lambda b: (b[0] + b[1]) - b[2],
           "intersect": lambda b: b[0].intersect(b[1]),
           "chain": lambda b: b[0] - b[2] + b[1],
           "neg": lambda b: -b[2]}


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("op", list(CSG_OPS))
def test_csg_exact(dtype, op):
    """CSG `sdf`, `measure` and `measure_sdf` bit for bit against JAX on
    bodies whose members both packages round alike."""
    J, T = _boxes(dtype)
    bj_, bt_ = CSG_OPS[op](J), CSG_OPS[op](T)
    S = (18, 14, 12)
    assert_exact(tb.measure_sdf(bt_, S, 0.3, TORCH[dtype], "cpu"),
                 jb.measure_sdf(bj_, S, 0.3, JAX[dtype]))
    pts = np.random.default_rng(2).uniform(1.0, 14.0, (200, 3)).astype(dtype)
    ref = jax.vmap(lambda x: jb.measure(bj_, x, 0.3, 9.0))(jj(pts))
    got = torch.func.vmap(lambda x: tb.measure(bt_, x, 0.3, 9.0))(tt(pts))
    for a, b in zip(got, ref):
        assert_exact(a, b)
    assert_exact(torch.func.vmap(lambda x: tb.sdf(bt_, x, 0.3))(tt(pts)),
                 jax.vmap(lambda x: jb.sdf(bj_, x, 0.3))(jj(pts)))


def _sphere_csg(dtype):
    """A union of two spheres minus a third, on both packages."""
    spec = [((7.0, 6.0, 5.0), 3.0), ((10.0, 6.5, 5.5), 2.5),
            ((8.5, 7.0, 6.0), 1.5)]
    J = [jb.AutoBody(lambda x, t, c=c, r=r: _norm2j(
        x - jnp.asarray(c, x.dtype)) - r) for c, r in spec]
    T = [tb.AutoBody(lambda x, t, c=c, r=r: _norm2t(
        x - torch.tensor(c, dtype=x.dtype)) - r) for c, r in spec]
    return (J[0] + J[1]) - J[2], (T[0] + T[1]) - T[2]


@pytest.mark.parametrize("dtype", [F32, F64])
def test_csg_fields(dtype):
    """A sphere CSG body through `measure_sdf` (within 1 ulp of the
    distance to the centre, |sdf| + r: PyTorch's CPU f64 sqrt is not
    correctly rounded, sqrt(4.75) gives 2.1794494717703365, and f32 XLA
    may contract the sum of squares), `measure_fields` (the tolerances of
    `test_measure_fields`), `band_box_shape` and the banded measurement
    (equal to the dense one)."""
    bj_, bt_ = _sphere_csg(dtype)
    S = (18, 14, 12)
    sd = npy(tb.measure_sdf(bt_, S, 0.0, TORCH[dtype], "cpu"))
    ref = np.asarray(jb.measure_sdf(bj_, S, 0.0, JAX[dtype]))
    ulp = np.spacing((np.abs(ref) + 3.0).astype(dtype))
    assert np.all(np.abs(sd - ref) <= ulp)
    outt = tb.measure_fields(bt_, S, 0.0, 1.0, dtype=TORCH[dtype],
                             device="cpu")
    outj = jb.measure_fields(bj_, S, 0.0, 1.0, dtype=JAX[dtype])
    atol = 1e-6 if dtype is F32 else 1e-12
    for a, b in zip(outt, outj):
        np.testing.assert_allclose(npy(a), npy(b), atol=atol)
    box = tb.band_box_shape(bt_, S, 0.0, 1.0, TORCH[dtype], max_frac=1.0,
                            device="cpu")
    assert box == jb.band_box_shape(bj_, S, 0.0, 1.0, JAX[dtype],
                                    max_frac=1.0)
    banded = tb.measure_fields_banded(bt_, S, 0.0, 1.0, (), False,
                                      TORCH[dtype], box, "cpu")
    for a, b in zip(banded[:4], outt):
        assert torch.equal(a, b)
