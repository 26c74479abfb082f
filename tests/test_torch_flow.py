"""Port parity: divergence, projection, CFL, BDIM and the momentum step
(torch vs JAX, and the kernels' plain versions vs the Pallas kernels in
interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import flow as jf
from waterlily_tpu.grid import pad_interior as jpad
from waterlily_tpu.ops import poisson as jp
from waterlily_tpu.ops.multigrid import build_levels as jbuild
from waterlily_tpu.ops.pallas_stencil import (div3d_pallas, project3d_pallas,
                                              cfl3d_pallas)
from waterlily_tpu_torch import flow as tf
from waterlily_tpu_torch.ops import stencil_kernels as sk
from waterlily_tpu_torch.convert import flow_from_numpy, levels_from_numpy

from _torch_parity import (F32, F64, STENCIL_RTOL, normal, uniform, tt, jj,
                           npy, assert_exact, assert_rel, bc_coeffs)

S3 = (14, 12, 10)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_div3d_plain_vs_jax(dtype):
    u = normal(1, (3,) + S3, dtype)
    p = normal(2, S3, dtype)
    dt = dtype(0.42)
    z, x = sk.div3d(tt(u), tt(p), torch.tensor(dt))
    assert_exact(z, jf.div(jj(u)))
    assert_exact(x, jj(p) * jnp.asarray(dt))


@pytest.mark.parametrize("S", [(14, 12, 10), (13, 10, 12)])
def test_div3d_plain_vs_pallas(S):
    u = normal(3, (3,) + S)
    p = normal(4, S)
    dt = np.float32(0.42)
    zj, xj = div3d_pallas(jj(u), jj(p), jnp.asarray(dt), interpret=True,
                          block=2)
    z, x = sk.div3d(tt(u), tt(p), torch.tensor(dt))
    assert_exact(z, zj)
    assert_exact(x, xj)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_project3d_plain_vs_jax(dtype):
    L = bc_coeffs(5, S3, dtype)
    x = normal(6, S3, dtype)
    u = normal(7, (3,) + S3, dtype)
    dt = dtype(0.37)
    lj = jp.make_level(jj(L), bf16_eps=False)
    uj = jj(u) - jpad(jp.pressure_grad_interior(lj, jj(x)), lead=1)
    ut, pt = sk.project3d(tt(L), tt(x), tt(u), torch.tensor(dt))
    assert_exact(ut, uj)
    assert_exact(pt, jj(x) / jnp.asarray(dt))


@pytest.mark.parametrize("S", [(14, 12, 10), (13, 10, 12)])
def test_project3d_plain_vs_pallas(S):
    L = bc_coeffs(8, S)
    x = normal(9, S)
    u = normal(10, (3,) + S)
    dt = np.float32(0.37)
    uj, pj = project3d_pallas(jj(L), jj(x), jj(u), jnp.asarray(dt),
                              interpret=True, block=1)
    ut, pt = sk.project3d(tt(L), tt(x), tt(u), torch.tensor(dt))
    assert_rel(ut, uj, 1e-6)   # the Pallas kernel may contract an FMA
    assert_exact(pt, pj)
    assert_exact(ut[:, 0], uj[:, 0])


@pytest.mark.parametrize("dtype", [F32, F64])
def test_cfl_bitwise(dtype):
    u = normal(11, (3,) + S3, dtype)
    assert float(tf.cfl(tt(u), 0.04)) == float(jf.cfl(jj(u), 0.04))
    assert_exact(sk.cfl3d(tt(u)), tf.cfl_flux_max(tt(u)))


# the kernel's ragged cases: an axis 0 of one and two interior planes,
# axes 1 and 2 off its (8, 32) column tiles
MARCH_RAGGED = [(3, 37, 70), (4, 9, 40), (37, 29, 35), (21, 10, 99)]


@pytest.mark.parametrize("S", [(18, 34, 34), (13, 10, 12)] + MARCH_RAGGED)
def test_cfl3d_plain_vs_pallas(S):
    u = normal(12, (3,) + S)
    assert_exact(sk.cfl3d(tt(u)), cfl3d_pallas(jj(u), S, interpret=True,
                                               block=4))


@pytest.mark.parametrize("S", MARCH_RAGGED)
def test_cfl3d_nan_plain_vs_pallas(S):
    """A NaN in an interior cell comes out of both; one in a ghost cell no
    interior term reads (u₀ on the plane i = 0) is ignored by both."""
    u = normal(13, (3,) + S)
    u[0, 0, 1, 1] = np.nan
    got = sk.cfl3d(tt(u))
    assert bool(torch.isfinite(got))
    assert_exact(got, cfl3d_pallas(jj(u), S, interpret=True, block=4))
    u[1, S[0] // 2, S[1] // 2, S[2] // 2] = np.nan
    assert bool(torch.isnan(sk.cfl3d(tt(u))))
    assert bool(jnp.isnan(cfl3d_pallas(jj(u), S, interpret=True, block=4)))


# (shape, planes a chunk, blocks) of the marches' rule with (8, 32) tiles:
# the path shapes (fine 256³ and its levels, the dense slice, the heaving
# sphere, the banded 48³ check) and the ragged ones
MARCH_GRIDS = [((258, 258, 258), 64, 1024), ((130, 130, 130), 16, 512),
               ((66, 66, 66), 4, 256), ((98, 66, 66), 4, 384),
               ((98, 98, 98), 7, 504), ((50, 50, 50), 4, 144),
               ((67, 130, 130), 9, 512), ((3, 37, 70), 1, 15),
               ((4, 9, 40), 2, 2), ((37, 29, 35), 4, 72)]


@pytest.mark.parametrize("S, planes, blocks", MARCH_GRIDS)
def test_march_planes_rule(S, planes, blocks):
    """`cfl3d` and `ana_mult3d` march chunks of 4 to 64 interior planes
    (fewer where axis 0 has fewer): as many chunks as a grid of 512 blocks
    needs, balanced over axis 0's interior, which they tile (the last one
    possibly shorter)."""
    tile = (8, 32)
    assert sk.march_planes(S, tile) == planes
    assert sk.march_blocks(S, planes, tile) == blocks
    n, lo, hi = S[0] - 2, *sk.MARCH_PLANES
    chunks = -(-n // planes)
    assert min(lo, n) <= planes <= hi
    assert (chunks - 1) * planes < n <= chunks * planes


def test_march_shapes_refuse():
    """The marches need an interior on every axis: the wrappers refuse a
    shape without one before they reach the card."""
    with pytest.raises(ValueError, match="at least 3"):
        sk._march("cfl3d", (2, 40, 40), "cpu", False)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_bdim(dtype):
    args = [normal(13 + k, (3,) + S3, dtype) for k in range(4)]
    mu0 = uniform(17, (3,) + S3, dtype=dtype)
    mu1 = normal(18, (3, 3) + S3, dtype, 0.1)
    dt = dtype(0.3)
    ref = jf.bdim(*[jj(a) for a in args], jj(mu0), jj(mu1), jnp.asarray(dt))
    got = tf.bdim(*[tt(a) for a in args], tt(mu0), tt(mu1), torch.tensor(dt))
    assert_rel(got, ref, STENCIL_RTOL[dtype])


def _configs(dtype):
    S = (18, 14, 10)
    jc = jf.FlowConfig(D=3, S=S, nu=0.02, U=(1.0, 0.0, 0.0),
                       dtype=jnp.float32 if dtype is F32 else jnp.float64)
    tcfg = tf.FlowConfig(D=3, S=S, device=torch.device("cpu"), nu=0.02,
                         U=(1.0, 0.0, 0.0),
                         dtype=torch.float32 if dtype is F32 else torch.float64)
    return S, jc, tcfg


@pytest.mark.parametrize("dtype", [F32, F64])
def test_flow_init(dtype):
    S, jc, tcfg = _configs(dtype)
    sj = jf.flow_init(jc)
    st = tf.flow_init(tcfg)
    for k in ("u", "p", "V", "mu0", "mu1", "dt", "t"):
        assert_exact(getattr(st, k), getattr(sj, k))


@pytest.mark.parametrize("dtype", [F32, F64])
def test_mom_step_from_one_state(dtype):
    """One predictor/corrector step of both packages from the same
    perturbed state with a body-like μ₀ (converted through `convert`)."""
    S, jc, tcfg = _configs(dtype)
    sj = jf.flow_init(jc)
    u = np.asarray(sj.u) + normal(19, (3,) + S, dtype, 0.1)
    mu0 = np.asarray(jf.bc_vector(jj(uniform(20, (3,) + S, 0.2, 1.0, dtype)),
                                  (0.0,) * 3))
    sj = sj._replace(u=jj(u), mu0=jj(mu0))
    levj = jbuild(sj.mu0, bf16_eps=False)
    st = flow_from_numpy({k: np.asarray(v) for k, v in sj._asdict().items()},
                         "cpu")
    levt = levels_from_numpy([{"L": np.asarray(l.L), "D": np.asarray(l.D),
                               "iD": np.asarray(l.iD)} for l in levj], "cpu")
    nj, auxj = jf.mom_step(jc, levj, sj)
    nt, auxt = tf.mom_step(tcfg, levt, st)
    assert [int(v) for v in auxj["pois_n"]] == auxt["pois_n"]
    assert_rel(nt.dt, nj.dt, 1e-5 if dtype is F32 else 1e-10)
    atol = 1e-4 if dtype is F32 else 1e-9
    np.testing.assert_allclose(npy(nt.u), npy(nj.u), atol=atol)
    np.testing.assert_allclose(npy(nt.p), npy(nj.p), atol=atol)
    # the step never writes into the state it was given
    assert np.array_equal(npy(st.u), u)


@pytest.mark.parametrize("form", [{}, {"perdir": (1,)}, {"exitBC": True}])
def test_mom_step_inplace_bc_leaves_state(form, monkeypatch):
    """The step's in-place boundary fills write only fields the step made:
    ``state.u``, ``V`` and ``μ₀`` come back unchanged, and the step equals
    one whose fills all copy (walls, a periodic axis, the outlet)."""
    from waterlily_tpu_torch.ops.multigrid import build_levels
    torch.set_num_threads(1)
    S = (18, 14, 10)
    cfg = tf.FlowConfig(D=3, S=S, device=torch.device("cpu"), nu=0.02,
                        U=(1.0, 0.0, 0.0), dtype=torch.float32, **form)
    st = tf.flow_init(cfg)
    V = tf.bc_vector(tt(normal(21, (3,) + S, F32, 0.1)), (0.0,) * 3,
                     cfg.exitBC, cfg.perdir)
    mu0 = tf.bc_vector(tt(uniform(20, (3,) + S, 0.2, 1.0, F32)), (0.0,) * 3,
                       False, cfg.perdir)
    st = st.replace(u=st.u + tt(normal(19, (3,) + S, F32, 0.1)), V=V,
                    mu0=mu0)
    levels = build_levels(st.mu0, cfg.perdir)
    before = {k: getattr(st, k).clone() for k in ("u", "V", "mu0")}
    new, aux = tf.mom_step(cfg, levels, st)
    for k, v in before.items():
        assert torch.equal(getattr(st, k), v), k
    copying = tf.bc_vector
    monkeypatch.setattr(tf, "bc_vector", lambda *a, inplace=False, **kw:
                        copying(*a, **kw))
    ref, aux_ref = tf.mom_step(cfg, levels, st)
    assert aux["pois_n"] == aux_ref["pois_n"]
    assert_exact(new.u, npy(ref.u))
    assert_exact(new.p, npy(ref.p))


@pytest.mark.parametrize("component", ["number", "tensor"])
def test_bc_tuple_on_the_device_of_t(component):
    """A callable ``U``'s components are 0-d tensors on the device of the
    time ``t`` (``meta`` standing in for the card), whether a component is
    a number (the reference's ``zero(T)``) or a tensor on another device,
    so that `bc3d` takes them (`stencil_kernels._vector_on` raised for a
    CPU component on the card); ``accelerate`` adds dU/dt there too.  On
    the CPU the values are JAX's; a constant ``U`` stays numbers."""
    from waterlily_tpu_torch.ops.convect import accelerate
    other = 0.5 if component == "number" else torch.tensor(0.5)
    U = lambda i, t: t if i == 0 else other * (i - 1)
    t = torch.full((), 0.25, device="meta")
    got = tf.bc_tuple(U, t, 3, torch.float32)
    assert got[0] is t
    for v in got:
        assert isinstance(v, torch.Tensor) and v.shape == ()
        assert v.device == t.device and v.dtype == torch.float32
    like = torch.empty((3, 5, 5, 5), device="meta")
    assert sk._vector_on(got, like, "bc3d").shape == (3,)
    assert accelerate(like, t, None, U, torch.float32).device == t.device
    ref = jf.bc_tuple(lambda i, t: t if i == 0 else 0.5 * (i - 1), 0.25, 3,
                      jnp.float64)
    cpu = tf.bc_tuple(U, torch.tensor(0.25, dtype=torch.float64), 3,
                      torch.float64)
    assert [float(v) for v in cpu] == [float(v) for v in ref]
    assert tf.bc_tuple((1, 0, 0), t, 3, torch.float32) == (1.0, 0.0, 0.0)


def test_times_case_spec():
    """`kernels.times` takes a case's keyword flags as Python literals, so
    a configuration such as the banded-levels sphere can be timed against
    another checkout."""
    from waterlily_tpu_torch.kernels.times import case_spec
    assert case_spec("case:sphere_3d:256,256:banded_levels=True") == (
        "sphere_3d", (256, 256), {"banded_levels": True},
        "sphere_3d(256,256, banded_levels=True)")
    assert case_spec("case:tgv_2d:64") == ("tgv_2d", (64,), {}, "tgv_2d(64)")


@pytest.mark.parametrize("flags", ["", ":op_bf16=True"])
def test_times_twin_spec(flags):
    """`kernels.times`' ``twin:`` spec steps a case and its CPU twin from
    one state (here both on the CPU, so they agree exactly), the CPU
    levels keeping their shadows under ``op_bf16``."""
    from waterlily_tpu_torch.kernels.times import _twin
    torch.set_num_threads(1)
    row = _twin("twin:sphere_3d:24,16" + flags, torch.device("cpu"))
    assert row["pois_n"] == row["cpu_pois_n"] and len(row["pois_n"]) == 3
    assert row["dt_rel"] == 0.0
