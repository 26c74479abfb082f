"""Port parity: the spatial decomposition (`waterlily_tpu_torch.parallel`)
against `waterlily_tpu.parallel` on the 8-device virtual CPU mesh.

The same numpy inputs go through JAX's shard_map functions and the port's
in-process mesh (a list of local blocks in row-major shard order; the
port's `ShardMesh.assemble` lays the blocks out as JAX's ``out_specs``
does).  Halo moves, the BC and the grid transfers are bit for bit; the
solve and the step hold JAX's tolerances (the psum'd dots differ in the
order of the sum).  The kernel-shaped forms (JAX ``"interpret"``, the
port's ``"kernels"``, whose shard-local kernels are their plain versions
on the CPU) are checked beside the plain local forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from waterlily_tpu.flow import FlowConfig as JFlowConfig, flow_init as jinit
from waterlily_tpu.ops.multigrid import build_levels as jbuild
from waterlily_tpu.parallel import mesh as jmesh_mod
from waterlily_tpu.parallel.halo import spatial_specs, get_shard_map
from waterlily_tpu_torch.convert import flow_from_numpy, levels_from_numpy
from waterlily_tpu_torch.flow import FlowConfig, mom_step
from waterlily_tpu_torch.parallel import halo, shard_solve, shard_step
from waterlily_tpu_torch.parallel.mesh import mesh_for

from _torch_parity import normal, interior_only, tt, jj, npy, assert_exact

f32 = jnp.float32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jmesh(S):
    return jmesh_mod.mesh_for(S, 8)


def _region(S, fn, D, lead_in=0, out="sc"):
    """JAX's ``fn`` of one local block under shard_map on ``S``'s mesh."""
    mesh = _jmesh(S)
    sc, vec = spatial_specs(mesh, D)
    spec_in = vec if lead_in else sc
    spec_out = {"sc": sc, "vec": vec, "rep": P()}[out]
    return jax.jit(get_shard_map()(fn, mesh=mesh, in_specs=(spec_in,),
                                   out_specs=spec_out, check_vma=False))


@pytest.mark.parametrize("S,n", [((258, 258, 258), 8), ((18, 18, 18), 8),
                                 ((34, 18, 18), 8), ((18, 10), 8),
                                 ((32, 32), 8), ((98, 66, 66), 4),
                                 ((66, 66, 66), 2), ((16, 32), 1)])
def test_mesh_for_matches_jax(S, n):
    jm = jmesh_mod.mesh_for(S, n)
    tm = mesh_for(S, n, "cpu")
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    # JAX maps the spatial mesh axes onto the grid's axes by position
    names = [a for a in jm.axis_names if a != "r"]
    assert tm.shards == tuple(jm.shape[names[d]] if d < len(names) else 1
                              for d in range(len(S)))


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("perdir", [(), (0, 2)])
def test_halo_exchange_matches_jax(width, perdir):
    from waterlily_tpu.parallel.halo import halo_exchange as jhalo
    S = (18, 10, 10)
    u = normal(31, (3,) + S)
    mesh = _jmesh(S)
    ref = _region(S, lambda u_l: jhalo(u_l, mesh, 3, width, perdir), 3,
                  lead_in=1, out="vec")(jj(u))
    tm = mesh_for(S, 8, "cpu")
    out = halo.halo_exchange(tm.split(tt(u), 1), tm, 3, width, perdir)
    assert_exact(tm.assemble(out, 1), ref)


@pytest.mark.parametrize("S,perdir", [((18, 10, 10), (0,)),
                                      ((18, 10, 10), (0, 2)),
                                      ((16, 32), (0, 1))])
def test_per_fill_local_matches_jax(S, perdir):
    from waterlily_tpu.parallel.halo import per_fill_local as jfill
    a = normal(32, S)
    mesh = _jmesh(S)
    ref = _region(S, lambda a_l: jfill(a_l, mesh, S, perdir), len(S))(jj(a))
    tm = mesh_for(S, 8, "cpu")
    out = halo.per_fill_local(tm.split(tt(a)), tm, S, perdir)
    assert_exact(tm.assemble(out), ref)


@pytest.mark.parametrize("S", [(18, 18, 18), (16, 32)])
def test_shardmap_mult_matches_jax(S):
    """A·x through the blocks (one halo round, the upper-face coefficient
    shifted in), against JAX's and the port's dense operator."""
    from waterlily_tpu.parallel.halo import shardmap_mult as jmult
    from waterlily_tpu_torch.ops.poisson import make_level, mult
    from _torch_parity import bc_coeffs
    D = len(S)
    L = bc_coeffs(37, S)
    lev = make_level(tt(L))
    x = normal(38, S)
    ref = jmult(_jmesh(S), jj(L), jj(npy(lev.D)), jj(x))
    out = halo.shardmap_mult(mesh_for(S, 8, "cpu"), tt(L), lev.D, tt(x))
    np.testing.assert_allclose(npy(out), np.asarray(ref), rtol=0,
                               atol=1e-6)
    assert_exact(out, mult(lev, tt(x)))


@pytest.mark.parametrize("S,save_exit", [((18, 10, 10), False),
                                         ((18, 10, 10), True),
                                         ((16, 32), False)])
def test_bc_vector_local_matches_jax(S, save_exit):
    """The select cascade and (3D) the bc3d shard-local form, both bit for
    bit JAX's cascade."""
    from waterlily_tpu.parallel.shard_step import bc_vector_local as jbc
    D = len(S)
    u = normal(33, (D,) + S)
    A = tuple(0.25 * i + 1.0 for i in range(D))
    mesh = _jmesh(S)
    ref = _region(S, lambda u_l: jbc(mesh, S, u_l, A, save_exit), D,
                  lead_in=1, out="vec")(jj(u))
    tm = mesh_for(S, 8, "cpu")
    for pallas in ("off", "kernels") if D == 3 else ("off",):
        out = shard_step.bc_vector_local(tm, S, tm.split(tt(u), 1), A,
                                         save_exit, pallas=pallas)
        assert_exact(tm.assemble(out, 1), ref)


@pytest.mark.parametrize("S", [(18, 18, 18), (34, 18, 18), (18, 10)])
def test_restrict_prolongate_match_jax(S):
    """The replicated restriction and the prolongation, bit for bit JAX's
    (and so the dense transfers')."""
    from waterlily_tpu.parallel.shard_solve import (
        restrict_replicated as jrestrict, prolongate_local as jprolong)
    from waterlily_tpu_torch.ops.multigrid import restrict, prolongate
    D = len(S)
    r = interior_only(normal(34, S))
    mesh = _jmesh(S)
    ref = _region(S, lambda r_l: jrestrict(mesh, S, r_l), D, out="rep")(
        jj(r))
    tm = mesh_for(S, 8, "cpu")
    rc = shard_solve.restrict_replicated(tm, S, tm.split(tt(r)))
    assert_exact(rc, ref)
    assert_exact(rc, restrict(tt(r)))
    xc = interior_only(normal(35, tuple(rc.shape)))
    sc, _vec = spatial_specs(mesh, D)
    pref = jax.jit(get_shard_map()(lambda x: jprolong(mesh, S, x), mesh=mesh,
                                   in_specs=(P(),), out_specs=sc,
                                   check_vma=False))(jj(xc))
    eps = tm.assemble(shard_solve.prolongate_local(tm, S, tt(xc)))
    assert_exact(eps, pref)
    assert_exact(eps, prolongate(tt(xc)))


def _levels_np(levels):
    return [{k: np.asarray(getattr(l, k)) for k in ("L", "D", "iD")}
            for l in levels]


def _state_np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def solve_case():
    """JAX's one-region solve at 18³ on the 8-device mesh, adaptive and
    with two fixed iterations."""
    from waterlily_tpu.flow import div as jdiv
    from waterlily_tpu.parallel.shard_solve import shardmap_ml_solve as jsolve
    cfg = JFlowConfig(D=3, S=(18, 18, 18), U=(1.0, 0.0, 0.0), nu=0.01,
                      dtype=f32)
    state = jinit(cfg)
    levels = jbuild(state.mu0)
    z = np.asarray(jax.jit(jdiv)(state.u))
    x0 = (0.25 * interior_only(normal(36, cfg.S))).astype(np.float32)
    mesh = _jmesh(cfg.S)
    levs = tuple(l.replace(mesh=mesh, sharded=True) for l in levels)
    run = lambda fixed: tuple(np.asarray(a) for a in jax.jit(
        lambda l, x, z: jsolve(l, x, z, fixed=fixed))(levs, jj(x0), jj(z)))
    return {"levels": _levels_np(levels), "x0": x0, "z": z,
            "ref": run(None), "fixed": run(2), "S": cfg.S}


@pytest.mark.parametrize("pallas", ["off", "kernels"])
def test_shardmap_ml_solve_matches_jax(solve_case, pallas):
    c = solve_case
    levels = levels_from_numpy(c["levels"], "cpu")
    tm = mesh_for(c["S"], 8, "cpu")
    x, r, n = shard_solve.shardmap_ml_solve(tm, levels, tt(c["x0"]),
                                            tt(c["z"]), pallas=pallas)
    xr, rr, nr = c["ref"]
    assert n == int(nr)
    np.testing.assert_allclose(npy(x), xr, atol=1e-5, rtol=0)
    np.testing.assert_allclose(npy(r), rr, atol=1e-5, rtol=0)
    x, r, n = shard_solve.shardmap_ml_solve(tm, levels, tt(c["x0"]),
                                            tt(c["z"]), fixed=2,
                                            pallas=pallas)
    assert n == 2 == int(c["fixed"][2])
    np.testing.assert_allclose(npy(x), c["fixed"][0], atol=1e-5, rtol=0)


def _ulam(kind):
    k = 2 * jnp.pi / 18

    def walls(i, x):
        return jnp.where(i == 0, 1.0 + 0.05 * jnp.sin(x[1] / 3), 0.0)

    def tgv(i, x):
        if i == 0:
            return jnp.sin(k * x[0]) * jnp.cos(k * x[1]) * jnp.cos(k * x[2])
        if i == 1:
            return -jnp.cos(k * x[0]) * jnp.sin(k * x[1]) * jnp.cos(k * x[2])
        return jnp.zeros_like(x[0])

    return tgv if kind == "periodic" else walls


STEP_CASES = {
    "walls": dict(U=(1.0, 0.0, 0.0), nu=0.01),
    "exitBC": dict(U=(1.0, 0.0, 0.0), nu=0.01, exitBC=True),
    "periodic": dict(U=(0.0, 0.0, 0.0), nu=0.005, perdir=(0, 1, 2)),
}
JAX_FORM = {"off": "off", "kernels": "interpret"}


@pytest.fixture(scope="module")
def step_refs():
    """JAX's one-region step (`shardmap_mom_step`, the region flag set as
    its own test sets it) on the 18³ configurations, cached per case and
    form."""
    from waterlily_tpu.parallel import shard_step as jstep
    cache = {}

    def get(kind, pallas):
        if (kind, pallas) in cache:
            return cache[kind, pallas]
        kw = STEP_CASES[kind]
        perdir = kw.get("perdir", ())
        cfg = JFlowConfig(D=3, S=(18, 18, 18), dtype=f32, **kw)
        state = jinit(cfg, _ulam(kind))
        levels = jbuild(state.mu0, perdir)
        mesh = _jmesh(cfg.S)
        old = (jmesh_mod.SHARDMAP_MIN_CELLS, jstep.WHOLE_STEP_REGION)
        try:
            jmesh_mod.SHARDMAP_MIN_CELLS = 0
            jstep.WHOLE_STEP_REGION = True
            levs = tuple(l.replace(mesh=mesh, sharded=True) for l in levels)
            scfg = cfg._replace(sharded=True)
            assert jstep.can_shard_step(scfg, levs)
            out, aux = jax.jit(lambda s, l: jstep.shardmap_mom_step(
                scfg, l, s, pallas=JAX_FORM[pallas]))(state, levs)
        finally:
            jmesh_mod.SHARDMAP_MIN_CELLS, jstep.WHOLE_STEP_REGION = old
        cache[kind, pallas] = (_state_np(state), _levels_np(levels),
                               _state_np(out),
                               [int(n) for n in aux["pois_n"]])
        return cache[kind, pallas]

    return get


@pytest.mark.parametrize("pallas", ["off", "kernels"])
@pytest.mark.parametrize("kind", ["walls", "exitBC", "periodic"])
def test_shardmap_mom_step_matches_jax(step_refs, kind, pallas):
    """The port's sharded step against JAX's on the 8-device mesh (JAX's
    tolerances: u 1e-5, p 1e-4, dt rtol 1e-6, pois_n equal), and against
    the port's own dense step."""
    state_np, levels_np, ref, pois = step_refs(kind, pallas)
    kw = STEP_CASES[kind]
    perdir = kw.get("perdir", ())
    cfg = FlowConfig(D=3, S=(18, 18, 18), device="cpu", dtype=torch.float32,
                     **kw)
    state = flow_from_numpy(state_np, "cpu")
    levels = levels_from_numpy(levels_np, "cpu", perdir)
    tm = mesh_for(cfg.S, 8, "cpu")
    assert shard_step.can_shard_step(cfg, tm, levels)
    out, aux = shard_step.shardmap_mom_step(cfg, tm, levels, state,
                                            pallas=pallas)
    assert aux["pois_n"] == pois
    np.testing.assert_allclose(npy(out.u), ref["u"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(npy(out.p), ref["p"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(out.dt), float(ref["dt"]), rtol=1e-6)
    assert float(out.t) == float(ref["t"])
    dense, daux = mom_step(cfg, levels, state)
    assert daux["pois_n"] == aux["pois_n"]
    np.testing.assert_allclose(npy(out.u), npy(dense.u), atol=1e-5, rtol=0)
    np.testing.assert_allclose(npy(out.p), npy(dense.p), atol=1e-4, rtol=0)


def test_simulation_mesh_steps_sharded(monkeypatch):
    """``Simulation(mesh=...)`` steps through `shardmap_mom_step` (the
    narrow-band measurement kept, the dense blend) and matches the dense
    simulation; ``fixed_iters`` under a mesh is refused."""
    from waterlily_tpu_torch import sphere_3d
    calls = []
    real = shard_step.shardmap_mom_step
    monkeypatch.setattr(shard_step, "shardmap_mom_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    mesh = mesh_for((66, 34, 34), 8, "cpu")
    a = sphere_3d(64, 32, bbox="force", device="cpu", mesh=mesh)
    b = sphere_3d(64, 32, bbox="force", device="cpu")
    assert a.cfg.bbox_shape is None and b.cfg.bbox_shape is not None
    assert torch.equal(a.flow.mu0, b.flow.mu0)
    a.steps(2)
    b.steps(2)
    assert len(calls) == 2
    assert a.pois_n == b.pois_n
    np.testing.assert_allclose(npy(a.flow.u), npy(b.flow.u), atol=1e-5,
                               rtol=0)
    with pytest.raises(NotImplementedError, match="A19"):
        sphere_3d(64, 32, device="cpu", mesh=mesh, fixed_iters=2)
