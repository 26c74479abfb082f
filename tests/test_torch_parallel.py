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
from _torch_dist_ranks import one_rank_world
from waterlily_tpu_torch.parallel.dist import ProcessMesh

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


def test_simulation_mesh_steps_sharded(monkeypatch, tmp_path):
    """``Simulation(mesh=...)`` steps through `shardmap_mom_step` (the
    narrow-band measurement kept, the dense blend) and matches the dense
    simulation; ``fixed_iters`` under the in-process mesh steps on the
    per-phase path, and a `ProcessMesh` steps it on the rank's blocks
    (the whole-step region), as the in-process mesh's block step does."""
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
    c = sphere_3d(64, 32, device="cpu", mesh=mesh, fixed_iters=2)
    assert not c._sharded and c.cfg.mesh is mesh
    c.step()
    assert len(calls) == 2 and c.pois_n == [[2, 2]]
    with one_rank_world(tmp_path):
        d = sphere_3d(64, 32, device="cpu", fixed_iters=2,
                      mesh=ProcessMesh((1, 1, 1), "cpu"))
        assert d._sharded
        d.step()
    assert len(calls) == 3 and d.pois_n == [[2, 2]]
    e = sphere_3d(64, 32, device="cpu", fixed_iters=2)
    twin, aux = real(e.cfg, mesh_for((66, 34, 34), 1, "cpu"), e.levels,
                     e.flow)
    assert aux["pois_n"] == [2, 2] and torch.equal(twin.u, d.flow.u)


# --- the standalone wrappers (tests/test_sharding.py:239, 287, 371, 799,
# 840) against JAX's on its 8-device mesh --------------------------------

def _jlev(L, perdir=()):
    from waterlily_tpu.ops.poisson import make_level as jmake
    return jmake(jj(L), perdir)


def _forms(cases):
    """Each case with the plain local forms, and the 3D ones also with the
    kernel forms (their plain versions on the CPU)."""
    return [c + (p,) for c in cases for p in ("off", "kernels")
            if p == "off" or len(c[0]) == 3]


@pytest.mark.parametrize("S,perdir,pallas", _forms([
    ((32, 32), ()), ((16, 32, 32), ()), ((32, 16, 16), (0,)),
    ((32, 16, 16), (0, 1, 2))]))
def test_shardmap_pcg_matches_jax(S, perdir, pallas):
    """`shardmap_pcg` (6 iterations from x = 0) against JAX's at the JAX
    tests' tolerance, 1e-6, and against the port's dense `pcg` (the same
    1e-6: the dots differ only in the order of the sum)."""
    from waterlily_tpu.parallel.shard_smooth import shardmap_pcg as jpcg
    from waterlily_tpu.ops.poisson import residual as jres
    from waterlily_tpu_torch.ops.poisson import make_level, pcg, residual
    from waterlily_tpu_torch.parallel.shard_smooth import shardmap_pcg
    L = (np.abs(normal(51, (len(S),) + S)) * 0.2 + 0.5).astype(np.float32)
    z = normal(52, S, scale=1e-2)
    jlev = _jlev(L, perdir)
    jr = jres(jlev, jnp.zeros(S, f32), jj(z))
    jx, jr2 = jax.jit(lambda l, x, r: jpcg(l, x, r))(
        jlev.replace(mesh=_jmesh(S), sharded=True), jnp.zeros(S, f32), jr)
    lev = make_level(tt(L), perdir)
    r = residual(lev, torch.zeros(S), tt(z))
    np.testing.assert_allclose(npy(r), np.asarray(jr), atol=1e-6, rtol=0)
    x, r2 = shardmap_pcg(mesh_for(S, 8, "cpu"), lev, torch.zeros(S), r,
                         pallas=pallas)
    np.testing.assert_allclose(npy(x), np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(npy(r2), np.asarray(jr2), atol=1e-6, rtol=0)
    xd, rd = pcg(lev, torch.zeros(S), r)
    np.testing.assert_allclose(npy(x), npy(xd), atol=1e-6, rtol=0)


@pytest.mark.parametrize("S,pallas", [(S, p) for S, p in _forms(
    [((32, 32),), ((16, 16, 32),)])])
def test_shardmap_increment_residual_match_jax(S, pallas):
    """`shardmap_residual` (a dead-cell block, the psum'd mean) and
    `shardmap_increment` against JAX's (1e-5 and 1e-6, the JAX tests')."""
    from waterlily_tpu.parallel.shard_smooth import (
        shardmap_residual as jres_s, shardmap_increment as jinc_s)
    from waterlily_tpu_torch.ops.poisson import make_level
    from waterlily_tpu_torch.parallel.shard_smooth import (
        shardmap_residual, shardmap_increment)
    D = len(S)
    L = (np.abs(normal(53, (D,) + S)) * 0.2 + 0.5).astype(np.float32)
    L[(0,) + tuple(slice(4, 8) for _ in range(D))] = 0.0
    x = normal(54, S)
    z = interior_only(normal(55, S))
    eps = interior_only(normal(56, S))
    jlev = _jlev(L).replace(mesh=_jmesh(S), sharded=True)
    jr = jax.jit(lambda l, x, z: jres_s(l, x, z))(jlev, jj(x), jj(z))
    jx1, jr1 = jax.jit(lambda l, x, r, e: jinc_s(l, x, r, e))(
        jlev, jj(x), jr, jj(eps))
    mesh = mesh_for(S, 8, "cpu")
    lev = make_level(tt(L))
    r = shardmap_residual(mesh, lev, tt(x), tt(z), pallas=pallas)
    np.testing.assert_allclose(npy(r), np.asarray(jr), atol=1e-5, rtol=0)
    x1, r1 = shardmap_increment(mesh, lev, tt(x), tt(np.asarray(jr)),
                                tt(eps), pallas=pallas)
    np.testing.assert_allclose(npy(x1), np.asarray(jx1), atol=1e-6, rtol=0)
    np.testing.assert_allclose(npy(r1), np.asarray(jr1), atol=1e-5, rtol=0)


@pytest.mark.parametrize("S,perdir,pallas", _forms([
    ((32, 32), ()), ((16, 16, 32), ()), ((32, 32), (0, 1)),
    ((16, 16, 32), (2,)), ((32, 16, 16), (0, 1, 2))]))
def test_shardmap_conv_diff_matches_jax(S, perdir, pallas):
    """`shardmap_conv_diff` (width-2 halos, modular wraps on periodic
    axes) against JAX's at its tests' 1e-5, the ghosts BC-filled as the
    step keeps them."""
    from waterlily_tpu.parallel.shard_smooth import shardmap_conv_diff as jcd
    from waterlily_tpu.ops.bc import bc_vector as jbcv
    from waterlily_tpu.ops.convect import quick as jquick
    from waterlily_tpu_torch.ops.convect import quick
    from waterlily_tpu_torch.parallel.shard_smooth import shardmap_conv_diff
    D = len(S)
    u = np.asarray(jbcv(jj(normal(57, (D,) + S)), (0.0,) * D, False,
                        perdir))
    ref = jax.jit(lambda u: jcd(_jmesh(S), u, 0.01, jquick,
                                perdir=perdir))(jj(u))
    out = shardmap_conv_diff(mesh_for(S, 8, "cpu"), tt(u), 0.01, quick,
                             pallas=pallas, perdir=perdir)
    np.testing.assert_allclose(npy(out), np.asarray(ref), atol=1e-5, rtol=0)


# --- JAX's per-phase region, shardmap_conv_bdim -----------------------------

BDIM_CASES = {
    "predictor": dict(scale=None),
    "corrector": dict(scale=0.5),
    "predictor bc": dict(scale=None, bc=True),
    "corrector bc": dict(scale=0.5, bc=True),
    "predictor bc exitBC": dict(scale=None, bc=True, exitBC=True),
    "corrector periodic": dict(scale=0.5, perdir=(0, 1, 2)),
}


@pytest.mark.parametrize("case", list(BDIM_CASES))
def test_shardmap_conv_bdim_matches_jax(case):
    """conv_diff + accelerate + the BDIM blend (+ the BCs after it) as one
    region over the blocks, against JAX's region on its mesh (1e-5, its
    conv tests' tolerance) and against the port's dense phases."""
    from waterlily_tpu.parallel.shard_step import shardmap_conv_bdim as jcb
    from waterlily_tpu.ops.bc import bc_vector as jbcv
    from waterlily_tpu_torch.parallel.shard_step import shardmap_conv_bdim
    kw = BDIM_CASES[case]
    scale, perdir = kw.get("scale"), kw.get("perdir", ())
    exitBC = kw.get("exitBC", False)
    S = (18, 18, 18)
    U = (1.0, 0.0, 0.0) if not perdir else (0.0, 0.0, 0.0)
    bc = U if kw.get("bc") else None
    u0 = np.asarray(jbcv(jj(normal(61, (3,) + S)), U, exitBC, perdir))
    u_in = np.asarray(jbcv(jj(normal(62, (3,) + S)), U, exitBC, perdir))
    V = normal(63, (3,) + S, scale=0.1)
    mu0 = (np.abs(normal(64, (3,) + S)) * 0.5 + 0.5).astype(np.float32)
    mu1 = normal(65, (3, 3) + S, scale=0.1)
    dt, t = 0.3, 0.7
    jcfg = JFlowConfig(D=3, S=S, U=U, nu=0.01, dtype=f32, perdir=perdir,
                       exitBC=exitBC, sharded=True, mesh=_jmesh(S))
    src = u0 if scale is None else u_in
    ref = jax.jit(lambda a, b, c, d, e: jcb(
        jcfg, a, b, c, d, e, dt, t, scale, bc=bc))(
        jj(src), jj(u0), jj(V), jj(mu0), jj(mu1))
    cfg = FlowConfig(D=3, S=S, U=U, nu=0.01, device="cpu",
                     dtype=torch.float32, perdir=perdir, exitBC=exitBC,
                     mesh=mesh_for(S, 8, "cpu"))
    for pallas in ("off", "kernels"):
        tu0 = tt(u0)
        out = shardmap_conv_bdim(cfg, tu0 if scale is None else tt(u_in),
                                 tu0, tt(V), tt(mu0), tt(mu1), dt, t, scale,
                                 pallas=pallas, bc=bc)
        np.testing.assert_allclose(npy(out), np.asarray(ref), atol=1e-5,
                                   rtol=0)


# --- log, fixed_iters and implicit_diff under the in-process mesh -----------

@pytest.mark.parametrize("flag", ["fixed_iters", "implicit_diff", "log"])
def test_per_phase_path_under_mesh(monkeypatch, flag):
    """``log``, ``fixed_iters`` and ``implicit_diff`` under a mesh step
    through `shardmap_conv_bdim` (twice a step; the whole-step region
    refused, as in JAX) and match the dense step (u 1e-5, p 1e-4, JAX's
    step tolerances; pois_n equal)."""
    from waterlily_tpu_torch import sphere_3d
    calls = []
    real = shard_step.shardmap_conv_bdim
    monkeypatch.setattr(shard_step, "shardmap_conv_bdim",
                        lambda *a, **k: calls.append(k.get("pallas"))
                        or real(*a, **k))
    kw = {"fixed_iters": dict(fixed_iters=2),
          "implicit_diff": dict(implicit_diff=True),
          "log": dict(log=True)}[flag]
    mesh = mesh_for((34, 18, 18), 8, "cpu")
    a = sphere_3d(32, 16, device="cpu", mesh=mesh, **kw)
    b = sphere_3d(32, 16, device="cpu", **kw)
    assert not a._sharded and a.cfg.mesh is mesh
    a.steps(2)
    b.steps(2)
    assert len(calls) == 4
    assert calls == (["off"] * 4 if flag == "implicit_diff" else [None] * 4)
    assert a.pois_n == b.pois_n
    np.testing.assert_allclose(npy(a.flow.u), npy(b.flow.u), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(npy(a.flow.p), npy(b.flow.p), atol=1e-4,
                               rtol=0)
    if flag == "log":
        assert len(a.res_log) == 2 and a.res_log[0].shape == b.res_log[0].shape


def test_fixed_iters_reverse_mode_under_mesh():
    """``fixed_iters`` under the mesh is differentiable in reverse mode
    through the region (the blocks' split and assembly): d(KE)/dν of one
    step equals the dense step's (rtol 1e-6, f64)."""
    from waterlily_tpu_torch.metrics import ke
    from waterlily_tpu_torch.ops.multigrid import build_levels
    from waterlily_tpu_torch.flow import flow_init

    def ke_after(nu, mesh):
        cfg = FlowConfig(D=3, S=(18, 18, 18), device="cpu", nu=nu,
                         U=(1.0, 0.0, 0.0), dtype=torch.float64,
                         fixed_iters=2, mesh=mesh)

        def ulam(i, x):
            return (1.0 + 0.05 * torch.sin(x[1] / 3)) if i == 0 \
                else torch.zeros_like(x[0])

        state = flow_init(cfg, ulam)
        state, _ = mom_step(cfg, build_levels(state.mu0), state)
        return torch.sum(ke(state.u))

    grads = []
    for mesh in (None, mesh_for((18, 18, 18), 8, "cpu")):
        nu = torch.tensor(0.01, dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(ke_after(nu, mesh), nu)
        grads.append(float(g))
    assert np.isfinite(grads[1]) and grads[1] != 0.0
    assert np.isclose(grads[0], grads[1], rtol=1e-6), grads


def test_implicit_diff_grad_under_mesh_matches_jax():
    """Port of tests/test_sharding.py:400: reverse mode through one
    periodic step with ``implicit_diff`` under the 8-shard mesh (the
    region on the blocks, the adjoint solve) against JAX's sharded
    gradient ``g8`` and the port's unsharded one (rtol 1e-6, f64)."""
    from waterlily_tpu.metrics import ke as jke
    from waterlily_tpu.parallel.mesh import (constrain_state,
                                             constrain_levels)
    from waterlily_tpu_torch.metrics import ke
    from waterlily_tpu_torch.ops.multigrid import build_levels
    from waterlily_tpu_torch.flow import flow_init
    jf64 = jnp.float64
    L = 16
    kappa = 2 * np.pi / L
    nu0 = 1.0 / (kappa * 100.0)
    S = (L + 2, L + 2)

    def jke_after(nu, mesh):
        cfg = JFlowConfig(D=2, S=S, nu=nu, U=(0.0, 0.0), perdir=(0, 1),
                          dtype=jf64, tol=1e-12, itmx=64, implicit_diff=True,
                          sharded=True, mesh=mesh)

        def ulam(i, x):
            return jnp.where(i == 0,
                             -jnp.sin(kappa * x[0]) * jnp.cos(kappa * x[1]),
                             jnp.cos(kappa * x[0]) * jnp.sin(kappa * x[1]))

        from waterlily_tpu.flow import mom_step as jstep
        state = jinit(cfg, ulam)
        levels = jbuild(state.mu0, cfg.perdir)
        state = constrain_state(state, mesh)
        levels = constrain_levels(levels, mesh)
        state, _aux = jstep(cfg, levels, state)
        return jnp.sum(jke(state.u))

    def ke_after(nu, mesh):
        cfg = FlowConfig(D=2, S=S, device="cpu", nu=nu, U=(0.0, 0.0),
                         perdir=(0, 1), dtype=torch.float64, tol=1e-12,
                         itmx=64, implicit_diff=True, mesh=mesh)

        def ulam(i, x):
            xs, ys = kappa * x[0], kappa * x[1]
            return (-torch.sin(xs) * torch.cos(ys) if i == 0
                    else torch.cos(xs) * torch.sin(ys))

        state = flow_init(cfg, ulam)
        state, _aux = mom_step(cfg, build_levels(state.mu0, cfg.perdir),
                               state)
        return torch.sum(ke(state.u))

    jm = jmesh_mod.mesh_for(S, 8)
    g8 = float(jax.jit(jax.grad(lambda nu: jke_after(nu, jm)))(
        jnp.asarray(nu0, jf64)))
    out = []
    for mesh in (mesh_for(S, 8, "cpu"), None):
        nu = torch.tensor(nu0, dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(ke_after(nu, mesh), nu)
        out.append(float(g))
    assert np.isfinite(out[0]) and abs(out[0]) > 1.0
    assert np.isclose(out[0], g8, rtol=1e-6), (out[0], g8)
    assert np.isclose(out[0], out[1], rtol=1e-6), out


# --- the sharded moving body (tests/test_sharding.py:721) -------------------

def test_sharded_moving_body_banded_measure(monkeypatch):
    """The heaving sphere on the in-process mesh, remeasured each step,
    routes through `measure_fields_banded` (a measure box, the dense
    blend: ``cfg.bbox_shape is None``) and matches the unsharded run and
    JAX's after 2 steps (u 2e-5, p 3e-3, dt rtol 1e-5: JAX's tolerances)."""
    from waterlily_tpu.models.cases import heaving_sphere_3d as jheave
    from waterlily_tpu_torch import simulation as sim_mod
    from waterlily_tpu_torch.models.cases import heaving_sphere_3d
    kw = dict(radius=12, amp=4, Re=100, bbox="force")
    ref = heaving_sphere_3d(device="cpu", **kw)
    assert ref.cfg.bbox_shape is not None
    ref.steps(2, remeasure=True)
    calls = []
    real = sim_mod.measure_fields_banded
    monkeypatch.setattr(sim_mod, "measure_fields_banded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    sim = heaving_sphere_3d(device="cpu", mesh=mesh_for((50,) * 3, 8, "cpu"),
                            **kw)
    assert sim.cfg.bbox_shape is None and sim._measure_box is not None
    sim.steps(2, remeasure=True)
    assert len(calls) >= 1 and sim._sharded
    jsim = jheave(dtype=f32, **kw)
    jsim.steps(2, remeasure=True)
    for other in (npy(ref.flow.u), np.asarray(jsim.flow.u)):
        np.testing.assert_allclose(npy(sim.flow.u), other, atol=2e-5, rtol=0)
    for other in (npy(ref.flow.p), np.asarray(jsim.flow.p)):
        np.testing.assert_allclose(npy(sim.flow.p), other, atol=3e-3, rtol=0)
    for other in (ref.dts[-1], float(jsim.flow.dt)):
        np.testing.assert_allclose(sim.dts[-1], other, rtol=1e-5)
