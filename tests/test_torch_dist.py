"""The decomposition over processes (`waterlily_tpu_torch.parallel.dist`)
against the in-process mesh, bit for bit, on the CPU.

One gloo world of 8 CPU ranks (`parallel.launch.run_ranks`, one thread a
rank) runs every case of `_torch_dist_ranks.run_cases` once for the
module; the parent (one thread too: a CPU reduction's order depends on
the thread count) runs the same cases on the in-process `ShardMesh` and
compares: the collectives, the halo exchange, the standalone wrappers,
three steps of the small sphere, its outlet form and ``tgv_3d(32)`` (u, p,
dt and every pois_n), the per-rank checkpoint's restart and assembly, a
replica mesh, the heaving sphere remeasured every step, and autograd
across ranks: a small sphere's drag differentiated in ν and its radius
with ``implicit_diff`` and ``fixed_iters`` (every rank's gradient alike
bit for bit, against the in-process block step) and its ``log`` traces.
Through the in-process mesh's own tests (`tests/test_torch_parallel.py`,
`tests/test_torch_grad_ranks.py`) the process mesh is tied to JAX.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import _torch_dist_ranks as R
from waterlily_tpu_torch.parallel import halo
from waterlily_tpu_torch.parallel.launch import run_ranks
from waterlily_tpu_torch.parallel.mesh import mesh_for

WORLD = 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of `run_cases`, and the world's directory."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    t0 = time.perf_counter()
    res = run_ranks(R.run_cases, WORLD, "gloo", "cpu", timeout=240.0,
                    args=(tmp,))
    return {"ranks": res, "tmp": tmp, "seconds": time.perf_counter() - t0}


def _eq(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _joined(mesh, blocks, lead):
    return mesh.assemble([torch.from_numpy(b) for b in blocks], lead)


def test_world_ran_every_rank(world):
    assert [r["rank"] for r in world["ranks"]] == list(range(WORLD))
    for r in world["ranks"]:
        assert r["stats"]["calls"] > 0 and r["stats"]["halo_bytes"] > 0


def test_collectives_match_shard_mesh(world):
    """psum (gathered, summed from shard 0), pmax, the gather and the
    ppermutes of every axis, bit for bit the in-process mesh's; a rank
    that receives nothing gets None."""
    mesh = mesh_for(R.COLLECTIVE_S, WORLD, "cpu")
    vals = [R.shard_value(s) for s in range(mesh.size)]
    psum, pmax = mesh.psum(vals), mesh.pmax(vals)
    for s, r in enumerate(world["ranks"]):
        c = r["collectives"]
        assert _eq(c["psum"], psum) and _eq(c["pmax"], pmax)
        assert all(_eq(a, b) for a, b in zip(c["gather"], vals))
        for d in range(3):
            k = mesh.k(d)
            ref = mesh.ppermute(vals, d, [(i, (i + 1) % k) for i in range(k)])
            assert _eq(c[f"ppermute{d}"], ref[s])
            ref = mesh.ppermute(vals, d, [(k - 1, 0)])
            assert (c[f"wrap{d}"] is None) == (ref[s] is None)
            if ref[s] is not None:
                assert _eq(c[f"wrap{d}"], ref[s])


@pytest.mark.parametrize("width,perdir", R.HALO_CASES)
def test_halo_exchange_matches_shard_mesh(world, width, perdir):
    mesh = mesh_for(R.COLLECTIVE_S, WORLD, "cpu")
    u = R.global_field(31, (3,) + R.COLLECTIVE_S)
    ref = halo.halo_exchange(mesh.split(u, 1), mesh, 3, width, perdir)
    for s, r in enumerate(world["ranks"]):
        assert _eq(r["halo"][width, perdir], ref[s])


def test_standalone_wrappers_match_shard_mesh(world):
    """`shardmap_residual`, `shardmap_pcg`, `shardmap_increment` and
    `shardmap_conv_diff` on the process mesh: every rank gets the global
    arrays, bit for bit the in-process mesh's."""
    ref = R.wrappers(mesh_for(R.WRAPPER_S, WORLD, "cpu"))
    for r in world["ranks"]:
        assert all(_eq(a, b) for a, b in zip(r["wrappers"], ref))


@pytest.fixture(scope="module")
def in_process(tmp_path_factory):
    """Each step case on the in-process mesh: the sim after 3 steps, and
    the sphere's single-file checkpoint after 2."""
    from waterlily_tpu_torch.io import save_checkpoint
    out = {"single": str(tmp_path_factory.mktemp("single") / "single.npz")}
    for kind in R.STEP_CASES:
        mesh = mesh_for(R.case_shape(kind), WORLD, "cpu")
        sim = R.make_case(kind, "cpu", mesh)
        if kind == "sphere":
            sim.steps(2)
            save_checkpoint(out["single"], sim)
            sim.steps(1)
        else:
            sim.steps(R.STEPS)
        out[kind] = sim
    return out


@pytest.mark.parametrize("kind", list(R.STEP_CASES))
def test_simulation_steps_match_in_process_mesh(world, in_process, kind):
    """``Simulation(mesh=ProcessMesh)`` (the whole-step region on the
    rank's blocks): 3 steps bit for bit the in-process mesh's (u, p, dt,
    every pois_n); `global_flow` assembles u on every rank."""
    ref = in_process[kind]
    ranks = [r["steps"][kind] for r in world["ranks"]]
    mesh = ref.mesh
    assert all(r["sharded"] for r in ranks) and ref._sharded
    assert ranks[0]["mesh"].startswith("ProcessMesh(shards=(2, 2, 2)")
    assert _eq(_joined(mesh, [r["u"] for r in ranks], 1), ref.flow.u)
    assert _eq(_joined(mesh, [r["p"] for r in ranks], 0), ref.flow.p)
    assert _eq(ranks[0]["global_u"], ref.flow.u)
    for r in ranks:
        assert r["dts"] == ref.dts and r["pois_n"] == ref.pois_n


def test_per_rank_checkpoint_round_trip(world, in_process):
    """A per-rank checkpoint after 2 steps, restarted in a fresh sim and
    stepped once, equals the uninterrupted run bit for bit; its assembled
    single file equals the in-process mesh's checkpoint key by key."""
    from waterlily_tpu_torch.io import assemble_checkpoint, load_checkpoint
    for r in world["ranks"]:
        a, b = r["restart"], r["steps"]["sphere"]
        assert _eq(a["u"], b["u"]) and _eq(a["p"], b["p"])
        assert a["dts"] == b["dts"] and a["pois_n"] == b["pois_n"]
    out = os.path.join(world["tmp"], "assembled.npz")
    assemble_checkpoint(os.path.join(world["tmp"], "ckpt"), out)
    got = load_checkpoint(out)
    ref = load_checkpoint(in_process["single"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert _eq(got[k], ref[k]), k


def test_restart_refuses_another_grid(world):
    """On each rank the tgv sim, given the sphere's per-rank files, raises
    `ValueError` before anything is restored."""
    for r in world["ranks"]:
        msg, untouched = r["restart_refused"]
        assert "checkpoint grid (34, 18, 18)" in msg and untouched


@pytest.fixture(scope="module")
def grad_twin():
    """Each mode of `_torch_dist_ranks.GRAD_MODES` on the in-process
    mesh's block step (`shardmap_mom_step` on `mesh_for`), from the dense
    Simulation's state and levels: the state, histories, traces and (the
    reverse modes) the drag and its gradient; and the run without a
    mode."""
    from waterlily_tpu_torch.parallel.shard_step import shardmap_mom_step
    mesh = mesh_for(R.GRAD_S, WORLD, "cpu")
    out = {}
    for mode in list(R.GRAD_MODES) + [None]:
        reverse = mode in ("implicit_diff", "fixed_iters")
        nu, radius = R.grad_leaves(reverse)
        sim = R.grad_sim("cpu", None, nu, radius, mode or "log")
        cfg = sim.cfg if mode else dataclasses.replace(sim.cfg, log=False)
        state, pois, dts, traces = sim.flow, [], [float(sim.flow.dt)], []
        for _ in range(R.GRAD_STEPS):
            state, aux = shardmap_mom_step(cfg, mesh, sim.levels, state)
            pois.append(aux["pois_n"])
            dts.append(float(aux["dt"].detach()))
            if cfg.log:
                traces.append(aux["res_trace"].numpy())
        res = {"u": state.u, "p": state.p, "pois_n": pois, "dts": dts,
               "res_log": traces}
        if reverse:
            d = R.drag(sim, state)
            res["drag"] = float(d.detach())
            res["grad"] = [float(g) for g in torch.autograd.grad(
                d, (nu, radius))]
        out[mode] = res
    return out


@pytest.mark.parametrize("mode", list(R.GRAD_MODES))
def test_process_mesh_steps_every_mode(world, grad_twin, mode):
    """``Simulation(mesh=ProcessMesh)`` with ``implicit_diff``,
    ``fixed_iters=2`` or ``log`` steps on the rank's blocks (no
    per-phase path to refuse): u, p, dt and every pois_n bit for bit the
    in-process block step's; under ``log`` each rank's ``res_log`` is
    the block step's traces bit for bit, alike on every rank, with
    pois_n + 1 non-zero rows a solve, and u, p, dt, pois_n bit for bit
    the run without it."""
    ref = grad_twin[mode]
    ranks = [r["grad"][mode] for r in world["ranks"]]
    mesh = mesh_for(R.GRAD_S, WORLD, "cpu")
    assert all(r["sharded"] for r in ranks)
    assert _eq(_joined(mesh, [r["u"] for r in ranks], 1), ref["u"])
    assert _eq(_joined(mesh, [r["p"] for r in ranks], 0), ref["p"])
    for r in ranks:
        assert r["dts"] == ref["dts"] and r["pois_n"] == ref["pois_n"]
    if mode != "log":
        assert all(r["res_log"] == [] for r in ranks)
        return
    plain = grad_twin[None]
    assert _eq(ref["u"], plain["u"]) and _eq(ref["p"], plain["p"])
    assert ref["dts"] == plain["dts"] and ref["pois_n"] == plain["pois_n"]
    for r in ranks:
        assert len(r["res_log"]) == R.GRAD_STEPS
        for got, want, pois in zip(r["res_log"], ref["res_log"],
                                   ref["pois_n"]):
            assert _eq(got, want) and got.shape == (2, 33, 2)
            assert [int(np.any(t != 0, axis=1).sum()) for t in got] == [
                n + 1 for n in pois]


@pytest.mark.parametrize("mode", ["implicit_diff", "fixed_iters"])
def test_process_mesh_gradient_across_ranks(world, grad_twin, mode):
    """The drag of `global_flow` after 2 steps, differentiated on every
    rank alike: each rank's d/dν and d/dradius are bit for bit the same
    on all ranks (no factor of the world size) and within rtol 1e-12 of
    the in-process block step's; the drag equal; the implicit adjoint
    solves recorded on every rank."""
    ref = grad_twin[mode]
    ranks = [r["grad"][mode] for r in world["ranks"]]
    assert all(r["grad"] == ranks[0]["grad"] for r in ranks)
    assert all(r["drag"] == ref["drag"] for r in ranks)
    assert all(np.isfinite(g) and g != 0.0 for g in ref["grad"])
    np.testing.assert_allclose(ranks[0]["grad"], ref["grad"], rtol=1e-12,
                               atol=0)
    for r in ranks:
        assert r["stats"]["bwd_calls"] > 0 and r["stats"]["bwd_halo_bytes"] > 0
        assert (len(r["adjoint_n"]) == 2 * R.GRAD_STEPS) == (
            mode == "implicit_diff")
        assert r["adjoint_n"] == ranks[0]["adjoint_n"]


def test_replica_mesh_matches_single(world):
    """JAX's replica-axis case (tests/test_sharding.py:154) on 8 ranks:
    (2, 2) shards x 2 replicas; both replicas give the in-process replica
    mesh's step bit for bit, and the dense step within JAX's 1e-5."""
    from waterlily_tpu_torch.flow import mom_step
    from waterlily_tpu_torch.parallel.shard_step import shardmap_mom_step
    cfg, state, levels = R.replica_case("cpu")
    mesh = mesh_for(R.REPLICA_S, WORLD, "cpu")
    assert mesh.replicas == 2 and "r" in mesh.axis_names
    ref, aux = shardmap_mom_step(cfg, mesh, levels, state)
    dense, _ = mom_step(cfg, levels, state)
    rows = world["ranks"]
    assert [(r["replica"]["replica"], r["replica"]["shard"]) for r in rows] \
        == [(r // mesh.size, r % mesh.size) for r in range(WORLD)]
    for rep in range(2):
        part = [r["replica"] for r in rows[rep * mesh.size:
                                           (rep + 1) * mesh.size]]
        u = _joined(mesh, [p["u"] for p in part], 1)
        assert _eq(u, ref.u)
        assert _eq(_joined(mesh, [p["p"] for p in part], 0), ref.p)
        assert all(p["pois_n"] == aux["pois_n"] for p in part)
        assert all(p["dt"] == float(aux["dt"]) for p in part)
        np.testing.assert_allclose(u.numpy(), dense.u.numpy(), atol=1e-5,
                                   rtol=0)


def test_moving_body_matches_in_process_and_dense(world):
    """JAX's sharded moving body (tests/test_sharding.py:721) on the
    process mesh: the narrow-band remeasure (measure_fields_banded) every
    step, a measure box with a dense blend; bit for bit the in-process
    mesh's two steps, and the unsharded run within JAX's tolerances (u
    2e-5, p 3e-3, dt rtol 1e-5)."""
    from waterlily_tpu_torch.models.cases import heaving_sphere_3d
    mesh = mesh_for(R.HEAVE_S, WORLD, "cpu")
    calls, ref = R.heave_steps("cpu", mesh)
    dense = heaving_sphere_3d(device="cpu", **R.HEAVE)
    assert dense.cfg.bbox_shape is not None
    dense.steps(2, remeasure=True)
    rows = [r["heave"] for r in world["ranks"]]
    for r in rows:
        assert r["calls"] >= 1 and r["calls"] == calls
        assert r["bbox_shape"] is None and r["measure_box"] is not None
        assert r["dts"] == ref.dts and r["pois_n"] == ref.pois_n
    u = _joined(mesh, [r["u"] for r in rows], 1)
    p = _joined(mesh, [r["p"] for r in rows], 0)
    assert _eq(u, ref.flow.u) and _eq(p, ref.flow.p)
    np.testing.assert_allclose(u.numpy(), dense.flow.u.numpy(), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(p.numpy(), dense.flow.p.numpy(), atol=3e-3,
                               rtol=0)
    np.testing.assert_allclose(rows[0]["dts"][-1], dense.dts[-1], rtol=1e-5)


def test_rank_raising_in_backward_fails_within_its_timeout():
    """A rank whose backward pass raises while the others wait in its
    exchanges: the launcher reports a failed rank (that one, or a peer
    whose exchange it closed), kills the world and raises within its
    limit."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="ranks failed"):
        run_ranks(R.raise_in_backward, 4, "gloo", "cpu", timeout=30.0,
                  args=(2,))
    assert time.perf_counter() - t0 < 30.0 + 20.0


def test_hung_rank_fails_within_its_timeout():
    """A rank that never reaches a collective: the others time out in it
    and the launcher kills the world and raises, within its limit."""
    t0 = time.perf_counter()
    with pytest.raises((RuntimeError, TimeoutError)):
        run_ranks(R.hang, 2, "gloo", "cpu", timeout=8.0, args=(1,))
    assert time.perf_counter() - t0 < 8.0 + 20.0
