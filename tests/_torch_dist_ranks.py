"""The rank functions of `tests/test_torch_dist.py`: what each rank of a
gloo world of 8 CPU processes runs (`parallel.launch.run_ranks`).

The module imports torch and the port only (no JAX, no test module), so a
spawned rank imports it quickly.  Each case returns numpy arrays of the
rank's blocks and host values; the test assembles them and holds them
against the in-process mesh in the parent.
"""
import os
import time

import torch

from waterlily_tpu_torch.parallel import halo
from waterlily_tpu_torch.parallel.dist import ProcessMesh, dist_mesh_for

# the cases' configurations, shared with the test
COLLECTIVE_S = (18, 10, 10)
HALO_CASES = [(w, p) for w in (1, 2) for p in ((), (0, 2))]
STEP_CASES = {
    "sphere": dict(n=32, m=16),
    "exitBC": dict(n=32, m=16, exitBC=True),
    "tgv": dict(L=32),
}
STEPS = 3
REPLICA_S = (66, 34)
WRAPPER_S = (18, 18, 18)
HEAVE = dict(radius=12, amp=4, Re=100, bbox="force")
HEAVE_S = (50, 50, 50)
# the differentiated sphere (f64): ν and the radius are leaves on every
# rank; fixed_iters and implicit_diff reverse, log forward
GRAD_DIMS = (32, 16, 16)
GRAD_S = tuple(n + 2 for n in GRAD_DIMS)
GRAD_NU, GRAD_RADIUS, GRAD_CENTRE = 0.1, 4.0, (11.0, 8.0, 8.0)
GRAD_STEPS = 2
GRAD_MODES = {"implicit_diff": dict(implicit_diff=True, tol=1e-12, itmx=64),
              "fixed_iters": dict(fixed_iters=2),
              "log": dict(log=True)}


def shard_value(s: int) -> torch.Tensor:
    """Shard ``s``'s value in the collective cases."""
    g = torch.Generator().manual_seed(100 + s)
    return torch.randn((3, 4), generator=g)


def global_field(seed: int, shape) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


def make_case(kind: str, device, mesh):
    from waterlily_tpu_torch import sphere_3d, tgv_3d
    kw = dict(STEP_CASES[kind])
    if kind == "tgv":
        return tgv_3d(kw.pop("L"), device=device, mesh=mesh)
    return sphere_3d(kw.pop("n"), kw.pop("m"), device=device, mesh=mesh,
                     **kw)


def case_shape(kind: str) -> tuple:
    kw = STEP_CASES[kind]
    if kind == "tgv":
        return (kw["L"] + 2,) * 3
    return (kw["n"] + 2, kw["m"] + 2, kw["m"] + 2)


def replica_case(device):
    """The 2D walls flow of JAX's replica-axis test (dense state)."""
    from waterlily_tpu_torch.flow import FlowConfig, flow_init
    from waterlily_tpu_torch.ops.multigrid import build_levels
    cfg = FlowConfig(D=2, S=REPLICA_S, U=(1.0, 0.0), nu=0.02,
                     dtype=torch.float32, device=device)

    def ulam(i, x):
        return torch.where(torch.as_tensor(i == 0),
                           1.0 + 0.1 * torch.sin(x[1] / 5),
                           torch.zeros_like(x[1]))

    state = flow_init(cfg, ulam)
    return cfg, state, build_levels(state.mu0)


def local_state(mesh, flow, levels):
    """A dense state and level stack as the rank's blocks (the form a
    `Simulation` on a process mesh keeps them)."""
    from waterlily_tpu_torch.parallel.shard_step import local_levels
    (u,), (p,) = mesh.split(flow.u, 1), mesh.split(flow.p)
    (V,), (mu0,) = mesh.split(flow.V, 1), mesh.split(flow.mu0, 1)
    (mu1,) = mesh.split(flow.mu1, 2)
    return (flow.replace(u=u, p=p, V=V, mu0=mu0, mu1=mu1),
            local_levels(mesh, levels))


def wrapper_inputs():
    """Inputs of the standalone wrappers' case: a level, x, z, eps, u."""
    from waterlily_tpu_torch.ops.poisson import make_level
    S = WRAPPER_S
    L = global_field(41, (3,) + S).abs() * 0.2 + 0.5
    interior = torch.zeros(S, dtype=torch.bool)
    interior[1:-1, 1:-1, 1:-1] = True
    x = global_field(42, S)
    z = torch.where(interior, global_field(43, S), 0.0)
    eps = torch.where(interior, global_field(44, S), 0.0)
    u = global_field(45, (3,) + S)
    return make_level(L), x, z, eps, u


def wrappers(mesh):
    """The four standalone wrappers on ``mesh``, global in and out."""
    from waterlily_tpu_torch.ops.convect import quick
    from waterlily_tpu_torch.ops.poisson import residual
    from waterlily_tpu_torch.parallel import shard_smooth as ss
    lev, x, z, eps, u = wrapper_inputs()
    r = ss.shardmap_residual(mesh, lev, x, z)
    r0 = residual(lev, torch.zeros_like(x), z)
    xp, rp = ss.shardmap_pcg(mesh, lev, torch.zeros_like(x), r0, it=3)
    xi, ri = ss.shardmap_increment(mesh, lev, x, r0, eps)
    cd = ss.shardmap_conv_diff(mesh, u, 0.01, quick)
    return [a.numpy() for a in (r, xp, rp, xi, ri, cd)]


def heave_steps(device, mesh):
    """JAX's sharded moving-body case: the heaving sphere remeasured every
    step for 2 steps; ``[calls of measure_fields_banded, sim]``."""
    from waterlily_tpu_torch import simulation as sim_mod
    from waterlily_tpu_torch.models.cases import heaving_sphere_3d
    real = sim_mod.measure_fields_banded
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    sim_mod.measure_fields_banded = spy
    try:
        sim = heaving_sphere_3d(device=device, mesh=mesh, **HEAVE)
        sim.steps(2, remeasure=True)
    finally:
        sim_mod.measure_fields_banded = real
    return len(calls), sim


def _np(t):
    return t.detach().cpu().numpy()


def grad_leaves(grad=True):
    """ν and the sphere's radius, 0-d f64 leaves."""
    return tuple(torch.tensor(v, dtype=torch.float64, requires_grad=grad)
                 for v in (GRAD_NU, GRAD_RADIUS))


def grad_sim(device, mesh, nu, radius, mode):
    """The differentiated sphere's `Simulation` on ``mesh`` (None: dense)
    with ``GRAD_MODES[mode]``."""
    from waterlily_tpu_torch import Simulation
    from waterlily_tpu_torch.body import AutoBody
    c = torch.tensor(GRAD_CENTRE, dtype=torch.float64, device=device)
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - c) ** 2))
                    - radius)
    return Simulation(GRAD_DIMS, (1.0, 0.0, 0.0), 2 * GRAD_RADIUS, nu=nu,
                      body=body, dtype=torch.float64, device=device,
                      mesh=mesh, **GRAD_MODES[mode])


def drag(sim, flow=None):
    """The drag of a state (default: the sim's, assembled on every rank of
    a process mesh)."""
    from waterlily_tpu_torch.metrics import total_force
    f = sim.global_flow() if flow is None else flow
    return total_force(f.u, f.p, sim.cfg.nu, sim.body, f.t)[0]


def grad_case(device, mesh, mode):
    """`GRAD_STEPS` steps of the differentiated sphere on ``mesh``; for
    the reverse modes the drag and its gradient in (ν, radius), every
    rank alike; the rank's blocks, histories and traces."""
    from waterlily_tpu_torch.ops.multigrid import ml_solve_implicit
    reverse = mode != "log"
    nu, radius = grad_leaves(reverse)
    sim = grad_sim(device, mesh, nu, radius, mode)
    ml_solve_implicit.adjoint_n.clear()
    sim.steps(GRAD_STEPS)
    out = {"u": _np(sim.flow.u), "p": _np(sim.flow.p), "dts": sim.dts,
           "pois_n": sim.pois_n, "sharded": sim._sharded,
           "res_log": [a.copy() for a in sim.res_log]}
    if reverse:
        d = drag(sim)
        out["drag"] = float(d.detach())
        out["grad"] = [float(g) for g in torch.autograd.grad(d, (nu,
                                                                 radius))]
        out["adjoint_n"] = list(ml_solve_implicit.adjoint_n)
    return out


def run_cases(rank, world, device, tmp):
    """Every case of the module test on this rank; a dict of results."""
    from waterlily_tpu_torch.io import save_checkpoint, restart_sim
    from waterlily_tpu_torch.parallel.shard_step import shardmap_mom_step
    out = {"rank": rank, "seconds": {}}
    t0 = time.perf_counter()

    # the collectives
    mesh = dist_mesh_for(COLLECTIVE_S, device=device)
    s = mesh.shard
    v = shard_value(s)
    coll = {"psum": _np(mesh.psum([v])), "pmax": _np(mesh.pmax([v])),
            "gather": [_np(a) for a in mesh.all_gather([v])]}
    for d in range(3):
        k = mesh.k(d)
        (got,) = mesh.ppermute([v], d, [(i, (i + 1) % k) for i in range(k)])
        coll[f"ppermute{d}"] = _np(got)
        (got,) = mesh.ppermute([v], d, [(k - 1, 0)])
        coll[f"wrap{d}"] = None if got is None else _np(got)
    out["collectives"] = coll

    # halo exchange
    u = global_field(31, (3,) + COLLECTIVE_S)
    out["halo"] = {(w, p): _np(halo.halo_exchange(mesh.split(u, 1), mesh, 3,
                                                  w, p)[0])
                   for w, p in HALO_CASES}
    out["wrappers"] = wrappers(dist_mesh_for(WRAPPER_S, device=device))
    out["seconds"]["collectives"] = time.perf_counter() - t0

    # three steps of each case on the process mesh; the sphere saves a
    # per-rank checkpoint after 2 and restarts a fresh sim from it
    steps = {}
    for kind in STEP_CASES:
        t0 = time.perf_counter()
        pm = dist_mesh_for(case_shape(kind), device=device)
        sim = make_case(kind, device, pm)
        if kind == "sphere":
            sim.steps(2)
            save_checkpoint(os.path.join(tmp, "ckpt"), sim)
            sim.steps(1)
            fresh = make_case(kind, device, pm)
            restart_sim(fresh, os.path.join(tmp, "ckpt"))
            fresh.steps(1)
            out["restart"] = {"u": _np(fresh.flow.u), "p": _np(fresh.flow.p),
                              "dts": fresh.dts, "pois_n": fresh.pois_n}
        else:
            sim.steps(STEPS)
        if kind == "tgv":
            # the sphere's files name another grid: refused before anything
            # is restored
            before = sim.flow
            try:
                restart_sim(sim, os.path.join(tmp, "ckpt"))
                out["restart_refused"] = None
            except ValueError as e:
                out["restart_refused"] = (str(e), sim.flow is before)
        glob = sim.global_flow()        # a gather: every rank calls it
        steps[kind] = {"u": _np(sim.flow.u), "p": _np(sim.flow.p),
                       "dts": sim.dts, "pois_n": sim.pois_n,
                       "sharded": sim._sharded, "mesh": repr(sim.mesh),
                       "global_u": _np(glob.u) if rank == 0 else None}
        out["seconds"][kind] = time.perf_counter() - t0
    out["steps"] = steps

    # reverse mode across ranks (fixed_iters, implicit_diff) and the
    # residual traces (log)
    out["grad"] = {}
    for mode in GRAD_MODES:
        t0 = time.perf_counter()
        gm = dist_mesh_for(GRAD_S, device=device)
        out["grad"][mode] = grad_case(device, gm, mode)
        out["grad"][mode]["stats"] = dict(gm.stats)
        out["seconds"]["grad " + mode] = time.perf_counter() - t0

    # the replica mesh: two groups of 4 ranks, one step of the 2D flow
    t0 = time.perf_counter()
    cfg, state, levels = replica_case(device)
    rm = dist_mesh_for(REPLICA_S, device=device)
    st, lv = local_state(rm, state, levels)
    new, aux = shardmap_mom_step(cfg, rm, lv, st)
    out["replica"] = {"replica": rm.replica, "shard": rm.shard,
                      "replicas": rm.replicas, "u": _np(new.u),
                      "p": _np(new.p), "pois_n": aux["pois_n"],
                      "dt": float(aux["dt"])}
    out["seconds"]["replica"] = time.perf_counter() - t0

    # the sharded moving body
    t0 = time.perf_counter()
    calls, sim = heave_steps(device, dist_mesh_for(HEAVE_S, device=device))
    out["heave"] = {"calls": calls, "bbox_shape": sim.cfg.bbox_shape,
                    "measure_box": sim._measure_box, "u": _np(sim.flow.u),
                    "p": _np(sim.flow.p), "dts": sim.dts,
                    "pois_n": sim.pois_n}
    out["seconds"]["heave"] = time.perf_counter() - t0
    out["stats"] = dict(pm.stats)
    return out


def raise_in_backward(rank, world, device, bad):
    """Rank ``bad`` raises in the backward pass of a differentiated psum;
    the others wait in its exchanges."""
    def fail(_grad):
        raise RuntimeError("raised in backward")

    mesh = ProcessMesh((world,), device)
    x = torch.ones((), dtype=torch.float64, requires_grad=True)
    y = mesh.pbroadcast(mesh.psum([x * (rank + 1)])) * 2.0
    if rank == bad:
        y.register_hook(fail)
    (g,) = torch.autograd.grad(mesh.psum([y]), x)
    return float(g)


def hang(rank, world, device, hung):
    """Rank ``hung`` never reaches the collective the others wait in."""
    mesh = ProcessMesh((world,), device)
    if rank == hung:
        time.sleep(3600)
    return float(mesh.psum([torch.ones(())]))


class one_rank_world:
    """A gloo world of this process alone, for the code that needs an
    initialised process group and no peer (a `ProcessMesh` of one shard);
    destroyed on exit."""

    def __init__(self, tmp):
        self.init_method = "file://" + os.path.join(str(tmp), "store")

    def __enter__(self):
        import datetime
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=self.init_method,
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=60))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
