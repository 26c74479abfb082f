"""Spatially decomposed 3D sphere over processes: ``sphere_3d(48, 32)``
(S = (50, 34, 34)) on ``mesh_for``'s (2, 2, 2) mesh of 8 ranks, one block
a rank (`parallel.dist.ProcessMesh`), stepped 20 times.

Each rank is a process (`parallel.launch.run_ranks`).  The backend is
NCCL, one rank a card, where the host has as many cards as ranks; else
gloo, whose ranks share the cards (or the CPU) and stage each exchange
through host memory.  Under ``torchrun`` (``torchrun --nproc-per-node 8
-m waterlily_tpu_torch.examples.sharded_sphere``) the world it started is
used.

Run:  python -m waterlily_tpu_torch.examples.sharded_sphere [--quick]
      [--device cpu] [--ranks 8] [--backend gloo|nccl]
"""
import torch

from waterlily_tpu_torch.examples import parser

N, M = 48, 32
S = (N + 2, M + 2, M + 2)


def rank_main(rank, world, device, steps):
    """One rank: the sphere on the process mesh, ``steps`` steps; returns
    what rank 0 prints."""
    from waterlily_tpu_torch.models.cases import sphere_3d
    from waterlily_tpu_torch.parallel.dist import dist_mesh_for
    mesh = dist_mesh_for(S, device=device)
    sim = sphere_3d(N, M, dtype=torch.float32, device=device, mesh=mesh)
    sim.steps(steps)
    return {"mesh": dict(mesh.shape), "rank": rank, "dt": sim.dts[-1],
            "pois_n": sim.pois_n, "dts": sim.dts}


def default_backend(device, ranks: int) -> str:
    dev = torch.device(device)
    return ("nccl" if dev.type == "cuda"
            and torch.cuda.device_count() >= ranks else "gloo")


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--ranks", type=int, default=8,
                   help="processes, one block each (default 8)")
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: nccl where the host has a "
                        "card a rank)")
    args = p.parse_args(argv)
    from waterlily_tpu_torch.parallel.launch import run_ranks
    steps = 3 if args.quick else 20
    backend = args.backend or default_backend(args.device, args.ranks)
    out = run_ranks(rank_main, args.ranks, backend, args.device,
                    timeout=600.0, args=(steps,))[0]
    print(f"mesh: {out['mesh']} over {args.ranks} ranks ({backend})")
    print(f"{steps} sharded steps done; dt={out['dt']:.3f}, "
          f"last MG iters={out['pois_n'][-1]}")
    return out


if __name__ == "__main__":
    main()
