"""Ensemble design sweep: spinning-cylinder simulations over a range of
spin ratios, all members in one batched program.

The whole pipeline (BDIM measurement -> multigrid levels -> momentum
steps -> force) is a pure function of the spin ratio, so
`torch.func.vmap` batches the entire simulation over a parameter vector:
every field carries a leading member axis, and on a CUDA device the
pressure smooths of every member run in one launch of the PCG kernel a
chunk of members (`ops.pcg_kernel.pcg_members`).

Run:  python -m waterlily_tpu_torch.examples.ensemble_sweep [--members M]
      [--dm DM] [--quick] [--device cpu]

``--quick`` runs 3 members at ``Dm=8`` for 4 steps.
"""
import torch

from waterlily_tpu_torch.body import AutoBody, measure_fields
from waterlily_tpu_torch.examples import parser
from waterlily_tpu_torch.flow import FlowConfig, flow_init, mom_step
from waterlily_tpu_torch.metrics import total_force
from waterlily_tpu_torch.ops.multigrid import build_levels


def make_force_fn(Dm=16, Re=500, U=1.0, n_steps=20, device="cuda",
                  dtype=torch.float32):
    """The time-averaged force coefficients ``(Cd, Cl)`` of a cylinder of
    diameter ``Dm`` spinning at tip-speed ratio ``xi``, as a pure
    function of ``xi`` (a 0-d tensor): the mean of the back half of
    ``n_steps`` steps (the transient discarded), over ``½U²Dm``."""
    R = Dm // 2
    S = (6 * Dm + 2, 4 * Dm + 2)

    def force(xi):
        c = torch.tensor([2.0 * Dm, 2.0 * Dm], dtype=dtype, device=device)

        def sdf(x, t):
            return torch.sqrt(torch.sum(x * x)) - R

        def mp(x, t):            # rotate the body frame at rate xi*U/R
            a = xi * U * t / R
            s, cs = torch.sin(a), torch.cos(a)
            Rm = torch.stack([torch.stack([cs, -s]), torch.stack([s, cs])])
            return Rm.to(x.dtype) @ (x - c)

        body = AutoBody(sdf, mp)
        cfg = FlowConfig(D=2, S=S, device=device, nu=U * Dm / Re, U=(U, 0.0),
                         dtype=dtype, fixed_iters=2)
        state = flow_init(cfg)
        V, m0, m1, _ = measure_fields(body, S, 0.0, 1.0, (), False, dtype,
                                      device)
        state = state.replace(V=V, mu0=m0, mu1=m1)
        levels = build_levels(m0)
        forces = []
        for _ in range(n_steps):
            state, _aux = mom_step(cfg, levels, state)
            forces.append(total_force(state.u, state.p, cfg.nu, body,
                                      state.t))
        back = torch.stack(forces[n_steps // 2:])
        return torch.mean(back, dim=0) / (0.5 * U * U * Dm)

    return force


def sweep(xis, **kw):
    """``(M, 2)`` force coefficients of the members ``xis`` (an ``(M,)``
    tensor), all at once under `torch.func.vmap`."""
    return torch.func.vmap(make_force_fn(device=xis.device,
                                         dtype=xis.dtype, **kw))(xis)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--members", type=int, default=None,
                   help="ensemble members (default 8; 3 with --quick)")
    p.add_argument("--dm", type=int, default=None,
                   help="cylinder diameter in cells (default 16; 8 with "
                        "--quick)")
    args = p.parse_args(argv)
    members = args.members or (3 if args.quick else 8)
    Dm = args.dm or (8 if args.quick else 16)
    xis = torch.linspace(0.5, 4.0, members, device=args.device)
    coeffs = sweep(xis, Dm=Dm, n_steps=4 if args.quick else 20)
    rows = [(float(xi), float(cd), float(cl))
            for xi, (cd, cl) in zip(xis.cpu(), coeffs.cpu())]
    print(f"{'xi':>5} {'Cd':>8} {'Cl':>8}")
    for xi, cd, cl in rows:
        print(f"{xi:5.2f} {cd:8.3f} {cl:8.3f}")
    return rows


if __name__ == "__main__":
    main()
