"""Flow past a 2D circle at Re=100, the reference README example
(README.md:41-51), with a drag and lift trace and an optional gif.

Run:  python -m waterlily_tpu_torch.examples.two_d_circle [--gif]
      [--quick] [--device cpu]

``--quick`` runs a reduced configuration (48x32, 2 samples).  ``--gif``
needs matplotlib, which `io.plots` imports only when it draws.
"""
from waterlily_tpu_torch.convert import to_numpy
from waterlily_tpu_torch.examples import parser
from waterlily_tpu_torch.metrics import total_force
from waterlily_tpu_torch.models.cases import circle_2d


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--gif", action="store_true",
                   help="write circle.gif of the vorticity")
    args = p.parse_args(argv)
    n, m = (48, 32) if args.quick else (96, 64)
    sim = circle_2d(n=n, m=m, Re=100, device=args.device)
    rows = []
    print("tU/L   Cd      Cl")
    for _ in range(2 if args.quick else 20):
        sim.sim_step(sim.sim_time + 0.5, remeasure=False)
        f = to_numpy(total_force(sim.flow.u, sim.flow.p, sim.cfg.nu,
                                 sim.body, sim.flow.t))
        coeff = 2 * f / (sim.U ** 2 * sim.L)      # force -> coefficient
        rows.append((sim.sim_time, -coeff[0], coeff[1]))
        print(f"{sim.sim_time:5.1f}  {-coeff[0]:6.3f}  {coeff[1]:6.3f}")
    if args.gif:
        from waterlily_tpu_torch.io.plots import sim_gif
        sim_gif(sim, "circle.gif", duration=5, step=0.25, clims=(-8, 8),
                plotbody=True)
        print("wrote circle.gif")
    return rows


if __name__ == "__main__":
    main()
