"""Heaving plate with the body re-measured every step: the moving-body
BDIM path (``remeasure=True``), its body velocity by autodiff of the map.

Run:  python -m waterlily_tpu_torch.examples.oscillating_plate [--quick]
      [--device cpu]
"""
from waterlily_tpu_torch.convert import to_numpy
from waterlily_tpu_torch.examples import parser
from waterlily_tpu_torch.metrics import pressure_force
from waterlily_tpu_torch.models.cases import oscillating_plate_2d


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    sim = oscillating_plate_2d(L=16 if args.quick else 32,
                               device=args.device)
    rows = []
    for _ in range(2 if args.quick else 10):
        sim.sim_step(sim.sim_time + 0.2, remeasure=True)
        f = to_numpy(pressure_force(sim.flow.p, sim.body, sim.flow.t))
        rows.append((sim.sim_time, f[1]))
        print(f"tU/L={sim.sim_time:5.2f}  Fy={f[1]:8.3f}  "
              f"MG iters={sim.pois_n[-1]}")
    return rows


if __name__ == "__main__":
    main()
