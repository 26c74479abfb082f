"""3D sphere benchmark, the reference's GPU demo (README.md:118-131):
1.3M velocity degrees of freedom on a (96,64,64) grid, f32, one card.

Run:  python -m waterlily_tpu_torch.examples.three_d_sphere [--quick]
      [--device cpu]
"""
import time

import torch

from waterlily_tpu_torch.examples import parser
from waterlily_tpu_torch.models.cases import sphere_3d


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    n, m, t_end = (32, 32, 0.5) if args.quick else (96, 64, 10.0)
    sim = sphere_3d(n, m, dtype=torch.float32, device=args.device)
    print(f"{sim.flow.u.numel() / 1e6:.1f}M velocity degrees of freedom")
    sim.steps(2 if args.quick else 10, remeasure=False)   # build + warm
    _sync(args.device)
    t0 = time.perf_counter()
    sim.run_until(t_end, chunk=5 if args.quick else 50, remeasure=False)
    _sync(args.device)
    print(f"tU/L={sim.sim_time:.1f} in {time.perf_counter() - t0:.1f}s "
          f"({len(sim.pois_n)} steps)")
    return sim


if __name__ == "__main__":
    main()
