"""waterlily_tpu_torch: the PyTorch and CUDA port of waterlily_tpu.

The 2D and 3D paths, dense and banded, walls, periodic axes and the
convective outlet, of the immersed-boundary incompressible flow solver
(BDIM bodies and their CSG combinations, QUICK convection-diffusion,
geometric-multigrid pressure projection), flow metrics and body forces
(`metrics`), the recording path (`Simulation.run_record`, the solver's
residual log, `io`: checkpoints, VTK, plots) and the spatial
decomposition (`parallel`, on an in-process mesh), with hand-written CUDA
kernels for the stencils the JAX package runs as Pallas kernels.  Imports
torch and numpy only (`io.plots` imports matplotlib when it draws).
"""
from .simulation import Simulation, sim_time  # noqa: F401
from .body import AutoBody, Bodies, NoBody  # noqa: F401
from .models.cases import (circle_2d, tgv_2d, tgv_3d, sphere_3d,  # noqa: F401
                           donut_3d, oscillating_plate_2d, heaving_sphere_3d)

__all__ = ["Simulation", "sim_time", "AutoBody", "Bodies", "NoBody",
           "circle_2d", "tgv_2d", "tgv_3d", "sphere_3d", "donut_3d",
           "oscillating_plate_2d", "heaving_sphere_3d"]
