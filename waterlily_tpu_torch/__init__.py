"""waterlily_tpu_torch: the PyTorch and CUDA port of waterlily_tpu.

Single-device 3D path, dense and banded, of the immersed-boundary
incompressible flow solver (BDIM bodies, QUICK convection-diffusion, geometric-multigrid
pressure projection), with hand-written CUDA kernels for the stencils the
JAX package runs as Pallas kernels.  Imports torch and numpy only.
"""
from .simulation import Simulation, sim_time  # noqa: F401
from .body import AutoBody, NoBody  # noqa: F401
from .models.cases import sphere_3d, heaving_sphere_3d  # noqa: F401

__all__ = ["Simulation", "sim_time", "AutoBody", "NoBody", "sphere_3d",
           "heaving_sphere_3d"]
