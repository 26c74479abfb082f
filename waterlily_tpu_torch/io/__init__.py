"""I/O: npz checkpoints, VTK export and restart, plots.

PyTorch counterpart of `waterlily_tpu.io`.  The files are numpy
containers that either package reads: a checkpoint written by one restarts
in the other.  `plots` imports matplotlib inside its functions only, so
importing this package does not.
"""
from .checkpoint import (save_checkpoint, load_checkpoint, restart_sim,
                         assemble_checkpoint)
from .vtk import (VTKWriter, vtk_writer, default_attrib, write_vti, read_vti,
                  restart_from_vtk)

__all__ = ["save_checkpoint", "load_checkpoint", "restart_sim",
           "assemble_checkpoint", "VTKWriter",
           "vtk_writer", "default_attrib", "write_vti", "read_vti",
           "restart_from_vtk"]
