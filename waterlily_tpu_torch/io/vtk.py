"""ParaView-compatible VTK ImageData (.vti) and collection (.pvd) I/O.

PyTorch counterpart of `waterlily_tpu.io.vtk` (the reference's
WriteVTK/ReadVTK extensions), numpy and the standard library only: XML
ImageData with inline base64 binary arrays, a ``.pvd`` collection keyed by
the rounded dimensionless time, and a reader that restarts a simulation
from the last snapshot.  The whole ghost-padded grid is written as point
data, vectors components first; 2D fields become a one-slice 3D image
with 3-component vectors.  A tensor reaches numpy through ``.cpu()``.
"""
from __future__ import annotations

import base64
import os
import struct
import xml.etree.ElementTree as ET

import numpy as np
import torch

from ..convert import to_numpy

__all__ = ["VTKWriter", "vtk_writer", "default_attrib", "write_vti",
           "read_vti", "restart_from_vtk"]


def _encode(data: np.ndarray) -> str:
    """VTK inline-binary encoding: base64(UInt64 byte count + raw bytes)."""
    raw = np.ascontiguousarray(data).tobytes()
    return base64.b64encode(struct.pack("<Q", len(raw)) + raw).decode()


def _decode(txt: str, dtype) -> np.ndarray:
    raw = base64.b64decode(txt.strip())
    (nbytes,) = struct.unpack("<Q", raw[:8])
    return np.frombuffer(raw[8:8 + nbytes], dtype=dtype).copy()


_VTK_TYPES = {np.dtype(np.float32): "Float32", np.dtype(np.float64): "Float64",
              np.dtype(np.int32): "Int32"}
_NP_TYPES = {v: k for k, v in _VTK_TYPES.items()}


def _is_vector(arr) -> bool:
    return arr.ndim in (3, 4) and arr.shape[0] == arr.ndim - 1


def write_vti(fname: str, fields: dict) -> None:
    """Write point-data ``fields`` (scalar ``(*S)``, vector ``(D, *S)``;
    numpy arrays or tensors) to a .vti, x fastest; 2D data becomes a z=1
    slab and 2D vectors get a zero z-component."""
    fields = {k: to_numpy(v) for k, v in fields.items()}
    first = next(iter(fields.values()))
    S = first.shape[1:] if _is_vector(first) else first.shape
    D = len(S)
    ext_shape = S if D == 3 else S + (1,)
    extent = f"0 {ext_shape[0]-1} 0 {ext_shape[1]-1} 0 {ext_shape[2]-1}"
    lines = ['<?xml version="1.0"?>',
             '<VTKFile type="ImageData" version="1.0" '
             'byte_order="LittleEndian" header_type="UInt64">',
             f'  <ImageData WholeExtent="{extent}" Origin="0 0 0" '
             'Spacing="1 1 1">',
             f'    <Piece Extent="{extent}">',
             '      <PointData>']
    for name, arr in fields.items():
        vtype = _VTK_TYPES[arr.dtype]
        if _is_vector(arr):
            comps = [arr[i] for i in range(arr.shape[0])]
            if D == 2:
                comps.append(np.zeros_like(comps[0]))
            flat = np.stack([c.flatten(order="F") for c in comps], axis=-1)
            lines.append(f'        <DataArray type="{vtype}" Name="{name}" '
                         f'NumberOfComponents="3" format="binary">')
        else:
            flat = arr.flatten(order="F")
            lines.append(f'        <DataArray type="{vtype}" Name="{name}" '
                         f'format="binary">')
        lines.append("          " + _encode(flat))
        lines.append("        </DataArray>")
    lines += ["      </PointData>", "      <CellData/>", "    </Piece>",
              "  </ImageData>", "</VTKFile>"]
    with open(fname, "w") as f:
        f.write("\n".join(lines))


def read_vti(fname: str) -> dict:
    """Point-data fields of a .vti written by `write_vti` (either
    package's), as numpy arrays: vectors back in ``(D, *S)`` layout (a 2D
    grid is a unit z-extent; its padding z-component is dropped)."""
    image = ET.parse(fname).getroot().find("ImageData")
    ext = [int(v) for v in image.get("WholeExtent").split()]
    nx, ny, nz = ext[1] + 1, ext[3] + 1, ext[5] + 1
    two_d = nz == 1
    S = (nx, ny) if two_d else (nx, ny, nz)
    out = {}
    for da in image.find("Piece").find("PointData").findall("DataArray"):
        flat = _decode(da.text, _NP_TYPES[da.get("type")])
        ncomp = int(da.get("NumberOfComponents", "1"))
        if ncomp > 1:
            pts = flat.reshape(-1, ncomp)
            out[da.get("Name")] = np.stack(
                [pts[:, i].reshape(S, order="F")
                 for i in range(2 if two_d else 3)], axis=0)
        else:
            out[da.get("Name")] = flat.reshape(S, order="F")
    return out


def default_attrib():
    """The fields a snapshot holds by default (reference
    WriteVTKExt.jl:48-50): ``u`` and ``p``."""
    return {"u": lambda sim: to_numpy(sim.flow.u),
            "p": lambda sim: to_numpy(sim.flow.p)}


class VTKWriter:
    """Snapshot writer keeping a .pvd collection (WriteVTKExt.jl:27-72).
    ``attrib`` maps field names to ``fn(sim)``; each snapshot is cast to
    ``T``."""

    def __init__(self, fname="WaterLily", attrib=None, dir="vtk_data",
                 T=np.float32):
        self.fname = fname
        self.dir = dir
        self.attrib = attrib or default_attrib()
        self.T = T
        self.count = 0
        self.entries = []  # (time, path of the .vti)
        os.makedirs(dir, exist_ok=True)

    def write(self, sim) -> None:
        """Append one snapshot keyed by the rounded sim time
        (WriteVTKExt.jl:57-66)."""
        vti = os.path.join(self.dir, f"{self.fname}_{self.count:06d}.vti")
        write_vti(vti, {k: to_numpy(fn(sim)).astype(self.T)
                        for k, fn in self.attrib.items()})
        self.entries.append((round(sim.sim_time, 14), vti))
        self.count += 1
        self._flush()

    def _flush(self) -> None:
        lines = ['<?xml version="1.0"?>',
                 '<VTKFile type="Collection" version="1.0" '
                 'byte_order="LittleEndian">',
                 '  <Collection>']
        for t, path in self.entries:
            lines.append(f'    <DataSet timestep="{t}" part="0" '
                         f'file="{path}"/>')
        lines += ["  </Collection>", "</VTKFile>"]
        with open(self.fname + ".pvd", "w") as f:
            f.write("\n".join(lines))

    def close(self) -> None:
        self._flush()


def vtk_writer(fname="WaterLily", attrib=None, dir="vtk_data", T=np.float32):
    return VTKWriter(fname, attrib, dir, T)


def restart_from_vtk(sim, fname: str):
    """Restart a simulation from the last snapshot of a .pvd collection
    (reference `restart_sim!`, ReadVTKExt.jl:28-45): u and p restored, the
    time taken from the file's timestamp, the body measured again there,
    and the next Δt recomputed as ``cfl`` of the restored u (as the
    reference does, and as the uninterrupted run computed it).  Returns a
    writer that appends to the same collection."""
    from ..flow import cfl
    root = ET.parse(fname).getroot()
    datasets = root.find("Collection").findall("DataSet")
    last = datasets[-1]
    t_star = float(last.get("timestep"))
    fields = read_vti(last.get("file"))
    if tuple(fields["p"].shape) != sim.cfg.S:
        raise ValueError("restart grid dims do not match simulation")
    dtype, dev = sim.cfg.dtype, sim.device
    t = t_star * sim.L / sim.U
    # the file's arrays are x-fastest (Fortran order); the kernels take
    # C-contiguous fields
    sim.flow = sim.flow.replace(
        u=torch.as_tensor(np.ascontiguousarray(fields["u"]), dtype=dtype,
                          device=dev),
        p=torch.as_tensor(np.ascontiguousarray(fields["p"]), dtype=dtype,
                          device=dev),
        t=torch.as_tensor(t, dtype=dtype, device=dev))
    sim.measure(t=t)
    sim.flow = sim.flow.replace(dt=cfl(sim.flow.u, sim.cfg.nu))
    wr = VTKWriter(os.path.splitext(os.path.basename(fname))[0],
                   dir=os.path.dirname(datasets[0].get("file")) or "vtk_data")
    wr.entries = [(float(d.get("timestep")), d.get("file")) for d in datasets]
    wr.count = len(wr.entries)
    return wr
