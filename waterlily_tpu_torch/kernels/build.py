"""Build and load the hand-written CUDA kernels.

Each source under ``waterlily_tpu_torch/csrc/`` is compiled by its own
``nvcc`` (all started together) and the objects are linked into one shared
library with a plain C interface, loaded with `ctypes`.
The build happens at first use, into ``waterlily_tpu_torch/_build/``, keyed
by a hash of the sources and flags, so a fresh checkout builds its kernels
from the repository's own sources and a changed source never loads a stale
library.  Nothing here runs at import time: CPU-only installs never build
or load the library.

`build_source` builds generated source the same way (a user-defined
limiter compiled into the conv kernel, `kernels.limiter`).

Every C entry point returns ``cudaGetLastError()`` after its launch;
`launch` raises on a non-zero code, so a refused launch is never silent.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["library", "build_source", "launch", "build_seconds", "THREADS",
           "NVCC_FLAGS"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# threads per block of the one-thread-per-cell kernels (csrc/common.cuh
# WL_THREADS); checked against the library at load
THREADS = 256

# --fmad=false: no multiply-add contraction, so every kernel without an
# in-kernel sum rounds exactly like its plain PyTorch version
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_S3 = [_I, _I, _I]
# C signatures (argument types before the trailing stream pointer)
SIGNATURES = {
    # the member forms' kernels take the members and each operand's member
    # stride (elements, c_longlong; 0: one operand every member shares)
    "wl_increment3d": [_P] * 5 + [_I] * 3 + [_L] * 4 + _S3,
    "wl_mult3d_stream": [_P] * 7 + [_I] + [_L] * 3 + [_I] * 3 + _S3,
    "wl_increment3d_stream": [_P] * 7 + [_I] * 4 + [_L] * 5 + _S3,
    "wl_pcg_dir_mult": [_P] * 12 + [_I] * 5 + [_L] * 6 + _S3,
    "wl_pcg_update": [_P] * 12 + [_I] * 4 + [_L] * 6 + _S3,
    "wl_dot3d": [_P] * 5 + [_I] * 4 + [_L] * 2 + _S3,
    "wl_pcg_axpy": [_P] * 11 + [_I] * 4 + [_L] * 6 + _S3,
    "wl_copy_probe": [_P, _P, _F] + _S3,
    "wl_roll_probe": [_P, _P, _F] + _S3,
    "wl_ana_mult3d": [_P] * 5 + [_F, _I, _I, _I] + _S3,
    "wl_cfl3d": [_P] * 4 + [_I, _I, _L] + _S3,
    # the shard-local forms' kernels also take the global sizes and the
    # global index of cell 0
    "wl_bc3d": [_P, _P, _F, _F, _F, _I, _I, _I, _I] + _S3 * 3,
    "wl_div3d": [_P] * 5 + [_I] + [_L] * 3 + _S3 * 3,
    "wl_project3d": [_P] * 6 + [_I] + [_L] * 4 + _S3 * 3,
    "wl_conv_diff3d": [_P, _P, _F, _P, _L, _I, _L, _I, _I, _I] + _S3 * 3,
    "wl_pcg": [_P] * 6 + [_I] + _S3 + [_I] * 5 + [_L, _L],
    "wl_grid_sync_probe": [_I, _I],
}

_build_seconds = [0.0]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libwaterlily_kernels_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """One `nvcc -c` per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, _obj, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
    objs = [obj for _cmd, obj, _proc in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    _build_seconds[0] = time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    out = _library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args + [_P]
        fn.restype = _I
    lib.wl_threads.restype = _I
    lib.wl_pcg_threads.argtypes = [_I]
    lib.wl_pcg_threads.restype = _I
    lib.wl_pcg_coresident.argtypes = [_I, _I]
    lib.wl_pcg_coresident.restype = _I
    lib.wl_stream_tile.argtypes = [_I]
    lib.wl_stream_tile.restype = _I
    lib.wl_march_tile.argtypes = [_I]
    lib.wl_march_tile.restype = _I
    lib.wl_stream_coresident.argtypes = [_I] * 3
    lib.wl_stream_coresident.restype = _I
    lib.wl_axpy_coresident.argtypes = [_I, _I]
    lib.wl_axpy_coresident.restype = _I
    lib.wl_error_string.argtypes = [_I]
    lib.wl_error_string.restype = ctypes.c_char_p
    if lib.wl_threads() != THREADS:
        raise RuntimeError(f"kernel library block size {lib.wl_threads()} "
                           f"!= {THREADS}")
    return lib


@functools.cache
def build_source(source: str, entry: str, argtypes: tuple) -> ctypes.CDLL:
    """A library built from generated CUDA C++ ``source`` (which includes
    ``csrc`` headers) with the kernels' flags, loaded, its C entry point
    ``entry`` typed with ``argtypes`` and a trailing stream pointer.  Keyed
    by a hash of the source, the ``csrc`` sources and the flags, so a
    program built once is loaded from ``_build/`` after."""
    h = hashlib.sha256(source.encode())
    h.update(_library_path().name.encode())
    out = BUILD_DIR / f"libwaterlily_gen_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(f".{os.getpid()}.cu")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src.write_text(source)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}\n"
                                   f"{proc.stderr}")
            os.replace(tmp, out)
        finally:
            src.unlink(missing_ok=True)
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes) + [_P]
    fn.restype = _I
    return lib


def build_seconds() -> float:
    """Seconds the last `nvcc` build in this process took (0 if the library
    was already built)."""
    return _build_seconds[0]


def _arg(a):
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    return a


def launch(name: str, *args, lib: ctypes.CDLL | None = None) -> None:
    """Call C entry point ``name`` (of ``lib``, by default the kernel
    library) on the current CUDA stream; tensors pass as device pointers,
    ``None`` as NULL.  Raises on a launch error."""
    fn = getattr(library() if lib is None else lib, name)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*[_arg(a) for a in args], ctypes.c_void_p(stream))
    if rc != 0:
        msg = library().wl_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
