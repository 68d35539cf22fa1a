"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources compile with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into one shared library with a plain C interface, loaded through ctypes.
The library lands in ``snesimage_torch/build/`` under a name keyed by a
hash of the sources and flags, so an edit rebuilds and a second process
reuses the build. Nothing builds at import: the first call of `library()`
does, and it raises when no ``nvcc`` is found. Every C entry point
launches on the stream it is given and returns ``cudaGetLastError()``;
`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np

from snesimage_torch.ops.ssimulacra2_consts import (
    OPSIN_BIAS,
    OPSIN_MATRIX,
    SSIM_C2,
    XYB_B_OFFSET,
    XYB_X_OFFSET,
    XYB_X_SCALE,
    XYB_Y_OFFSET,
)

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
MAX_SCALES = 6

_P = ctypes.c_void_p
_I = ctypes.c_int


class MetricParams(ctypes.Structure):
    """Mirror of snes::MetricParams (csrc/metric_common.cuh)."""

    _fields_ = [
        ("taps", ctypes.c_float * 17),
        ("opsin", ctypes.c_float * 9),
        ("bias", ctypes.c_float),
        ("cbrt_bias", ctypes.c_float),
        ("x_scale", ctypes.c_float),
        ("x_offset", ctypes.c_float),
        ("y_offset", ctypes.c_float),
        ("b_offset", ctypes.c_float),
        ("ssim_c2", ctypes.c_float),
    ]


class RefPyramid(ctypes.Structure):
    """Mirror of snes::RefPyramid (csrc/metric_common.cuh)."""

    _fields_ = [
        ("img1", _P * MAX_SCALES),
        ("mu1", _P * MAX_SCALES),
        ("s11", _P * MAX_SCALES),
        ("h", _I * MAX_SCALES),
        ("w", _I * MAX_SCALES),
    ]


_SIGNATURES = {
    "snes_select_colors": (_P, _P, _P, _I, _I, _I, _P),
    "snes_ds2": (_P, _P, _I, _I, _I, _P),
    "snes_tiled_scale": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "snes_reduce_tiles": (_P, _P, _I, _I, _I, _I, _P),
    "snes_resident_scales": (
        _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P,
    ),
    "snes_coarse_redmean": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
    ),
}


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into build/ unless this exact build exists;
    returns the library's path. The compiler's resource report (``-Xptxas
    -v``) is kept beside it as a .log file."""
    lib = BUILD_DIR / f"libsnesimage_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), *NVCC_FLAGS, "-o", tmp,
        *(str(p) for p in sorted(SRC_DIR.glob("*.cu"))),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)
    return lib


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {rc}")


def require(t, name: str, dtype, shape: tuple, device) -> int:
    """Validates one kernel operand and returns its data pointer: a
    contiguous CUDA tensor of `dtype` and `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def stream(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


@lru_cache(maxsize=None)
def metric_params() -> MetricParams:
    """Host-side constants of the metric kernels, from the same formulas
    as the torch code (ops/ssimulacra2.py)."""
    from snesimage_torch.ops.ssimulacra2 import blur_taps

    bias = np.float32(OPSIN_BIAS)
    p = MetricParams()
    p.taps[:] = [float(t) for t in blur_taps()]
    p.opsin[:] = [float(v) for v in OPSIN_MATRIX.astype(np.float32).reshape(-1)]
    p.bias = float(bias)
    p.cbrt_bias = float(np.cbrt(bias))
    p.x_scale = XYB_X_SCALE
    p.x_offset = XYB_X_OFFSET
    p.y_offset = XYB_Y_OFFSET
    p.b_offset = XYB_B_OFFSET
    p.ssim_c2 = SSIM_C2
    return p
