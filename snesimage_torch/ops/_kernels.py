"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a``,
all of them at once in parallel processes, and the objects link into one
shared library with a plain C interface, loaded through ctypes. The
library lands in ``snesimage_torch/build/`` under a name keyed by a hash of
the sources and flags, so an edit rebuilds and a second process reuses the
build. Nothing builds at import: the first call of `library()` does, and it
raises when no ``nvcc`` is found. Every C entry point launches on the
stream it is given and returns ``cudaGetLastError()``; `check` turns a
non-zero code into an exception.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
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
        ("img_stride", ctypes.c_longlong * MAX_SCALES),
    ]


MAX_LEVELS = 12  # kMaxLevels in csrc/multiscale.cu


class Levels(ctypes.Structure):
    """Mirror of snes::Levels (csrc/multiscale.cu)."""

    _fields_ = [("h", _I * MAX_LEVELS), ("w", _I * MAX_LEVELS)]


class MultiscaleCall(ctypes.Structure):
    """Mirror of snes::MultiscaleCall (csrc/multiscale.cu)."""

    _fields_ = [
        ("frames", _P),
        ("out", _P),
        ("partial", _P),
        ("tickets", _P),
        ("gate", _P),
        ("n_frames", _I),
        ("frames_per_image", _I),
        ("pre_ds", _I),
        ("n_scales", _I),
        ("n_tiled", _I),
        ("n_resident_items", _I),
        ("tiles_total", _I),
        ("tiles_x", _I * MAX_SCALES),
        ("tile_start", _I * (MAX_SCALES + 1)),
        ("lv", Levels),
    ]


class LabParams(ctypes.Structure):
    """Mirror of snes::LabParams (csrc/srgb_lab.cuh)."""

    _fields_ = [
        ("lut", ctypes.c_float * 256),
        ("m", ctypes.c_float * 9),
        ("inv_white", ctypes.c_float * 3),
        ("delta3", ctypes.c_float),
        ("third", ctypes.c_float),
        ("lin_slope", ctypes.c_float),
        ("lin_offset", ctypes.c_float),
    ]


class DitherParams(ctypes.Structure):
    """Mirror of snes::DitherParams (csrc/dither.cu)."""

    _fields_ = [("wgt", ctypes.c_float * 4), ("lab", LabParams)]



_SIGNATURES = {
    "snes_select_colors": (_P, _P, _P, _I, _I, _I, _P),
    "snes_select_colors_prologue": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P,
    ),
    "snes_select_colors_render": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
    ),
    "snes_multiscale": (_P, _P, _P, _P),
    "snes_multiscale_active_clusters": (_P,),
    "snes_coarse_redmean": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
    ),
    "snes_coarse_ciede": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
        _P, _P,
    ),
    "snes_coarse_redmean_active_clusters": (_I, _I, _I),
    "snes_coarse_ciede_active_clusters": (_I, _I, _I),
    "snes_pooled_wins_redmean": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
    ),
    "snes_pooled_wins_ciede": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
    ),
    "snes_dither_remap": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P, _P, _P,
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
    returns the library's path. One nvcc process per source, all started
    together, then one link. The compiler's resource report (``-Xptxas
    -v``) is kept beside the library as a .log file."""
    lib = BUILD_DIR / f"libsnesimage_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(SRC_DIR.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            jobs.append((src.name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log, failed = [], []
        for name, _, proc in jobs:
            out = proc.communicate()[0]
            log.append(f"== {name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if not failed:
            so = Path(tmp) / "lib.so"
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(so),
                 *(str(obj) for _, obj, _ in jobs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            log.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
        lib.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed for {', '.join(failed)}:\n"
                + "".join(log)[-4000:]
            )
        os.replace(so, lib)
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


@lru_cache(maxsize=None)
def entry(name: str):
    """The library's C entry point `name`, looked up once."""
    return getattr(library(), name)


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


def require_images(t, name: str, dtype, shape: tuple, n: int,
                   device) -> tuple[int, int]:
    """Validates an operand that holds `shape` for each of n images: one
    contiguous `shape` (or an (n, *shape) view of it with stride 0 on the
    image axis), which every image shares, or a contiguous (n, *shape).
    Returns its data pointer and the elements from one image to the next
    (0 where shared)."""
    if t.dim() == len(shape) + 1 and t.shape[0] == n and t.stride(0) == 0:
        t = t[0]
    if t.dim() == len(shape):
        return require(t, name, dtype, shape, device), 0
    ptr = require(t, name, dtype, (n, *shape), device)
    return ptr, int(np.prod(shape))


def stream(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a raw handle (read
    without building a Stream object: this runs on every launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


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


@lru_cache(maxsize=None)
def dither_params() -> DitherParams:
    """Host-side constants of kernel G: the damped diffusion weights and
    the Lab conversion's constants, from the functions its twin uses
    (ops/dither.py, ops/color.py)."""
    from snesimage_torch.ops import color
    from snesimage_torch.ops.dither import damped_weights

    p = DitherParams()
    p.wgt[:] = [float(v) for v in damped_weights()]
    p.lab.lut[:] = [float(v) for v in color._srgb_u8_linear_lut()]
    p.lab.m[:] = [float(v) for v in color._RGB_TO_XYZ.reshape(-1)]
    p.lab.inv_white[:] = [color._recip(w) for w in color._D65_WHITE.tolist()]
    p.lab.delta3 = color._f32(color._DELTA**3)
    p.lab.third = color._f32(1.0 / 3.0)
    p.lab.lin_slope = color._recip(3.0 * color._DELTA**2)
    p.lab.lin_offset = color._f32(4.0 / 29.0)
    return p


@lru_cache(maxsize=None)
def dither_params_address() -> int:
    """Where `dither_params()` lies, for the C entry point."""
    return ctypes.addressof(dither_params())
