"""The least time a kernel could take for the work a cell gave it.

Rates and operation counts are copied from `chip_smoke.py` (its bound
arithmetic, lines 208-245): NVIDIA's H100 SXM data sheet at the full 700 W
(3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor cores), and
the float32 operations per pixel of each kernel's algorithm. A kernel's
least time for one call is the larger of its bytes over the memory rate
and its operations over the float32 rate; each input byte counts once when
read and each output byte once when written. The calls are the stages of
the visit that the cell's recipe runs (the candidates it scores and the
scales it scores them at), counted from the shapes, never from launch
counters or from how a kernel splits its work. Each kernel's file
(`B_multiscale.py`, ...) gives `least_seconds(config, steps)`: the least
time for the images of the traced window, `steps` being each image's
sweeps.
"""

from __future__ import annotations

MEMORY_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32 = 4  # bytes of a float32 or int32
# One pyramid scale of SSIMULACRA2, per pixel of the scale: the 2x2 mean
# that makes it 12, positive XYB 32, the horizontal blur of three fields
# 255 and the vertical 306, the moments 75.
METRIC_OPS_PER_PX = 680
MEAN_OPS_PER_PX = 12
# A red-mean distance, the win test and the pooled sums (kernel C).
REDMEAN_OPS_PER_PX = 17
# Kernel G per pixel and candidate: the error window 40; per opaque pixel
# the target and its rounding 15, and per entry of the subpalette a
# red-mean distance and compare 14 (integer operations counted at the
# float32 rate).
DITHER_OPS_PER_PX = 40
DITHER_OPS_PER_LIVE_PX = 15
DITHER_REDMEAN_OPS_PER_ENTRY = 14
NUM_SCALES = 6
REFERENCE_FIELDS = 3  # img1, mu1, s11 of the source, per scale
CHANNELS = 3
FEATURES = 6


def least_seconds(n_bytes: float, ops: float) -> float:
    return max(n_bytes / MEMORY_BYTES_PER_S, ops / F32_OPS_PER_S)


def scale_pixels(height: int, width: int) -> list[int]:
    """Pixels of each scale of the pyramid (an odd side rounds up)."""
    out = []
    for _ in range(NUM_SCALES):
        out.append(height * width)
        height, width = (height + 1) // 2, (width + 1) // 2
    return out


def visits_per_sweep(config: dict) -> int:
    """Slot visits of a channel sweep: every entry of every subpalette,
    each of its three channels."""
    if config.get("schedule") != "channel" or config.get("nes"):
        raise ValueError("the roofline counts only channel sweeps")
    return config["subpalette_count"] * config["subpalette_size"] * 3


def candidates(config: dict) -> int:
    """Candidates of a channel visit: the 32 values of the channel and the
    explore draws."""
    if config.get("channel_window"):
        raise ValueError("the roofline does not count windowed visits")
    return 32 + config.get("channel_explore", 0)


def metric_call(config: dict, frames: int, first: int, scales: int,
                pre_ds: int) -> float:
    """Least seconds of one metric call (kernel B): `frames` frames at the
    resolution of scale first - pre_ds, scored at scales first ..
    first + scales - 1 against the source's pyramid."""
    px = scale_pixels(config["height"], config["width"])
    level = first - pre_ds
    n_bytes = (frames * CHANNELS * px[level] * F32
               + sum(REFERENCE_FIELDS * CHANNELS * px[s] * F32
                     for s in range(first, first + scales))
               + frames * scales * CHANNELS * FEATURES * F32)
    ops = sum(MEAN_OPS_PER_PX * px[s] for s in range(level + 1, first))
    ops += sum((METRIC_OPS_PER_PX - (MEAN_OPS_PER_PX if s == level else 0))
               * px[s] for s in range(first, first + scales))
    return least_seconds(n_bytes, frames * ops)
