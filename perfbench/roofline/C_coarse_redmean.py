"""Kernel C (`coarse_redmean_kernel`, the undithered visit's coarse rank).

Per visit, for every candidate: its red-mean distance, win test and 4x4
pooled sums at every pixel, then its frame's SSIMULACRA2 features at
scales 2-5 (scale 2 straight from the pooled 4x4 means). It reads the
target, the win rule, the masked no-candidate frame and its 4x4 means,
the candidates and the source's planes at scales 2-5; it writes the sums.
"""

from __future__ import annotations

from perfbench.roofline import (
    CHANNELS, F32, FEATURES, MEAN_OPS_PER_PX, METRIC_OPS_PER_PX, NUM_SCALES,
    REDMEAN_OPS_PER_PX, REFERENCE_FIELDS, candidates, least_seconds as bound,
    scale_pixels, visits_per_sweep)

KERNEL = "C"


def least_seconds_visit(config: dict) -> float:
    if config.get("dither") or config.get("perceptual_palettes") or config.get(
            "prescreen_pre"):
        raise ValueError("kernel C runs in undithered red-mean two-level visits")
    b = candidates(config)
    px = scale_pixels(config["height"], config["width"])
    coarse = range(2, NUM_SCALES)
    n_bytes = (
        CHANNELS * px[0] * F32  # target
        + px[0] * F32  # the win rule's best distance
        + CHANNELS * px[0] * F32  # the masked no-candidate frame
        + CHANNELS * px[2] * F32  # its 4x4 means
        + b * CHANNELS * 2 * F32  # candidates, 8-bit and linear
        + sum(REFERENCE_FIELDS * CHANNELS * px[s] * F32 for s in coarse)
        + b * len(coarse) * CHANNELS * FEATURES * F32)
    ops = b * (REDMEAN_OPS_PER_PX * px[0]
               + (METRIC_OPS_PER_PX - MEAN_OPS_PER_PX) * px[2]
               + sum(METRIC_OPS_PER_PX * px[s] for s in coarse[1:]))
    return bound(n_bytes, ops)


def least_seconds(config: dict, steps: list[int]) -> float:
    return sum(steps) * visits_per_sweep(config) * least_seconds_visit(config)
