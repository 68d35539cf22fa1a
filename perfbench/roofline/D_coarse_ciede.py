"""Kernel D (`coarse_ciede_kernel`, the undithered perceptual visit's
coarse rank).

Per visit, for every candidate: its CIEDE2000 distance to the target, win
test and 4x4 pooled sums at every pixel, then its frame's SSIMULACRA2
features at scales 2-5 (scale 2 straight from the pooled 4x4 means). It
reads the target's Lab, the win rule (the best distance without the
candidate's slot and the tie flag), the masked no-candidate frame and its
4x4 means, the candidates and the source's planes at scales 2-5; it
writes the sums and every candidate's distance plane.
"""

from __future__ import annotations

from perfbench.roofline import (
    CHANNELS, F32, FEATURES, MEAN_OPS_PER_PX, METRIC_OPS_PER_PX, NUM_SCALES,
    REFERENCE_FIELDS, candidates, least_seconds as bound, scale_pixels,
    visits_per_sweep)
from perfbench.roofline.ciede import CIEDE_OPS_PER_PX

KERNEL = "D"


def least_seconds_visit(config: dict) -> float:
    if (config.get("dither") or not config.get("perceptual_palettes")
            or config.get("prescreen_pre")):
        raise ValueError("kernel D runs in undithered perceptual two-level "
                         "visits")
    b = candidates(config)
    px = scale_pixels(config["height"], config["width"])
    coarse = range(2, NUM_SCALES)
    n_bytes = (
        CHANNELS * px[0] * F32  # the target's Lab
        + 2 * px[0] * F32  # the win rule: best distance, tie flag
        + CHANNELS * px[0] * F32  # the masked no-candidate frame
        + CHANNELS * px[2] * F32  # its 4x4 means
        + b * CHANNELS * 2 * F32  # candidates, Lab and linear
        + sum(REFERENCE_FIELDS * CHANNELS * px[s] * F32 for s in coarse)
        + b * len(coarse) * CHANNELS * FEATURES * F32  # the sums
        + b * px[0] * F32)  # the distance planes
    ops = b * (CIEDE_OPS_PER_PX * px[0]
               + (METRIC_OPS_PER_PX - MEAN_OPS_PER_PX) * px[2]
               + sum(METRIC_OPS_PER_PX * px[s] for s in coarse[1:]))
    return bound(n_bytes, ops)


def least_seconds(config: dict, steps: list[int]) -> float:
    return sum(steps) * visits_per_sweep(config) * least_seconds_visit(config)
