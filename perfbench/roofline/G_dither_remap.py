"""Kernel G (`dither_remap_kernel`, Floyd-Steinberg maps of candidates).

Per visit, one dithered map of the whole image for every candidate put
into the visited slot; per image, the two full remaps of the
initialisation (one candidate each). It reads the source, the tile map,
the palette and the candidates, and writes the maps.
"""

from __future__ import annotations

from perfbench.roofline import (
    DITHER_OPS_PER_LIVE_PX, DITHER_OPS_PER_PX, DITHER_REDMEAN_OPS_PER_ENTRY,
    F32, candidates, least_seconds as bound, visits_per_sweep)

KERNEL = "G"
INIT_REMAPS = 2  # `initialize` and `cluster` each remap once


def call(config: dict, b: int) -> float:
    h, w = config["height"], config["width"]
    c, s = config["subpalette_count"], config["subpalette_size"]
    px = h * w  # every pixel of the benchmark's images is opaque
    n_bytes = (px * 4  # RGBA source, one byte a channel
               + (h // 8) * (w // 8) * F32 + c * s * 3 * F32 + b * 3 * F32
               + b * px * F32)
    ops = b * (DITHER_OPS_PER_PX * px
               + px * (DITHER_OPS_PER_LIVE_PX + s * DITHER_REDMEAN_OPS_PER_ENTRY))
    return bound(n_bytes, ops)


def least_seconds(config: dict, steps: list[int]) -> float:
    if not config.get("dither") or config.get("perceptual_palettes") or (
            config.get("dither_proxy")):
        raise ValueError("kernel G's roofline counts red-mean dithered visits")
    visit = call(config, candidates(config))
    return sum(INIT_REMAPS * call(config, 1)
               + n * visits_per_sweep(config) * visit for n in steps)
