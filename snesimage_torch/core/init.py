"""Initialization stage: tile->subpalette assignment and palette k-means.

Counterpart of snesimage_tpu/core/init.py (src/lib.rs:79-189, 330-415):
per-tile mean colors over opaque pixels (tiles whose channel sum is zero
excluded), k-means of tile means into subpalettes, flat-filled initial
palettes, and per-subpalette pixel k-means. The k-means runs on RGB, or on
CIELAB with `perceptual_palettes`. Pixels are visited in the reference's
x-outer / y-inner tile order, which fixes the first-k k-means seeding. With
`nes` every quantised colour is snapped to the 56 NES colours.
"""

from __future__ import annotations

import numpy as np
import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core.state import QuantState
from snesimage_torch.ops.color import (
    lab_to_srgb_u8,
    nes_quantize,
    round_half_away_nonneg,
    srgb_u8_to_lab,
)
from snesimage_torch.ops.kmeans import lloyd_kmeans


def _tile_pixel_gather(config: QuantConfig) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) index arrays of shape (T, 64) listing each tile's pixels
    in the reference's x-outer / y-inner order (src/lib.rs:95-96, 338-339)."""
    wt, ht = config.width_tiles, config.height_tiles
    t = np.arange(wt * ht)
    ty, tx = t // wt, t % wt
    x = np.arange(8)
    y = np.arange(8)
    rows = np.broadcast_to(ty[:, None, None] * 8 + y[None, None, :], (len(t), 8, 8))
    cols = np.broadcast_to(tx[:, None, None] * 8 + x[None, :, None], (len(t), 8, 8))
    return rows.reshape(-1, 64), cols.reshape(-1, 64)


def _tile_init_order(config: QuantConfig) -> np.ndarray:
    """Tile priority order for k-means init: tile_x is the outer loop
    (src/lib.rs:89-90), i.e. column-major."""
    wt, ht = config.width_tiles, config.height_tiles
    return np.arange(ht * wt).reshape(ht, wt).T.reshape(-1)


def tile_pixels(
    state: QuantState, config: QuantConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, 64, 3) int32 rgb and (T, 64) opacity, reference traversal order."""
    rows, cols = _tile_pixel_gather(config)
    dev = state.device
    rows = torch.from_numpy(rows).to(dev)
    cols = torch.from_numpy(cols).to(dev)
    return state.rgb[rows, cols], state.alpha[rows, cols] > 0


def _color_coords(rgb_u8: torch.Tensor, perceptual: bool) -> torch.Tensor:
    """Clustering coordinates: CIELAB in perceptual mode, raw RGB otherwise
    (src/lib.rs:100-111, 343-359)."""
    if perceptual:
        return srgb_u8_to_lab(rgb_u8)
    return rgb_u8.to(torch.float32)


def _quantize_center(center: torch.Tensor, config: QuantConfig) -> torch.Tensor:
    """Cluster mean -> 5-bit color (src/lib.rs:140-171, 368-401): a Lab
    mean goes to 8-bit sRGB and is truncated by `// 8`; an RGB mean is
    rounded, round(mean / 8) half away from zero, and clipped to 31. NES
    mode snaps the result to the 56 NES colours."""
    if config.perceptual_palettes:
        rgb5 = lab_to_srgb_u8(center) // 8
    else:
        rgb5 = round_half_away_nonneg(center / 8.0).to(torch.int32).clamp(0, 31)
    if config.nes:
        rgb5 = nes_quantize(rgb5, config.perceptual_palettes)
    return rgb5


def assign_tiles(state: QuantState, config: QuantConfig) -> QuantState:
    """Cluster tile means into subpalettes and flat-fill initial palettes
    (src/lib.rs:79-189 minus the final remap). Identity when
    subpalette_count == 1."""
    if config.subpalette_count == 1:
        return state
    rgb, opaque = tile_pixels(state, config)
    coords = _color_coords(rgb, config.perceptual_palettes)  # (T, 64, 3)
    w = opaque.to(torch.float32).unsqueeze(-1)
    sums = (coords * w).sum(1)  # (T, 3), exact for RGB: integer values
    counts = opaque.sum(1).to(torch.float32)
    means = sums / counts.clamp(min=1.0).unsqueeze(-1)
    # The reference guard (src/lib.rs:118), copied as it is: in Lab the
    # sums can be negative, and such tiles are excluded too.
    valid = sums.sum(-1) > 0.0

    km = lloyd_kmeans(
        means,
        valid,
        config.subpalette_count,
        init_order=torch.from_numpy(_tile_init_order(config)).to(state.device),
    )
    tp = torch.where(valid, km.assignments, 0).reshape(
        config.height_tiles, config.width_tiles
    )
    colors5 = _quantize_center(km.centers, config)
    palette = (
        colors5[:, None, :]
        .expand(config.subpalette_count, config.subpalette_size, 3)
        .contiguous()
    )
    return state.replace(tile_palettes=tp.to(torch.int32), palette=palette)


def recalculate_palettes(state: QuantState, config: QuantConfig) -> QuantState:
    """Per-subpalette pixel k-means into subpalette_size colors
    (src/lib.rs:330-415 minus the final remap), all subpalettes batched."""
    rgb, opaque = tile_pixels(state, config)
    coords = _color_coords(rgb, config.perceptual_palettes).reshape(-1, 3)
    tile_of_pixel = state.tile_palettes.reshape(-1).repeat_interleave(64)
    palettes = torch.arange(
        config.subpalette_count, dtype=torch.int32, device=state.device
    )
    masks = (tile_of_pixel[None, :] == palettes[:, None]) & opaque.reshape(-1)
    km = lloyd_kmeans(coords, masks, config.subpalette_size)
    return state.replace(
        palette=_quantize_center(km.centers, config)
    )
