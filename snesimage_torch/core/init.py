"""Initialization stage: tile->subpalette assignment and palette k-means.

Counterpart of snesimage_tpu/core/init.py in RGB mode (src/lib.rs:79-189,
330-415): per-tile mean colors over opaque pixels (tiles whose channel
sum is zero excluded), k-means of tile means into subpalettes, flat-filled
initial palettes, and per-subpalette pixel k-means. Pixels are visited in
the reference's x-outer / y-inner tile order, which fixes the first-k
k-means seeding. Perceptual and NES palettes are not ported yet (ROADMAP
queue A items 12-13).
"""

from __future__ import annotations

import numpy as np
import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core.state import QuantState
from snesimage_torch.ops.color import round_half_away_nonneg
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


def _check_rgb_mode(config: QuantConfig) -> None:
    if config.perceptual_palettes or config.nes:
        raise NotImplementedError(
            "perceptual and NES palettes are not ported yet "
            "(ROADMAP queue A items 12-13)"
        )


def tile_pixels(
    state: QuantState, config: QuantConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, 64, 3) int32 rgb and (T, 64) opacity, reference traversal order."""
    rows, cols = _tile_pixel_gather(config)
    dev = state.device
    rows = torch.from_numpy(rows).to(dev)
    cols = torch.from_numpy(cols).to(dev)
    return state.rgb[rows, cols], state.alpha[rows, cols] > 0


def _quantize_center(center: torch.Tensor) -> torch.Tensor:
    """RGB cluster mean -> 5-bit color: round(mean / 8) half away from
    zero, clipped to 31 (src/lib.rs:140-171, 368-401)."""
    return round_half_away_nonneg(center / 8.0).to(torch.int32).clamp(0, 31)


def assign_tiles(state: QuantState, config: QuantConfig) -> QuantState:
    """Cluster tile means into subpalettes and flat-fill initial palettes
    (src/lib.rs:79-189 minus the final remap). Identity when
    subpalette_count == 1."""
    _check_rgb_mode(config)
    if config.subpalette_count == 1:
        return state
    rgb, opaque = tile_pixels(state, config)
    coords = rgb.to(torch.float32)  # (T, 64, 3)
    w = opaque.to(torch.float32).unsqueeze(-1)
    sums = (coords * w).sum(1)  # (T, 3), exact: integer values
    counts = opaque.sum(1).to(torch.float32)
    means = sums / counts.clamp(min=1.0).unsqueeze(-1)
    valid = sums.sum(-1) > 0.0  # reference guard, src/lib.rs:118

    km = lloyd_kmeans(
        means,
        valid,
        config.subpalette_count,
        init_order=torch.from_numpy(_tile_init_order(config)).to(state.device),
    )
    tp = torch.where(valid, km.assignments, 0).reshape(
        config.height_tiles, config.width_tiles
    )
    colors5 = _quantize_center(km.centers)  # (C, 3)
    palette = (
        colors5[:, None, :]
        .expand(config.subpalette_count, config.subpalette_size, 3)
        .contiguous()
    )
    return state.replace(tile_palettes=tp.to(torch.int32), palette=palette)


def recalculate_palettes(state: QuantState, config: QuantConfig) -> QuantState:
    """Per-subpalette pixel k-means into subpalette_size colors
    (src/lib.rs:330-415 minus the final remap), all subpalettes batched."""
    _check_rgb_mode(config)
    rgb, opaque = tile_pixels(state, config)
    coords = rgb.to(torch.float32).reshape(-1, 3)
    tile_of_pixel = state.tile_palettes.reshape(-1).repeat_interleave(64)
    palettes = torch.arange(
        config.subpalette_count, dtype=torch.int32, device=state.device
    )
    masks = (tile_of_pixel[None, :] == palettes[:, None]) & opaque.reshape(-1)
    km = lloyd_kmeans(coords, masks, config.subpalette_size)
    return state.replace(palette=_quantize_center(km.centers))
