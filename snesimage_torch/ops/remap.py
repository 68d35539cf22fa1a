"""Pixel -> palette-entry remap and linear frame rendering.

Counterpart of snesimage_tpu/ops/remap.py, undithered path: the remap is
a per-pixel argmin over the pixel's subpalette with the exact int32
red-mean distance, or CIEDE2000 in perceptual mode (src/lib.rs:780-792),
ties to the lowest entry index (the reference's strict-less-than scan);
transparent pixels map to 0 and render as black.
"""

from __future__ import annotations

import torch

from snesimage_torch.ops.color import (
    ciede2000,
    expand_5bit_to_8bit,
    red_mean_sq_scaled,
    srgb_u8_to_lab,
    srgb_u8_to_linear,
)


def tile_pixel_map(tile_palettes: torch.Tensor) -> torch.Tensor:
    """(Ht, Wt) per-tile values -> (H, W) per-pixel values."""
    return tile_palettes.repeat_interleave(8, 0).repeat_interleave(8, 1)


def entry_distances(
    target_u8: torch.Tensor,
    tile_palettes: torch.Tensor,
    palette5: torch.Tensor,
    perceptual: bool = False,
) -> torch.Tensor:
    """(H, W, S) distances from each (H, W, 3) 8-bit target pixel to the
    entries of its own subpalette: int32 scaled red-mean, or float32
    CIEDE2000 when `perceptual`."""
    entries8 = expand_5bit_to_8bit(palette5)  # (C, S, 3)
    tp_pix = tile_pixel_map(tile_palettes).long()
    target_u8 = target_u8.to(torch.int32).unsqueeze(-2)
    if perceptual:
        # The (C, S) entry table goes to Lab once, then is gathered. The
        # reference's order: color_distance_cielab(entry, target).
        return ciede2000(srgb_u8_to_lab(entries8)[tp_pix],
                         srgb_u8_to_lab(target_u8))
    return red_mean_sq_scaled(entries8[tp_pix], target_u8)


def remap_undithered(
    original_rgb: torch.Tensor,
    alpha: torch.Tensor,
    tile_palettes: torch.Tensor,
    palette5: torch.Tensor,
    perceptual: bool = False,
) -> torch.Tensor:
    """Nearest-entry remap with zero accumulated error: (H, W) int32."""
    d = entry_distances(original_rgb, tile_palettes, palette5, perceptual)
    idx = torch.argmin(d, dim=-1).to(torch.int32)
    return torch.where(alpha > 0, idx, 0)


def render_linear(
    palette_map: torch.Tensor,
    alpha: torch.Tensor,
    tile_palettes: torch.Tensor,
    palette5: torch.Tensor,
) -> torch.Tensor:
    """(H, W, 3) linear-RGB rendering: the C*S entries are decoded once
    through the exact table, then gathered per pixel."""
    entries_lin = srgb_u8_to_linear(expand_5bit_to_8bit(palette5))
    c, s, _ = entries_lin.shape
    color_index = tile_pixel_map(tile_palettes) * s + palette_map
    lin = entries_lin.reshape(c * s, 3)[color_index.long()]
    return torch.where((alpha > 0).unsqueeze(-1), lin, 0.0)
