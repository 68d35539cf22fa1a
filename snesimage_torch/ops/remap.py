"""Pixel -> palette-entry remap and linear frame rendering.

Counterpart of snesimage_tpu/ops/remap.py, undithered red-mean path: the
remap is a per-pixel argmin over the pixel's subpalette with the exact
int32 red-mean distance, ties to the lowest entry index (the reference's
strict-less-than scan, src/lib.rs:780-792); transparent pixels map to 0
and render as black.
"""

from __future__ import annotations

import torch

from snesimage_torch.ops.color import (
    expand_5bit_to_8bit,
    red_mean_sq_scaled,
    srgb_u8_to_linear,
)


def tile_pixel_map(tile_palettes: torch.Tensor) -> torch.Tensor:
    """(Ht, Wt) per-tile values -> (H, W) per-pixel values."""
    return tile_palettes.repeat_interleave(8, 0).repeat_interleave(8, 1)


def entry_distances(
    target_u8: torch.Tensor, sub_entries8: torch.Tensor
) -> torch.Tensor:
    """(..., S) scaled red-mean distances from (..., 3) targets to their
    (..., S, 3) subpalette entries (int32)."""
    return red_mean_sq_scaled(sub_entries8, target_u8.unsqueeze(-2))


def remap_undithered(
    original_rgb: torch.Tensor,
    alpha: torch.Tensor,
    tile_palettes: torch.Tensor,
    palette5: torch.Tensor,
) -> torch.Tensor:
    """Nearest-entry remap with zero accumulated error: (H, W) int32."""
    entries8 = expand_5bit_to_8bit(palette5)  # (C, S, 3)
    sub = entries8[tile_pixel_map(tile_palettes).long()]  # (H, W, S, 3)
    d = entry_distances(original_rgb.to(torch.int32), sub)
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
