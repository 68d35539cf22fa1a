"""Automatic tile->subpalette reassignment.

Counterpart of snesimage_tpu/core/reassign.py. The reference never
reassigns tiles after the initial clustering (TODO.md:36-37 wishes for it;
its only mechanism is a GUI click, src/lib.rs:1005-1024). This extension
moves every tile to the subpalette whose entries are nearest its pixels:
the sum over the tile of each pixel's nearest-entry distance (red-mean or
CIEDE2000, as the run compares colours), the criterion the per-pixel remap
minimises, lifted to tiles.

With dithering the criterion is an undithered proxy and can worsen the
error (the JAX package measured +8 on the bench image).
"""

from __future__ import annotations

import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core.state import QuantState
from snesimage_torch.ops.remap import entry_distances


def auto_reassign_tiles(state: QuantState, config: QuantConfig) -> QuantState:
    """The state with each tile moved to its best subpalette (the first
    among ties, as `argmin` takes it); fully transparent tiles go to
    subpalette 0 (src/lib.rs:58). The palette map is stale afterwards:
    callers remap (`pipeline.optimize` does)."""
    c, ht, wt = config.subpalette_count, config.height_tiles, config.width_tiles
    opaque = state.alpha > 0
    dmin = torch.stack([
        entry_distances(state.rgb, torch.full_like(state.tile_palettes, p),
                        state.palette, config.perceptual_palettes).amin(-1)
        for p in range(c)
    ], dim=-1).to(torch.float32)  # (H, W, C)
    dmin = torch.where(opaque[..., None], dmin, 0.0)
    per_tile = dmin.reshape(ht, 8, wt, 8, c).sum(dim=(1, 3))
    tp = torch.argmin(per_tile, dim=-1).to(torch.int32)
    opaque_any = opaque.reshape(ht, 8, wt, 8).any(dim=3).any(dim=1)
    return state.replace(tile_palettes=torch.where(opaque_any, tp, 0))
