"""Headless preview rendering.

Counterpart of snesimage_tpu/preview.py. The reference shows a 640x256
SDL2 window: source at x=0, quantized at x=256, palette swatches at x=512
(src/lib.rs:855-972). This module renders the same composite to a PNG.
"""

from __future__ import annotations

import numpy as np

from snesimage_torch.config import QuantConfig
from snesimage_torch.core.state import QuantState
from snesimage_torch.ops.color import expand_5bit_to_8bit
from snesimage_torch.ops.remap import render_rgb8


def _grid_darken(rgb: np.ndarray) -> np.ndarray:
    """Darken tile-grid rows/cols by x4/5 integer math (src/lib.rs:1056-1063:
    cells with x%8==0 or y%8==0 get c/5*4)."""
    out = rgb.copy()
    mask = np.zeros(rgb.shape[:2], dtype=bool)
    mask[::8, :] = True
    mask[:, ::8] = True
    out[mask] = out[mask] // 5 * 4
    return out


def render_palette_swatches(
    state: QuantState, config: QuantConfig, height: int
) -> np.ndarray:
    """Palette swatch panel, 128 wide: entry ci of subpalette pi drawn as an
    8x8 rect at ((ci+1)*8, pi*8) (src/lib.rs:797-822)."""
    panel = np.zeros((height, 128, 3), dtype=np.uint8)
    entries8 = expand_5bit_to_8bit(state.palette).cpu().numpy()  # (C, S, 3)
    c, s, _ = entries8.shape
    for pi in range(c):
        for ci in range(s):
            x = (ci + 1) * 8
            y = pi * 8
            panel[y : y + 8, x : x + 8] = entries8[pi, ci]
    return panel


def render_preview(
    state: QuantState, config: QuantConfig, *, grid: bool = False
) -> np.ndarray:
    """Composite [source | quantized | palette] frame as (H, W*2+128, 3)."""
    source = state.original[..., :3].cpu().numpy()
    quant = render_rgb8(
        state.palette_map, state.alpha, state.tile_palettes, state.palette
    ).cpu().numpy().astype(np.uint8)
    if grid:
        source = _grid_darken(source)
        quant = _grid_darken(quant)
    swatches = render_palette_swatches(state, config, source.shape[0])
    return np.concatenate([source, quant, swatches], axis=1)


def save_preview(path: str, state: QuantState, config: QuantConfig,
                 **kw) -> None:
    from snesimage_torch.io.image import save_rgb

    save_rgb(path, render_preview(state, config, **kw))
