"""The reference program's JSON output (src/lib.rs:579-625, serde_json).

An object with three keys in this order, written with no spaces:

- "palette": 16 numbers for each subpalette: 0 for entry 0 (transparent),
  then each entry packed as BGR555 (r | g << 5 | b << 10), then zeros up
  to 16;
- "tile_palettes": the subpalette of each 8x8 tile, tiles row-major;
- "tiles": for each tile, row-major, its 64 pixels row-major, each the
  pixel's entry plus one, or 0 where the pixel is transparent.

`decode` reads the arrays back and counts what breaks the format; a text
that is not the reference's encoding of what it decodes to counts too.
"""

from __future__ import annotations

import json

import numpy as np


def encode(palette5, tile_palettes, palette_map, alpha) -> str:
    palette5 = np.asarray(palette5, np.int64)
    c, s, _ = palette5.shape
    packed = palette5[..., 0] | (palette5[..., 1] << 5) | (palette5[..., 2] << 10)
    palette = np.zeros((c, 16), np.int64)
    palette[:, 1:s + 1] = packed
    ht, wt = np.asarray(tile_palettes).shape
    values = np.where(np.asarray(alpha) > 0, np.asarray(palette_map) + 1, 0)
    tiles = values.reshape(ht, 8, wt, 8).transpose(0, 2, 1, 3).reshape(
        ht * wt, 64)
    obj = {"palette": palette.reshape(-1).tolist(),
           "tile_palettes": np.asarray(tile_palettes).reshape(-1).tolist(),
           "tiles": tiles.tolist()}
    return json.dumps(obj, separators=(",", ":"))


def decode(text: str, subpalette_count: int, subpalette_size: int,
           alpha: np.ndarray):
    """(palette5 (C, S, 3), tile_palettes (Ht, Wt), palette_map (H, W),
    violations). Out-of-range values are clipped so that the rest of the
    check can go on; each one counts as a violation."""
    h, w = alpha.shape
    ht, wt = h // 8, w // 8
    c, s = subpalette_count, subpalette_size
    bad = 0
    try:
        obj = json.loads(text)
    except ValueError:
        obj = None
    if not isinstance(obj, dict) or list(obj) != ["palette", "tile_palettes",
                                                  "tiles"]:
        return None, None, None, 1
    try:
        palette = np.asarray(obj["palette"], np.int64).reshape(c, 16)
        tp = np.asarray(obj["tile_palettes"], np.int64).reshape(ht, wt)
        tiles = np.asarray(obj["tiles"], np.int64).reshape(ht, wt, 8, 8)
    except (ValueError, TypeError):
        return None, None, None, 1
    bad += int((palette[:, 0] != 0).sum()) + int((palette[:, s + 1:] != 0).sum())
    bad += int(((palette < 0) | (palette >= 1 << 15)).sum())
    bad += int(((tp < 0) | (tp >= c)).sum())
    values = tiles.transpose(0, 2, 1, 3).reshape(h, w)
    live = alpha > 0
    bad += int(((values < 1) | (values > s))[live].sum())
    bad += int((values[~live] != 0).sum())
    palette = np.clip(palette, 0, (1 << 15) - 1)
    entries = palette[:, 1:s + 1]
    palette5 = np.stack([entries & 31, (entries >> 5) & 31,
                         (entries >> 10) & 31], axis=-1)
    tp = np.clip(tp, 0, c - 1)
    pmap = np.where(live, np.clip(values - 1, 0, s - 1), 0)
    if encode(palette5, tp, pmap, alpha) != text:
        bad += 1
    return palette5, tp, pmap, bad
