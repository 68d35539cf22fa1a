"""The perceptual deployment (`--perceptual-palettes`): its remap and its
initial state, from the source.

From the reference program (src/lib.rs:79-189, 330-415, 1090-1100) as the
port's README and core/init.py describe it:

- remap: each opaque pixel takes the entry of its tile's subpalette at the
  least CIEDE2000 distance between the pixel's CIELAB and the entry's
  (a 5-bit channel c shows as c * 8 + c // 4), the first entry winning a
  tie; a transparent pixel maps to 0;
- initial state: as perfbench/reference/init.py with the clustering in
  CIELAB: each tile's mean Lab over its opaque pixels, the tiles whose
  Lab sum is not positive left out (the reference's guard `sum > 0`,
  kept although Lab sums can be negative), Lloyd's k-means of those means
  into the subpalettes, then of each subpalette's pixels into its
  colours; each centre becomes lab_to_srgb_u8(centre) // 8, truncated.

The k-means is perfbench/reference/init.py's. Its points are Lab
coordinates in the program's float32 steps (perfbench/reference/lab.py),
and a tile's Lab sum is a float32 sum of its 64 pixels, as the program
takes it: a near tie decides which cluster a tile joins, so the reference
rounds where the program does. `dtype` bfloat16 (the control) computes
every step in it.

The program computes its distances in float32 (Lab coordinates off the
exact ones by up to LAB_ERROR, each square root and transcendental rounded
once). So the check (`remap_off`) takes CIEDE2000 in float64, over both of
its branches where the program's hues could lie either side of 180
degrees apart (lab.ciede2000 with `lab_error`), and counts a pixel only
where its entry is at least TAU further than another entry could be, or
where an identical colour comes earlier in the subpalette (identical
colours tie in any arithmetic, and the first wins).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import lab
from perfbench.reference.init import kmeans
from perfbench.reference.remap import expand, tile_map

# The largest |float32 - float64| of a Lab coordinate that the program's
# conversion gives, over all 2^24 8-bit colours (6.886e-05), rounded up.
LAB_ERROR = 7e-5
# Twice the largest distance of the program's float32 CIEDE2000 from the
# float64 range of lab.ciede2000 (LAB_ERROR), 2 x 0.0520 rounded up, over
# every 5-bit entry against every grey and every colour one step from a
# grey (near greys have the least defined hue, so the largest error): a
# pixel's float32 argmin can be that much worse in float64 than the best
# entry, since its own distance and the best one's are each off.
TAU = 0.15
ROWS = 32  # image rows a step of the remap takes at once


def _entries_lab(palette5, dtype) -> torch.Tensor:
    """(C, S, 3) Lab of every entry's 8-bit colour."""
    return lab.srgb_to_lab(expand(palette5), dtype)


def _rows(rgb, tile_palettes, palette5, dtype, lab_error=None):
    """For each block of ROWS rows: (rows, (n, W, S) distances of each
    pixel to its tile's entries; with `lab_error` a (least, largest)
    pair)."""
    rgb = np.asarray(rgb)
    tiles = torch.from_numpy(tile_map(tile_palettes)).long()
    entries = _entries_lab(palette5, dtype)
    for y in range(0, rgb.shape[0], ROWS):
        px = lab.srgb_to_lab(rgb[y:y + ROWS], dtype)[..., None, :]
        yield slice(y, y + ROWS), lab.ciede2000(px, entries[tiles[y:y + ROWS]],
                                                lab_error)


def palette_map(rgb, alpha, tile_palettes, palette5, dtype=None) -> np.ndarray:
    """(H, W) nearest-entry map by CIEDE2000, the first entry winning a
    tie; `dtype` None is float64."""
    out = np.zeros(np.asarray(alpha).shape, np.int64)
    for rows, d in _rows(rgb, tile_palettes, palette5,
                         torch.float64 if dtype is None else dtype):
        out[rows] = torch.argmin(d, dim=-1).numpy()
    return np.where(np.asarray(alpha) > 0, out, 0)


def remap_off(rgb, alpha, tile_palettes, palette5, palette_map) -> int:
    """Opaque pixels whose entry in `palette_map` the float32 program
    cannot have chosen (module docstring)."""
    pmap = torch.from_numpy(np.asarray(palette_map)).long()
    live = torch.from_numpy(np.asarray(alpha) > 0)
    entries = torch.from_numpy(expand(palette5))  # (C, S, 3)
    tiles = torch.from_numpy(tile_map(tile_palettes)).long()
    s = entries.shape[1]
    # same[c, j, k]: entries j and k of subpalette c are one colour.
    same = (entries[:, :, None] == entries[:, None, :]).all(-1)
    earlier = torch.tril(torch.ones(s, s, dtype=torch.bool), -1)
    twin = (same & earlier).any(-1)  # (C, S): an identical colour before it
    off = 0
    for rows, (least, largest) in _rows(rgb, tile_palettes, palette5,
                                        torch.float64, LAB_ERROR):
        m = pmap[rows]
        chosen = least.gather(-1, m[..., None])[..., 0]
        far = chosen > largest.min(-1).values + TAU
        bad = (far | twin[tiles[rows], m]) & live[rows]
        off += int(bad.sum())
    return off


def initial_state(rgba: np.ndarray, subpalette_count: int,
                  subpalette_size: int, dtype=None):
    """(tile_palettes (Ht, Wt), palette5 (C, S, 3), palette_map (H, W)) of
    the perceptual initialisation; `dtype` None is the program's float32
    arithmetic (its map by float64 CIEDE2000)."""
    ftype = torch.float32 if dtype is None else dtype
    h, w, _ = rgba.shape
    ht, wt = h // 8, w // 8
    alpha = rgba[..., 3]
    # (Ht * Wt, 64 [x-outer, y-inner], 3): each tile's pixels.
    tiles_rgb = np.ascontiguousarray(rgba[..., :3].reshape(
        ht, 8, wt, 8, 3).transpose(0, 2, 3, 1, 4)).reshape(ht * wt, 64, 3)
    live = torch.from_numpy(np.ascontiguousarray((alpha > 0).reshape(
        ht, 8, wt, 8).transpose(0, 2, 3, 1)).reshape(ht * wt, 64))
    # The program's float32 Lab and float32 tile sums: a tile near the
    # border of two clusters joins one or the other by their last bits.
    coords = lab.srgb_to_lab(tiles_rgb, ftype)
    sums = (coords * live[..., None].to(ftype)).sum(1)
    means = sums / torch.clamp(live.sum(1).to(ftype), min=1.0)[:, None]
    valid = (sums.sum(-1) > 0).reshape(ht, wt).numpy()
    tile_palettes = np.zeros((ht, wt), np.int64)
    if subpalette_count > 1:
        order = [(ty, tx) for tx in range(wt) for ty in range(ht)
                 if valid[ty, tx]]
        pts = (means[[ty * wt + tx for ty, tx in order]] if order
               else torch.zeros((0, 3), dtype=ftype))
        _, assign = kmeans(pts, subpalette_count)
        for (ty, tx), a in zip(order, assign.tolist()):
            tile_palettes[ty, tx] = a
    palette5 = np.zeros((subpalette_count, subpalette_size, 3), np.int64)
    flat = coords.reshape(-1, 3)
    flat_pal = torch.from_numpy(np.repeat(tile_palettes.reshape(-1), 64))
    for p in range(subpalette_count):
        centers, _ = kmeans(flat[live.reshape(-1) & (flat_pal == p)],
                            subpalette_size)
        palette5[p] = (lab.lab_to_srgb_u8(centers) // 8).numpy()
    pmap = palette_map(rgba[..., :3], alpha, tile_palettes, palette5, dtype)
    return tile_palettes, palette5, pmap
