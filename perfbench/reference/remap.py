"""The palette map a palette gives, and the frame that the map renders.

From the reference program (aexoden/snesimage, src/lib.rs) as the port's
README describes it:

- a 5-bit channel c shows as the 8-bit value c * 8 + c // 4;
- each pixel takes the entry of its tile's subpalette at the least
  red-mean distance (scaled by 512 to an integer,
  (1024 + r1 + r2) dr^2 + 2048 dg^2 + (1534 - r1 - r2) db^2), the first
  entry winning a tie (a strict less-than scan); a transparent pixel maps
  to 0 and shows black;
- with dithering, Floyd-Steinberg error diffusion: each pixel adds the
  error it has received to its colour, rounds the sum (clamped to
  [0, 255], half away from zero) to the 8-bit target it matches, and
  hands 0.8 * [7, 3, 5, 1] / 16 of its own error (target minus the chosen
  colour) to its E, SW, S and SE neighbours; a transparent pixel passes
  on what it received. The program defines the arithmetic in float32,
  with a pixel's received error summed as (SE + S) + (E + SW), the order
  in which its neighbours finish under the program's wavefront. Error
  diffusion is chaotic, so the reference keeps that precision and order.

`dtype` None keeps the exact arithmetic (integer distances, float32
diffusion); a float dtype computes the distances and the diffusion in it
(bfloat16 for the control).
"""

from __future__ import annotations

import numpy as np
import torch


def expand(palette5: np.ndarray) -> np.ndarray:
    p = np.asarray(palette5, dtype=np.int64)
    return p * 8 + p // 4


def tile_map(tile_palettes: np.ndarray) -> np.ndarray:
    """(Ht, Wt) per-tile values -> (H, W) per-pixel values."""
    return np.repeat(np.repeat(np.asarray(tile_palettes), 8, 0), 8, 1)


def render(palette5, tile_palettes, palette_map, alpha) -> np.ndarray:
    """(H, W, 3) uint8 frame of a palette, tile assignment and map."""
    entries = expand(palette5)
    rgb = entries[tile_map(tile_palettes), np.asarray(palette_map)]
    rgb[np.asarray(alpha) == 0] = 0
    return rgb.astype(np.uint8)


def red_mean(entries8: torch.Tensor, target8: torch.Tensor, dtype=None):
    """512 x the red-mean distance squared, broadcast over the leading
    axes; exact in int64 when `dtype` is None."""
    if dtype is None:
        e, t = entries8.to(torch.int64), target8.to(torch.int64)
    else:
        e, t = entries8.to(dtype), target8.to(dtype)
    d = e - t
    rsum = e[..., 0] + t[..., 0]
    return ((1024 + rsum) * d[..., 0] * d[..., 0]
            + 2048 * d[..., 1] * d[..., 1]
            + (1534 - rsum) * d[..., 2] * d[..., 2])


def remap(rgb, alpha, tile_palettes, palette5, dtype=None) -> np.ndarray:
    """(H, W) nearest-entry map, the first entry winning a tie."""
    entries = torch.from_numpy(expand(palette5))[
        torch.from_numpy(tile_map(tile_palettes)).long()]  # (H, W, S, 3)
    d = red_mean(entries, torch.from_numpy(np.asarray(rgb))[..., None, :],
                 dtype)
    idx = torch.argmin(d, dim=-1).numpy()
    return np.where(np.asarray(alpha) > 0, idx, 0)


def dither_weights(dtype=torch.float32) -> torch.Tensor:
    """[E, SW, S, SE] weights with the 0.8 damping, rounded as float32
    products."""
    w = np.array([7.0, 3.0, 5.0, 1.0], np.float32) / np.float32(16.0)
    return torch.from_numpy(w * np.float32(0.8)).to(dtype)


def dither(rgb, alpha, tile_palettes, palette5, dtype=None) -> np.ndarray:
    """(H, W) Floyd-Steinberg map. The pixels of one skewed column
    c = x + 2y depend only on earlier columns, so each column is one step."""
    ftype = torch.float32 if dtype is None else dtype
    h, w, _ = rgb.shape
    orig = torch.from_numpy(np.asarray(rgb, np.float32)).to(ftype)
    live = torch.from_numpy(np.asarray(alpha) > 0)
    entries8 = torch.from_numpy(expand(palette5))  # (C, S, 3)
    entries_f = entries8.to(ftype)
    tiles = torch.from_numpy(tile_map(tile_palettes)).long()
    wgt = dither_weights(ftype)
    # What each pixel received from each neighbour; zero where none is.
    got = {k: torch.zeros((h, w, 3), dtype=ftype)
           for k in ("e", "sw", "s", "se")}
    out = np.zeros((h, w), np.int64)
    for c in range(w + 2 * h - 2):
        y = torch.arange(max(0, (c - w + 2) // 2), min(h - 1, c // 2) + 1)
        x = c - 2 * y
        keep = (x >= 0) & (x < w)
        y, x = y[keep], x[keep]
        if not len(y):
            continue
        acc = ((got["se"][y, x] + got["s"][y, x])
               + (got["e"][y, x] + got["sw"][y, x]))
        target = orig[y, x] + acc
        t8 = torch.floor(torch.clamp(target, 0.0, 255.0) + 0.5)
        sub = entries8[tiles[y, x]]  # (n, S, 3)
        d = red_mean(sub, t8.to(torch.int64)[:, None, :], dtype)
        idx = torch.argmin(d, dim=-1)
        chosen = entries_f[tiles[y, x], idx]
        lv = live[y, x]
        err = torch.where(lv[:, None], target - chosen, acc)
        out[y.numpy(), x.numpy()] = torch.where(lv, idx, 0).numpy()
        east = x + 1 < w
        got["e"][y[east], x[east] + 1] = err[east] * wgt[0]
        below = y + 1 < h
        sw = below & (x > 0)
        got["sw"][y[sw] + 1, x[sw] - 1] = err[sw] * wgt[1]
        got["s"][y[below] + 1, x[below]] = err[below] * wgt[2]
        se = below & east
        got["se"][y[se] + 1, x[se] + 1] = err[se] * wgt[3]
    return out


def palette_map(rgb, alpha, tile_palettes, palette5, dithered: bool,
                dtype=None) -> np.ndarray:
    if dithered:
        return dither(rgb, alpha, tile_palettes, palette5, dtype)
    return remap(rgb, alpha, tile_palettes, palette5, dtype)
