"""The initial state: tile assignment, palettes and map, from the source.

From the reference program (src/lib.rs:79-189 and 330-415) as the port's
README and core/init.py describe it:

1. Each 8x8 tile's mean colour over its opaque pixels; tiles whose channel
   sum is zero take no part.
2. Lloyd's k-means of those means into `subpalette_count` clusters, the
   centres starting at the first valid tiles in column-major tile order;
   each tile's cluster is its subpalette (0 for the tiles left out).
3. For each subpalette, Lloyd's k-means of its tiles' opaque pixels into
   `subpalette_size` colours, the centres starting at its first pixels in
   tile order (tiles row-major, each tile's pixels x-outer, y-inner); a
   centre with no pixel is black. Each centre becomes the 5-bit colour
   round(centre / 8), half away from zero, clamped to 31.
4. The palette map of that palette (perfbench/reference/remap.py).

Lloyd's k-means as the program defines it: a point goes to the centre of
least ||c||^2 - 2 x.c, the first centre winning a tie; a centre moves to
the mean of its points (float64 sums rounded to float32, then a float32
division) or stays where it has none; the loop stops once no centre moves
by more than 1e-6 (squared), after 100 rounds at most. The program fixes
the float32 arithmetic of the distance: x.c summed one coordinate at a
time in order, each product rounded, and ||c||^2 with each square added in
one rounding. A near tie decides which cluster a point joins, so the
reference keeps that arithmetic; `dtype` bfloat16 (the control) computes
the same steps in bfloat16.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from perfbench.reference.remap import palette_map

TOL = 1e-6
MAX_ROUNDS = 100


def round_f32(q: Fraction) -> float:
    """q rounded once to the nearest float32, ties to even (normal range)."""
    if q == 0:
        return 0.0
    sign = -1 if q < 0 else 1
    q = abs(q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    # Scale so that the significand m has 24 bits: 2^23 <= m < 2^24.
    shift = 23 - e
    m = q * (Fraction(2) ** shift)
    while m >= 2 ** 24:
        m /= 2
        shift -= 1
    while m < 2 ** 23:
        m *= 2
        shift += 1
    whole = int(m)
    rest = m - whole
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and whole % 2):
        whole += 1
    return sign * float(np.float32(Fraction(whole) / Fraction(2) ** shift))


def _square_norms(centers: torch.Tensor) -> torch.Tensor:
    """(k,) ||c||^2: the first square rounded, each later square added in
    one rounding; in a low precision, plain products and sums."""
    if centers.dtype != torch.float32:
        c2 = centers[:, 0] * centers[:, 0]
        for j in range(1, centers.shape[1]):
            c2 = c2 + centers[:, j] * centers[:, j]
        return c2
    c = centers.numpy().astype(np.float64)
    out = []
    for row in c:
        acc = float(np.float32(row[0] * row[0]))  # exact product, one rounding
        for v in row[1:]:
            acc = round_f32(Fraction(v) * Fraction(v) + Fraction(acc))
        out.append(acc)
    return torch.tensor(out, dtype=torch.float32)


def _assign(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    dots = data[:, None, 0] * centers[None, :, 0]
    for j in range(1, data.shape[1]):
        dots = dots + data[:, None, j] * centers[None, :, j]
    return torch.argmin(_square_norms(centers)[None, :] - 2.0 * dots, dim=1)


def kmeans(points: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means of (n, 3) points taken in the order given; returns
    (centres (k, 3), each point's cluster)."""
    dtype = points.dtype
    centers = torch.zeros((k, points.shape[1]), dtype=dtype)
    first = min(k, len(points))
    centers[:first] = points[:first]
    shift = float("inf")
    for _ in range(MAX_ROUNDS):
        if not shift > TOL:
            break
        assign = _assign(points, centers)
        sums = torch.zeros((k, points.shape[1]), dtype=torch.float64)
        sums.index_add_(0, assign, points.to(torch.float64))
        counts = torch.bincount(assign, minlength=k).to(dtype)[:, None]
        means = sums.to(dtype) / torch.clamp(counts, min=1.0)
        moved = torch.where(counts > 0, means, centers)
        shift = float(((moved - centers) ** 2).sum(-1).max())
        centers = moved
    return centers, _assign(points, centers)


def to_5bit(centers: torch.Tensor) -> np.ndarray:
    """round(centre / 8), half away from zero, clamped to [0, 31]."""
    q = torch.floor(centers / 8.0 + 0.5)
    return torch.clamp(q, 0, 31).to(torch.int64).numpy()


def initial_state(rgba: np.ndarray, subpalette_count: int,
                  subpalette_size: int, dithered: bool, dtype=None):
    """(tile_palettes (Ht, Wt), palette5 (C, S, 3), palette_map (H, W)) of
    the initialisation; `dtype` None is the program's float32 arithmetic."""
    ftype = torch.float32 if dtype is None else dtype
    h, w, _ = rgba.shape
    ht, wt = h // 8, w // 8
    rgb = rgba[..., :3].astype(np.int64)
    alpha = rgba[..., 3]
    # (ht, wt, 8 [x], 8 [y], 3): each tile's pixels x-outer, y-inner.
    tiles_rgb = rgb.reshape(ht, 8, wt, 8, 3).transpose(0, 2, 3, 1, 4)
    tiles_live = (alpha > 0).reshape(ht, 8, wt, 8).transpose(0, 2, 3, 1)
    sums = (tiles_rgb * tiles_live[..., None]).sum(axis=(2, 3))
    counts = tiles_live.sum(axis=(2, 3))
    means = (torch.from_numpy(sums.astype(np.float32)).to(ftype)
             / torch.clamp(torch.from_numpy(counts.astype(np.float32))
                           .to(ftype), min=1.0)[..., None])
    valid = sums.sum(-1) > 0
    if subpalette_count == 1:
        tile_palettes = np.zeros((ht, wt), np.int64)
    else:
        order = [(ty, tx) for tx in range(wt) for ty in range(ht)
                 if valid[ty, tx]]
        pts = torch.stack([means[ty, tx] for ty, tx in order]) if order else (
            torch.zeros((0, 3), dtype=ftype))
        _, assign = kmeans(pts, subpalette_count)
        tile_palettes = np.zeros((ht, wt), np.int64)
        for (ty, tx), a in zip(order, assign.tolist()):
            tile_palettes[ty, tx] = a
    palette5 = np.zeros((subpalette_count, subpalette_size, 3), np.int64)
    flat_rgb = tiles_rgb.reshape(ht * wt * 64, 3)
    flat_live = tiles_live.reshape(-1)
    flat_pal = np.repeat(tile_palettes.reshape(-1), 64)
    for p in range(subpalette_count):
        pick = flat_live & (flat_pal == p)
        pts = torch.from_numpy(flat_rgb[pick].astype(np.float32)).to(ftype)
        centers, _ = kmeans(pts, subpalette_size)
        palette5[p] = to_5bit(centers)
    pmap = palette_map(rgba[..., :3], alpha, tile_palettes, palette5,
                       dithered, dtype)
    return tile_palettes, palette5, pmap
