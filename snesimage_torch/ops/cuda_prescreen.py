"""Prescreen kernels A, E and F and their plain twins.

Counterpart of snesimage_tpu/ops/pallas_prescreen.py.

- Kernel A (csrc/select_colors.cu): colour planes picked from the linear
  entry table by pixel key, the sentinel key K (transparent pixels) giving
  0. Three entry points, each counted as a launch of A:
  - `select_colors`, the direct counterpart of the TPU kernel: key planes
    and tables given. Its twin is the padded gather of the JAX package's
    XLA path; the two are bit-identical: both copy table entries.
  - `visit_prologue`: what an undithered visit of slot (p, i) shares across
    its candidates, from the distance cache in one launch: each pixel's
    best entry with and without slot i, the no-candidate frame, the win
    rule's operands of kernels C to F and the masked frame.
  - `render_palette_maps`: the dithered visit's (B, H, W) palette maps to
    (B, 3, H, W) linear frames, map b with candidate b in slot (p, i).
  The two fused entries build the table from the 5-bit palette themselves.
  Their twins are the torch code they replace; every output is a copy, a
  comparison or an integer add, so kernel and twin agree bit for bit.
- `pooled_wins_redmean` (kernel E) and `pooled_wins_ciede` (kernel F), both
  csrc/pooled_wins.cu: per candidate the win mask of a slot visit and its
  4x4-pooled sums, from which `coarse_frames` assembles the exact
  quarter-resolution candidate frames. The visit takes them where the
  fused kernels C and D (ops/cuda_metric.py) cannot run: image sides that
  are not multiples of 32. F also returns the CIEDE2000 distance planes.
  Given the tile map and the visited subpalette p, both compute only the
  8x8 tiles of p (0 sums and +inf distances elsewhere), which is all a
  visit of a slot of p reads; without them, every pixel.
  The twins take the same steps in plain torch; C's and D's twins pool
  with the same routine (`pooled_sums`). Mask counts are exact; the three
  m*ML sums add 16 floats in another order than torch does and agree
  within 1e-5; F's distance planes equal the twin's to the bit.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the twin. A launch counts in the profiling counter
"launch.<kernel>" (ops/_kernels.py `launch`), and kernel F its calls in
"f.calls": on the card after its launch, on the CPU beside the twin. Each
also takes a leading image axis N on its operands (the JAX package's
`custom_vmap` image fold): N images in one launch, each image's outputs
bit-equal to its own launch; the twins run the images one after another.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from snesimage_torch.ops import _kernels
from snesimage_torch.ops.color import (
    _linear_lut,
    ciede2000,
    expand_5bit_to_8bit,
    srgb_u8_to_linear,
)
from snesimage_torch.ops.remap import tile_pixel_map
from snesimage_torch.utils import profiling

INT32_MAX = torch.iinfo(torch.int32).max
INT32_MIN = torch.iinfo(torch.int32).min
_BIG = 3.0e38  # the float cache's exclusion value (JAX package: _BIG)


def _select_colors_plain(key: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Zero-padded gather: (N, 3, H, W) planes, 0 where key >= K (or
    (3, H, W) for one key plane and one table)."""
    if key.dim() == 2:
        return _select_colors_plain(key[None], table[None])[0]
    n, h, w = key.shape
    padded = torch.cat([table, table.new_zeros((n, 3, 1))], dim=2)
    safe = torch.clamp(key, max=padded.shape[2] - 1).long()
    flat = safe.reshape(n, 1, h * w).expand(n, 3, h * w)
    return torch.gather(padded, 2, flat).reshape(n, 3, h, w)


def _select_colors_cuda(key: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    n, h, w = key.shape
    k = table.shape[2]
    dev = key.device
    out = torch.empty((n, 3, h, w), dtype=torch.float32, device=dev)
    _kernels.launch(
        "snes_select_colors",
        _kernels.require(key, "key", torch.int32, (n, h, w), dev),
        _kernels.require(table, "table", torch.float32, (n, 3, k), dev),
        out.data_ptr(),
        n,
        h * w,
        k,
        _kernels.stream(dev),
    )
    return out


def select_colors(key: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(3, H, W) colour planes selected from a small table by pixel key.

    key:   (H, W) int32 in [0, K]; the value K selects 0.0.
    table: (3, K) float32 channel-major colour table.
    With a leading axis N on both (one table per key plane), the result is
    (N, 3, H, W).
    """
    batched = key.dim() == 3
    if not batched:
        key, table = key[None], table[None]
    fn = _select_colors_cuda if key.is_cuda else _select_colors_plain
    out = fn(key, table)
    return out if batched else out[0]


def _check_slot(name, palette5, p, i, h, w):
    c, s = palette5.shape[:2]
    if not (0 <= p < c and 0 <= i < s):
        raise ValueError(f"{name}: slot ({p}, {i}) is outside the {c}x{s} "
                         "palette")
    if h % 8 or w % 8:
        raise ValueError(f"{name}: {h}x{w} is not whole 8x8 tiles")


class VisitPrologue(NamedTuple):
    """What an undithered visit of slot (p, i) shares across its
    candidates (`visit_prologue`)."""

    best_val: torch.Tensor  # (H, W) int32 or float32: best without slot i
    best_idx: torch.Tensor  # (H, W) int32, its entry
    base_idx: torch.Tensor  # (H, W) int32, the best entry with slot i
    affected: torch.Tensor  # (H, W) bool, pixels of subpalette p
    # (H, W) int32, the palette map with slot i never winning: best_idx on
    # affected pixels, base_idx elsewhere, 0 on transparent ones
    map_nc: torch.Tensor
    lnc: torch.Tensor  # (3, H, W) float32, the frame with slot i never winning
    # The win rule of kernels C to F: (bva,) in red-mean mode, a candidate
    # wins where its distance is below bva; (bvalm, adj) in perceptual mode,
    # it wins where d < bvalm, or d == bvalm and adj != 0.
    rule: tuple
    ml: torch.Tensor  # (3, H, W) float32, lnc where the candidate may win


def no_candidate_key(d_all, tile_palettes, alpha, palette5, p: int, i: int):
    """The visit's first minima and what kernel A's key/table entry makes
    the no-candidate frame from: (best_val, best_idx, base_idx, affected,
    opaque, key_nc, table), `key_nc` (H, W) int32 in [0, C*S] and `table`
    (3, C*S) float32 linear entry colours."""
    s = palette5.shape[1]
    entries8 = expand_5bit_to_8bit(palette5)  # (C, S, 3)
    tp_pix = tile_pixel_map(tile_palettes)
    excl = (torch.arange(s, device=d_all.device) == i)[:, None, None]
    big = INT32_MAX if d_all.dtype == torch.int32 else _BIG
    best_val, best_idx = torch.min(torch.where(excl, big, d_all), dim=0)
    best_idx = best_idx.to(torch.int32)
    base_idx = torch.argmin(d_all, dim=0).to(torch.int32)
    affected = tp_pix == p
    opaque = alpha > 0
    # Affected pixels take their best other entry, the rest their best
    # entry, transparent pixels the sentinel (colour 0).
    table = srgb_u8_to_linear(entries8).reshape(-1, 3).T.contiguous()
    idx_nc = torch.where(affected, best_idx, base_idx)
    key_nc = torch.where(opaque, tp_pix * s + idx_nc, table.shape[1]).to(
        torch.int32
    )
    return best_val, best_idx, base_idx, affected, opaque, key_nc, table


def _visit_prologue_plain(d_all, tile_palettes, alpha, palette5, p, i):
    best_val, best_idx, base_idx, affected, opaque, key_nc, table = (
        no_candidate_key(d_all, tile_palettes, alpha, palette5, p, i))
    lnc = _select_colors_plain(key_nc, table)
    map_nc = torch.where(opaque, torch.where(affected, best_idx, base_idx), 0)
    mask = affected & opaque
    adj = (i < best_idx).to(torch.int32)
    ml = torch.where(mask[None], lnc, 0.0)
    if d_all.dtype != torch.int32:
        # Float win rule (d < bvalm) | (d == bvalm & adj): the tie rule
        # cannot fold into the threshold; masked pixels never win.
        rule = (torch.where(mask, best_val, -_BIG), adj)
    else:
        # Integer win threshold with the tie rule and the mask folded in.
        rule = (torch.where(
            mask,
            torch.where(best_val == INT32_MAX, best_val, best_val + adj),
            INT32_MIN,
        ),)
    return VisitPrologue(best_val, best_idx, base_idx, affected,
                         map_nc.to(torch.int32), lnc, rule, ml)


def _stack_prologues(outs) -> VisitPrologue:
    """One VisitPrologue with a leading image axis from one an image."""
    fields = []
    for parts in zip(*outs):
        if isinstance(parts[0], tuple):
            fields.append(tuple(torch.stack(r) for r in zip(*parts)))
        else:
            fields.append(torch.stack(parts))
    return VisitPrologue(*fields)


def _visit_prologue_cuda(d_all, tile_palettes, alpha, palette5, p, i):
    dev = d_all.device
    n, s, h, w = d_all.shape
    c = palette5.shape[1]
    perceptual = d_all.dtype == torch.float32
    dtype = torch.float32 if perceptual else torch.int32
    ptrs = (
        _kernels.require(d_all, "d_all", dtype, (n, s, h, w), dev),
        _kernels.require(tile_palettes, "tile_palettes", torch.int32,
                         (n, h // 8, w // 8), dev),
        _kernels.require(alpha, "alpha", torch.int32, (n, h, w), dev),
        _kernels.require(palette5, "palette5", torch.int32, (n, c, s, 3),
                         dev),
    )
    _check_slot("visit_prologue", palette5[0], p, i, h, w)
    if not 0 < n <= 65535:
        raise ValueError(f"visit_prologue takes 1 to 65535 images, not {n}")
    # Three allocations, cut into (N, H, W) or (N, 3, H, W) planes:
    # (best_idx, base_idx, map_nc, adj or best_val and bva), (best_val,
    # bvalm, lnc, ml) or (lnc, ml), and the mask of subpalette p.
    ints = torch.empty((5 - perceptual, n, h, w), dtype=torch.int32,
                       device=dev)
    floats = torch.empty((6 + 2 * perceptual) * n * h * w,
                         dtype=torch.float32, device=dev)
    affected = torch.empty((n, h, w), dtype=torch.bool, device=dev)
    best_idx, base_idx, map_nc, rest = ints[0], ints[1], ints[2], ints[3:]
    plane = n * h * w
    if perceptual:
        best_val, thr = (floats[k * plane:(k + 1) * plane].view(n, h, w)
                         for k in range(2))
        adj, planes, rule = rest[0], floats[2 * plane:], (thr, rest[0])
    else:
        best_val, thr, adj = rest[0], rest[1], None
        planes, rule = floats, (thr,)
    lnc, ml = (planes[k * 3 * plane:(k + 1) * 3 * plane].view(n, 3, h, w)
               for k in range(2))
    _kernels.launch(
        "snes_select_colors_prologue", *ptrs, n, h, w, c, s, p, i,
        int(perceptual),
        _linear_lut(dev).data_ptr(),
        best_val.data_ptr(), best_idx.data_ptr(), base_idx.data_ptr(),
        affected.data_ptr(), map_nc.data_ptr(), lnc.data_ptr(),
        thr.data_ptr(), None if adj is None else adj.data_ptr(),
        ml.data_ptr(), _kernels.stream(dev),
    )
    return VisitPrologue(best_val, best_idx, base_idx, affected, map_nc, lnc,
                         rule, ml)


def visit_prologue(d_all: torch.Tensor, tile_palettes: torch.Tensor,
                   alpha: torch.Tensor, palette5: torch.Tensor, p: int,
                   i: int) -> VisitPrologue:
    """Kernel A's visit prologue for slot (p, i) of an undithered visit.

    d_all: (S, H, W) distances of every pixel to each entry of its own
    subpalette, int32 scaled red-mean or float32 CIEDE2000 (perceptual);
    tile_palettes: (H/8, W/8) int32; alpha: (H, W) int32; palette5:
    (C, S, 3) int32 5-bit palette. The first minimum wins every tie. The
    no-candidate frame and map give affected pixels (subpalette p) their
    best entry other than i, the rest their best entry, transparent pixels
    0. With a leading image axis N on every operand, every output gains
    it.
    """
    operands = (d_all, tile_palettes, alpha, palette5)
    if d_all.dim() == 3:
        out = visit_prologue(*(a[None] for a in operands), p, i)
        return VisitPrologue(*(
            tuple(r[0] for r in f) if isinstance(f, tuple) else f[0]
            for f in out))
    if d_all.is_cuda:
        return _visit_prologue_cuda(*operands, p, i)
    return _stack_prologues([
        _visit_prologue_plain(*(a[n] for a in operands), p, i)
        for n in range(d_all.shape[0])])


def render_operands(maps, tile_palettes, alpha, palette5, cand5, p: int,
                    i: int):
    """What kernel A's key/table entry renders the (B, H, W) palette maps
    `maps` from: the (B, H, W) int32 keys `subpalette * S + entry`, with the
    sentinel key for transparent pixels, and one (3, C*S) linear colour
    table per candidate, candidate b's colour in slot (p, i) of table b."""
    s = palette5.shape[1]
    entries_lin = srgb_u8_to_linear(expand_5bit_to_8bit(palette5))
    tables = entries_lin.reshape(-1, 3).T[None].repeat(cand5.shape[0], 1, 1)
    tables[:, :, p * s + i] = srgb_u8_to_linear(expand_5bit_to_8bit(cand5))
    tp_pix = tile_pixel_map(tile_palettes)
    key = torch.where(alpha > 0, tp_pix * s + maps, tables.shape[2])
    return key.to(torch.int32), tables.contiguous()


def _render_plain(maps, tile_palettes, alpha, palette5, cand5, p, i):
    return _select_colors_plain(
        *render_operands(maps, tile_palettes, alpha, palette5, cand5, p, i))


def _render_cuda(maps, tile_palettes, alpha, palette5, cand5, p, i):
    dev = maps.device
    n, b, h, w = maps.shape
    c, s = palette5.shape[1:3]
    ptrs = (
        _kernels.require(maps, "maps", torch.int32, (n, b, h, w), dev),
        _kernels.require(tile_palettes, "tile_palettes", torch.int32,
                         (n, h // 8, w // 8), dev),
        _kernels.require(alpha, "alpha", torch.int32, (n, h, w), dev),
        _kernels.require(palette5, "palette5", torch.int32, (n, c, s, 3),
                         dev),
        _kernels.require(cand5, "cand5", torch.int32, (n, b, 3), dev),
    )
    _check_slot("render_palette_maps", palette5[0], p, i, h, w)
    if not (0 < b <= 65535 and 0 < n <= 65535):
        raise ValueError("render_palette_maps takes 1 to 65535 maps of 1 to "
                         f"65535 images, not {b} of {n}")
    out = torch.empty((n, b, 3, h, w), dtype=torch.float32, device=dev)
    _kernels.launch(
        "snes_select_colors_render", *ptrs, n, b, h, w, c, s, p, i,
        _linear_lut(dev).data_ptr(), out.data_ptr(), _kernels.stream(dev),
    )
    return out


def render_palette_maps(maps: torch.Tensor, tile_palettes: torch.Tensor,
                        alpha: torch.Tensor, palette5: torch.Tensor,
                        cand5: torch.Tensor, p: int, i: int) -> torch.Tensor:
    """(B, 3, H, W) linear frames of the (B, H, W) int32 palette maps
    `maps`, map b rendered with the 5-bit candidate `cand5[b]` in slot
    (p, i) of `palette5` (C, S, 3); transparent pixels (alpha 0) are 0.
    Kernel A's render entry; the JAX package's one-hot contraction over S
    computes the same frames. With a leading image axis N on every operand
    (maps (N, B, H, W), cand5 (N, B, 3)), the frames are (N, B, 3, H, W)."""
    operands = (maps, tile_palettes, alpha, palette5, cand5)
    if maps.dim() == 3:
        return render_palette_maps(*(a[None] for a in operands), p, i)[0]
    if maps.is_cuda:
        return _render_cuda(*operands, p, i)
    return torch.stack([_render_plain(*(a[n] for a in operands), p, i)
                        for n in range(maps.shape[0])])


def redmean_wins(tg, cand8, bva) -> torch.Tensor:
    """(B, H, W) bool win masks d < bva, d the exact int32 scaled red-mean
    distance of target `tg` (3, H, W) to each of the (B, 3) candidates."""
    d = cand8[:, :, None, None] - tg[None]  # (B, 3, H, W) int32
    rsum = tg[0][None] + cand8[:, 0, None, None]
    dist = (
        (1024 + rsum) * d[:, 0] * d[:, 0]
        + 2048 * d[:, 1] * d[:, 1]
        + (1534 - rsum) * d[:, 2] * d[:, 2]
    )
    return dist < bva[None]


def ciede_wins(tlab, cand_lab, bvalm, adj):
    """((B, H, W) bool win masks, (B, H, W) float32 CIEDE2000 distances of
    the target Lab planes (3, H, W) to each of the (B, 3) candidate Labs):
    a candidate wins where d < bvalm, or d == bvalm and adj != 0."""
    dcand = ciede2000(tlab.movedim(0, -1)[None], cand_lab[:, None, None, :])
    wins = (dcand < bvalm[None]) | ((dcand == bvalm[None]) & (adj[None] != 0))
    return wins, dcand


def pooled_sums(wins, ml) -> torch.Tensor:
    """(B, 4, H/4, W/4) sums over 4x4 cells of m, m*ML_r, m*ML_g, m*ML_b
    for (B, H, W) win masks and the (3, H, W) masked no-candidate frame."""
    b, h, w = wins.shape
    m = wins.to(torch.float32)
    maps = torch.cat([m[:, None], m[:, None] * ml[None]], dim=1)
    return maps.reshape(b, 4, h // 4, 4, w // 4, 4).sum(dim=(3, 5))


def coarse_frames(pooled, cand_lin, ds4_l) -> torch.Tensor:
    """(B, 3, H/4, W/4) exact quarter-resolution candidate frames
    ds4(L) + (c * pool4(m) - pool4(m * ML)) / 16 from (B, 4, H/4, W/4)
    pooled sums, the (B, 3) linear candidate colours and the (3, H/4, W/4)
    4x4 means of the no-candidate frame. A candidate that wins no pixel
    gets ds4(L) itself, bit for bit. With a leading image axis N on all
    three, the frames are (N, B, 3, H/4, W/4)."""
    return (
        cand_lin[..., None, None] * pooled[..., :1, :, :]
        - pooled[..., 1:4, :, :]
    ) / 16.0 + ds4_l.unsqueeze(-4)


def tile_masks(tile_palettes, p: int):
    """The 4x4 cells (..., H/4, W/4) and the pixels (..., H, W), as bool
    masks, of the 8x8 tiles of subpalette p in the (..., H/8, W/8) tile
    map."""
    cells = (tile_palettes == p).repeat_interleave(2, -2).repeat_interleave(
        2, -1)
    return cells, cells.repeat_interleave(4, -2).repeat_interleave(4, -1)


def _check_tiles(name, tile_palettes, p):
    if (tile_palettes is None) != (p is None):
        raise ValueError(f"{name} takes the tile map and p together")


def _pooled_geometry(name, n, b, h, w, ptrs, tiles):
    if h % 4 or w % 4 or h < 4 or w < 4:
        raise ValueError(f"kernel {name} pools 4x4 cells; {h}x{w} has no "
                         "whole number of them")
    if tiles is not None and (h % 8 or w % 8):
        raise ValueError(f"kernel {name} takes a tile map only for whole 8x8 "
                         f"tiles, not {h}x{w}")
    if not 0 < n * b <= 65535:
        raise ValueError(f"kernel {name} takes 1 to 65535 (image, candidate) "
                         f"pairs, not {n}x{b}")
    if n * -(-h // 8) * -(-w // 8) * -(-b // 4) >= 2**31 or n * h * w >= 2**31:
        raise ValueError(f"kernel {name} counts its tiles and pixels in int32")
    if any(p % 16 for p in ptrs):
        raise ValueError(f"kernel {name} reads its planes as 16-byte vectors")


def _tiles_ptr(tile_palettes, n, h, w, dev):
    if tile_palettes is None:
        return None
    return _kernels.require(tile_palettes, "tile_palettes", torch.int32,
                            (n, h // 8, w // 8), dev)


def _batched(fn, first, *rest):
    """fn over operands with a leading image axis, adding one (and taking
    it off the results) where `first` has none; None operands pass as they
    are."""
    if first.dim() == 4:
        return fn(first, *rest)
    out = fn(first[None], *(a if a is None else a[None] for a in rest))
    return tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]


def _pooled_wins_redmean_plain(tg, cand8, bva, ml, tile_palettes=None,
                               p=None):
    pooled = torch.stack([
        pooled_sums(redmean_wins(tg[n], cand8[n], bva[n]), ml[n])
        for n in range(tg.shape[0])
    ])
    if tile_palettes is None:
        return pooled
    cells, _ = tile_masks(tile_palettes, p)
    return torch.where(cells[:, None, None], pooled, 0.0)


def _pooled_wins_redmean_cuda(tg, cand8, bva, ml, tile_palettes=None,
                              p=None):
    dev = tg.device
    n, b = cand8.shape[:2]
    h, w = bva.shape[-2:]
    ptrs = [
        _kernels.require(tg, "tg", torch.int32, (n, 3, h, w), dev),
        _kernels.require(cand8, "cand8", torch.int32, (n, b, 3), dev),
        _kernels.require(bva, "bva", torch.int32, (n, h, w), dev),
        _kernels.require(ml, "ml", torch.float32, (n, 3, h, w), dev),
    ]
    _pooled_geometry("E", n, b, h, w, (ptrs[0], ptrs[2], ptrs[3]),
                     tile_palettes)
    tiles = _tiles_ptr(tile_palettes, n, h, w, dev)
    out = torch.empty((n, b, 4, h // 4, w // 4), dtype=torch.float32,
                      device=dev)
    _kernels.launch("snes_pooled_wins_redmean", *ptrs, tiles,
                    -1 if p is None else int(p), n, b, h, w, out.data_ptr(),
                    _kernels.stream(dev))
    return out


def pooled_wins_redmean(tg, cand8, bva, ml, tile_palettes=None,
                        p=None) -> torch.Tensor:
    """Pooled win sums of a visit's candidates, red-mean distance.

    tg: (3, H, W) int32 target; cand8: (B, 3) int32 8-bit candidates; bva:
    (H, W) int32 win threshold (a candidate wins a pixel where its scaled
    red-mean distance is below it; the caller folds the tie rule and the
    candidate mask in); ml: (3, H, W) float32 masked no-candidate frame.
    H and W are multiples of 4.
    Returns (B, 4, H/4, W/4) float32: per 4x4 cell the sums of m, m*ML_r,
    m*ML_g, m*ML_b. With a leading image axis N on every operand the
    result is (N, B, 4, H/4, W/4).

    With the (H/8, W/8) int32 `tile_palettes` (N of them with the image
    axis) and a subpalette `p`, only the 8x8 tiles of p are computed and
    every other cell's sums are 0 (H and W are multiples of 8 then). The
    visit of a slot of subpalette p passes them; its precondition, which
    the prologue's win rule guarantees: no pixel off the tiles of p wins,
    so the restricted sums equal the unrestricted ones everywhere.
    """
    _check_tiles("pooled_wins_redmean", tile_palettes, p)
    fn = (_pooled_wins_redmean_cuda if tg.is_cuda
          else _pooled_wins_redmean_plain)
    return _batched(lambda *a: fn(*a, p=p), tg, cand8, bva, ml,
                    tile_palettes)


def _pooled_wins_ciede_plain(tlab, cand_lab, bvalm, adj, ml,
                             tile_palettes=None, p=None):
    pooled, dcand = [], []
    for n in range(tlab.shape[0]):
        wins, d = ciede_wins(tlab[n], cand_lab[n], bvalm[n], adj[n])
        pooled.append(pooled_sums(wins, ml[n]))
        dcand.append(d)
    pooled, dcand = torch.stack(pooled), torch.stack(dcand)
    if tile_palettes is None:
        return pooled, dcand
    cells, pixels = tile_masks(tile_palettes, p)
    return (torch.where(cells[:, None, None], pooled, 0.0),
            torch.where(pixels[:, None], dcand, float("inf")))


def _pooled_wins_ciede_cuda(tlab, cand_lab, bvalm, adj, ml,
                            tile_palettes=None, p=None):
    dev = tlab.device
    n, b = cand_lab.shape[:2]
    h, w = bvalm.shape[-2:]
    ptrs = [
        _kernels.require(tlab, "tlab", torch.float32, (n, 3, h, w), dev),
        _kernels.require(cand_lab, "cand_lab", torch.float32, (n, b, 3), dev),
        _kernels.require(bvalm, "bvalm", torch.float32, (n, h, w), dev),
        _kernels.require(adj, "adj", torch.int32, (n, h, w), dev),
        _kernels.require(ml, "ml", torch.float32, (n, 3, h, w), dev),
    ]
    _pooled_geometry("F", n, b, h, w, (ptrs[0], *ptrs[2:]), tile_palettes)
    tiles = _tiles_ptr(tile_palettes, n, h, w, dev)
    out = torch.empty((n, b, 4, h // 4, w // 4), dtype=torch.float32,
                      device=dev)
    dcand = torch.empty((n, b, h, w), dtype=torch.float32, device=dev)
    _kernels.launch("snes_pooled_wins_ciede", *ptrs, tiles,
                    -1 if p is None else int(p), n, b, h, w, out.data_ptr(),
                    dcand.data_ptr(), _kernels.stream(dev))
    profiling.count("f.calls")
    return out, dcand


def pooled_wins_ciede(tlab, cand_lab, bvalm, adj, ml, tile_palettes=None,
                      p=None):
    """Pooled win sums of a visit's candidates, CIEDE2000 distance.

    tlab: (3, H, W) float32 target CIELAB planes; cand_lab: (B, 3) float32
    candidate CIELAB; bvalm: (H, W) float32 best distance without the
    candidate's slot, -3e38 where the candidate may not win; adj: (H, W)
    int32, non-zero where the candidate wins ties; ml as for
    `pooled_wins_redmean`. A candidate wins a pixel where d < bvalm, or
    d == bvalm and adj != 0, with d = ciede2000(target Lab, candidate Lab),
    the standard formula of ops/color.py.
    Returns ((B, 4, H/4, W/4) float32 pooled sums, (B, H, W) float32
    distances); with a leading image axis N on every operand, both gain it.

    With `tile_palettes` and `p` as for `pooled_wins_redmean`, only the
    tiles of subpalette p are computed: every other cell's sums are 0 and
    every other pixel's distance is +inf, which never wins there (bvalm is
    -3e38) and which the visit never reads (it takes a distance plane only
    on the pixels of subpalette p). Precondition as there: no pixel off the
    tiles of p wins.
    """
    _check_tiles("pooled_wins_ciede", tile_palettes, p)
    if not tlab.is_cuda:  # `_pooled_wins_ciede_cuda` counts at its launch
        profiling.count("f.calls")
    fn = _pooled_wins_ciede_cuda if tlab.is_cuda else _pooled_wins_ciede_plain
    return _batched(lambda *a: fn(*a, p=p), tlab, cand_lab, bvalm, adj, ml,
                    tile_palettes)
