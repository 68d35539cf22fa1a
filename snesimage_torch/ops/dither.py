"""Floyd-Steinberg error-diffusion remap as a wavefront: the plain twin.

Counterpart of snesimage_tpu/ops/dither.py. The reference's `optimize`
(src/lib.rs:425-501) is a serial raster scan: each pixel adds its
accumulated error to the original colour, picks the nearest entry of its
subpalette, and diffuses ``0.8 * [7, 3, 5, 1] / 16`` of the quantisation
error to its E, SW, S and SE neighbours. Transparent pixels pass their
accumulated error on unchanged (src/lib.rs:463-475) and map to 0.

Pixel (x, y) depends only on (x-1, y), (x+1, y-1), (x, y-1) and (x-1, y-1),
so under the skewed coordinate ``c = x + 2y`` every dependency has a smaller
c: the pixels of one skewed column are independent, and the image takes
``W + 2H - 2`` steps. `remap_dithered` walks those columns in a Python loop
with a rolling (..., H, 3, 3) error window, batched over a leading axis of
palettes so that one loop serves all B candidates of a slot visit.

The arithmetic is the JAX scan's, operation for operation in float32:
target = original + accumulated error; clamp to [0, 255] and round half
away from zero before the distance; the exact int32 red-mean on that 8-bit
target, or CIEDE2000 of its Lab against the entries' Lab (ops/color.py);
strict less-than with the first index winning; E and SE masked at
x + 1 = W, SW at x = 0. Each mask multiplies its product last, so a
compiler that fuses the product into the following sum changes no bit.

This is the twin of kernel G (ops/cuda_dither.py, csrc/dither.cu), which
runs in its place on CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from snesimage_torch.constants import DITHER_DAMPING, DITHER_WEIGHTS
from snesimage_torch.ops.color import (
    ciede2000,
    expand_5bit_to_8bit,
    red_mean_sq_scaled,
    srgb_u8_to_lab,
)
from snesimage_torch.ops.remap import quantize_target_u8, tile_pixel_map


def damped_weights() -> np.ndarray:
    """float32 [E, SW, S, SE] weights with the damping folded in, rounded
    as the JAX package rounds them (a float32 product)."""
    return np.asarray(DITHER_WEIGHTS, np.float32) * np.float32(DITHER_DAMPING)


def _skew_indices(h: int, w: int, device):
    y = torch.arange(h, device=device)[:, None].expand(h, w)
    x = torch.arange(w, device=device)[None, :]
    return y, x + 2 * y


def skew(img: torch.Tensor, fill=0) -> torch.Tensor:
    """(H, W, ...) -> (H, W + 2H - 2, ...) with A[y, x + 2y] = img[y, x]."""
    h, w = img.shape[:2]
    out = img.new_full((h, w + 2 * (h - 1)) + tuple(img.shape[2:]), fill)
    yy, cc = _skew_indices(h, w, img.device)
    out[yy, cc] = img
    return out


def unskew(skewed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The inverse of `skew` on the leading two axes."""
    yy, cc = _skew_indices(h, w, skewed.device)
    return skewed[yy, cc]


def _down(a: torch.Tensor) -> torch.Tensor:
    """The contribution of row y lands on row y + 1 (axis -2)."""
    return torch.cat([torch.zeros_like(a[..., :1, :]), a[..., :-1, :]], dim=-2)


def remap_dithered(
    original_rgb: torch.Tensor,
    alpha: torch.Tensor,
    tile_palettes: torch.Tensor,
    palette5: torch.Tensor,
    perceptual: bool = False,
    weights=None,
    return_targets: bool = False,
):
    """Dithered nearest-entry remap: palette_map (H, W) int32 for a
    (C, S, 3) palette, or (B, H, W) for a (B, C, S, 3) batch of palettes
    over the same image. `weights` replaces the damped [E, SW, S, SE]
    weights (all zero gives the undithered remap). With `return_targets`
    the result is (maps, targets): the (..., H, W, 3) int32 quantised
    targets the distances were taken from, for telling where and why two
    implementations part."""
    batched = palette5.dim() == 4
    palettes = palette5 if batched else palette5[None]
    h, w, _ = original_rgb.shape
    dev = original_rgb.device
    b = palettes.shape[0]
    wgt = [float(v) for v in
           (damped_weights() if weights is None else weights)]

    entries8 = expand_5bit_to_8bit(palettes)  # (B, C, S, 3)
    entries_f = entries8.to(torch.float32)
    entries_lab = srgb_u8_to_lab(entries8) if perceptual else None
    orig_sk = skew(original_rgb.to(torch.float32))  # (H, WS, 3)
    live_sk = skew(alpha > 0, fill=False)
    tp_sk = skew(tile_pixel_map(tile_palettes).long())
    x_of = skew(
        torch.arange(w, device=dev)[None, :].expand(h, w).contiguous(),
        fill=-1,
    )  # source x of each skewed cell, -1 outside the image

    win = torch.zeros((b, h, 3, 3), dtype=torch.float32, device=dev)
    cols, targets = [], []
    for c in range(orig_sk.shape[1]):
        x_col = x_of[:, c]
        valid = (x_col >= 0)[:, None]
        live = (live_sk[:, c] & (x_col >= 0))
        err_col = win[:, :, 0]  # (B, H, 3)
        target = orig_sk[:, c] + err_col
        t_u8 = quantize_target_u8(target)
        tp_col = tp_sk[:, c]
        sub = entries8[:, tp_col]  # (B, H, S, 3)
        if perceptual:
            # The reference's order: color_distance_cielab(entry, target).
            d = ciede2000(entries_lab[:, tp_col],
                          srgb_u8_to_lab(t_u8)[..., None, :])
        else:
            d = red_mean_sq_scaled(sub, t_u8[..., None, :])
        idx = torch.argmin(d, dim=-1)  # the first minimum
        new_color = torch.gather(
            entries_f[:, tp_col], 2, idx[..., None, None].expand(b, h, 1, 3)
        )[:, :, 0]
        perr = torch.where(live[:, None], target - new_color, err_col)
        perr = torch.where(valid, perr, 0.0)

        m_e = ((x_col + 1 < w)[:, None] & valid).to(torch.float32)
        m_sw = ((x_col > 0)[:, None] & valid).to(torch.float32)
        m_s = valid.to(torch.float32)
        add1 = perr * wgt[0] * m_e + _down(perr * wgt[1] * m_sw)
        add2 = _down(perr * wgt[2] * m_s)
        add3 = _down(perr * wgt[3] * m_e)
        win = torch.stack([win[:, :, 1] + add1, win[:, :, 2] + add2, add3],
                          dim=2)
        cols.append(torch.where(live, idx, 0).to(torch.int32))
        if return_targets:
            targets.append(t_u8)

    def image(columns):  # WS x (B, H, ...) -> (B, H, W, ...)
        sk = torch.stack(columns, dim=0).movedim(1, -1)  # (WS, H, ..., B)
        out = unskew(sk.movedim(0, 1), h, w).movedim(-1, 0).contiguous()
        return out if batched else out[0]

    if return_targets:
        return image(cols), image(targets)
    return image(cols)


def dither_candidates(
    original_rgb: torch.Tensor,
    alpha: torch.Tensor,
    tile_palettes: torch.Tensor,
    palette5: torch.Tensor,
    p: int,
    i: int,
    cand5: torch.Tensor,
    perceptual: bool = False,
    return_targets: bool = False,
):
    """(B, H, W) int32 dithered palette maps, one for each of the B
    candidate colours `cand5` put into slot (p, i) of the palette. A
    negative p overrides nothing: every row is the remap with `palette5`.
    `return_targets` as for `remap_dithered`."""
    palettes = palette5[None].repeat(cand5.shape[0], 1, 1, 1)
    if p >= 0:
        palettes[:, p, i] = cand5.to(palettes.dtype)
    return remap_dithered(original_rgb, alpha, tile_palettes, palettes,
                          perceptual, return_targets=return_targets)
