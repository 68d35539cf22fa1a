"""Dithered candidate remap: kernel G and its plain twin.

Counterpart of snesimage_tpu/ops/pallas_dither.py
`dither_remap_candidates`. For each of B candidate colours of palette slot
(p, i) it gives the whole Floyd-Steinberg remap of the image with that
colour in the slot: (B, H, W) int32 palette maps. Row b equals the remap
with the palette changed, so an accepted candidate's map needs no second
wavefront. A negative p overrides nothing (`full_remap` calls it so, with
B = 1).

On a CUDA tensor `dither_remap_candidates` launches csrc/dither.cu or
raises; on a CPU tensor it runs the twin, ops/dither.py
`dither_candidates`. Red-mean maps are bit-equal; so are perceptual ones
unless the card's double `pow` or trigonometry lands across a float32
rounding boundary from the host's.

The kernel's C interface takes a leading image axis N and the candidate
axis B; this wrapper passes one image (N = 1). The seed-grouped form of the
TPU kernel (one launch for several seeds' palettes) belongs to the
portfolio, ROADMAP queue A item 16, and is not ported.
"""

from __future__ import annotations

import ctypes

import torch

from snesimage_torch.ops import _kernels
from snesimage_torch.ops.color import expand_5bit_to_8bit
from snesimage_torch.ops.dither import dither_candidates

MAX_ROWS = 256  # kMaxRows in csrc/dither.cu: one thread per image row


def _dither_remap_cuda(rgb, alpha, tile_palettes, palette5, p, i, cand5,
                       perceptual):
    dev = rgb.device
    h, w, _ = rgb.shape
    c, s, _ = palette5.shape
    b = cand5.shape[0]
    if h > MAX_ROWS or h % 8 or w % 8:
        raise NotImplementedError(
            f"kernel G takes images of whole 8x8 tiles with at most "
            f"{MAX_ROWS} rows, not {h}x{w}"
        )
    if not -1 <= p < c or not 0 <= i < s:
        raise ValueError(f"slot ({p}, {i}) is outside the {c}x{s} palette")
    entries8 = expand_5bit_to_8bit(palette5).contiguous()
    cand8 = expand_5bit_to_8bit(cand5).contiguous()
    out = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    rc = _kernels.library().snes_dither_remap(
        _kernels.require(rgb, "rgb", torch.int32, (h, w, 3), dev),
        _kernels.require(alpha, "alpha", torch.int32, (h, w), dev),
        _kernels.require(tile_palettes, "tile_palettes", torch.int32,
                         (h // 8, w // 8), dev),
        _kernels.require(entries8, "entries8", torch.int32, (c, s, 3), dev),
        _kernels.require(cand8, "cand8", torch.int32, (b, 3), dev),
        1, b, h, w, c, s, p, i, int(bool(perceptual)),
        ctypes.addressof(_kernels.dither_params()), out.data_ptr(),
        _kernels.stream(dev),
    )
    _kernels.check(rc, "dither_remap")
    dither_remap_candidates.launches += 1
    return out


def dither_remap_candidates(
    rgb: torch.Tensor,
    alpha: torch.Tensor,
    tile_palettes: torch.Tensor,
    palette5: torch.Tensor,
    p: int,
    i: int,
    cand5: torch.Tensor,
    perceptual: bool = False,
) -> torch.Tensor:
    """(B, H, W) int32 dithered palette maps for the B candidates `cand5`
    of slot (p, i).

    rgb: (H, W, 3) int32 8-bit source colours; alpha: (H, W) int32;
    tile_palettes: (H/8, W/8) int32 subpalette of each tile; palette5:
    (C, S, 3) int32 5-bit palette; cand5: (B, 3) int32 5-bit candidates;
    perceptual: CIEDE2000 instead of the red-mean distance.
    """
    if rgb.is_cuda:
        return _dither_remap_cuda(rgb.contiguous(), alpha.contiguous(),
                                  tile_palettes, palette5, p, i, cand5,
                                  perceptual)
    return dither_candidates(rgb, alpha, tile_palettes, palette5, p, i,
                             cand5, perceptual)


dither_remap_candidates.launches = 0
