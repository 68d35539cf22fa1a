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
`dither_candidates`. The maps are bit-equal in both distance modes: the
kernel takes the twin's float operations in the twin's order, and its
CIEDE2000 rounds as the twin's does (csrc/ciede2000.cuh).

The kernel gives each row slot L lanes that split the entry search
(csrc/dither.cu). L is not a knob: each distance mode launches the variant
measured fastest on the card (PERF.md, "Kernel G") where its blocks fit,
and `VARIANTS` holds only what `variant` can choose. Every variant gives
the same maps; `_dither_remap_cuda` can launch any of them for that check.

The kernel's C interface takes a leading image axis N and the candidate
axis B; this wrapper passes one image (N = 1). The seed-grouped form of the
TPU kernel (one launch for several seeds' palettes) belongs to the
portfolio, ROADMAP queue A item 16, and is not ported.
"""

from __future__ import annotations

import torch

from snesimage_torch.ops import _kernels
from snesimage_torch.ops.dither import dither_candidates

# The variants csrc/dither.cu builds, per distance mode (perceptual) in
# the order `variant` tries them: (lanes per row slot, blocks per
# candidate). Red-mean L = 1 fits up to 512 row slots; perceptual L = 8
# over a cluster of two blocks fits up to 128, L = 2 up to 256.
VARIANTS = {False: ((1, 1),), True: ((8, 2), (2, 1), (1, 1))}
MAX_THREADS = 512  # a block of any variant


def row_slots(h: int, w: int) -> int:
    """R = min(H, ceil(W/2)): rows y, y + R, ... share row slot y mod R."""
    return min(h, (w + 1) // 2)


def _threads(h: int, w: int, lanes: int, cluster: int) -> int:
    per_block = -(-row_slots(h, w) // cluster)
    return -(-per_block * lanes // 32) * 32


def variant(perceptual: bool, h: int, w: int) -> tuple[int, int]:
    """(lanes, cluster) of the launch for an H x W image: the first variant
    of the mode whose blocks fit."""
    for lanes, cl in VARIANTS[bool(perceptual)]:
        if _threads(h, w, lanes, cl) <= MAX_THREADS:
            return lanes, cl
    raise NotImplementedError(
        f"kernel G has no variant for {row_slots(h, w)} row slots "
        f"({h}x{w}); images up to 1024 pixels wide fit")


def _dither_remap_cuda(rgb, alpha, tile_palettes, palette5, p, i, cand5,
                       perceptual, lanes=None, cluster=None):
    dev = rgb.device
    h, w, _ = rgb.shape
    c, s, _ = palette5.shape
    b = cand5.shape[0]
    if h % 8 or w % 8:
        raise NotImplementedError(
            f"kernel G takes images of whole 8x8 tiles, not {h}x{w}")
    if not -1 <= p < c or not 0 <= i < s:
        raise ValueError(f"slot ({p}, {i}) is outside the {c}x{s} palette")
    if lanes is None:
        lanes, cluster = variant(perceptual, h, w)
    elif ((lanes, cluster) not in VARIANTS[bool(perceptual)]
          or _threads(h, w, lanes, cluster) > MAX_THREADS):
        raise ValueError(f"kernel G has no variant of {lanes} lanes over "
                         f"{cluster} block(s) for {h}x{w}")
    out = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    rc = _kernels.entry("snes_dither_remap")(
        _kernels.require(rgb, "rgb", torch.int32, (h, w, 3), dev),
        _kernels.require(alpha, "alpha", torch.int32, (h, w), dev),
        _kernels.require(tile_palettes, "tile_palettes", torch.int32,
                         (h // 8, w // 8), dev),
        _kernels.require(palette5, "palette5", torch.int32, (c, s, 3), dev),
        _kernels.require(cand5, "cand5", torch.int32, (b, 3), dev),
        1, b, h, w, c, s, p, i, int(bool(perceptual)), lanes, cluster,
        _kernels.dither_params_address(), out.data_ptr(),
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
        return _dither_remap_cuda(
            rgb.contiguous(), alpha.contiguous(), tile_palettes.contiguous(),
            palette5.to(torch.int32).contiguous(), p, i,
            cand5.to(torch.int32).contiguous(), perceptual)
    return dither_candidates(rgb, alpha, tile_palettes, palette5, p, i,
                             cand5, perceptual)


dither_remap_candidates.launches = 0
