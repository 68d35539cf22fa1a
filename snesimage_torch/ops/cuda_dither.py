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

The wrapper also takes a leading image axis N: N images, each with its
own palette and candidates, in one launch (the TPU kernel's image fold).
Where the palettes carry N and the image does not, the N rows are a seed
portfolio's palettes over one shared image: the kernel reads that image
with a stride of 0, and one launch walks every seed's chain at once (the
TPU kernel's seed fold, which puts the seeds on its candidate axis with an
entry table per seed group). Each row's maps equal its own launch's bit
for bit: every (image, candidate) is its own block.
"""

from __future__ import annotations

import torch

from snesimage_torch.ops import _kernels
from snesimage_torch.ops.dither import dither_candidates

# The variants csrc/dither.cu builds, per distance mode (perceptual) in
# the order `variant` tries them: (lanes per row slot, blocks per
# candidate). Red-mean L = 1 fits up to 512 row slots (L = 2 and 4, which
# split the 16-entry search, and a cluster of two blocks are slower on the
# card at 256x256); perceptual L = 8 over a cluster of two blocks fits up
# to 128, L = 2 up to 256.
VARIANTS = {False: ((1, 1),), True: ((8, 2), (2, 1), (1, 1))}
MAX_THREADS = 512  # a block of any variant
MAX_ENTRIES = 16  # a subpalette's entries (kMaxEntries; the config's S <= 15)


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and starting on 16 bytes, as the kernel's vector loads
    read it: t itself where it is (every tensor the pipeline makes), else
    a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _dither_remap_cuda(rgb, alpha, tile_palettes, palette5, p, i, cand5,
                       perceptual, lanes=None, cluster=None):
    """Kernel G on N palettes (palette5 (N, C, S, 3), cand5 (N, B, 3)) over
    N images (rgb (N, H, W, 3)) or one shared image (rgb (H, W, 3)); one
    palette (C, S, 3) with cand5 (B, 3) gives (B, H, W) maps."""
    if palette5.dim() == 3:
        return _dither_remap_cuda(rgb[None], alpha[None], tile_palettes[None],
                                  palette5[None], p, i, cand5[None],
                                  perceptual, lanes, cluster)[0]
    dev = rgb.device
    h, w = rgb.shape[-3:-1]
    n, c, s, _ = palette5.shape
    b = cand5.shape[1]
    shared = rgb.dim() == 3
    lead = () if shared else (n,)
    if h % 8 or w % 8:
        raise NotImplementedError(
            f"kernel G takes images of whole 8x8 tiles, not {h}x{w}")
    if not -1 <= p < c or not 0 <= i < s:
        raise ValueError(f"slot ({p}, {i}) is outside the {c}x{s} palette")
    if s > MAX_ENTRIES:
        raise ValueError(f"kernel G takes subpalettes of at most "
                         f"{MAX_ENTRIES} entries, not {s}")
    if lanes is None:
        lanes, cluster = variant(perceptual, h, w)
    elif ((lanes, cluster) not in VARIANTS[bool(perceptual)]
          or _threads(h, w, lanes, cluster) > MAX_THREADS):
        raise ValueError(f"kernel G has no variant of {lanes} lanes over "
                         f"{cluster} block(s) for {h}x{w}")
    out = torch.empty((n, b, h, w), dtype=torch.int32, device=dev)
    _kernels.launch(
        "snes_dither_remap",
        _kernels.require(rgb, "rgb", torch.int32, (*lead, h, w, 3), dev),
        _kernels.require(alpha, "alpha", torch.int32, (*lead, h, w), dev),
        _kernels.require(tile_palettes, "tile_palettes", torch.int32,
                         (*lead, h // 8, w // 8), dev),
        _kernels.require(palette5, "palette5", torch.int32, (n, c, s, 3),
                         dev),
        _kernels.require(cand5, "cand5", torch.int32, (n, b, 3), dev),
        n, b, int(shared), h, w, c, s, p, i, int(bool(perceptual)), lanes,
        cluster,
        _kernels.dither_params_address(), out.data_ptr(),
        _kernels.stream(dev),
    )
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

    With a leading axis N on palette5 (N, C, S, 3) and cand5 (N, B, 3) the
    maps are (N, B, H, W): row n remaps image n (rgb, alpha and
    tile_palettes with the same leading axis) or, where they have none,
    the one image they hold (a seed portfolio's N palettes).
    """
    if palette5.dim() == 3:
        return dither_remap_candidates(rgb, alpha, tile_palettes,
                                       palette5[None], p, i, cand5[None],
                                       perceptual)[0]
    if rgb.is_cuda:
        return _dither_remap_cuda(
            _aligned(rgb), _aligned(alpha), tile_palettes.contiguous(),
            palette5.to(torch.int32).contiguous(), p, i,
            cand5.to(torch.int32).contiguous(), perceptual)
    shared = rgb.dim() == 3
    return torch.stack([
        dither_candidates(*((rgb, alpha, tile_palettes) if shared else
                            (rgb[n], alpha[n], tile_palettes[n])),
                          palette5[n], p, i, cand5[n], perceptual)
        for n in range(palette5.shape[0])])
