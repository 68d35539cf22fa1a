"""SSIMULACRA2 feature kernels B and C and their plain twins.

Counterparts of snesimage_tpu/ops/pallas_metric.py:

- `multiscale_feature_sums` (kernel B, csrc/multiscale.cu): raw feature
  sums of several consecutive pyramid scales for a batch of linear-RGB
  frames, after `pre_ds` 2x2 means. Twin: the maps of
  ops/ssimulacra2.py `scale_features`, summed instead of averaged.
- `coarse_feature_sums_redmean` (kernel C, csrc/coarse_redmean.cu): the
  fused coarse prescreen of one slot visit: per candidate the int32
  red-mean win mask, its 4x4 pooled sums, the exact quarter-resolution
  frame and the raw sums of its scales. Twin: the JAX package's XLA chain
  (pallas_prescreen.py `_pooled_wins_redmean_xla`, the coarse frame of
  core/refine.py, then kernel B's twin).

Both return raw sums of [d, art, det, d^4, art^4, det^4]; the division by
the pixel count and the fourth root stay in `finalize_feature_sums`. On a
CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor it
runs the twin. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from snesimage_torch.ops import _kernels
from snesimage_torch.ops.ssimulacra2 import (
    downsample2,
    feature_maps,
    linear_rgb_to_positive_xyb,
)

# Planes up to this many pixels run block-resident in shared memory
# (kResidentMaxPixels in csrc/metric_common.cuh).
RESIDENT_MAX_PIXELS = 64 * 64
_TILE = 32  # kTile in csrc/multiscale.cu


def _raw_sums(img1, mu1, s11, img2) -> torch.Tensor:
    """(..., 3, 6) raw sums of the three maps and their fourth powers."""
    maps = feature_maps(img1, mu1, s11, img2)
    ones = [m.sum(dim=(-3, -2)) for m in maps]
    fours = [((m * m) * (m * m)).sum(dim=(-3, -2)) for m in maps]
    return torch.stack(ones + fours, dim=-1)


def _multiscale_feature_sums_plain(ref_scales, frames, pre_ds=0):
    lin = frames.movedim(1, -1)  # (B, h, w, 3)
    for _ in range(pre_ds):
        lin = downsample2(lin)
    out = []
    for si, triple in enumerate(ref_scales):
        if si:
            lin = downsample2(lin)
        img1, mu1, s11 = (a.movedim(0, -1) for a in triple)
        out.append(_raw_sums(img1, mu1, s11, linear_rgb_to_positive_xyb(lin)))
    return torch.stack(out, dim=1)  # (B, n, 3, 6)


def _ref_pyramid(triples, device) -> _kernels.RefPyramid:
    refs = _kernels.RefPyramid()
    for si, triple in enumerate(triples):
        _, hs, ws = triple[0].shape
        ptrs = [
            _kernels.require(a, f"ref plane {si}.{j}", torch.float32,
                             (3, hs, ws), device)
            for j, a in enumerate(triple)
        ]
        refs.img1[si], refs.mu1[si], refs.s11[si] = ptrs
        refs.h[si], refs.w[si] = hs, ws
    return refs


def _ds2_cuda(lib, x: torch.Tensor, st: int) -> torch.Tensor:
    b, c, h, w = x.shape
    out = torch.empty((b, c, h // 2, w // 2), dtype=torch.float32,
                      device=x.device)
    _kernels.check(
        lib.snes_ds2(x.data_ptr(), out.data_ptr(), b * c, h, w, st), "ds2"
    )
    return out


def _multiscale_feature_sums_cuda(ref_scales, frames, pre_ds):
    dev = frames.device
    b, _, h, w = frames.shape
    n = len(ref_scales)
    _kernels.require(frames, "frames", torch.float32, (b, 3, h, w), dev)
    sizes = [tuple(t[0].shape[-2:]) for t in ref_scales]
    for si, (hs, ws) in enumerate(sizes):
        d = pre_ds + si
        if (hs, ws) != (h >> d, w >> d) or h % (1 << d) or w % (1 << d):
            raise ValueError(
                f"scale {si} is {hs}x{ws}; kernel B needs exact 2x2 "
                f"downsamples of the {h}x{w} frames"
            )
    if min(sizes[-1]) < 1:
        raise ValueError("empty scale")
    lib = _kernels.library()
    st = _kernels.stream(dev)
    params = ctypes.addressof(_kernels.metric_params())
    refs = _ref_pyramid(ref_scales, dev)
    out = torch.empty((b, n, 3, 6), dtype=torch.float32, device=dev)
    cur = frames
    for _ in range(pre_ds):
        cur = _ds2_cuda(lib, cur, st)
    for si, (hs, ws) in enumerate(sizes):
        if si:
            cur = _ds2_cuda(lib, cur, st)
        if hs * ws <= RESIDENT_MAX_PIXELS:
            rc = lib.snes_resident_scales(
                cur.data_ptr(), ctypes.addressof(refs), si, n - si, b, b,
                hs, ws, params, out.data_ptr(), n, si, st,
            )
            _kernels.check(rc, "resident_scales")
            break
        n_tiles = (-(-hs // _TILE)) * (-(-ws // _TILE))
        partial = torch.empty((b, 3, n_tiles, 6), dtype=torch.float32,
                              device=dev)
        img1, mu1, s11 = ref_scales[si]
        rc = lib.snes_tiled_scale(
            cur.data_ptr(), img1.data_ptr(), mu1.data_ptr(), s11.data_ptr(),
            partial.data_ptr(), b, b, hs, ws, params, st,
        )
        _kernels.check(rc, "tiled_scale")
        rc = lib.snes_reduce_tiles(
            partial.data_ptr(), out.data_ptr(), b, n_tiles, n, si, st
        )
        _kernels.check(rc, "reduce_tiles")
    multiscale_feature_sums.launches += 1
    return out


def multiscale_feature_sums(ref_scales, frames, *, pre_ds: int = 0):
    """Raw feature sums of consecutive pyramid scales.

    ref_scales: tuple over scales of channel-major (img1, mu1, s11)
        triples, each (3, h_s, w_s) float32 in positive XYB; scale 0 is
        the frames' size after `pre_ds` 2x2 means, each later scale the
        next 2x2 mean (even sizes).
    frames: (B, 3, H, W) float32 linear-RGB frames.
    Returns (B, n_scales, 3, 6) raw sums.
    """
    if frames.is_cuda:
        return _multiscale_feature_sums_cuda(ref_scales, frames, pre_ds)
    return _multiscale_feature_sums_plain(ref_scales, frames, pre_ds)


multiscale_feature_sums.launches = 0


def _coarse_frames_plain(tg, cand8, cand_lin, bva, ml, ds4_l):
    """(B, 3, H/4, W/4) exact quarter-resolution candidate frames
    ds4(L) + (c * pool4(m) - pool4(m * ML)) / 16."""
    b = cand8.shape[0]
    h, w = tg.shape[-2:]
    d = cand8[:, :, None, None] - tg[None]  # (B, 3, H, W) int32
    rsum = tg[0][None] + cand8[:, 0, None, None]
    dist = (
        (1024 + rsum) * d[:, 0] * d[:, 0]
        + 2048 * d[:, 1] * d[:, 1]
        + (1534 - rsum) * d[:, 2] * d[:, 2]
    )
    m = (dist < bva[None]).to(torch.float32)
    maps = torch.cat([m[:, None], m[:, None] * ml[None]], dim=1)
    pooled = maps.reshape(b, 4, h // 4, 4, w // 4, 4).sum(dim=(3, 5))
    return (
        cand_lin[:, :, None, None] * pooled[:, :1] - pooled[:, 1:4]
    ) / 16.0 + ds4_l[None]


def _triples(flat_refs):
    return tuple(
        tuple(flat_refs[3 * si : 3 * si + 3]) for si in range(len(flat_refs) // 3)
    )


def _coarse_plain(tg, cand8, cand_lin, bva, ml, ds4_l, flat_refs):
    frames = _coarse_frames_plain(tg, cand8, cand_lin, bva, ml, ds4_l)
    sums = _multiscale_feature_sums_plain(_triples(flat_refs), frames)
    return sums.reshape(cand8.shape[0], -1, 6)


def _coarse_cuda(tg, cand8, cand_lin, bva, ml, ds4_l, flat_refs):
    dev = tg.device
    b = cand8.shape[0]
    h, w = bva.shape
    if h % 32 or w % 32:
        raise NotImplementedError(
            f"kernel C takes 32-aligned frames, not {h}x{w}; other "
            "geometries need pooled_wins_redmean (ROADMAP queue B item 4)"
        )
    if (h // 4) * (w // 4) > RESIDENT_MAX_PIXELS:
        raise NotImplementedError(
            f"kernel C keeps the quarter-resolution frame in shared memory; "
            f"{h}x{w} is larger than 256x256"
        )
    triples = _triples(flat_refs)
    n = len(triples)
    for si, t in enumerate(triples):
        if tuple(t[0].shape[-2:]) != (h >> (2 + si), w >> (2 + si)):
            raise ValueError(f"coarse scale {2 + si} has the wrong size")
    ptrs = [
        _kernels.require(tg, "tg", torch.int32, (3, h, w), dev),
        _kernels.require(cand8, "cand8", torch.int32, (b, 3), dev),
        _kernels.require(cand_lin, "cand_lin", torch.float32, (b, 3), dev),
        _kernels.require(bva, "bva", torch.int32, (h, w), dev),
        _kernels.require(ml, "ml", torch.float32, (3, h, w), dev),
        _kernels.require(ds4_l, "ds4_l", torch.float32, (3, h // 4, w // 4),
                         dev),
    ]
    if any(p % 16 for p in (ptrs[0], ptrs[3], ptrs[4])):
        raise ValueError("kernel C reads tg, bva and ml as 16-byte vectors")
    refs = _ref_pyramid(triples, dev)
    out = torch.empty((b, n, 3, 6), dtype=torch.float32, device=dev)
    rc = _kernels.library().snes_coarse_redmean(
        *ptrs, ctypes.addressof(refs), 0, n, 1, b, h, w,
        ctypes.addressof(_kernels.metric_params()), out.data_ptr(),
        _kernels.stream(dev),
    )
    _kernels.check(rc, "coarse_redmean")
    coarse_feature_sums_redmean.launches += 1
    return out.reshape(b, 3 * n, 6)


def coarse_feature_sums_redmean(tg, cand8, cand_lin, bva, ml, ds4_l, flat_refs):
    """Fused coarse prescreen, red-mean path.

    tg: (3, H, W) int32 target; cand8: (B, 3) int32 8-bit candidates;
    cand_lin: (B, 3) float32 their linear colours; bva: (H, W) int32 win
    threshold (a candidate wins a pixel where its scaled red-mean distance
    is below it; the caller folds the tie rule and the candidate mask in);
    ml: (3, H, W) float32 masked no-candidate frame; ds4_l: (3, H/4, W/4)
    float32 4x4 means of the no-candidate frame; flat_refs: channel-major
    (img1, mu1, s11) of the coarse scales, from scale 2.
    Returns (B, 3 * n_scales, 6) raw sums.
    """
    if tg.is_cuda:
        return _coarse_cuda(tg, cand8, cand_lin, bva, ml, ds4_l, flat_refs)
    return _coarse_plain(tg, cand8, cand_lin, bva, ml, ds4_l, flat_refs)


coarse_feature_sums_redmean.launches = 0
