"""SSIMULACRA2 metric on torch tensors.

Counterpart of snesimage_tpu/ops/ssimulacra2.py with the same structure
(SSIMULACRA2 v2.1): linear RGB -> 6-scale 2x2-box pyramid -> positive XYB
-> FIR Gaussian blur (sigma 1.5, radius 8, zero padding, no border
renormalisation) of img, img^2 and img1*img2 -> SSIM, artifact and
detail-loss maps -> 1-norms and 4-norms -> weighted sum -> score.

Layouts follow the JAX package: frames are channel-last (..., H, W, 3)
except where a name says ``cmaj`` (channel-major, (B, 3, H, W)). The
reference pyramid's planes are *stored* channel-major, the layout the CUDA
kernels read, and handed out as channel-last views, the layout every
function here and in the JAX package takes (`channel_major_storage`).

`fused_scale_feature_block` is the refine loop's metric entry: it takes
raw moment sums from ops/cuda_metric.py `multiscale_feature_sums` (kernel B
on CUDA tensors, its plain twin on CPU tensors) and finalises them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from snesimage_torch.ops.color import srgb01_to_linear, srgb_u8_to_linear
from snesimage_torch.ops.ssimulacra2_consts import (
    GAUSSIAN_SIGMA,
    NUM_SCALES,
    OPSIN_BIAS,
    OPSIN_MATRIX,
    SCORE_P1,
    SCORE_P2,
    SCORE_P3,
    SCORE_POW,
    SCORE_SCALE,
    SSIM_C2,
    WEIGHTS,
    XYB_B_OFFSET,
    XYB_X_OFFSET,
    XYB_X_SCALE,
    XYB_Y_OFFSET,
)

BLUR_RADIUS = 8


def blur_taps() -> np.ndarray:
    """The 17 FIR taps: a Gaussian normalised in f64, then cast to f32
    (the entries of the JAX package's banded blur matrices)."""
    x = np.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / GAUSSIAN_SIGMA) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


@lru_cache(maxsize=None)
def _blur_matrix(n: int, device: torch.device) -> torch.Tensor:
    """Banded (n, n) matrix applying the taps with zero padding."""
    taps = blur_taps()
    mat = np.zeros((n, n), dtype=np.float32)
    for off, w in zip(range(-BLUR_RADIUS, BLUR_RADIUS + 1), taps):
        idx = np.arange(max(0, -off), min(n, n - off))
        mat[idx, idx + off] = w
    return torch.from_numpy(mat).to(device)


@lru_cache(maxsize=None)
def _weights(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(WEIGHTS.astype(np.float32)).to(device)


@lru_cache(maxsize=None)
def _pixel_counts(sizes: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(sizes, dtype=torch.float32).to(device)


def channel_major_storage(a: torch.Tensor) -> torch.Tensor:
    """Channel-last view (..., h, w, 3) of a channel-major copy of `a`."""
    return a.movedim(-1, -3).contiguous().movedim(-3, -1)


def stack_pyramids(pyramids):
    """The pyramids of N images as one: each plane (N, h, w, 3), a view of
    channel-major (N, 3, h, w) storage as the kernels read it."""
    return tuple(
        tuple(torch.stack([p[s][j].movedim(-1, -3) for p in pyramids])
              .movedim(-3, -1) for j in range(3))
        for s in range(len(pyramids[0]))
    )


def shared_pyramid(refp, n: int):
    """One image's pyramid as the pyramid of n images that share it: each
    plane an (n, h, w, 3) view with stride 0 on the image axis, which the
    kernels read as one pyramid (no copies)."""
    return tuple(tuple(a.expand(n, *a.shape) for a in sc) for sc in refp)


def blur(img: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur over the (-3, -2) spatial axes of
    (..., H, W, C) as two banded float32 matmuls."""
    h, w = img.shape[-3], img.shape[-2]
    bh = _blur_matrix(h, img.device)
    bw = _blur_matrix(w, img.device)
    tmp = torch.einsum("hj,...jwc->...hwc", bh, img)
    return torch.einsum("wk,...hkc->...hwc", bw, tmp)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 box mean over (..., H, W, C), edge-replicating odd sizes."""
    h, w = img.shape[-3], img.shape[-2]
    if h % 2:
        img = torch.cat([img, img[..., -1:, :, :]], dim=-3)
    if w % 2:
        img = torch.cat([img, img[..., :, -1:, :]], dim=-2)
    h2, w2 = (h + h % 2) // 2, (w + w % 2) // 2
    r = img.reshape(*img.shape[:-3], h2, 2, w2, 2, img.shape[-1])
    return r.mean(dim=(-4, -2))


def pyramid_size(h: int, w: int, levels: int) -> tuple[int, int]:
    """Size of an h x w plane after `levels` calls of `downsample2`."""
    for _ in range(levels):
        h, w = (h + 1) // 2, (w + 1) // 2
    return h, w


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    # The power is taken in float64 and rounded: a CPU float32 pow rounds
    # a vectorised body and a scalar tail differently, and equal frames
    # of a batch must score equal (ties are broken by index).
    return torch.sign(x) * x.abs().double().pow(1.0 / 3.0).to(torch.float32)


_BIAS_F32 = float(np.float32(OPSIN_BIAS))
_CBRT_BIAS_F32 = float(np.cbrt(np.float32(OPSIN_BIAS)))


def linear_rgb_to_positive_xyb(lin: torch.Tensor) -> torch.Tensor:
    """Linear RGB -> XYB (libjxl opsin) -> v2.1 positive-XYB affine map.
    The opsin mix is written out term by term, so every pixel of a batch
    rounds alike (a batched matmul may not)."""
    lin = lin.to(torch.float32)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    m = OPSIN_MATRIX.astype(np.float32)
    lms = [
        _cbrt(float(m[i, 0]) * r + float(m[i, 1]) * g + float(m[i, 2]) * b
              + _BIAS_F32) - _CBRT_BIAS_F32
        for i in range(3)
    ]
    x = 0.5 * (lms[0] - lms[1])
    y = 0.5 * (lms[0] + lms[1])
    return torch.stack(
        [x * XYB_X_SCALE + XYB_X_OFFSET, y + XYB_Y_OFFSET,
         (lms[2] - y) + XYB_B_OFFSET],
        dim=-1,
    )


def feature_maps(img1, mu1, s11, img2):
    """The SSIM, artifact and detail-loss maps of one scale, each shaped
    like img2 (..., H, W, C)."""
    mu2 = blur(img2)
    s22 = blur(img2 * img2)
    s12 = blur(img1 * img2)
    mu_diff = mu1 - mu2
    num_m = 1.0 - mu_diff * mu_diff
    num_s = 2.0 * (s12 - mu1 * mu2) + SSIM_C2
    denom_s = (s11 - mu1 * mu1) + (s22 - mu2 * mu2) + SSIM_C2
    ssim_d = torch.clamp(1.0 - (num_m * num_s) / denom_s, min=0.0)
    d1 = (1.0 + (img2 - mu2).abs()) / (1.0 + (img1 - mu1).abs()) - 1.0
    return ssim_d, torch.clamp(d1, min=0.0), torch.clamp(-d1, min=0.0)


def _fourth_root(m4: torch.Tensor) -> torch.Tensor:
    # Two correctly rounded square roots: the same bits for every element.
    return torch.where(m4 > 0, torch.sqrt(torch.sqrt(m4)), 0.0)


def _scale_features(img1, mu1, s11, img2) -> torch.Tensor:
    """(..., C, 6): [ssim1, art1, det1, ssim4, art4, det4] per channel."""
    maps = feature_maps(img1, mu1, s11, img2)
    one = [m.mean(dim=(-3, -2)) for m in maps]
    four = [_fourth_root((m**4).mean(dim=(-3, -2))) for m in maps]
    return torch.stack(one + four, dim=-1)


def _decode_srgb(img: torch.Tensor) -> torch.Tensor:
    """Integer inputs take the exact u8 table; float inputs in [0, 1] the
    analytic transfer curve."""
    if img.dtype.is_floating_point:
        return srgb01_to_linear(img)
    return srgb_u8_to_linear(img)


def reference_pyramid(ref01: torch.Tensor):
    """Candidate-independent half of the metric: per scale (img1, mu1, s11)
    in positive XYB, each (h, w, 3) (see `channel_major_storage`)."""
    lin = _decode_srgb(ref01)
    scales = []
    for s in range(NUM_SCALES):
        if s:
            lin = downsample2(lin)
        img1 = linear_rgb_to_positive_xyb(lin)
        scales.append(
            tuple(
                channel_major_storage(a)
                for a in (img1, blur(img1), blur(img1 * img1))
            )
        )
    return tuple(scales)


def scale_features(
    refp,
    lin2: torch.Tensor,
    *,
    skip_scales: int = 0,
    input_scale: int = 0,
    max_scale: int = NUM_SCALES,
) -> torch.Tensor:
    """Per-scale features (..., NUM_SCALES, 3, 6) of channel-last linear
    frames already at scale `input_scale`; scales outside
    [max(skip_scales, input_scale), max_scale) are zero."""
    if input_scale > skip_scales:
        raise ValueError("input_scale must be <= skip_scales")
    zero = torch.zeros(lin2.shape[:-3] + (3, 6), device=lin2.device)
    feats = []
    for s in range(NUM_SCALES):
        if s < input_scale or s >= max_scale:
            feats.append(zero)
            continue
        if s > input_scale:
            lin2 = downsample2(lin2)
        if s < skip_scales:
            feats.append(zero)
            continue
        img1, mu1, s11 = refp[s]
        feats.append(
            _scale_features(img1, mu1, s11, linear_rgb_to_positive_xyb(lin2))
        )
    return torch.stack(feats, dim=-3)


def finalize_feature_sums(
    sums: torch.Tensor, sizes, start_scale: int
) -> torch.Tensor:
    """Raw moment sums (..., B, 3*n, 6) -> (..., B, NUM_SCALES, 3, 6)
    features, zero outside [start_scale, start_scale + n)."""
    lead = sums.shape[:-2]
    n = len(sizes)
    sums = sums.reshape(*lead, n, 3, 6)
    n_px = _pixel_counts(tuple(sizes), sums.device).view(n, 1, 1)
    one = sums[..., 0:3] / n_px
    four = _fourth_root(sums[..., 3:6] / n_px)
    full = torch.zeros((*lead, NUM_SCALES, 3, 6), device=sums.device)
    full[..., start_scale : start_scale + n, :, :] = torch.cat([one, four],
                                                               dim=-1)
    return full


def fused_scale_feature_block(
    refp,
    frames_cmaj: torch.Tensor,
    start_scale: int,
    num_scales: int,
    *,
    pre_ds: int = 0,
    gate=None,
) -> torch.Tensor:
    """Features (B, NUM_SCALES, 3, 6) of `num_scales` consecutive scales
    from channel-major linear frames (B, 3, h, w) at the resolution of
    scale `start_scale - pre_ds`; zero outside [start_scale, start_scale +
    num_scales). Raw sums come from `multiscale_feature_sums` (kernel B on
    CUDA tensors, its twin on CPU tensors). The pyramid's scales must have
    the sizes `reference_pyramid` gives for frames of this size (odd sides
    round up); anything else raises ValueError.

    Frames (N, B, 3, h, w) of N images give (N, B, NUM_SCALES, 3, 6): the
    pyramid's planes are then (N, h, w, 3), one pyramid an image, or
    (h, w, 3), one for all. `gate` (an int32 flag an image) zeroes the sums
    of the images whose flag is 0 (`multiscale_feature_sums`)."""
    from snesimage_torch.ops.cuda_metric import multiscale_feature_sums

    lead = frames_cmaj.shape[:-3]
    h, w = frames_cmaj.shape[-2:]
    ref_scales, sizes = [], []
    for si in range(num_scales):
        img1, mu1, s11 = refp[start_scale + si]
        hs, ws = img1.shape[-3], img1.shape[-2]
        if (hs, ws) != pyramid_size(h, w, si + pre_ds):
            raise ValueError(
                f"scale {start_scale + si} of the pyramid is {hs}x{ws}, not "
                f"the {si + pre_ds}-fold 2x2 downsample of the {h}x{w} frames"
            )
        sizes.append(hs * ws)
        ref_scales.append(tuple(a.movedim(-1, -3) for a in (img1, mu1, s11)))
    sums = multiscale_feature_sums(tuple(ref_scales), frames_cmaj,
                                   pre_ds=pre_ds, gate=gate)
    return finalize_feature_sums(sums.reshape(*lead, -1, 6), sizes,
                                 start_scale)


def ssim_weighted_sum(f: torch.Tensor) -> torch.Tensor:
    """(..., NUM_SCALES, 3, 6) features -> the weighted |feature| sum in
    the weight table's order (channel, scale, norm, metric). Sums of
    features with disjoint scale support decompose exactly."""
    f = f.movedim(-2, -3)  # (..., C, scales, 6)
    flat = f.abs().reshape(*f.shape[:-3], 108)
    return (flat * _weights(f.device)).sum(-1)  # rows round alike


def score_from_ssim_sum(ssim: torch.Tensor) -> torch.Tensor:
    """Weighted |feature| sum -> SSIMULACRA2 score (<= 100)."""
    ssim = ssim * SCORE_SCALE
    sq = ssim * ssim
    ssim = SCORE_P3 * (sq * ssim) - SCORE_P2 * sq + SCORE_P1 * ssim
    # float64 power, rounded: see _cbrt
    powed = torch.clamp(ssim, min=1e-30).double().pow(SCORE_POW)
    return torch.where(ssim > 0.0, 100.0 - 10.0 * powed.to(torch.float32), 100.0)


def score_from_features(f: torch.Tensor) -> torch.Tensor:
    return score_from_ssim_sum(ssim_weighted_sum(f))


def ssimulacra2(ref01: torch.Tensor, dis01: torch.Tensor) -> torch.Tensor:
    """Full-reference SSIMULACRA2 score (100 = identical, lower = worse)
    of (..., H, W, 3) sRGB frames (float in [0, 1] or 8-bit)."""
    return score_from_features(
        scale_features(reference_pyramid(ref01), _decode_srgb(dis01))
    )
