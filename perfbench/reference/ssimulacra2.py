"""Plain SSIMULACRA2 (v2.1) of 8-bit sRGB frames, in torch on the CPU.

Written from the published algorithm (libjxl tools/ssimulacra2.cc, as the
program's README and ops/ssimulacra2.py describe it): sRGB decoded to
linear light, a six-scale pyramid of 2x2 box means (an odd side repeats
its last row or column), the positive XYB transform per scale, a
separable Gaussian blur (sigma 1.5, radius 8, zero padding, no border
renormalisation) of both images, their squares and their product, the
SSIM, artifact and detail-loss maps, their 1-norms and 4-norms, the
weighted sum and the score polynomial. The error is 100 - score.

Everything is computed in one dtype: float64 for the reference, bfloat16
for the control (perfbench/control.py), so that a lower precision shows as
a gap. Nothing here reads the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.ssimulacra2_consts import (
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

RADIUS = 8


def srgb_to_linear(rgb_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """8-bit sRGB -> linear light, the transfer curve in float64, then cast."""
    c = rgb_u8.to(torch.float64) / 255.0
    lin = torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    return lin.to(dtype)


def _blur_matrix(n: int, dtype: torch.dtype) -> torch.Tensor:
    """(n, n) banded matrix of the 17 normalised Gaussian taps, zero outside
    the image."""
    x = np.arange(-RADIUS, RADIUS + 1, dtype=np.float64)
    taps = np.exp(-0.5 * (x / GAUSSIAN_SIGMA) ** 2)
    taps /= taps.sum()
    mat = np.zeros((n, n))
    for off, w in zip(range(-RADIUS, RADIUS + 1), taps):
        idx = np.arange(max(0, -off), min(n, n - off))
        mat[idx, idx + off] = w
    return torch.from_numpy(mat).to(dtype)


class _Blur:
    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.mats: dict[int, torch.Tensor] = {}

    def _mat(self, n: int) -> torch.Tensor:
        if n not in self.mats:
            self.mats[n] = _blur_matrix(n, self.dtype)
        return self.mats[n]

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """Blur of (3, h, w) planes along both spatial axes."""
        h, w = img.shape[-2:]
        return self._mat(h) @ img @ self._mat(w).T


def downsample(lin: torch.Tensor) -> torch.Tensor:
    """2x2 box mean of (3, h, w) planes; an odd side repeats its last line."""
    if lin.shape[-2] % 2:
        lin = torch.cat([lin, lin[:, -1:]], dim=-2)
    if lin.shape[-1] % 2:
        lin = torch.cat([lin, lin[:, :, -1:]], dim=-1)
    return (lin[:, 0::2, 0::2] + lin[:, 1::2, 0::2]
            + lin[:, 0::2, 1::2] + lin[:, 1::2, 1::2]) / 4


def positive_xyb(lin: torch.Tensor) -> torch.Tensor:
    """(3, h, w) linear RGB -> positive XYB (libjxl's opsin absorbance, the
    cube root, then SSIMULACRA2's shifts)."""
    m = torch.from_numpy(OPSIN_MATRIX).to(lin.dtype)
    bias = torch.tensor(OPSIN_BIAS, dtype=torch.float64)
    cbrt_bias = bias.pow(1.0 / 3.0).to(lin.dtype)
    mixed = torch.einsum("ij,jhw->ihw", m, lin) + bias.to(lin.dtype)
    lms = torch.sign(mixed) * mixed.abs().pow(1.0 / 3.0) - cbrt_bias
    x = 0.5 * (lms[0] - lms[1])
    y = 0.5 * (lms[0] + lms[1])
    return torch.stack([x * XYB_X_SCALE + XYB_X_OFFSET, y + XYB_Y_OFFSET,
                        (lms[2] - y) + XYB_B_OFFSET])


def _norms(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(3,) 1-norm and 4-norm over each plane of (3, h, w)."""
    one = m.mean(dim=(-2, -1))
    four = (m ** 4).mean(dim=(-2, -1)).pow(0.25)
    return one, four


class Scorer:
    """SSIMULACRA2 errors of frames against one source image: the source's
    half of every scale is worked out once."""

    def __init__(self, source_rgb_u8: np.ndarray, dtype=torch.float64):
        self.dtype = dtype
        self.blur = _Blur(dtype)
        lin = srgb_to_linear(torch.from_numpy(
            np.ascontiguousarray(source_rgb_u8)).permute(2, 0, 1), dtype)
        self.scales = []
        for s in range(NUM_SCALES):
            if s:
                lin = downsample(lin)
            img1 = positive_xyb(lin)
            self.scales.append((img1, self.blur(img1), self.blur(img1 * img1)))
        self.weights = torch.from_numpy(WEIGHTS).to(dtype)

    def error(self, frame_rgb_u8: np.ndarray) -> float:
        """100 - SSIMULACRA2 of an (H, W, 3) 8-bit frame."""
        lin = srgb_to_linear(torch.from_numpy(
            np.ascontiguousarray(frame_rgb_u8)).permute(2, 0, 1), self.dtype)
        feats = []  # (scale, channel, 6)
        for s, (img1, mu1, s11) in enumerate(self.scales):
            if s:
                lin = downsample(lin)
            img2 = positive_xyb(lin)
            mu2 = self.blur(img2)
            s22 = self.blur(img2 * img2)
            s12 = self.blur(img1 * img2)
            num_m = 1.0 - (mu1 - mu2) ** 2
            num_s = 2.0 * (s12 - mu1 * mu2) + SSIM_C2
            denom_s = (s11 - mu1 * mu1) + (s22 - mu2 * mu2) + SSIM_C2
            ssim = torch.clamp(1.0 - num_m * num_s / denom_s, min=0.0)
            d1 = (1.0 + (img2 - mu2).abs()) / (1.0 + (img1 - mu1).abs()) - 1.0
            maps = (ssim, torch.clamp(d1, min=0.0), torch.clamp(-d1, min=0.0))
            norms = [_norms(mp) for mp in maps]
            feats.append(torch.stack([n[0] for n in norms]
                                     + [n[1] for n in norms], dim=-1))
        f = torch.stack(feats).permute(1, 0, 2).reshape(-1)  # c, scale, 6
        total = (f.abs() * self.weights).sum() * SCORE_SCALE
        total = (SCORE_P3 * total ** 3 - SCORE_P2 * total ** 2
                 + SCORE_P1 * total)
        if float(total) <= 0.0:
            return 0.0
        return float(10.0 * total.to(torch.float64) ** SCORE_POW)
