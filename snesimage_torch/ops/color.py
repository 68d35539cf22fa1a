"""Color-space primitives on torch tensors: the red-mean subset of
snesimage_tpu/ops/color.py.

- 5-bit <-> 8-bit channel expansion ``c*8 + c//4`` and SNES BGR555 packing
  (reference: src/lib.rs:662-681).
- The red-mean distance as an exact int32 (reference: src/lib.rs:1080-1088).
- The exact u8 sRGB -> linear lookup table and the analytic transfer curve
  for float inputs.

CIELAB, CIEDE2000 and the NES projection (perceptual and NES modes) are not
ported yet: ROADMAP queue A items 12-13.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def expand_5bit_to_8bit(c: torch.Tensor) -> torch.Tensor:
    """5-bit channel value -> 8-bit int32 via ``c*8 + c//4`` (31 -> 255),
    clipped to [0, 31] first (src/lib.rs:662-669)."""
    c = c.to(torch.int32).clamp(0, 31)
    return c * 8 + c // 4


def pack_bgr555(palette5: torch.Tensor) -> torch.Tensor:
    """Pack 5-bit RGB triples (trailing axis 3) into SNES ``r|g<<5|b<<10``
    as int32 (src/lib.rs:679-681)."""
    p = palette5.to(torch.int32)
    return p[..., 0] + (p[..., 1] << 5) + (p[..., 2] << 10)


def round_half_away_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Rust ``f64::round`` (half away from zero) for non-negative inputs.
    ``torch.round`` rounds half to even, so it is never used here."""
    return torch.floor(x + 0.5)


def red_mean_sq_scaled(rgb1: torch.Tensor, rgb2: torch.Tensor) -> torch.Tensor:
    """512 * red_mean_distance(rgb1, rgb2)**2 as an exact int32:

        (1024 + r1 + r2)*dr^2 + 2048*dg^2 + (1534 - r1 - r2)*db^2

    Inputs are 8-bit RGB values (any integer dtype, trailing axis 3); the
    maximum is about 3.3e8 < 2^31, so argmin over these values keeps the
    reference's strict-less-than tie behaviour."""
    c1 = rgb1.to(torch.int32)
    c2 = rgb2.to(torch.int32)
    d = c1 - c2
    rsum = c1[..., 0] + c2[..., 0]
    return (
        (1024 + rsum) * d[..., 0] * d[..., 0]
        + 2048 * d[..., 1] * d[..., 1]
        + (1534 - rsum) * d[..., 2] * d[..., 2]
    )


def _srgb_u8_linear_lut() -> np.ndarray:
    """Exact f64-computed sRGB-decode table for the 256 u8 codes."""
    c = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    return lin.astype(np.float32)


@lru_cache(maxsize=None)
def _linear_lut(device: torch.device) -> torch.Tensor:
    # Cached per device: a fresh host-to-device copy would synchronise.
    return torch.from_numpy(_srgb_u8_linear_lut()).to(device)


def srgb_u8_to_linear(rgb_u8: torch.Tensor) -> torch.Tensor:
    """8-bit sRGB -> linear f32 via the exact 256-entry table."""
    return _linear_lut(rgb_u8.device)[rgb_u8.long()]


def srgb01_to_linear(c: torch.Tensor) -> torch.Tensor:
    """sRGB transfer decode, input/output in [0, 1]."""
    c = c.to(torch.float32)
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
