"""Color-space primitives on torch tensors, the counterpart of
snesimage_tpu/ops/color.py.

- 5-bit <-> 8-bit channel expansion ``c*8 + c//4`` and SNES BGR555 packing
  (reference: src/lib.rs:662-681).
- The red-mean distance as an exact int32 (reference: src/lib.rs:1080-1088).
- The exact u8 sRGB -> linear lookup table and the analytic transfer curve
  for float inputs.
- sRGB u8 <-> CIELAB (D65) and the standard CIEDE2000 difference
  (reference: src/lib.rs:1090-1100, via the `palette` crate).
- The projection of 5-bit colours onto the 56 NES colours
  (reference: src/lib.rs:640-660).

The float32 arithmetic follows what the JAX package's CPU compilation
computes, so that the two packages agree to the bit as often as they can:
XLA fuses a product into the sum that consumes it (one rounding: `_fma`),
turns a division by a constant into a product with its float32 reciprocal,
adds the X and Y rows of a 3x3 colour matrix left to right but fuses the Z
row (`_mat3`), and takes a power as glibc's ``powf`` does (here a float64
power rounded once, which differs in the last bit for about 0.06% of Lab
channels). Square roots and CIEDE2000's arctangent, sines, cosines and
exponential are taken in float64 and rounded once (`_f64`): the CPU
float32 ``torch.sqrt`` is not correctly rounded, and the CPU float32
``torch.atan2`` rounds a vectorised body and a scalar tail differently, so
its bits would depend on how a tensor is split between threads. Rounded
from float64, the backends agree to the bit unless two float64 libraries
straddle a float32 rounding boundary; csrc/ciede2000.cuh takes the same
steps on the card.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from snesimage_torch.constants import NES_PALETTE_5BIT


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


def linear_to_srgb01(c: torch.Tensor) -> torch.Tensor:
    """sRGB transfer encode, input/output in [0, 1]."""
    c = torch.clamp(c.to(torch.float32), min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       _fma(1.055, _powf(c, 1.0 / 2.4), -0.055))


# sRGB D65 matrices and white point (the `palette` crate's constants).
_RGB_TO_XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=np.float32,
)
_XYZ_TO_RGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=np.float32,
)
_D65_WHITE = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)
_DELTA = 6.0 / 29.0


def _f32(x: float) -> float:
    """A Python float rounded to float32, as XLA folds a weak constant."""
    return float(np.float32(x))


def _recip(x: float) -> float:
    """The float32 reciprocal that replaces a division by constant x."""
    return float(np.float32(1.0) / np.float32(x))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (the float64 product of two float32
    values is exact). At least one argument is a float32 tensor; Python
    constants are rounded to float32 first."""
    a, b, c = (x.double() if torch.is_tensor(x) else _f32(x) for x in (a, b, c))
    return (a * b + c).to(torch.float32)


def _f64(fn, *args: torch.Tensor) -> torch.Tensor:
    """fn taken in float64 and rounded once to float32."""
    return fn(*(a.double() for a in args)).to(torch.float32)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return _f64(torch.sqrt, x)


def _powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """x ** float32(y) for x >= 0, taken in float64 and rounded once."""
    return x.double().pow(_f32(y)).to(torch.float32)


def _mat3(m: np.ndarray, v0, v1, v2) -> list[torch.Tensor]:
    """m @ (v0, v1, v2) with the rounding of XLA's CPU dot: rows 0 and 1
    are ((m0 v0 + m1 v1) + m2 v2) with each step rounded, row 2 a chain of
    two fused multiply-adds."""
    rows = [
        float(m[r, 0]) * v0 + float(m[r, 1]) * v1 + float(m[r, 2]) * v2
        for r in range(2)
    ]
    rows.append(_fma(float(m[2, 2]), v2,
                     _fma(float(m[2, 1]), v1, float(m[2, 0]) * v0)))
    return rows


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(
        t > _f32(_DELTA**3),
        _powf(t, 1.0 / 3.0),  # cbrt, as XLA's CPU code takes it
        _fma(t, _recip(3.0 * _DELTA**2), _f32(4.0 / 29.0)),
    )


def _lab_f_inv(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _f32(_DELTA), t * (t * t),
                       _f32(3.0 * _DELTA**2) * (t - _f32(4.0 / 29.0)))


def srgb_u8_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """8-bit sRGB (trailing axis 3) -> CIELAB (D65), float32. Matches the
    `palette` crate conversion of src/lib.rs:101-103, 344-346, 1092-1097."""
    lin = srgb_u8_to_linear(rgb)
    xyz = _mat3(_RGB_TO_XYZ, lin[..., 0], lin[..., 1], lin[..., 2])
    fx, fy, fz = (
        _lab_f(v * _recip(w)) for v, w in zip(xyz, _D65_WHITE.tolist())
    )
    return torch.stack(
        [_fma(116.0, fy, -16.0), 500.0 * (fx - fy), 200.0 * (fy - fz)],
        dim=-1,
    )


def lab_to_srgb_u8(lab: torch.Tensor) -> torch.Tensor:
    """CIELAB (D65) -> 8-bit sRGB, int32: clamped to [0, 1], then c*255
    rounded half away from zero like Rust's ``f64::round`` (src/lib.rs:
    140-153, 368-371; ROADMAP fault class C-2)."""
    lab = lab.to(torch.float32)
    fy = (lab[..., 0] + 16.0) * _recip(116.0)
    fx = _fma(lab[..., 1], _recip(500.0), fy)
    fz = _fma(-lab[..., 2], _recip(200.0), fy)
    xyz = [
        _lab_f_inv(f) * w for f, w in zip((fx, fy, fz), _D65_WHITE.tolist())
    ]
    lin = torch.stack(_mat3(_XYZ_TO_RGB, *xyz), dim=-1)
    srgb = torch.clamp(linear_to_srgb01(lin), 0.0, 1.0)
    return torch.floor(_fma(srgb, 255.0, 0.5)).to(torch.int32)


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """JAX's hypot formula: max * sqrt(1 + (min / max)**2)."""
    x, y = x.abs(), y.abs()
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    r = lo / torch.where(hi == 0, 1.0, hi)
    return torch.where(hi == 0, hi, hi * _sqrt(_fma(r, r, 1.0)))


def _pow7(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    return (x * x2) * (x2 * x2)


_RAD2DEG = _f32(180.0 / math.pi)
_DEG2RAD = _f32(math.pi / 180.0)
_POW25_7 = _f32(25.0**7)


def ciede2000(lab1: torch.Tensor, lab2: torch.Tensor) -> torch.Tensor:
    """CIEDE2000 colour difference (Sharma et al. 2005), the formula of
    the `palette` crate (src/lib.rs:8, 1090-1100). Inputs are CIELAB
    triples (trailing axis 3); they broadcast. The steps are those of
    snesimage_tpu/ops/color.py `ciede2000`; csrc/ciede2000.cuh repeats
    them on the card."""
    lab1 = lab1.to(torch.float32)
    lab2 = lab2.to(torch.float32)
    l1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    l2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]

    cbar = 0.5 * (_hypot(a1, b1) + _hypot(a2, b2))
    cbar7 = _pow7(cbar)
    g = 0.5 * (1.0 - _sqrt(cbar7 / (cbar7 + _POW25_7)))
    a1p = (1.0 + g) * a1
    a2p = (1.0 + g) * a2
    c1p = _hypot(a1p, b1)
    c2p = _hypot(a2p, b2)

    def hue(b, a):
        # degrees in [0, 360): a floor-mod, atan2(0, 0) == 0
        h = _f64(torch.atan2, b, a) * _RAD2DEG
        return torch.where(h < 0.0, h + 360.0, h)

    h1p = hue(b1, a1p)
    h2p = hue(b2, a2p)
    prod_zero = (c1p * c2p) == 0.0
    hdiff = h2p - h1p
    dhp = torch.where(
        prod_zero,
        0.0,
        torch.where(
            hdiff.abs() <= 180.0,
            hdiff,
            torch.where(hdiff > 180.0, hdiff - 360.0, hdiff + 360.0),
        ),
    )
    dHp = 2.0 * _sqrt(c1p * c2p) * _f64(torch.sin, dhp * _DEG2RAD * 0.5)

    lbar = 0.5 * (l1 + l2)
    cbarp = 0.5 * (c1p + c2p)
    hsum = h1p + h2p
    hbarp = torch.where(
        prod_zero,
        hsum,
        torch.where(
            (h1p - h2p).abs() <= 180.0,
            0.5 * hsum,
            torch.where(hsum < 360.0, 0.5 * (hsum + 360.0),
                        0.5 * (hsum - 360.0)),
        ),
    )
    def cos(deg):
        return _f64(torch.cos, deg * _DEG2RAD)

    t = _fma(
        -0.20, cos(_fma(4.0, hbarp, -63.0)),
        _fma(0.32, cos(_fma(3.0, hbarp, 6.0)),
             _fma(0.24, cos(2.0 * hbarp),
                  _fma(-0.17, cos(hbarp - 30.0), 1.0))),
    )
    q = (hbarp - 275.0) * _recip(25.0)
    dtheta = 30.0 * _f64(torch.exp, -(q * q))
    cbarp7 = _pow7(cbarp)
    rc = 2.0 * _sqrt(cbarp7 / (cbarp7 + _POW25_7))
    lm = lbar - 50.0
    lm50 = lm * lm
    sl = 1.0 + 0.015 * lm50 / _sqrt(20.0 + lm50)
    sc = _fma(0.045, cbarp, 1.0)
    sh = _fma(0.015 * cbarp, t, 1.0)
    rt = -_f64(torch.sin, (2.0 * dtheta) * _DEG2RAD) * rc

    tl = (l2 - l1) / sl
    tc = (c2p - c1p) / sc
    th = dHp / sh
    s = _fma(rt * tc, th, _fma(th, th, _fma(tl, tl, tc * tc)))
    return _sqrt(torch.clamp(s, min=0.0))


def ciede2000_srgb_u8(rgb1: torch.Tensor, rgb2: torch.Tensor) -> torch.Tensor:
    """CIEDE2000 between 8-bit sRGB colours (src/lib.rs:1090-1100)."""
    return ciede2000(srgb_u8_to_lab(rgb1), srgb_u8_to_lab(rgb2))


@lru_cache(maxsize=None)
def nes_palette_5bit(device: torch.device) -> torch.Tensor:
    """The 56 NES colours as (56, 3) int32 5-bit triples on `device`
    (cached per device: a fresh host-to-device copy would synchronise)."""
    return torch.from_numpy(NES_PALETTE_5BIT).to(device)


def nes_palette_rgb8(device: torch.device | str = "cpu") -> torch.Tensor:
    """The 56 NES colours expanded to 8-bit RGB, (56, 3) int32."""
    return expand_5bit_to_8bit(nes_palette_5bit(torch.device(device)))


def nes_quantize(rgb5: torch.Tensor, perceptual: bool) -> torch.Tensor:
    """5-bit RGB triples (trailing axis 3) projected onto the nearest of
    the 56 NES colours, as 5-bit triples of the same shape. Matches
    ``SnesColor::new_nes_only`` (src/lib.rs:640-660): both sides are
    expanded to 8 bits and compared by red-mean, or by CIEDE2000 when
    `perceptual`; the first index that attains the minimum wins."""
    nes5 = nes_palette_5bit(rgb5.device)
    nes8 = expand_5bit_to_8bit(nes5)
    rgb8 = expand_5bit_to_8bit(rgb5)
    if perceptual:
        d = ciede2000(srgb_u8_to_lab(rgb8)[..., None, :], srgb_u8_to_lab(nes8))
    else:
        d = red_mean_sq_scaled(rgb8[..., None, :], nes8)
    return nes5[torch.argmin(d, dim=-1)]
