"""CIELAB and the CIEDE2000 colour difference, in torch on the CPU.

From the published definitions, as the reference program takes them from
the `palette` crate (src/lib.rs:8, 101-103, 140-153, 344-371, 1090-1100):

- 8-bit sRGB decoded to linear light (IEC 61966-2-1), to XYZ by the sRGB
  D65 matrix, to CIELAB against the D65 white (CIE 15);
- CIELAB back to XYZ, linear light and the sRGB curve, clamped to [0, 1],
  then c * 255 rounded half away from zero (Rust's `f64::round`);
- CIEDE2000 as Sharma, Wu and Dalal (2005) state it, the mean hue and the
  hue difference taken as their equations (7) to (14) say where either
  chroma is 0.

`dtype` picks the arithmetic. float64 is the plain reference. bfloat16
(the control, perfbench/control.py) computes every step in it. float32
restates the program's own float32 steps of the conversions (the rounding
of each product and sum, a cube root and the sRGB curve's power taken in
float64 and rounded once): Lab coordinates feed the initialisation's
k-means, where a near tie decides which cluster a tile joins, so there the
reference has to round where the program does (perfbench/reference/
perceptual.py). CIEDE2000 itself is only ever taken in float64 or in the
control's dtype: the remap check allows the float32 program a stated
rounding margin instead.
"""

from __future__ import annotations

import numpy as np
import torch

# sRGB D65 primaries to XYZ and back, and the D65 white, to the seven
# digits the sRGB definition and the `palette` crate give them.
RGB_TO_XYZ = ((0.4124564, 0.3575761, 0.1804375),
              (0.2126729, 0.7151522, 0.0721750),
              (0.0193339, 0.1191920, 0.9503041))
XYZ_TO_RGB = ((3.2404542, -1.5371385, -0.4985314),
              (-0.9692660, 1.8760108, 0.0415560),
              (0.0556434, -0.2040259, 1.0572252))
WHITE = (0.95047, 1.0, 1.08883)
DELTA = 6.0 / 29.0


def _f32(x: float) -> float:
    return float(np.float32(x))


def _recip32(x: float) -> float:
    """The float32 reciprocal of a constant, which the program multiplies
    by where the formula divides by the constant."""
    return float(np.float32(1.0) / np.float32(x))


def _fma32(a, b, c) -> torch.Tensor:
    """a * b + c taken in float64 and rounded to float32, as the program's
    fused multiply-adds are (constants rounded to float32 first)."""
    a, b, c = (x.double() if torch.is_tensor(x) else _f32(x)
               for x in (a, b, c))
    return (a * b + c).to(torch.float32)


def _pow32(x: torch.Tensor, y: float) -> torch.Tensor:
    """x ** float32(y) in float64, rounded once to float32."""
    return x.double().pow(_f32(y)).to(torch.float32)


def srgb_u8_to_linear(rgb_u8: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """8-bit sRGB -> linear light, the curve in float64, then cast."""
    c = rgb_u8.to(torch.float64) / 255.0
    lin = torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    return lin.to(dtype)


def _matrix(m, v0, v1, v2, dtype) -> list[torch.Tensor]:
    """m @ (v0, v1, v2). In float32 the program's rounding: rows 0 and 1
    ((m0 v0 + m1 v1) + m2 v2) with each product and sum rounded, row 2 two
    fused multiply-adds after the first product."""
    if dtype != torch.float32:
        return [m[r][0] * v0 + m[r][1] * v1 + m[r][2] * v2 for r in range(3)]
    q = [[_f32(x) for x in row] for row in m]
    rows = [q[r][0] * v0 + q[r][1] * v1 + q[r][2] * v2 for r in range(2)]
    rows.append(_fma32(q[2][2], v2, _fma32(q[2][1], v1, q[2][0] * v0)))
    return rows


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return torch.where(t > _f32(DELTA ** 3), _pow32(t, 1.0 / 3.0),
                           _fma32(t, _recip32(3.0 * DELTA ** 2),
                                  4.0 / 29.0))
    cbrt = torch.pow(t.clamp(min=0), 1.0 / 3.0)
    return torch.where(t > DELTA ** 3, cbrt,
                       t / (3.0 * DELTA ** 2) + 4.0 / 29.0)


def srgb_to_lab(rgb_u8, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """8-bit sRGB (trailing axis 3) -> CIELAB (D65) in `dtype`."""
    rgb = torch.as_tensor(np.asarray(rgb_u8)).to(torch.int64)
    lin = srgb_u8_to_linear(rgb, dtype)
    xyz = _matrix(RGB_TO_XYZ, lin[..., 0], lin[..., 1], lin[..., 2], dtype)
    if dtype == torch.float32:
        fx, fy, fz = (_lab_f(v * _recip32(w)) for v, w in zip(xyz, WHITE))
        lightness = _fma32(116.0, fy, -16.0)
    else:
        fx, fy, fz = (_lab_f(v / w) for v, w in zip(xyz, WHITE))
        lightness = 116.0 * fy - 16.0
    return torch.stack([lightness, 500.0 * (fx - fy), 200.0 * (fy - fz)],
                       dim=-1)


def _lab_f_inv(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return torch.where(t > _f32(DELTA), t * (t * t),
                           _f32(3.0 * DELTA ** 2) * (t - _f32(4.0 / 29.0)))
    return torch.where(t > DELTA, t * t * t,
                       3.0 * DELTA ** 2 * (t - 4.0 / 29.0))


def _linear_to_srgb01(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, min=0.0)
    if c.dtype == torch.float32:
        curve = _fma32(1.055, _pow32(c, 1.0 / 2.4), -0.055)
    else:
        curve = 1.055 * c ** (1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, c * 12.92, curve)


def lab_to_srgb_u8(lab: torch.Tensor) -> torch.Tensor:
    """CIELAB (D65, trailing axis 3) -> 8-bit sRGB, int64, computed in
    lab's dtype: clamped to [0, 1], then c * 255 rounded half away from
    zero."""
    dtype = lab.dtype
    l, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    if dtype == torch.float32:
        fy = (l + 16.0) * _recip32(116.0)
        fx = _fma32(a, _recip32(500.0), fy)
        fz = _fma32(-b, _recip32(200.0), fy)
    else:
        fy = (l + 16.0) / 116.0
        fx, fz = fy + a / 500.0, fy - b / 200.0
    xyz = [_lab_f_inv(f) * w for f, w in zip((fx, fy, fz), WHITE)]
    lin = torch.stack(_matrix(XYZ_TO_RGB, *xyz, dtype), dim=-1)
    srgb = torch.clamp(_linear_to_srgb01(lin), 0.0, 1.0)
    if dtype == torch.float32:
        scaled = _fma32(srgb, 255.0, 0.5)
    else:
        scaled = srgb * 255.0 + 0.5
    return torch.floor(scaled).to(torch.int64)


def _hue(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """atan2(b, a) in degrees, in [0, 360); 0 where a = b = 0."""
    h = torch.rad2deg(torch.atan2(b, a))
    return torch.where(h < 0, h + 360.0, h)


def ciede2000(lab1: torch.Tensor, lab2: torch.Tensor, lab_error=None):
    """The CIEDE2000 difference of CIELAB triples (trailing axis 3; they
    broadcast), with kL = kC = kH = 1, in their dtype.

    The formula is discontinuous where the two hues lie 180 degrees apart:
    the mean hue and the sign of the hue difference switch branch there.
    With `lab_error` (the largest error of a Lab coordinate that the
    compared computation makes) it returns (least, largest) of the two
    branches wherever coordinates that far off could put the hues on
    either side, and the value twice elsewhere."""
    l1, a1, b1 = lab1.unbind(-1)
    l2, a2, b2 = lab2.unbind(-1)
    c_mean = (torch.sqrt(a1 * a1 + b1 * b1)
              + torch.sqrt(a2 * a2 + b2 * b2)) / 2
    c7 = c_mean ** 7
    g = 0.5 * (1 - torch.sqrt(c7 / (c7 + 25.0 ** 7)))
    a1p, a2p = (1 + g) * a1, (1 + g) * a2
    c1p = torch.sqrt(a1p * a1p + b1 * b1)
    c2p = torch.sqrt(a2p * a2p + b2 * b2)
    h1p, h2p = _hue(b1, a1p), _hue(b2, a2p)
    apart = (h1p - h2p).abs()

    def branch(far: torch.Tensor) -> torch.Tensor:
        return _ciede2000_rest(l1, l2, c1p, c2p, h1p, h2p, far)

    far = apart > 180
    d = branch(far)
    if lab_error is None:
        return d
    # a' and b move by at most (1 + G) * lab_error <= e, so C' by at most
    # e and a hue by at most e / (C' - e) radians (any hue where C' <= e).
    e = 1.5 * lab_error
    slack = sum(torch.rad2deg(e / (c - e).clamp(min=0)) for c in (c1p, c2p))
    other = torch.where((apart - 180).abs() <= slack, branch(~far), d)
    return torch.minimum(d, other), torch.maximum(d, other)


def _ciede2000_rest(l1, l2, c1p, c2p, h1p, h2p, far):
    """CIEDE2000 from the lightnesses, the adjusted chromas and hues,
    with the hues taken as more than 180 degrees apart where `far`."""
    achromatic = (c1p * c2p) == 0
    dh = h2p - h1p
    dh = torch.where(far, torch.where(dh > 0, dh - 360, dh + 360), dh)
    dh = torch.where(achromatic, torch.zeros_like(dh), dh)
    d_lp = l2 - l1
    d_cp = c2p - c1p
    d_hp = 2 * torch.sqrt(c1p * c2p) * torch.sin(torch.deg2rad(dh / 2))
    l_mean = (l1 + l2) / 2
    cp_mean = (c1p + c2p) / 2
    h_sum = h1p + h2p
    h_mean = torch.where(
        ~far, h_sum / 2,
        torch.where(h_sum < 360, (h_sum + 360) / 2, (h_sum - 360) / 2))
    h_mean = torch.where(achromatic, h_sum, h_mean)
    t = (1 - 0.17 * torch.cos(torch.deg2rad(h_mean - 30))
         + 0.24 * torch.cos(torch.deg2rad(2 * h_mean))
         + 0.32 * torch.cos(torch.deg2rad(3 * h_mean + 6))
         - 0.20 * torch.cos(torch.deg2rad(4 * h_mean - 63)))
    d_theta = 30 * torch.exp(-(((h_mean - 275) / 25) ** 2))
    cp7 = cp_mean ** 7
    r_c = 2 * torch.sqrt(cp7 / (cp7 + 25.0 ** 7))
    lm2 = (l_mean - 50) ** 2
    s_l = 1 + 0.015 * lm2 / torch.sqrt(20 + lm2)
    s_c = 1 + 0.045 * cp_mean
    s_h = 1 + 0.015 * cp_mean * t
    r_t = -torch.sin(torch.deg2rad(2 * d_theta)) * r_c
    tl, tc, th = d_lp / s_l, d_cp / s_c, d_hp / s_h
    return torch.sqrt(torch.clamp(tl * tl + tc * tc + th * th + r_t * tc * th,
                                  min=0))
