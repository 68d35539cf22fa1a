"""Prescreen kernels A, E and F and their plain twins.

Counterpart of snesimage_tpu/ops/pallas_prescreen.py.

- `select_colors` (kernel A, csrc/select_colors.cu). The refine loop builds
  each slot visit's no-candidate frame with it: every pixel picks its
  linear colour from the (3, C*S) entry table by a combined key, and the
  sentinel key K (transparent pixels) gives 0. The dithered visit renders
  all its candidates' palette maps in one call, each with its own table.
  The twin is the padded gather of the JAX package's XLA path; the two are
  bit-identical: both copy table entries.
- `pooled_wins_redmean` (kernel E) and `pooled_wins_ciede` (kernel F), both
  csrc/pooled_wins.cu: per candidate the win mask of a slot visit and its
  4x4-pooled sums, from which `coarse_frames` assembles the exact
  quarter-resolution candidate frames. The visit takes them where the
  fused kernels C and D (ops/cuda_metric.py) cannot run: image sides that
  are not multiples of 32. F also returns the CIEDE2000 distance planes.
  The twins take the same steps in plain torch; C's and D's twins pool
  with the same routine (`pooled_sums`). Mask counts are exact; the three
  m*ML sums add 16 floats in another order than torch does and agree
  within 1e-5; F's distance planes equal the twin's to the bit.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the twin. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from snesimage_torch.ops import _kernels
from snesimage_torch.ops.color import ciede2000


def _select_colors_plain(key: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Zero-padded gather: (N, 3, H, W) planes, 0 where key >= K (or
    (3, H, W) for one key plane and one table)."""
    if key.dim() == 2:
        return _select_colors_plain(key[None], table[None])[0]
    n, h, w = key.shape
    padded = torch.cat([table, table.new_zeros((n, 3, 1))], dim=2)
    safe = torch.clamp(key, max=padded.shape[2] - 1).long()
    flat = safe.reshape(n, 1, h * w).expand(n, 3, h * w)
    return torch.gather(padded, 2, flat).reshape(n, 3, h, w)


def _select_colors_cuda(key: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    n, h, w = key.shape
    k = table.shape[2]
    dev = key.device
    out = torch.empty((n, 3, h, w), dtype=torch.float32, device=dev)
    rc = _kernels.library().snes_select_colors(
        _kernels.require(key, "key", torch.int32, (n, h, w), dev),
        _kernels.require(table, "table", torch.float32, (n, 3, k), dev),
        out.data_ptr(),
        n,
        h * w,
        k,
        _kernels.stream(dev),
    )
    _kernels.check(rc, "select_colors")
    select_colors.launches += 1
    return out


def select_colors(key: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(3, H, W) colour planes selected from a small table by pixel key.

    key:   (H, W) int32 in [0, K]; the value K selects 0.0.
    table: (3, K) float32 channel-major colour table.
    With a leading axis N on both (one table per key plane: the dithered
    visit renders its candidates so), the result is (N, 3, H, W).
    """
    batched = key.dim() == 3
    if not batched:
        key, table = key[None], table[None]
    fn = _select_colors_cuda if key.is_cuda else _select_colors_plain
    out = fn(key, table)
    return out if batched else out[0]


select_colors.launches = 0


def redmean_wins(tg, cand8, bva) -> torch.Tensor:
    """(B, H, W) bool win masks d < bva, d the exact int32 scaled red-mean
    distance of target `tg` (3, H, W) to each of the (B, 3) candidates."""
    d = cand8[:, :, None, None] - tg[None]  # (B, 3, H, W) int32
    rsum = tg[0][None] + cand8[:, 0, None, None]
    dist = (
        (1024 + rsum) * d[:, 0] * d[:, 0]
        + 2048 * d[:, 1] * d[:, 1]
        + (1534 - rsum) * d[:, 2] * d[:, 2]
    )
    return dist < bva[None]


def ciede_wins(tlab, cand_lab, bvalm, adj):
    """((B, H, W) bool win masks, (B, H, W) float32 CIEDE2000 distances of
    the target Lab planes (3, H, W) to each of the (B, 3) candidate Labs):
    a candidate wins where d < bvalm, or d == bvalm and adj != 0."""
    dcand = ciede2000(tlab.movedim(0, -1)[None], cand_lab[:, None, None, :])
    wins = (dcand < bvalm[None]) | ((dcand == bvalm[None]) & (adj[None] != 0))
    return wins, dcand


def pooled_sums(wins, ml) -> torch.Tensor:
    """(B, 4, H/4, W/4) sums over 4x4 cells of m, m*ML_r, m*ML_g, m*ML_b
    for (B, H, W) win masks and the (3, H, W) masked no-candidate frame."""
    b, h, w = wins.shape
    m = wins.to(torch.float32)
    maps = torch.cat([m[:, None], m[:, None] * ml[None]], dim=1)
    return maps.reshape(b, 4, h // 4, 4, w // 4, 4).sum(dim=(3, 5))


def coarse_frames(pooled, cand_lin, ds4_l) -> torch.Tensor:
    """(B, 3, H/4, W/4) exact quarter-resolution candidate frames
    ds4(L) + (c * pool4(m) - pool4(m * ML)) / 16 from (B, 4, H/4, W/4)
    pooled sums, the (B, 3) linear candidate colours and the (3, H/4, W/4)
    4x4 means of the no-candidate frame. A candidate that wins no pixel
    gets ds4(L) itself, bit for bit."""
    return (
        cand_lin[:, :, None, None] * pooled[:, :1] - pooled[:, 1:4]
    ) / 16.0 + ds4_l[None]


def _pooled_geometry(name, n, b, h, w, ptrs):
    if h % 4 or w % 4 or h < 4 or w < 4:
        raise ValueError(f"kernel {name} pools 4x4 cells; {h}x{w} has no "
                         "whole number of them")
    if not 0 < n * b <= 65535:
        raise ValueError(f"kernel {name} takes 1 to 65535 (image, candidate) "
                         f"pairs, not {n}x{b}")
    if any(p % 16 for p in ptrs):
        raise ValueError(f"kernel {name} reads its planes as 16-byte vectors")


def _batched(fn, first, *rest):
    """fn over operands with a leading image axis, adding one (and taking
    it off the results) where `first` has none."""
    if first.dim() == 4:
        return fn(first, *rest)
    out = fn(first[None], *(a[None] for a in rest))
    return tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]


def _pooled_wins_redmean_plain(tg, cand8, bva, ml):
    return torch.stack([
        pooled_sums(redmean_wins(tg[n], cand8[n], bva[n]), ml[n])
        for n in range(tg.shape[0])
    ])


def _pooled_wins_redmean_cuda(tg, cand8, bva, ml):
    dev = tg.device
    n, b = cand8.shape[:2]
    h, w = bva.shape[-2:]
    ptrs = [
        _kernels.require(tg, "tg", torch.int32, (n, 3, h, w), dev),
        _kernels.require(cand8, "cand8", torch.int32, (n, b, 3), dev),
        _kernels.require(bva, "bva", torch.int32, (n, h, w), dev),
        _kernels.require(ml, "ml", torch.float32, (n, 3, h, w), dev),
    ]
    _pooled_geometry("E", n, b, h, w, (ptrs[0], ptrs[2], ptrs[3]))
    out = torch.empty((n, b, 4, h // 4, w // 4), dtype=torch.float32,
                      device=dev)
    rc = _kernels.library().snes_pooled_wins_redmean(
        *ptrs, n, b, h, w, out.data_ptr(), _kernels.stream(dev))
    _kernels.check(rc, "pooled_wins_redmean")
    pooled_wins_redmean.launches += 1
    return out


def pooled_wins_redmean(tg, cand8, bva, ml) -> torch.Tensor:
    """Pooled win sums of a visit's candidates, red-mean distance.

    tg: (3, H, W) int32 target; cand8: (B, 3) int32 8-bit candidates; bva:
    (H, W) int32 win threshold (a candidate wins a pixel where its scaled
    red-mean distance is below it; the caller folds the tie rule and the
    candidate mask in); ml: (3, H, W) float32 masked no-candidate frame.
    H and W are multiples of 4.
    Returns (B, 4, H/4, W/4) float32: per 4x4 cell the sums of m, m*ML_r,
    m*ML_g, m*ML_b. With a leading image axis N on every operand the
    result is (N, B, 4, H/4, W/4).
    """
    fn = (_pooled_wins_redmean_cuda if tg.is_cuda
          else _pooled_wins_redmean_plain)
    return _batched(fn, tg, cand8, bva, ml)


pooled_wins_redmean.launches = 0


def _pooled_wins_ciede_plain(tlab, cand_lab, bvalm, adj, ml):
    pooled, dcand = [], []
    for n in range(tlab.shape[0]):
        wins, d = ciede_wins(tlab[n], cand_lab[n], bvalm[n], adj[n])
        pooled.append(pooled_sums(wins, ml[n]))
        dcand.append(d)
    return torch.stack(pooled), torch.stack(dcand)


def _pooled_wins_ciede_cuda(tlab, cand_lab, bvalm, adj, ml):
    dev = tlab.device
    n, b = cand_lab.shape[:2]
    h, w = bvalm.shape[-2:]
    ptrs = [
        _kernels.require(tlab, "tlab", torch.float32, (n, 3, h, w), dev),
        _kernels.require(cand_lab, "cand_lab", torch.float32, (n, b, 3), dev),
        _kernels.require(bvalm, "bvalm", torch.float32, (n, h, w), dev),
        _kernels.require(adj, "adj", torch.int32, (n, h, w), dev),
        _kernels.require(ml, "ml", torch.float32, (n, 3, h, w), dev),
    ]
    _pooled_geometry("F", n, b, h, w, (ptrs[0], *ptrs[2:]))
    out = torch.empty((n, b, 4, h // 4, w // 4), dtype=torch.float32,
                      device=dev)
    dcand = torch.empty((n, b, h, w), dtype=torch.float32, device=dev)
    rc = _kernels.library().snes_pooled_wins_ciede(
        *ptrs, n, b, h, w, out.data_ptr(), dcand.data_ptr(),
        _kernels.stream(dev))
    _kernels.check(rc, "pooled_wins_ciede")
    pooled_wins_ciede.launches += 1
    return out, dcand


def pooled_wins_ciede(tlab, cand_lab, bvalm, adj, ml):
    """Pooled win sums of a visit's candidates, CIEDE2000 distance.

    tlab: (3, H, W) float32 target CIELAB planes; cand_lab: (B, 3) float32
    candidate CIELAB; bvalm: (H, W) float32 best distance without the
    candidate's slot, -3e38 where the candidate may not win; adj: (H, W)
    int32, non-zero where the candidate wins ties; ml as for
    `pooled_wins_redmean`. A candidate wins a pixel where d < bvalm, or
    d == bvalm and adj != 0, with d = ciede2000(target Lab, candidate Lab),
    the standard formula of ops/color.py.
    Returns ((B, 4, H/4, W/4) float32 pooled sums, (B, H, W) float32
    distances); with a leading image axis N on every operand, both gain it.
    """
    fn = _pooled_wins_ciede_cuda if tlab.is_cuda else _pooled_wins_ciede_plain
    return _batched(fn, tlab, cand_lab, bvalm, adj, ml)


pooled_wins_ciede.launches = 0
