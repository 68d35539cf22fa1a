"""The work split of kernels C and D (csrc/coarse_cluster.cuh), replayed in
torch on the CPU and held against the plain twins, so that an indexing
error shows before the card runs the kernel.

A candidate's cluster of four blocks pools its 4x4 cells one warp of 32
cells at a time, in whatever order the blocks take the chunks, and hands
each cell's quarter-frame value over: XYB channel c to block c, the linear
value to block 3. Block c runs the first scale (pyramid scale 2) of channel
c; block 3 takes the 2x2 means (ds2_at's order) twice, runs scale 3 of
the three channels at a time and hands scale 4's frame to blocks 0-2,
which then run scales 4 and 5 of their channel. A scale is the horizontal
blur in tiles of kHTile outputs from kSpan zero-padded inputs, items
running over (channel, row, tile); the vertical blur of each field in
columns of kVTile outputs from kVSpan zero-padded inputs, into the spare
plane and then over the spent fields; and the moments summed by 512
virtual threads (two a thread of a 256-thread block), a shuffle tree per
warp and the 16 warps in turn.

The replay agrees with `_multiscale_feature_sums_plain`, `_coarse_plain`
and `_coarse_ciede_plain` within chip_smoke.py's FEATURE_TOL (2e-4,
absolute plus relative) on finalised features at quarter frames of 64x64,
56x64 (256x224), 16x16 and 8x8 (32x32 images); the largest difference
seen was 2.1e-5 (256x224, kernel D). The replay rounds each product and
sum on its own where the kernel fuses multiply-adds, so it is held to the
tolerance, not to the bits."""

import numpy as np
import pytest
import torch

from snesimage_torch.ops import cuda_metric
from snesimage_torch.ops.color import srgb_u8_to_lab, srgb_u8_to_linear
from snesimage_torch.ops.cuda_prescreen import (
    ciede_wins,
    coarse_frames,
    pooled_sums,
)
from snesimage_torch.ops.ssimulacra2 import (
    blur_taps,
    finalize_feature_sums,
    linear_rgb_to_positive_xyb,
    reference_pyramid,
)
from snesimage_torch.ops.ssimulacra2_consts import SSIM_C2

FEATURE_TOL = 2e-4  # chip_smoke.py FEATURE_TOL
RADIUS = 8  # kRadius
THREADS = 256  # kClusterThreads
VIRTUAL = 512  # kResidentThreads: the summation order kept
H_TILE = 4  # kHTile
SPAN = H_TILE + 2 * RADIUS  # kSpan
V_TILE = 16  # kVTile
V_SPAN = V_TILE + 2 * RADIUS  # kVSpan
TAPS = torch.from_numpy(blur_taps())
# (image height, width): quarter frames 64x64, 56x64, 16x16 and 8x8.
SIZES = [(256, 256), (224, 256), (64, 64), (32, 32)]


def _pool_schedule(frames, rng):
    """The pooling hand-off: chunks of 32 cells, taken in a random order,
    each cell's XYB channel c stored into block c's plane and its linear
    value into block 3's frame. Every cell must arrive exactly once.
    Returns ([(B, h, w) XYB plane of block c], (B, 3, h, w) frame)."""
    b, _, hq, wq = frames.shape
    n_q = hq * wq
    lin = frames.reshape(b, 3, n_q)
    xyb = linear_rgb_to_positive_xyb(lin.movedim(1, -1)).movedim(-1, 1)
    planes = torch.full((3, b, n_q), float("nan"))
    frame = torch.full((b, 3, n_q), float("nan"))
    seen = torch.zeros(n_q, dtype=torch.int64)
    for chunk in rng.permutation(-(-n_q // 32)):
        cells = torch.arange(chunk * 32, min(chunk * 32 + 32, n_q))
        for r in range(3):
            planes[r][:, cells] = xyb[:, r, cells]
        frame[..., cells] = lin[..., cells]
        seen[cells] += 1
    assert bool((seen == 1).all())
    return ([p.reshape(b, hq, wq) for p in planes],
            frame.reshape(b, 3, hq, wq))


def _ds2(cur):
    """ds2_at: the 2x2 mean, an odd side's last row or column doubled,
    added (y0, x0), (y0, x1), (y1, x0), (y1, x1)."""
    h, w = cur.shape[-2:]
    y0 = torch.arange((h + 1) // 2) * 2
    x0 = torch.arange((w + 1) // 2) * 2
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)

    def at(y, x):
        return cur[..., y[:, None], x[None, :]]

    return (((at(y0, x0) + at(y0, x1)) + at(y1, x0)) + at(y1, x1)) * 0.25


def _horizontal(x2, x1):
    """The tiled horizontal pass over kCh channels, x2 (B, kCh, h, w) and
    x1 (kCh, h, w): item -> (channel, row y, first output x0), kSpan inputs
    from x0 - kRadius, zero outside the row, kHTile outputs. Returns the
    (B, kCh, 3, h * w) blurred fields."""
    b, n_ch, h, w = x2.shape
    segs = -(-w // H_TILE)
    items = torch.arange(n_ch * h * segs)
    ch = items // (h * segs)
    rest = items - ch * h * segs
    y = rest // segs
    x0 = (rest - y * segs) * H_TILE
    xx = x0[:, None] - RADIUS + torch.arange(SPAN)[None, :]
    inside = (xx >= 0) & (xx < w)
    idx = (ch * h * w + y * w)[:, None] + xx.clamp(0, w - 1)
    v2 = torch.where(inside, x2.reshape(b, -1)[:, idx], 0.0)
    v1 = torch.where(inside, x1.reshape(-1)[idx], 0.0)
    hb = torch.full((b, n_ch, 3, h * w), float("nan"))
    for o in range(H_TILE):
        a = torch.zeros(b, len(items))
        bb, cc = torch.zeros_like(a), torch.zeros_like(a)
        for k in range(2 * RADIUS + 1):
            u2 = v2[..., o + k]
            a = a + TAPS[k] * u2
            bb = bb + TAPS[k] * (u2 * u2)
            cc = cc + TAPS[k] * (v1[..., o + k] * u2)
        keep = x0 + o < w
        dst = (y * w + x0 + o)[keep]
        for f, val in enumerate((a, bb, cc)):
            hb[:, ch[keep], f, dst] = val[:, keep]
    assert not bool(hb.isnan().any()), "a blurred value was never written"
    return hb


def _moments(x1, m1, v1, x2, mu2, s22, s12):
    mu_diff = m1 - mu2
    num_m = 1.0 - mu_diff * mu_diff
    num_s = 2.0 * (s12 - m1 * mu2) + SSIM_C2
    denom_s = (v1 - m1 * m1) + (s22 - mu2 * mu2) + SSIM_C2
    ssim_d = torch.clamp(1.0 - (num_m * num_s) / denom_s, min=0.0)
    d1 = (1.0 + (x2 - mu2).abs()) / (1.0 + (x1 - m1).abs()) - 1.0
    maps = [ssim_d, d1.clamp(min=0.0), (-d1).clamp(min=0.0)]
    return torch.stack(maps + [(m * m) * (m * m) for m in maps], dim=-1)


def _shuffle_tree(v):
    """__shfl_down_sync over a warp's 32 lanes, offsets 16 .. 1; lane 0's
    value. A lane whose source is past the warp adds its own value."""
    for off in (16, 8, 4, 2, 1):
        src = torch.cat([v[..., off:, :], v[..., 32 - off:, :]], dim=-2)
        v = v + src
    return v[..., 0, :]


def _vertical(hb, h, w):
    """The vertical pass, field by field: item -> (channel, segment of
    kVTile rows, column x), kVSpan inputs from y0 - kRadius, zero outside
    the plane. Field 0's results land in the spare planes, field f's over
    field f - 1's blurred planes. Returns the (B, kCh, h * w) spare planes
    and hb, which then holds (mu2, s22) in fields 0 and 1."""
    b, n_ch = hb.shape[:2]
    hb = hb.clone()
    spare = torch.full((b, n_ch, h * w), float("nan"))
    vsegs = -(-h // V_TILE)
    items = torch.arange(n_ch * vsegs * w)
    ch = items // (vsegs * w)
    rest = items - ch * vsegs * w
    seg = rest // w
    x = rest - seg * w
    y0 = seg * V_TILE
    yy = y0[:, None] - RADIUS + torch.arange(V_SPAN)[None, :]
    inside = (yy >= 0) & (yy < h)
    src = yy.clamp(0, h - 1) * w + x[:, None]
    for f in range(3):
        col = torch.where(inside, hb[:, ch[:, None], f, src], 0.0)
        for r in range(V_TILE):
            v = torch.zeros(b, len(items))
            for k in range(2 * RADIUS + 1):
                v = v + TAPS[k] * col[..., r + k]
            keep = y0 + r < h
            dst = ((y0 + r) * w + x)[keep]
            if f:
                hb[:, ch[keep], f - 1, dst] = v[:, keep]
            else:
                spare[:, ch[keep], dst] = v[:, keep]
    assert not bool(spare.isnan().any()), "a vertical blur was never written"
    return spare, hb


def _vertical_and_sums(hb, x2, x1, m1, v1):
    """The vertical pass, then the moments of pixel i by virtual thread
    i mod 512 (thread i mod 256, set (i mod 512) // 256), each summing its
    pixels in turn, for every channel; then the warp trees and the 16
    virtual warps in order. hb (B, kCh, 3, h * w); x2 (B, kCh, h, w);
    x1, m1, v1 (kCh, h, w). Returns (B, kCh, 6) raw sums."""
    b, n_ch, h, w = x2.shape
    n_px = h * w
    spare, hb = _vertical(hb, h, w)
    tid = torch.arange(THREADS)
    acc = torch.zeros(VIRTUAL // THREADS, b, n_ch, THREADS, 6)
    for base in range(0, n_px, VIRTUAL):
        for j in range(VIRTUAL // THREADS):
            i = base + j * THREADS + tid
            live = i < n_px
            ii = i.clamp(max=n_px - 1)
            terms = _moments(x1.reshape(n_ch, -1)[:, ii],
                             m1.reshape(n_ch, -1)[:, ii],
                             v1.reshape(n_ch, -1)[:, ii],
                             x2.reshape(b, n_ch, -1)[..., ii],
                             spare[..., ii], hb[:, :, 0, ii], hb[:, :, 1, ii])
            acc[j] = acc[j] + torch.where(live[:, None], terms, 0.0)
    warps = [_shuffle_tree(acc[j].reshape(b, n_ch, THREADS // 32, 32, 6))
             for j in range(VIRTUAL // THREADS)]
    red = torch.cat(warps, dim=2)  # (b, kCh, 16, 6): warp j * 8 + w
    total = torch.zeros(b, n_ch, 6)
    for vw in range(VIRTUAL // 32):
        total = total + red[:, :, vw]
    return total


def _scale(x2, triple, c0):
    """One scale of channels c0 .. c0 + kCh - 1: (B, kCh, 6) raw sums."""
    n_ch = x2.shape[1]
    img1, mu1, s11 = (a[c0:c0 + n_ch] for a in triple)
    return _vertical_and_sums(_horizontal(x2, img1), x2, img1, mu1, s11)


def _cluster(frames, triples, rng):
    """(B, 3 * n_scales, 6) raw sums, as kernels C and D lay them out:
    block 3 takes the 2x2 means twice, runs scale 3 of every channel and
    hands scale 4's frame to blocks 0-2, which run scale 2 and then scales
    4 and 5 of their channel."""
    planes, frame = _pool_schedule(frames, rng)
    lin1 = _ds2(frame)  # block 3
    lin2 = _ds2(lin1)  # block 3, stored into blocks 0-2
    x2 = linear_rgb_to_positive_xyb(lin1.movedim(1, -1)).movedim(-1, 1)
    third = _scale(x2, triples[1], 0)
    blocks = []
    for c in range(3):  # blocks 0-2
        sums, lin = [_scale(planes[c][:, None], triples[0], c)], lin2
        for triple in triples[2:]:
            xyb = linear_rgb_to_positive_xyb(lin.movedim(1, -1))
            sums.append(_scale(xyb[..., c][:, None], triple, c))
            lin = _ds2(lin)
        blocks.append(torch.stack(sums, dim=1))  # (B, n_scales - 1, 1, 6)
    ours = torch.cat(blocks, dim=2)  # (B, n_scales - 1, 3, 6)
    scales = [ours[:, 0], third] + [ours[:, s]
                                    for s in range(1, len(triples) - 1)]
    return torch.stack(scales, dim=1).reshape(frames.shape[0], -1, 6)


def _refs(h, w, rng):
    ref = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.int32))
    refp = reference_pyramid(ref)
    return tuple(a.permute(2, 0, 1).contiguous()
                 for s in range(2, 6) for a in refp[s])


def _close(got, want, n_px):
    """Finalised features within FEATURE_TOL; returns the largest
    difference."""
    sizes = list(n_px)
    g = finalize_feature_sums(got, sizes, 2)
    w = finalize_feature_sums(want, sizes, 2)
    diff = (g - w).abs()
    assert bool((diff <= FEATURE_TOL + FEATURE_TOL * w.abs()).all()), (
        float(diff.max()))
    return float(diff.max())


def _sizes(h, w):
    return [(h >> s) * (w >> s) for s in range(2, 6)]


@pytest.mark.parametrize("h,w", SIZES)
def test_channel_split_matches_the_metric_twin(h, w):
    """Random linear quarter frames through the channel blocks against
    kernel B's twin on the same frames and reference planes."""
    rng = np.random.default_rng(h + w)
    flat = _refs(h, w, rng)
    triples = cuda_metric._triples(flat)
    frames = torch.from_numpy(
        rng.random((3, 3, h // 4, w // 4), dtype=np.float32)) ** 2.2
    got = _cluster(frames, triples, rng)
    want = cuda_metric._multiscale_feature_sums_plain(triples, frames)
    _close(got, want.reshape(3, -1, 6), _sizes(h, w))


def _redmean_args(h, w, b, rng):
    def ints(hi, shape):
        return torch.from_numpy(rng.integers(0, hi, shape, dtype=np.int32))

    tg, cand8 = ints(256, (3, h, w)), ints(256, (b, 3))
    cand8[-1] = cand8[0]
    bva = ints(150_000_000, (h, w))
    bva[:8] = torch.iinfo(torch.int32).min
    lnc = torch.from_numpy(rng.random((3, h, w), dtype=np.float32))
    ml = torch.where(bva[None] > 0, lnc, 0.0)
    ds4 = lnc.reshape(3, h // 4, 4, w // 4, 4).mean(dim=(2, 4)).contiguous()
    return (tg, cand8, srgb_u8_to_linear(cand8), bva, ml, ds4,
            _refs(h, w, rng))


@pytest.mark.parametrize("h,w", SIZES)
def test_cluster_matches_kernel_c_twin(h, w):
    """Kernel C's whole split: pooled frames through the hand-off and the
    channel blocks, against `_coarse_plain`; duplicate candidates give
    equal rows."""
    rng = np.random.default_rng(7 * h + w)
    args = _redmean_args(h, w, 3, rng)
    frames = cuda_metric._coarse_frames_plain(*args[:-1])
    got = _cluster(frames, cuda_metric._triples(args[-1]), rng)
    _close(got, cuda_metric._coarse_plain(*args), _sizes(h, w))
    assert torch.equal(got[-1], got[0])


@pytest.mark.parametrize("h,w", SIZES)
def test_cluster_matches_kernel_d_twin(h, w):
    """Kernel D's split on CIEDE2000 win masks, against
    `_coarse_ciede_plain`."""
    rng = np.random.default_rng(h * w)
    tg, cand8, cand_lin, bva, ml, ds4, flat = _redmean_args(h, w, 3, rng)
    tlab = srgb_u8_to_lab(tg.permute(1, 2, 0)).permute(2, 0, 1).contiguous()
    cand_lab = srgb_u8_to_lab(cand8)
    bvalm = torch.from_numpy(rng.random((h, w), dtype=np.float32)) * 60.0
    bvalm[:8] = -3.0e38
    adj = torch.from_numpy(rng.integers(0, 2, (h, w), dtype=np.int32))
    args = (tlab, cand_lab, cand_lin, bvalm, adj, ml, ds4, flat)
    wins, _ = ciede_wins(tlab, cand_lab, bvalm, adj)
    frames = coarse_frames(pooled_sums(wins, ml), cand_lin, ds4)
    got = _cluster(frames, cuda_metric._triples(flat), rng)
    want, _ = cuda_metric._coarse_ciede_plain(*args)
    _close(got, want, _sizes(h, w))
