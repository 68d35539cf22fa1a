"""The work split of kernel B (csrc/multiscale.cu), replayed in torch on the
CPU and held against the plain twin and the JAX package, so that an
indexing error shows before the card runs the kernel.

One launch a call. The wrapper's launch description
(`cuda_metric._multiscale_call`) puts one resident cluster a frame first,
if the call has scales of 64x64 or fewer pixels, then a tile cluster for
each (frame, tiled scale, 32x32 tile), frame by frame; the kernel decodes a
cluster's index into (frame, scale, tile) with `tile_start`. Every pixel a
block loads is the nested 2x2 mean of the caller's frame, taken from the
frame in the loads (`level_at`: ds2_at's nesting and order, the clamped
last row or column of an odd side). A tile cluster's blocks split the
tile's 48x48 region between them (block r takes pixels r * 256 + t, then
every 256 * blocks), convert each pixel to XYB once and hand channel c to
block c, which blurs it and sums the tile's moments: thread t over pixels
t, t + 256, ... in turn, a shuffle tree in each warp, the 8 warps in order.
Each tile's sums land at the wrapper's offsets, and the last block of a
(frame, scale) adds them in tile order. The small scales run on the cluster
pass of kernels C and D, replayed by tests/test_torch_coarse_cluster.py's
`_cluster` on the frame's first small scale.

The replay agrees with `_multiscale_feature_sums_plain` at every case and
with the JAX package's kernel B (`pallas_metric.multiscale_feature_sums`,
interpreted) where every scale halves exactly (the Pallas kernel takes no
other pyramid), within chip_smoke.py's FEATURE_TOL (2e-4, absolute plus
relative) on finalised features. The replay rounds each
product and sum on its own where the kernel fuses multiply-adds, so it is
held to the tolerance, not to the bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_coarse_cluster import (
    RADIUS,
    TAPS,
    THREADS,
    _cluster,
    _ds2,
    _moments,
    _shuffle_tree,
)

from snesimage_torch.ops import cuda_metric
from snesimage_torch.ops.ssimulacra2 import (
    finalize_feature_sums,
    linear_rgb_to_positive_xyb,
    pyramid_size,
    reference_pyramid,
)
from snesimage_tpu.ops import pallas_metric as pm
from snesimage_tpu.ops import ssimulacra2 as jss

FEATURE_TOL = 2e-4  # chip_smoke.py FEATURE_TOL
TILE = 32  # kTile
REGION = TILE + 2 * RADIUS  # kRegion
TILE_CHANNELS = 3  # kTileChannels
CLUSTER_BLOCKS = 4  # kClusterBlocks

# (label, reference rows, columns, first scale, scales, pre_ds, frames):
# the frame error at 256x256, the scale-1 rank (pre_ds 1), the dithered
# coarse stage (pre_ds 2), the 48 quarter frames of a 256x240 visit (cut to
# 3) and a pyramid odd from 15x16 on, a tile row cut short at 120 rows.
CASES = [
    ("256x256, six scales", 256, 256, 0, 6, 0, 1),
    ("256x256, pre_ds 1", 256, 256, 1, 1, 1, 2),
    ("256x256, pre_ds 2", 256, 256, 2, 4, 2, 2),
    ("60x64 quarter frames", 240, 256, 2, 4, 0, 3),
    ("120x128 to 4x4", 120, 128, 0, 6, 0, 2),
]


def _level_at(src, levels, depth, y, x):
    """level_at<depth>: the nested 2x2 means of `src` (..., h0, w0) at the
    level-`depth` coordinates y (rows) and x (columns), gathered from the
    source at every depth."""
    if depth == 0:
        return src[..., y[:, None], x[None, :]]
    h, w = levels[depth - 1]
    y0, x0 = 2 * y, 2 * x
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    parts = [_level_at(src, levels, depth - 1, yy, xx)
             for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    return (((parts[0] + parts[1]) + parts[2]) + parts[3]) * 0.25


def _level(frames, call, depth):
    """The (B, 3, h, w) frame at pyramid level `depth`, fused from the
    source; it must equal 2x2 means taken plane by plane, bit for bit."""
    levels = [(call.lv.h[k], call.lv.w[k]) for k in range(depth + 1)]
    h, w = levels[depth]
    got = _level_at(frames, levels, depth, torch.arange(h), torch.arange(w))
    planes = frames
    for _ in range(depth):
        planes = _ds2(planes)
    assert torch.equal(got, planes)
    return got


def _region_split(n_blocks):
    """Which block converts each region pixel; each exactly once."""
    owner = torch.full((REGION * REGION,), -1)
    for r in range(n_blocks):
        for t in range(THREADS):
            for i in range(r * THREADS + t, REGION * REGION,
                           n_blocks * THREADS):
                assert owner[i] == -1
                owner[i] = r
    assert bool((owner >= 0).all())
    return owner


def _tile_sums(xyb, triple, h, w, tiles_x, n_tiles):
    """Each tile's (B, n_tiles, 3, 6) raw sums, blocks c = 0..2 on XYB
    channel c of the tile's zero-padded region."""
    b = xyb.shape[0]
    rows = -(-h // TILE) * TILE
    cols = tiles_x * TILE
    pad = (RADIUS, cols - w + RADIUS, RADIUS, rows - h + RADIUS)
    x2 = torch.nn.functional.pad(xyb, pad)
    x1 = torch.nn.functional.pad(triple[0], pad)
    mu1 = torch.nn.functional.pad(triple[1], pad)
    s11 = torch.nn.functional.pad(triple[2], pad)
    inside = torch.nn.functional.pad(torch.ones(h, w), pad) > 0
    out = torch.zeros(b, n_tiles, 3, 6)
    for t in range(n_tiles):
        y0, x0 = (t // tiles_x) * TILE, (t % tiles_x) * TILE
        reg = (slice(y0, y0 + REGION), slice(x0, x0 + REGION))
        sx2, sx1 = x2[..., reg[0], reg[1]], x1[:, reg[0], reg[1]]
        hb = [torch.zeros(b, 3, REGION, TILE) for _ in range(3)]
        for k in range(2 * RADIUS + 1):
            v2, v1 = sx2[..., k:k + TILE], sx1[:, :, k:k + TILE]
            hb[0] = hb[0] + TAPS[k] * v2
            hb[1] = hb[1] + TAPS[k] * (v2 * v2)
            hb[2] = hb[2] + TAPS[k] * (v1 * v2)
        vb = [torch.zeros(b, 3, TILE, TILE) for _ in range(3)]
        for k in range(2 * RADIUS + 1):
            for f in range(3):
                vb[f] = vb[f] + TAPS[k] * hb[f][..., k:k + TILE, :]
        core = (slice(y0 + RADIUS, y0 + RADIUS + TILE),
                slice(x0 + RADIUS, x0 + RADIUS + TILE))
        terms = _moments(x1[:, core[0], core[1]], mu1[:, core[0], core[1]],
                         s11[:, core[0], core[1]], x2[..., core[0], core[1]],
                         vb[0], vb[1], vb[2])  # (B, 3, 32, 32, 6)
        terms = torch.where(inside[core[0], core[1]][..., None], terms, 0.0)
        terms = terms.reshape(b, 3, TILE * TILE, 6)
        acc = torch.zeros(b, 3, THREADS, 6)
        for j in range(TILE * TILE // THREADS):  # pixels t, t + 256, ...
            acc = acc + terms[:, :, j * THREADS:(j + 1) * THREADS]
        warps = _shuffle_tree(acc.reshape(b, 3, THREADS // 32, 32, 6))
        total = torch.zeros(b, 3, 6)
        for wp in range(THREADS // 32):
            total = total + warps[:, :, wp]
        out[:, t] = total
    return out


def _replay(frames, triples, pre_ds, rng):
    """(B, n_scales, 3, 6) raw sums as kernel B's launch lays them out."""
    b = frames.shape[0]
    sizes = [tuple(t[0].shape[-2:]) for t in triples]
    call = cuda_metric._multiscale_call(frames, sizes, pre_ds)
    n, n_tiled = len(sizes), call.n_tiled
    assert n_tiled == sum(hs * ws > cuda_metric.RESIDENT_MAX_PIXELS
                          for hs, ws in sizes)
    blocks = CLUSTER_BLOCKS if call.n_resident_items else TILE_CHANNELS
    _region_split(blocks)
    out = torch.full((b, n, 3, 6), float("nan"))
    if call.n_resident_items:
        assert call.n_resident_items == b
        first = _level(frames, call, pre_ds + n_tiled)
        res = _cluster(first, triples[n_tiled:], rng)
        out[:, n_tiled:] = res.reshape(b, n - n_tiled, 3, 6)

    # The grid's tile clusters, decoded as the kernel does.
    seen = set()
    partial = torch.full((b * max(call.tiles_total, 1) * 18,), float("nan"))
    levels = {s: _level(frames, call, pre_ds + s) for s in range(n_tiled)}
    sums = {}
    for s in range(n_tiled):
        hs, ws = sizes[s]
        n_tiles = call.tile_start[s + 1] - call.tile_start[s]
        assert n_tiles == call.tiles_x[s] * -(-hs // TILE)
        xyb = linear_rgb_to_positive_xyb(
            levels[s].movedim(1, -1)).movedim(-1, 1)
        sums[s] = _tile_sums(xyb, triples[s], hs, ws, call.tiles_x[s],
                             n_tiles)
    for q in range(call.n_resident_items,
                   call.n_resident_items + b * call.tiles_total):
        j = q - call.n_resident_items
        m, r = j // call.tiles_total, j % call.tiles_total
        s = 0
        while r >= call.tile_start[s + 1]:
            s += 1
        t = r - call.tile_start[s]
        assert (m, s, t) not in seen
        seen.add((m, s, t))
        first = m * call.tiles_total + call.tile_start[s]
        for c in range(TILE_CHANNELS):
            at = (first + t) * 18 + c * 6
            partial[at:at + 6] = sums[s][m, t, c]
    assert len(seen) == b * call.tiles_total
    for m in range(b):  # the last block of each (frame, scale)
        for s in range(n_tiled):
            first = m * call.tiles_total + call.tile_start[s]
            n_tiles = call.tile_start[s + 1] - call.tile_start[s]
            total = torch.zeros(18)
            for j in range(n_tiles):
                total = total + partial[(first + j) * 18:(first + j + 1) * 18]
            out[m, s] = total.reshape(3, 6)
    assert not bool(out.isnan().any())
    return out


def _jax_features(refs, frames, start, n, pre_ds):
    """The JAX package's kernel B (interpreted) on the same call, finalised;
    None where a scale does not halve exactly, which it does not take."""
    sizes = [tuple(t[0].shape[-2:]) for t in refs]
    if any(hs % 2 or ws % 2 for hs, ws in sizes[:-1]):
        return None
    raw = pm.multiscale_feature_sums(
        tuple(tuple(jnp.asarray(a.numpy()) for a in t) for t in refs),
        jnp.asarray(frames), pre_ds=pre_ds, interpret=True)
    return torch.from_numpy(np.array(jss.finalize_feature_sums(
        raw.reshape(len(frames), -1, 6), [h * w for h, w in sizes], start)))


@pytest.mark.parametrize("label,h,w,start,n,pre_ds,b", CASES,
                         ids=[c[0] for c in CASES])
def test_split_matches_the_twin_and_jax(label, h, w, start, n, pre_ds, b):
    rng = np.random.default_rng(h * w + 10 * start + pre_ds)
    ref = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.int32))
    refp = reference_pyramid(ref)
    fh, fw = pyramid_size(h, w, start - pre_ds)
    frames = rng.random((b, 3, fh, fw), dtype=np.float32) ** 2.2
    triples = tuple(tuple(a.permute(2, 0, 1).contiguous()
                          for a in refp[start + s]) for s in range(n))
    sizes = [t[0].shape[-2] * t[0].shape[-1] for t in triples]
    got = _replay(torch.from_numpy(frames), triples, pre_ds, rng)
    got = finalize_feature_sums(got.reshape(b, -1, 6), sizes, start)
    twin = cuda_metric._multiscale_feature_sums_plain(
        triples, torch.from_numpy(frames), pre_ds)
    wants = [finalize_feature_sums(twin.reshape(b, -1, 6), sizes, start),
             _jax_features(triples, frames, start, n, pre_ds)]
    assert (wants[1] is None) == (label in ("60x64 quarter frames",
                                            "120x128 to 4x4"))
    for want in wants:
        if want is not None:
            diff = (got - want).abs()
            assert bool((diff <= FEATURE_TOL
                         + FEATURE_TOL * want.abs()).all()), float(diff.max())


def _level_walk(src, levels, depth, y, x):
    """level_at_deep: the 4^depth source pixels of (y, x) in order, leaf k's
    child at level l - 1 from its base-4 digit l, a running sum per level,
    each finished 2x2 sum times 0.25 passed up."""
    acc = [None] * (depth + 1)
    v = None
    for k in range(1 << (2 * depth)):
        yy, xx = y, x
        for lv in range(depth, 0, -1):
            d = (k >> (2 * (lv - 1))) & 3
            yy = (2 * yy + (d >> 1)).clamp(max=levels[lv - 1][0] - 1)
            xx = (2 * xx + (d & 1)).clamp(max=levels[lv - 1][1] - 1)
        v = src[..., yy[:, None], xx[None, :]]
        for lv in range(1, depth + 1):
            d = (k >> (2 * (lv - 1))) & 3
            acc[lv] = acc[lv] + v if d else v
            if d != 3:
                break
            v = acc[lv] * 0.25
    return v


@pytest.mark.parametrize("h,w,depth", [(72, 44, 3), (40, 56, 4),
                                       (64, 64, 3)])
def test_deep_levels_walk_the_nested_means(h, w, depth):
    """Levels deeper than the unrolled ones equal the nested 2x2 means,
    odd sides included, bit for bit."""
    rng = np.random.default_rng(h + w + depth)
    src = torch.from_numpy(rng.random((3, h, w), dtype=np.float32))
    levels = [pyramid_size(h, w, k) for k in range(depth + 1)]
    hs, ws = levels[depth]
    got = _level_walk(src, levels, depth, torch.arange(hs), torch.arange(ws))
    assert torch.equal(got, _level_at(src, levels, depth, torch.arange(hs),
                                      torch.arange(ws)))


@pytest.mark.parametrize("h,w,pre_ds,n,b", [
    (256, 256, 0, 6, 1), (256, 256, 0, 6, 15), (256, 256, 0, 6, 64),
    (240, 256, 0, 6, 56), (256, 256, 1, 1, 8), (256, 256, 2, 4, 48),
    (512, 512, 0, 6, 2)])
def test_launches_cover_every_tile_and_frame(h, w, pre_ds, n, b):
    """The call's launches, decoded as the kernel decodes its grid: every
    (frame, tiled scale, tile) once and every frame's small scales once,
    in one launch, or in two (tiles, then resident frames) from
    SPLIT_FRAMES frames on where the call has both."""
    sizes = [pyramid_size(h, w, pre_ds + s) for s in range(n)]
    call = cuda_metric._multiscale_call(
        torch.zeros(b, 3, h, w), sizes, pre_ds)
    launches = cuda_metric._launches(call)
    both = call.tiles_total > 0 and call.n_resident_items > 0
    assert len(launches) == (2 if both and b >= cuda_metric.SPLIT_FRAMES
                             else 1)
    tiles, frames = [], []
    for c in launches:
        for q in range(c.n_resident_items + b * c.tiles_total):
            if q < c.n_resident_items:
                frames.append(q)
                continue
            j = q - c.n_resident_items
            m, r = j // c.tiles_total, j % c.tiles_total
            s = 0
            while r >= c.tile_start[s + 1]:
                s += 1
            tiles.append((m, s, r - c.tile_start[s]))
    want = [(m, s, t) for m in range(b) for s in range(call.n_tiled)
            for t in range(call.tiles_x[s] * -(-sizes[s][0] // TILE))]
    assert sorted(tiles) == want
    assert sorted(frames) == (list(range(b)) if call.n_tiled < n else [])
