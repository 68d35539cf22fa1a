"""Kernels A to G against their plain twins on a CUDA card, at shapes
beyond the main paths' (which chip_smoke.py covers). Marked `cuda`: they
skip where no card is present. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

A is exact in all three entries (key/table, the visit prologue and the
render of palette maps); B, C and D agree within 2e-4 on finalised
features; D's distance planes equal kernel F's and the twin's. C and D
give the same bits in two calls. In their three-level mode (pre_ds=1,
emit_frames) C's and D's quarter frames agree with the twins' within
1e-6.
E's and F's mask counts equal their twins', their m*ML sums agree within
1e-5 (16 floats added in another order) and F's distance planes within
1e-4; restricted to the tiles of one subpalette (none, all, or a ragged
set of them), F's planes equal the twin's bit for bit. B runs at pyramids with odd scales (240x256, 40x24, 60x60), in one
kernel launch a call. B's, C's and D's sums equal, bit for bit, the ones
kept in tests/data/kernel_sums_frozen.npz (written by
`python tests/test_torch_cuda.py --freeze PATH`, run against the kernels
they were taken from). G's
maps equal its twin's at the dithered paths' geometries (256x256,
256x240), a narrow one and one whose row slots take several rows each, in
both distance modes, and every variant built (lanes per row slot, blocks
per candidate) gives the same maps; on random images in perceptual mode
the older cases ask for 0.99 of the pixels (the card's double pow and
trigonometry could land across a float32 rounding boundary from the
twin's, and error diffusion spreads one flipped pixel)."""

import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from snesimage_torch.ops import cuda_dither, cuda_metric, cuda_prescreen
from snesimage_torch.ops.color import srgb_u8_to_lab, srgb_u8_to_linear
from snesimage_torch.ops.dither import dither_candidates
from snesimage_torch.ops.ssimulacra2 import (
    finalize_feature_sums,
    pyramid_size,
    reference_pyramid,
)

pytestmark = pytest.mark.cuda
TOL = 2e-4
DISTANCE_TOL = 1e-4
FROZEN = Path(__file__).with_name("data") / "kernel_sums_frozen.npz"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    diff = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((diff <= tol + tol * want.abs()).all()), float(diff.max())


@lru_cache(maxsize=None)
def _frozen() -> dict:
    with np.load(FROZEN) as data:
        return {k: torch.from_numpy(data[k]) for k in data.files}


def _key(kernel: str, *params) -> str:
    return "_".join([kernel, *(str(p) for p in params)])


def _assert_frozen(key: str, got) -> None:
    """`got` equals the sums kept under `key`, bit for bit."""
    want = _frozen()[key]
    assert got.shape == want.shape and torch.equal(got.cpu(), want), key


def _one_launch(refs, frames, pre_ds):
    """Kernel B under torch.profiler: the call must run kernel B's kernel
    once on the card and nothing else (twice where a call of many frames
    has tiled and resident scales). Returns its output."""
    from torch.profiler import ProfilerActivity, profile

    want = len(cuda_metric.multiscale_launches(refs, frames, pre_ds))
    assert want == 1 or len(frames) >= cuda_metric.SPLIT_FRAMES
    for _ in range(3):  # a profiler session now and then records no event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = cuda_metric.multiscale_feature_sums(refs, frames,
                                                      pre_ds=pre_ds)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == want, kernels
    assert all("multiscale_kernel" in k for k in kernels), kernels
    return out


@pytest.mark.parametrize("h,w,k", [(256, 256, 120), (64, 96, 7), (8, 8, 240)])
def test_select_colors(dev, h, w, k):
    g = torch.Generator(device=dev).manual_seed(h + k)
    key = torch.randint(0, k + 1, (h, w), generator=g, device=dev,
                        dtype=torch.int32)
    table = torch.rand((3, k), generator=g, device=dev)
    before = cuda_prescreen.select_colors.launches
    got = cuda_prescreen.select_colors(key, table)
    assert cuda_prescreen.select_colors.launches == before + 1
    assert torch.equal(got, cuda_prescreen._select_colors_plain(key, table))


def _pyramid(dev, size, seed, width=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    ref = torch.randint(0, 256, (size, width or size, 3), generator=g,
                        device=dev, dtype=torch.int32)
    return reference_pyramid(ref), g


# The last two take their small scales three and four 2x2 means deep,
# past the depths kernel B unrolls into its loads.
B_SHAPES = [(256, 0, 6, 0, 1), (256, 1, 1, 1, 8), (256, 0, 1, 0, 2),
            (256, 0, 2, 0, 3), (128, 1, 3, 1, 5), (64, 0, 6, 0, 4),
            (256, 2, 4, 0, 48), (512, 0, 6, 0, 2), (512, 4, 2, 4, 3)]


def _b_inputs(dev, size, start, n, pre_ds, b):
    refp, g = _pyramid(dev, size, 7 * size + n)
    edge = size >> (start - pre_ds)
    frames = torch.rand((b, 3, edge, edge), generator=g, device=dev) ** 2.2
    refs = tuple(tuple(a.permute(2, 0, 1) for a in refp[start + s])
                 for s in range(n))
    return refs, frames


@pytest.mark.parametrize("size,start,n,pre_ds,b", B_SHAPES)
def test_multiscale_feature_sums(dev, size, start, n, pre_ds, b):
    refs, frames = _b_inputs(dev, size, start, n, pre_ds, b)
    sizes = [(size >> (start + s)) ** 2 for s in range(n)]
    before = cuda_metric.multiscale_feature_sums.launches
    got = cuda_metric.multiscale_feature_sums(refs, frames, pre_ds=pre_ds)
    assert cuda_metric.multiscale_feature_sums.launches == before + 1
    want = cuda_metric._multiscale_feature_sums_plain(refs, frames, pre_ds)
    _close(finalize_feature_sums(got.reshape(b, -1, 6), sizes, start),
           finalize_feature_sums(want.reshape(b, -1, 6), sizes, start))
    _assert_frozen(_key("B", size, start, n, pre_ds, b), got)
    again = _one_launch(refs, frames, pre_ds)
    assert torch.equal(got, again)  # no float atomics: the same bits


# Kernels C and D at the fused geometries (256x256, 256x224, 128x128,
# 64x64, 32x32), with lone candidates, grids short of a full wave of
# clusters and more candidates than a visit has.
COARSE_SHAPES = [(256, 256, 48), (64, 64, 5), (128, 128, 9), (256, 256, 1),
                 (256, 256, 2), (256, 256, 9), (256, 256, 64),
                 (224, 256, 9), (224, 256, 48), (64, 64, 48), (32, 32, 1),
                 (32, 32, 64)]


def _coarse_redmean_args(dev, h, w, b, seed=None):
    refp, g = _pyramid(dev, h, h + w + b if seed is None else seed, width=w)
    tg = torch.randint(0, 256, (3, h, w), generator=g, device=dev,
                       dtype=torch.int32)
    cand8 = torch.randint(0, 256, (b, 3), generator=g, device=dev,
                          dtype=torch.int32)
    cand8[-1] = cand8[0]
    cand_lin = (cand8 / 255.0) ** 2.2
    bva = torch.randint(0, 150_000_000, (h, w), generator=g, device=dev,
                        dtype=torch.int32)
    bva[:8] = torch.iinfo(torch.int32).min
    bva[8:12] = torch.iinfo(torch.int32).max
    lnc = torch.rand((3, h, w), generator=g, device=dev)
    ml = torch.where(bva[None] > 0, lnc, 0.0)
    ds4 = lnc.reshape(3, h // 4, 4, w // 4, 4).mean(dim=(2, 4))
    flat = tuple(a.permute(2, 0, 1) for s in range(2, 6) for a in refp[s])
    return (tg, cand8, cand_lin.float(), bva, ml, ds4.contiguous(), flat)


@pytest.mark.parametrize("h,w,b", COARSE_SHAPES)
def test_coarse_feature_sums_redmean(dev, h, w, b):
    args = _coarse_redmean_args(dev, h, w, b)
    sizes = [(h >> s) * (w >> s) for s in range(2, 6)]
    before = cuda_metric.coarse_feature_sums_redmean.launches
    got = cuda_metric.coarse_feature_sums_redmean(*args)
    assert cuda_metric.coarse_feature_sums_redmean.launches == before + 1
    want = cuda_metric._coarse_plain(*args)
    _close(finalize_feature_sums(got, sizes, 2),
           finalize_feature_sums(want, sizes, 2))
    assert torch.equal(got[-1], got[0])  # duplicate candidates: equal rows
    assert torch.equal(got, cuda_metric.coarse_feature_sums_redmean(*args))
    _assert_frozen(_key("C", h, w, b), got)


def _coarse_ciede_args(dev, h, w, b, seed):
    refp, g = _pyramid(dev, h, seed, width=w)
    rgb = torch.randint(0, 256, (h, w, 3), generator=g, device=dev,
                        dtype=torch.int32)
    cand8 = torch.randint(0, 256, (b, 3), generator=g, device=dev,
                          dtype=torch.int32)
    cand8[-1] = cand8[0]
    bvalm = torch.rand((h, w), generator=g, device=dev) * 60.0
    bvalm[:8] = -3.0e38  # masked rows
    # exact ties with the first candidate, won only where adj is set
    ties = slice(8, 12)
    adj = torch.randint(0, 2, (h, w), generator=g, device=dev,
                        dtype=torch.int32)
    tlab = srgb_u8_to_lab(rgb).permute(2, 0, 1).contiguous()
    cand_lab = srgb_u8_to_lab(cand8)
    lnc = torch.rand((3, h, w), generator=g, device=dev)
    args = [tlab, cand_lab, srgb_u8_to_linear(cand8), bvalm, adj,
            torch.where(bvalm[None] > 0, lnc, 0.0),
            lnc.reshape(3, h // 4, 4, w // 4, 4).mean(dim=(2, 4)).contiguous(),
            tuple(a.permute(2, 0, 1) for s in range(2, 6) for a in refp[s])]
    d0 = cuda_metric._coarse_ciede_plain(*args)[1][0]
    bvalm[ties] = d0[ties]
    return args


CIEDE_SHAPES = [(64, 96, 7), (128, 128, 48)] + COARSE_SHAPES[3:]


@pytest.mark.parametrize("h,w,b", CIEDE_SHAPES)
def test_coarse_feature_sums_ciede(dev, h, w, b):
    args = _coarse_ciede_args(dev, h, w, b, h + w + b)
    sizes = [(h >> s) * (w >> s) for s in range(2, 6)]
    before = cuda_metric.coarse_feature_sums_ciede.launches
    sums, dcand = cuda_metric.coarse_feature_sums_ciede(*args)
    assert cuda_metric.coarse_feature_sums_ciede.launches == before + 1
    want_sums, want_d = cuda_metric._coarse_ciede_plain(*args)
    assert dcand.shape == (b, h, w)
    # The distance planes: kernel F's (the same device code) and the twin's.
    f_planes = cuda_prescreen.pooled_wins_ciede(*args[:2], *args[3:6])[1]
    assert torch.equal(dcand, f_planes)
    _close(dcand, want_d, DISTANCE_TOL)
    assert torch.equal(dcand, want_d), float((dcand == want_d).float().mean())
    _close(finalize_feature_sums(sums, sizes, 2),
           finalize_feature_sums(want_sums, sizes, 2))
    assert torch.equal(sums[-1], sums[0])
    again = cuda_metric.coarse_feature_sums_ciede(*args)
    assert torch.equal(sums, again[0]) and torch.equal(dcand, again[1])
    _assert_frozen(_key("D", h, w, b), sums)


def test_coarse_feature_sums_ciede_rejects_uneven_frames(dev):
    args = _coarse_ciede_args(dev, 64, 64, 2, 3)
    crop = [args[0][:, :48, :48].contiguous(), args[1], args[2],
            args[3][:48, :48].contiguous(), args[4][:48, :48].contiguous(),
            args[5][:, :48, :48].contiguous(), args[6][:, :12, :12].contiguous(),
            args[7]]
    with pytest.raises(ValueError, match="pooled_wins_ciede"):
        cuda_metric.coarse_feature_sums_ciede(*crop)


# Kernels C and D in the three-level mode (pre_ds=1, emit_frames): the
# visit's shape, a lone candidate, the smallest fused geometry and a
# non-square one.
THREE_LEVEL_SHAPES = [(256, 256, 48), (256, 256, 1), (32, 32, 9),
                      (224, 256, 16), (128, 128, 64)]
FRAME_TOL = 1e-6


def _three_level(args):
    """`args` of a two-level call with the reference planes of scales
    3-5 in place of 2-5."""
    return (*args[:-1], args[-1][3:])


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("h,w,b", THREE_LEVEL_SHAPES)
def test_coarse_three_level(dev, perceptual, h, w, b):
    """The three-level mode against the twins: scales 3-5 within 2e-4 on
    finalised features, the quarter frames within 1e-6, D's distance
    planes equal to the two-level call's; the same bits in two calls, and
    at N = 2 images the bits of each image's own launch."""
    if perceptual:
        args = _coarse_ciede_args(dev, h, w, b, h + w + b)
        wrapper, twin = (cuda_metric.coarse_feature_sums_ciede,
                         cuda_metric._coarse_ciede_plain)
    else:
        args = _coarse_redmean_args(dev, h, w, b)
        wrapper, twin = (cuda_metric.coarse_feature_sums_redmean,
                         cuda_metric._coarse_plain)
    three = _three_level(args)
    mode = dict(pre_ds=1, emit_frames=True)
    before = (wrapper.launches, wrapper.frame_launches)
    got = wrapper(*three, **mode)
    assert (wrapper.launches, wrapper.frame_launches) == (before[0] + 1,
                                                          before[1] + 1)
    want = twin(*three, **mode)
    sizes = [(h >> s) * (w >> s) for s in range(3, 6)]
    _close(finalize_feature_sums(got[0], sizes, 3),
           finalize_feature_sums(want[0], sizes, 3))
    assert got[-1].shape == (b, 3, h // 4, w // 4)
    _close(got[-1], want[-1], FRAME_TOL)
    if perceptual:
        assert torch.equal(got[1], wrapper(*args)[1])
    assert torch.equal(got[0][-1], got[0][0])
    again = wrapper(*three, **mode)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    both = wrapper(*(a if isinstance(a, tuple) else torch.stack([a, a])
                     for a in three), **mode)
    assert all(torch.equal(x[n], y) for x, y in zip(both, got)
               for n in range(2))


def test_coarse_three_level_rejects_other_modes(dev):
    args = _coarse_redmean_args(dev, 64, 64, 2)
    with pytest.raises(ValueError, match="pre_ds"):
        cuda_metric.coarse_feature_sums_redmean(*args, pre_ds=1)
    with pytest.raises(ValueError, match="coarse scale 3"):
        cuda_metric.coarse_feature_sums_redmean(*args, pre_ds=1,
                                                emit_frames=True)


@pytest.mark.parametrize("batched", [False, True])
def test_select_colors_batched(dev, batched):
    """One table per key plane, as the dithered visit renders its maps."""
    g = torch.Generator(device=dev).manual_seed(5)
    n, h, w, k = 48, 64, 96, 120
    key = torch.randint(0, k + 1, (n, h, w), generator=g, device=dev,
                        dtype=torch.int32)
    table = torch.rand((n, 3, k), generator=g, device=dev)
    if not batched:
        key, table = key[0], table[0]
    got = cuda_prescreen.select_colors(key, table)
    assert got.shape == ((n, 3, h, w) if batched else (3, h, w))
    assert torch.equal(got, cuda_prescreen._select_colors_plain(key, table))


# 240x256 (rows x columns of a 256x240 image): the frame error, the coarse
# stage on E's frames, the scale-1 rank, the scale-0 finalists and the
# dithered coarse stage; then small pyramids odd from early on
ODD_SHAPES = [(240, 256, 0, 6, 0, 1), (240, 256, 2, 4, 0, 48),
              (240, 256, 1, 1, 1, 8), (240, 256, 0, 1, 0, 2),
              (240, 256, 2, 4, 2, 48), (40, 24, 0, 6, 0, 3),
              (60, 60, 0, 6, 0, 2), (120, 72, 1, 5, 1, 5),
              (256, 256, 0, 6, 0, 65)]


def _b_odd_inputs(dev, h, w, start, n, pre_ds, b):
    refp, g = _pyramid(dev, h, 3 * h + w + n, width=w)
    fh, fw = pyramid_size(h, w, start - pre_ds)
    frames = torch.rand((b, 3, fh, fw), generator=g, device=dev) ** 2.2
    refs = tuple(tuple(a.permute(2, 0, 1) for a in refp[start + s])
                 for s in range(n))
    return refp, refs, frames


@pytest.mark.parametrize("h,w,start,n,pre_ds,b", ODD_SHAPES)
def test_multiscale_feature_sums_odd_pyramids(dev, h, w, start, n, pre_ds, b):
    refp, refs, frames = _b_odd_inputs(dev, h, w, start, n, pre_ds, b)
    sizes = [refp[start + s][0].shape[0] * refp[start + s][0].shape[1]
             for s in range(n)]
    assert sizes == [hs * ws for hs, ws in
                     (pyramid_size(h, w, start + s) for s in range(n))]
    got = cuda_metric.multiscale_feature_sums(refs, frames, pre_ds=pre_ds)
    want = cuda_metric._multiscale_feature_sums_plain(refs, frames, pre_ds)
    _close(finalize_feature_sums(got.reshape(b, -1, 6), sizes, start),
           finalize_feature_sums(want.reshape(b, -1, 6), sizes, start))
    _assert_frozen(_key("Bodd", h, w, start, n, pre_ds, b), got)
    again = _one_launch(refs, frames, pre_ds)
    assert torch.equal(got, again)


def _pooled_args(dev, n, h, w, b, seed, perceptual):
    """Operands of kernel E or F for n images (no image axis when n is 0):
    masked rows, rows that every candidate wins, duplicate candidates and,
    for F, exact ties with the first candidate that only `adj` decides."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lead = (n,) if n else ()
    rgb = torch.randint(0, 256, lead + (h, w, 3), generator=g, device=dev,
                        dtype=torch.int32)
    cand8 = torch.randint(0, 256, lead + (b, 3), generator=g, device=dev,
                          dtype=torch.int32)
    cand8[..., -1, :] = cand8[..., 0, :]
    lnc = torch.rand(lead + (3, h, w), generator=g, device=dev)
    if not perceptual:
        bva = torch.randint(0, 150_000_000, lead + (h, w), generator=g,
                            device=dev, dtype=torch.int32)
        bva[..., :4, :] = torch.iinfo(torch.int32).min
        bva[..., 4:8, :] = torch.iinfo(torch.int32).max
        ml = torch.where(bva.unsqueeze(-3) > 0, lnc, 0.0)
        return [rgb.movedim(-1, -3).contiguous(), cand8, bva, ml]
    bvalm = torch.rand(lead + (h, w), generator=g, device=dev) * 60.0
    bvalm[..., :4, :] = -3.0e38
    adj = torch.randint(0, 2, lead + (h, w), generator=g, device=dev,
                        dtype=torch.int32)
    ml = torch.where(bvalm.unsqueeze(-3) > 0, lnc, 0.0)
    args = [srgb_u8_to_lab(rgb).movedim(-1, -3).contiguous(),
            srgb_u8_to_lab(cand8), bvalm, adj, ml]
    batched = [a if n else a[None] for a in args]
    d0 = cuda_prescreen._pooled_wins_ciede_plain(*batched)[1][:, 0]
    bvalm[..., 4:8, :] = (d0 if n else d0[0])[..., 4:8, :]
    return args


POOLED_SHAPES = [(0, 24, 40, 5), (0, 40, 24, 7), (0, 48, 48, 3),
                 (3, 40, 24, 6), (0, 240, 256, 48), (2, 256, 240, 9),
                 (0, 256, 256, 56)]
POOLED_SUM_TOL = 1e-5


def _check_pooled(got, want, lead, b, h, w):
    assert got.shape == lead + (b, 4, h // 4, w // 4)
    assert torch.equal(got[..., 0, :, :], want[..., 0, :, :])  # mask counts
    assert float((got - want).abs().max()) <= POOLED_SUM_TOL
    assert torch.equal(got[..., -1, :, :, :], got[..., 0, :, :, :])
    assert bool((got[..., 0, 0, :] == 0).all())  # masked rows never win


@pytest.mark.parametrize("n,h,w,b", POOLED_SHAPES)
def test_pooled_wins_redmean(dev, n, h, w, b):
    args = _pooled_args(dev, n, h, w, b, h + 2 * w + b, False)
    before = cuda_prescreen.pooled_wins_redmean.launches
    got = cuda_prescreen.pooled_wins_redmean(*args)
    assert cuda_prescreen.pooled_wins_redmean.launches == before + 1
    batched = [a if n else a[None] for a in args]
    want = cuda_prescreen._pooled_wins_redmean_plain(*batched)
    _check_pooled(got, want if n else want[0], (n,) if n else (), b, h, w)
    assert bool((got[..., 0, 1, :] == 16).all())  # rows every candidate wins
    assert torch.equal(got, cuda_prescreen.pooled_wins_redmean(*args))


@pytest.mark.parametrize("n,h,w,b", POOLED_SHAPES)
def test_pooled_wins_ciede(dev, n, h, w, b):
    args = _pooled_args(dev, n, h, w, b, h + 2 * w + b, True)
    before = cuda_prescreen.pooled_wins_ciede.launches
    got, dcand = cuda_prescreen.pooled_wins_ciede(*args)
    assert cuda_prescreen.pooled_wins_ciede.launches == before + 1
    batched = [a if n else a[None] for a in args]
    want, want_d = cuda_prescreen._pooled_wins_ciede_plain(*batched)
    lead = (n,) if n else ()
    assert dcand.shape == lead + (b, h, w)
    _close(dcand, want_d if n else want_d[0], DISTANCE_TOL)
    if torch.equal(dcand, want_d if n else want_d[0]):
        _check_pooled(got, want if n else want[0], lead, b, h, w)
    else:  # a distance one bit off may move a pixel across its threshold
        assert float((got - (want if n else want[0])).abs().max()) <= 1.0
    again = cuda_prescreen.pooled_wins_ciede(*args)
    assert torch.equal(got, again[0]) and torch.equal(dcand, again[1])


# Tile maps of the restricted calls, p = 2 in each: "none" has no tile of
# p, "all" only tiles of p, "ragged" a random third of them with more along
# the last row and column of the grid.
TILE_CASES = ["none", "all", "ragged"]


def _tile_map(dev, n, h, w, case, seed):
    lead = (n,) if n else ()
    shape = lead + (h // 8, w // 8)
    if case == "all":
        return torch.full(shape, 2, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    tiles = torch.randint(0, 2 if case == "none" else 3, shape, generator=g,
                          device=dev, dtype=torch.int32)
    if case == "ragged":
        tiles[..., -1, ::2] = 2
        tiles[..., ::3, -1] = 2
    return tiles


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("n,h,w,b", POOLED_SHAPES)
def test_pooled_wins_restricted(dev, n, h, w, b, case, perceptual):
    """E and F given a tile map and p = 2, against their twins given the
    same: one launch, mask counts equal, sums within POOLED_SUM_TOL, F's
    distance planes (+inf off the tiles of p) bit-equal, the same bits on
    a second call; with every tile of p, the unrestricted call's bits."""
    seed = h + 2 * w + b + 3 * TILE_CASES.index(case)
    args = _pooled_args(dev, n, h, w, b, seed, perceptual)
    tiles = _tile_map(dev, n, h, w, case, seed)
    wrapper, twin = (
        (cuda_prescreen.pooled_wins_ciede,
         cuda_prescreen._pooled_wins_ciede_plain) if perceptual
        else (cuda_prescreen.pooled_wins_redmean,
              cuda_prescreen._pooled_wins_redmean_plain))
    before = wrapper.launches
    got = wrapper(*args, tiles, 2)
    assert wrapper.launches == before + 1
    want = twin(*(a if n else a[None] for a in [*args, tiles]), p=2)
    want = want if n else (tuple(o[0] for o in want) if perceptual
                           else want[0])
    lead = (n,) if n else ()
    if perceptual:
        (got, dcand), (want, want_d) = got, want
        assert dcand.shape == lead + (b, h, w)
        assert torch.equal(dcand, want_d), float(
            (dcand == want_d).float().mean())
    assert got.shape == lead + (b, 4, h // 4, w // 4)
    assert torch.equal(got[..., 0, :, :], want[..., 0, :, :])  # mask counts
    assert float((got - want).abs().max()) <= POOLED_SUM_TOL
    again = wrapper(*args, tiles, 2)
    assert all(torch.equal(x, y) for x, y in zip(
        (got, dcand) if perceptual else (got,),
        again if perceptual else (again,)))
    if case == "none":
        assert not bool(got.any())
        assert not perceptual or bool(torch.isinf(dcand).all())
    if case == "all":
        full = wrapper(*args)
        assert torch.equal(got, full[0] if perceptual else full)
        assert not perceptual or torch.equal(dcand, full[1])


def test_pooled_wins_reject_bad_operands(dev):
    args = _pooled_args(dev, 0, 24, 40, 3, 1, False)
    with pytest.raises(TypeError):
        cuda_prescreen.pooled_wins_redmean(args[0].float(), *args[1:])
    with pytest.raises(ValueError):  # a threshold plane of another size
        cuda_prescreen.pooled_wins_redmean(args[0], args[1],
                                           args[2][:20].contiguous(), args[3])
    with pytest.raises(ValueError):  # planes off the 16-byte grid
        cuda_prescreen.pooled_wins_redmean(
            args[0], args[1], args[2],
            torch.zeros(3 * 24 * 40 + 1, device=dev)[1:].view(3, 24, 40))
    odd = _pooled_args(dev, 0, 24, 40, 3, 1, True)
    with pytest.raises(ValueError):  # not whole 4x4 cells
        cuda_prescreen.pooled_wins_ciede(
            *(a[..., :22, :].contiguous() if a.dim() > 1 and a.shape[-1] == 40
              else a for a in odd))


def test_pooled_wins_restricted_reject_bad_tile_maps(dev):
    args = _pooled_args(dev, 0, 24, 40, 3, 1, False)
    tiles = torch.zeros((3, 5), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # a tile map of another size
        cuda_prescreen.pooled_wins_redmean(*args, tiles[:2], 0)
    with pytest.raises(TypeError):
        cuda_prescreen.pooled_wins_redmean(*args, tiles.long(), 0)
    with pytest.raises(ValueError):  # p without the tile map
        cuda_prescreen.pooled_wins_redmean(*args, None, 0)
    odd = _pooled_args(dev, 0, 20, 40, 3, 1, True)
    with pytest.raises(ValueError):  # whole 4x4 cells, not whole tiles
        cuda_prescreen.pooled_wins_ciede(*odd, tiles[:2], 0)


def _dither_args(dev, h, w, c, s, b, seed):
    """Random image with a transparent tile band, an interior transparent
    block off the tile grid and scattered transparent pixels; a palette
    whose entries 0 and 1 are duplicates (exact distance ties); the last
    candidate equals the first, and the second equals an entry."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    rgb = ints(256, (h, w, 3))
    alpha = torch.full((h, w), 255, dtype=torch.int32, device=dev)
    alpha[8:16, : w // 2] = 0
    alpha[h // 2 + 3 : h // 2 + 13, w // 2 + 5 : w // 2 + 14] = 0
    alpha[::7, ::5] = 0
    pal = ints(32, (c, s, 3))
    pal[:, 1] = pal[:, 0]
    cand = ints(32, (b, 3))
    cand[-1] = cand[0]
    p, i = c - 1, s // 2
    if b > 2:
        cand[1] = pal[p, 0]
    return rgb, alpha, ints(c, (h // 8, w // 8)), pal, p, i, cand


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize(
    "h,w,c,s,b", [(64, 96, 4, 15, 7), (128, 128, 8, 15, 48),
                  (256, 256, 8, 15, 1), (40, 24, 2, 4, 3)],
)
def test_dither_remap_candidates(dev, h, w, c, s, b, perceptual):
    args = _dither_args(dev, h, w, c, s, b, h + w + b)
    before = cuda_dither.dither_remap_candidates.launches
    got = cuda_dither.dither_remap_candidates(*args, perceptual)
    assert cuda_dither.dither_remap_candidates.launches == before + 1
    want = dither_candidates(*args, perceptual)
    assert got.shape == (b, h, w) and got.dtype == torch.int32
    share = float((got == want).float().mean())
    assert share >= (0.99 if perceptual else 1.0), share
    assert bool((got[:, args[1] == 0] == 0).all())  # transparent pixels
    assert torch.equal(got[-1], got[0])  # equal candidates, equal maps
    again = cuda_dither.dither_remap_candidates(*args, perceptual)
    assert torch.equal(got, again)
    # With no slot overridden every row is the remap of the palette.
    rgb, alpha, tiles, pal, _, _, cand = args
    plain = cuda_dither.dither_remap_candidates(rgb, alpha, tiles, pal, -1, 0,
                                                cand[:1], perceptual)
    want_plain = dither_candidates(rgb, alpha, tiles, pal, -1, 0, cand[:1],
                                   perceptual)
    assert float((plain == want_plain).float().mean()) >= (
        0.99 if perceptual else 1.0)


def test_dither_remap_candidates_rejects_bad_operands(dev):
    rgb, alpha, tiles, pal, p, i, cand = _dither_args(dev, 32, 32, 2, 4, 2, 1)
    with pytest.raises(TypeError):
        cuda_dither.dither_remap_candidates(rgb.long(), alpha, tiles, pal, p,
                                            i, cand)
    with pytest.raises(ValueError):  # a tile map of another size
        cuda_dither.dither_remap_candidates(rgb, alpha, tiles[:2], pal, p, i,
                                            cand)
    with pytest.raises(ValueError):  # a slot outside the palette
        cuda_dither.dither_remap_candidates(rgb, alpha, tiles, pal, 2, 0,
                                            cand)
    with pytest.raises(NotImplementedError):  # not whole tiles
        cuda_dither.dither_remap_candidates(
            rgb[:30].contiguous(), alpha[:30].contiguous(), tiles, pal, p, i,
            cand)
    with pytest.raises(ValueError):  # a variant that is not built
        cuda_dither._dither_remap_cuda(rgb, alpha, tiles, pal, p, i, cand,
                                       False, lanes=4, cluster=1)


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize(
    # the dithered paths' geometries; a narrow image (R = 12 row slots);
    # slots that take three and more rows (H > 2 ceil(W/2)); and more rows
    # than the old one-thread-per-row kernel took
    "h,w,b", [(256, 256, 3), (240, 256, 3), (64, 24, 4), (48, 16, 5),
              (264, 32, 2)],
)
def test_dither_maps_equal_twin(dev, h, w, b, perceptual):
    args = _dither_args(dev, h, w, 4, 15, b, 3 * h + w)
    got = cuda_dither.dither_remap_candidates(*args, perceptual)
    want = dither_candidates(*args, perceptual)
    assert got.shape == (b, h, w)
    assert torch.equal(got, want), float((got == want).float().mean())
    assert cuda_dither.row_slots(h, w) == min(h, w // 2)


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("h,w", [(256, 256), (64, 96), (64, 24)])
def test_dither_variants_give_the_same_maps(dev, h, w, perceptual):
    """Every variant of kernel G that is built gives the maps of the one
    `variant` chooses: the lanes only split each pixel's entry search."""
    args = _dither_args(dev, h, w, 8, 15, 3, h * w)
    want = cuda_dither.dither_remap_candidates(*args, perceptual)
    for lanes, cluster in cuda_dither.VARIANTS[perceptual]:
        got = cuda_dither._dither_remap_cuda(*args, perceptual, lanes=lanes,
                                             cluster=cluster)
        assert torch.equal(got, want), (lanes, cluster)


def _prologue_args(dev, h, w, c, s, perceptual, seed):
    """Kernel A prologue operands on the card: distance planes full of
    ties, transparency, duplicate palette entries."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if perceptual:
        values = torch.tensor([0.0, 1.5, 2.25, 7.0], device=dev)
        d_all = values[torch.randint(0, 4, (s, h, w), generator=g,
                                     device=dev)]
    else:
        d_all = torch.randint(0, 5, (s, h, w), generator=g, device=dev,
                              dtype=torch.int32) * 1000
    alpha = torch.full((h, w), 255, dtype=torch.int32, device=dev)
    alpha[::3, ::5] = 0
    alpha[h // 2:h // 2 + 5, 2:9] = 0
    tiles = torch.randint(0, c, (h // 8, w // 8), generator=g, device=dev,
                          dtype=torch.int32)
    pal = torch.randint(0, 32, (c, s, 3), generator=g, device=dev,
                        dtype=torch.int32)
    if s > 1:
        pal[:, 1] = pal[:, 0]
    return d_all.contiguous(), tiles, alpha, pal


def _all_planes(out):
    return [t for v in out for t in (v if isinstance(v, tuple) else (v,))]


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize(
    "h,w,c,s,p,i", [(256, 256, 8, 15, 0, 0), (240, 256, 8, 15, 7, 14),
                    (40, 24, 3, 4, 1, 2), (16, 24, 2, 1, 1, 0)],
)
def test_visit_prologue(dev, h, w, c, s, p, i, perceptual):
    args = _prologue_args(dev, h, w, c, s, perceptual, h + w + s + i)
    before = cuda_prescreen.select_colors.launches
    got = cuda_prescreen.visit_prologue(*args, p, i)
    assert cuda_prescreen.select_colors.launches == before + 1
    want = cuda_prescreen._visit_prologue_plain(*args, p, i)
    for a, b in zip(_all_planes(got), _all_planes(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert len(_all_planes(got)) == len(_all_planes(want))


@pytest.mark.parametrize(
    "h,w,c,s,b,p,i", [(256, 256, 8, 15, 48, 0, 0), (240, 256, 8, 15, 48, 3, 7),
                      (40, 24, 3, 4, 5, 2, 3)],
)
def test_render_palette_maps(dev, h, w, c, s, b, p, i):
    _, tiles, alpha, pal = _prologue_args(dev, h, w, c, s, False, b + i)
    g = torch.Generator(device=dev).manual_seed(b)
    maps = torch.randint(0, s, (b, h, w), generator=g, device=dev,
                         dtype=torch.int32)
    cand5 = torch.randint(0, 32, (b, 3), generator=g, device=dev,
                          dtype=torch.int32)
    before = cuda_prescreen.select_colors.launches
    got = cuda_prescreen.render_palette_maps(maps, tiles, alpha, pal, cand5,
                                             p, i)
    assert cuda_prescreen.select_colors.launches == before + 1
    want = cuda_prescreen._render_plain(maps, tiles, alpha, pal, cand5, p, i)
    assert got.shape == (b, 3, h, w) and torch.equal(got, want)
    with pytest.raises(ValueError):  # a slot outside the palette
        cuda_prescreen.render_palette_maps(maps, tiles, alpha, pal, cand5, c,
                                           0)


def test_wrappers_reject_bad_operands(dev):
    key = torch.zeros((16, 16), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        cuda_prescreen.select_colors(key, torch.zeros((3, 4), device=dev))
    refp, g = _pyramid(dev, 64, 1)
    refs = tuple(tuple(a.permute(2, 0, 1) for a in refp[s]) for s in (0, 1))
    frames = torch.rand((2, 3, 64, 64), device=dev)
    with pytest.raises(ValueError):  # channel-last frames
        cuda_metric.multiscale_feature_sums(
            refs, frames.permute(0, 1, 3, 2), pre_ds=0)
    with pytest.raises(ValueError):  # scale sizes that do not halve
        cuda_metric.multiscale_feature_sums(refs[:1] + refs[:1], frames)


@pytest.mark.parametrize("perceptual", [False, True])
def test_run_fused_256x224_takes_the_fused_route(dev, perceptual):
    """The SNES's visible screen, 256x224: both sides are multiples of 32,
    so a run on the card ranks every visit's candidates with the fused
    kernel C (or D) and never with E or F; one sweep improves on the init."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine
    from snesimage_torch.core.state import new_state
    from snesimage_torch.testing import bench_image

    config = QuantConfig(
        subpalette_count=8, subpalette_size=15, width=256, height=224,
        max_steps=1, schedule="channel", prescreen=8,
        prescreen_full=4 if perceptual else 2, channel_explore=16,
        accept_margin=0.005, perceptual_palettes=perceptual)
    img = bench_image(0)[16:240]
    wrappers = (cuda_metric.coarse_feature_sums_redmean,
                cuda_metric.coarse_feature_sums_ciede,
                cuda_prescreen.pooled_wins_redmean,
                cuda_prescreen.pooled_wins_ciede)
    before = [fn.launches for fn in wrappers]
    state, errors, _ = pipeline.run_fused(img, config, device="cuda")
    c, d, e, f = (fn.launches - n for fn, n in zip(wrappers, before))
    assert (c, d, e, f) == ((0, 360, 0, 0) if perceptual else (360, 0, 0, 0))
    init = pipeline.cluster(
        pipeline.initialize(new_state(img, config, "cuda"), config), config)
    refp = refine.make_reference_pyramid(init)
    assert [tuple(s[0].shape[:2]) for s in refp][-2:] == [(14, 16), (7, 8)]
    assert errors[0] < float(refine.frame_error_fused(init, config, refp))
    assert state.palette_map.shape == (224, 256)


def test_run_fused_nes_perceptual(dev):
    """One perceptual NES sweep of the `nes-compat` preset on the card: a
    NES visit does not prescreen, so kernel F gives the 56 distance planes
    (once a visit, at a 32-aligned geometry too) and kernel B scores all 56
    frames at six scales; every entry ends on a NES colour."""
    from snesimage_torch.core import pipeline
    from snesimage_torch.models.presets import get_preset
    from snesimage_torch.ops.color import nes_palette_5bit
    from snesimage_torch.testing import bench_image

    config = get_preset("nes-compat", perceptual_palettes=True, max_steps=1)
    wrappers = (cuda_prescreen.pooled_wins_ciede,
                cuda_metric.coarse_feature_sums_ciede,
                cuda_metric.multiscale_feature_sums)
    before = [fn.launches for fn in wrappers]
    state, errors, _ = pipeline.run_fused(bench_image(0), config,
                                          device="cuda")
    f, d, b = (fn.launches - n for fn, n in zip(wrappers, before))
    assert (f, d, b) == (12, 0, 13)
    assert len(errors) == 1 and errors[0] == errors[0] < float("inf")
    nes = {tuple(c) for c in nes_palette_5bit(state.device).tolist()}
    assert {tuple(c) for c in state.palette.reshape(-1, 3).tolist()} <= nes


def freeze(path) -> None:
    """Writes the sums of kernels B, C and D at the shapes above, on the
    card, with whichever snesimage_torch is imported, to `path`."""
    dev = torch.device("cuda")
    sums = {}
    for shape in B_SHAPES:
        refs, frames = _b_inputs(dev, *shape)
        sums[_key("B", *shape)] = cuda_metric.multiscale_feature_sums(
            refs, frames, pre_ds=shape[3])
    for shape in ODD_SHAPES:
        _, refs, frames = _b_odd_inputs(dev, *shape)
        sums[_key("Bodd", *shape)] = cuda_metric.multiscale_feature_sums(
            refs, frames, pre_ds=shape[4])
    for h, w, b in COARSE_SHAPES:
        sums[_key("C", h, w, b)] = cuda_metric.coarse_feature_sums_redmean(
            *_coarse_redmean_args(dev, h, w, b))
    for h, w, b in CIEDE_SHAPES:
        sums[_key("D", h, w, b)] = cuda_metric.coarse_feature_sums_ciede(
            *_coarse_ciede_args(dev, h, w, b, h + w + b))[0]
    np.savez_compressed(path, **{k: v.cpu().numpy() for k, v in sums.items()})


if __name__ == "__main__":
    if sys.argv[1:2] != ["--freeze"] or len(sys.argv) != 3:
        sys.exit("usage: python tests/test_torch_cuda.py --freeze PATH")
    freeze(sys.argv[2])


# The image axis N (the JAX package's image fold, and the seed rows of a
# portfolio): every kernel at N = 1 to 4 gives each image what its own
# launch with N = 1 gives, bit for bit.
N_IMAGES = [1, 2, 4]
N_SHAPES = [(256, 256), (240, 256), (64, 64)]


def _stack(per_image):
    """The images' operands stacked on a new leading axis; tuples of
    reference planes plane by plane."""
    out = []
    for parts in zip(*per_image):
        if isinstance(parts[0], tuple):
            out.append(tuple(torch.stack(r) for r in zip(*parts)))
        elif isinstance(parts[0], torch.Tensor):
            out.append(torch.stack(parts))
        else:
            out.append(parts[0])
    return out


def _assert_rows(batched, singles):
    for n, single in enumerate(singles):
        for a, b in zip(_all_planes(batched), _all_planes(single)):
            assert torch.equal(a[n], b), n


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("h,w", N_SHAPES)
@pytest.mark.parametrize("n", N_IMAGES)
def test_visit_prologue_images(dev, n, h, w, perceptual):
    per = [_prologue_args(dev, h, w, 8, 15, perceptual, 11 * k + h)
           for k in range(n)]
    before = cuda_prescreen.select_colors.launches
    got = cuda_prescreen.visit_prologue(*_stack(per), 3, 7)
    assert cuda_prescreen.select_colors.launches == before + 1
    _assert_rows(got, [cuda_prescreen.visit_prologue(*a, 3, 7) for a in per])
    want = cuda_prescreen.visit_prologue(*(a.cpu() for a in _stack(per)),
                                         3, 7)
    for a, b in zip(_all_planes(got), _all_planes(want)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("h,w", N_SHAPES)
@pytest.mark.parametrize("n", N_IMAGES)
def test_render_palette_maps_images(dev, n, h, w):
    per = []
    for k in range(n):
        _, tiles, alpha, pal = _prologue_args(dev, h, w, 8, 15, False,
                                              5 * k + w)
        g = torch.Generator(device=dev).manual_seed(k)
        maps = torch.randint(0, 15, (6, h, w), generator=g, device=dev,
                             dtype=torch.int32)
        cand5 = torch.randint(0, 32, (6, 3), generator=g, device=dev,
                              dtype=torch.int32)
        per.append((maps, tiles, alpha, pal, cand5))
    got = cuda_prescreen.render_palette_maps(*_stack(per), 2, 9)
    assert got.shape == (n, 6, 3, h, w)
    for k, args in enumerate(per):
        assert torch.equal(got[k],
                           cuda_prescreen.render_palette_maps(*args, 2, 9))
        assert torch.equal(got[k].cpu(), cuda_prescreen._render_plain(
            *(a.cpu() for a in args), 2, 9))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("h,w", N_SHAPES)
@pytest.mark.parametrize("n", N_IMAGES)
@pytest.mark.parametrize("start,count,pre_ds,b", [(0, 6, 0, 2), (1, 1, 1, 8),
                                                  (2, 4, 2, 12),
                                                  (0, 6, 0, 9)])
def test_multiscale_feature_sums_images(dev, n, h, w, shared, start, count,
                                        pre_ds, b):
    """N images' frames, each scored against its own pyramid (or all of
    them against one, with stride 0), in one launch, or two where the
    call splits (SPLIT_FRAMES): each image's sums are its own launch's."""
    pyramids = [_pyramid(dev, h, 3 * k + w + b, width=w)[0]
                for k in range(1 if shared else n)]
    triples = [tuple(tuple(a.permute(2, 0, 1) for a in refp[sc])
                     for sc in range(start, start + count))
               for refp in pyramids]
    fh, fw = pyramid_size(h, w, start - pre_ds)
    g = torch.Generator(device=dev).manual_seed(n + b)
    frames = torch.rand((n, b, 3, fh, fw), generator=g, device=dev)
    refs = triples[0] if shared else tuple(
        tuple(torch.stack(r) for r in zip(*sc)) for sc in zip(*triples))
    got = cuda_metric.multiscale_feature_sums(refs, frames, pre_ds=pre_ds)
    assert got.shape == (n, b, count, 3, 6)
    for k in range(n):
        one = cuda_metric.multiscale_feature_sums(
            triples[0 if shared else k], frames[k].contiguous(),
            pre_ds=pre_ds)
        assert torch.equal(got[k], one), k
    assert torch.equal(got, cuda_metric.multiscale_feature_sums(
        refs, frames, pre_ds=pre_ds))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("h,w", [(256, 256), (224, 256), (64, 64)])
@pytest.mark.parametrize("n", N_IMAGES)
def test_coarse_feature_sums_redmean_images(dev, n, h, w, shared):
    per = [_coarse_redmean_args(dev, h, w, 12, seed=7 * k + h)
           for k in range(n)]
    if shared:
        per = [a[:-1] + (per[0][-1],) for a in per]
    args = _stack(per)
    if shared:
        args[-1] = per[0][-1]
    before = cuda_metric.coarse_feature_sums_redmean.launches
    got = cuda_metric.coarse_feature_sums_redmean(*args)
    assert cuda_metric.coarse_feature_sums_redmean.launches == before + 1
    assert got.shape[:2] == (n, 12)
    for k, one in enumerate(per):
        assert torch.equal(got[k],
                           cuda_metric.coarse_feature_sums_redmean(*one))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("h,w", [(256, 256), (224, 256), (64, 64)])
@pytest.mark.parametrize("n", N_IMAGES)
def test_coarse_feature_sums_ciede_images(dev, n, h, w, shared):
    per = [_coarse_ciede_args(dev, h, w, 12, 5 * k + w) for k in range(n)]
    if shared:
        per = [a[:-1] + [per[0][-1]] for a in per]
    args = _stack(per)
    if shared:
        args[-1] = per[0][-1]
    sums, dcand = cuda_metric.coarse_feature_sums_ciede(*args)
    for k, one in enumerate(per):
        want = cuda_metric.coarse_feature_sums_ciede(*one)
        assert torch.equal(sums[k], want[0]) and torch.equal(dcand[k],
                                                             want[1])


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("h,w", N_SHAPES)
@pytest.mark.parametrize("n", N_IMAGES)
def test_pooled_wins_images(dev, n, h, w, perceptual):
    """E and F over N images, each with its own tile map of subpalette 2:
    each image lists its own tiles of p, as its own launch does."""
    args = _pooled_args(dev, n, h, w, 9, h + w + n, perceptual)
    tiles = _tile_map(dev, n, h, w, "ragged", h + n)
    wrapper = (cuda_prescreen.pooled_wins_ciede if perceptual
               else cuda_prescreen.pooled_wins_redmean)
    got = wrapper(*args, tiles, 2)
    for k in range(n):
        one = wrapper(*(a[k].contiguous() for a in args),
                      tiles[k].contiguous(), 2)
        for a, b in zip(got if perceptual else (got,),
                        one if perceptual else (one,)):
            assert torch.equal(a[k], b), k


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("h,w", N_SHAPES)
@pytest.mark.parametrize("n", N_IMAGES)
def test_dither_remap_images_and_seeds(dev, n, h, w, perceptual):
    """Kernel G over N images, and over N seed rows (palettes) of one
    shared image read with stride 0: each row's maps are its own launch's
    with one image, bit for bit."""
    per = [_dither_args(dev, h, w, 8, 15, 3, 13 * k + h) for k in range(n)]
    rgb, alpha, tiles, pal, p, i, cand = _stack(per)
    got = cuda_dither.dither_remap_candidates(rgb, alpha, tiles, pal, p, i,
                                              cand, perceptual)
    seeds = cuda_dither.dither_remap_candidates(
        per[0][0], per[0][1], per[0][2], pal, p, i, cand, perceptual)
    for k, (r, a, t, pl, _, _, c) in enumerate(per):
        assert torch.equal(got[k], cuda_dither.dither_remap_candidates(
            r, a, t, pl, p, i, c, perceptual)), k
        assert torch.equal(seeds[k], cuda_dither.dither_remap_candidates(
            per[0][0], per[0][1], per[0][2], pl, p, i, c, perceptual)), k


@pytest.mark.parametrize("flags", [(0,), (1,), (1, 0), (0, 1), (0, 0)])
@pytest.mark.parametrize("h,w,start,count,b", [
    (256, 256, 0, 1, 2), (240, 256, 0, 1, 2), (256, 256, 0, 2, 1),
    (256, 256, 0, 6, 32), (64, 64, 0, 6, 3)])
def test_multiscale_gate_flag(dev, flags, h, w, start, count, b):
    """Kernel B's per-image gate flag: an open image's sums equal the call
    without a flag bit for bit, a closed image's are zero (its blocks
    return before they load anything), and the twin says the same; a
    closed call leaves the tile tickets at 0, so the next call's sums are
    unchanged. Shapes: the gated visit's scale-0 call (B = 2), the gate's
    carry (scales 0-1, B = 1), a call that launches tiles and resident
    clusters apart (B = 32, six scales) and one with resident scales only."""
    n = len(flags)
    pyramids = [_pyramid(dev, h, 5 * k + w + b, width=w)[0] for k in range(n)]
    triples = [tuple(tuple(a.permute(2, 0, 1) for a in refp[sc])
                     for sc in range(start, start + count))
               for refp in pyramids]
    g = torch.Generator(device=dev).manual_seed(n + b + h)
    frames = torch.rand((n, b, 3, h, w), generator=g, device=dev)
    refs = tuple(tuple(torch.stack(r) for r in zip(*sc))
                 for sc in zip(*triples))
    if n == 1:
        refs, frames = triples[0], frames[0]
    gate = torch.tensor(flags, dtype=torch.int32, device=dev)
    want = cuda_metric.multiscale_feature_sums(refs, frames)
    got = cuda_metric.multiscale_feature_sums(refs, frames, gate=gate)
    plain = cuda_metric._multiscale_feature_sums_plain(
        refs, frames, gate=gate)
    unflagged = cuda_metric._multiscale_feature_sums_plain(refs, frames)
    assert got.shape == want.shape == plain.shape
    for k, flag in enumerate(flags):
        g_k, w_k, p_k = ((got[k], want[k], plain[k]) if n > 1
                         else (got, want, plain))
        if flag:
            assert torch.equal(g_k, w_k), k
            assert torch.equal(p_k, unflagged[k] if n > 1 else unflagged)
        else:
            assert not g_k.any() and not p_k.any(), k
    assert torch.equal(cuda_metric.multiscale_feature_sums(refs, frames),
                       want)
