"""Kernels A, B, C and D against their plain twins on a CUDA card, at
shapes beyond the main paths' (which chip_smoke.py covers). Marked `cuda`:
they skip where no card is present. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

A is exact; B, C and D agree within 2e-4 on finalised features, and D's
distance planes within 1e-4 (absolute plus relative)."""

import pytest
import torch

from snesimage_torch.ops import cuda_metric, cuda_prescreen
from snesimage_torch.ops.color import srgb_u8_to_lab, srgb_u8_to_linear
from snesimage_torch.ops.ssimulacra2 import (
    finalize_feature_sums,
    reference_pyramid,
)

pytestmark = pytest.mark.cuda
TOL = 2e-4
DISTANCE_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    diff = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((diff <= tol + tol * want.abs()).all()), float(diff.max())


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


@pytest.mark.parametrize(
    "size,start,n,pre_ds,b",
    [(256, 0, 6, 0, 1), (256, 1, 1, 1, 8), (256, 0, 1, 0, 2), (256, 0, 2, 0, 3),
     (128, 1, 3, 1, 5), (64, 0, 6, 0, 4), (256, 2, 4, 0, 48)],
)
def test_multiscale_feature_sums(dev, size, start, n, pre_ds, b):
    refp, g = _pyramid(dev, size, 7 * size + n)
    edge = size >> (start - pre_ds)
    frames = torch.rand((b, 3, edge, edge), generator=g, device=dev) ** 2.2
    refs = tuple(tuple(a.permute(2, 0, 1) for a in refp[start + s])
                 for s in range(n))
    sizes = [(size >> (start + s)) ** 2 for s in range(n)]
    before = cuda_metric.multiscale_feature_sums.launches
    got = cuda_metric.multiscale_feature_sums(refs, frames, pre_ds=pre_ds)
    assert cuda_metric.multiscale_feature_sums.launches == before + 1
    want = cuda_metric._multiscale_feature_sums_plain(refs, frames, pre_ds)
    _close(finalize_feature_sums(got.reshape(b, -1, 6), sizes, start),
           finalize_feature_sums(want.reshape(b, -1, 6), sizes, start))
    again = cuda_metric.multiscale_feature_sums(refs, frames, pre_ds=pre_ds)
    assert torch.equal(got, again)  # no atomics: the same bits every run


@pytest.mark.parametrize("size,b", [(256, 48), (64, 5), (128, 9)])
def test_coarse_feature_sums_redmean(dev, size, b):
    refp, g = _pyramid(dev, size, size + b)
    tg = torch.randint(0, 256, (3, size, size), generator=g, device=dev,
                       dtype=torch.int32)
    cand8 = torch.randint(0, 256, (b, 3), generator=g, device=dev,
                          dtype=torch.int32)
    cand8[-1] = cand8[0]
    cand_lin = (cand8 / 255.0) ** 2.2
    bva = torch.randint(0, 150_000_000, (size, size), generator=g, device=dev,
                        dtype=torch.int32)
    bva[:8] = torch.iinfo(torch.int32).min
    bva[8:12] = torch.iinfo(torch.int32).max
    lnc = torch.rand((3, size, size), generator=g, device=dev)
    ml = torch.where(bva[None] > 0, lnc, 0.0)
    ds4 = lnc.reshape(3, size // 4, 4, size // 4, 4).mean(dim=(2, 4))
    flat = tuple(a.permute(2, 0, 1) for s in range(2, 6) for a in refp[s])
    args = (tg, cand8, cand_lin.float(), bva, ml, ds4.contiguous(), flat)
    sizes = [(size >> s) ** 2 for s in range(2, 6)]
    before = cuda_metric.coarse_feature_sums_redmean.launches
    got = cuda_metric.coarse_feature_sums_redmean(*args)
    assert cuda_metric.coarse_feature_sums_redmean.launches == before + 1
    want = cuda_metric._coarse_plain(*args)
    _close(finalize_feature_sums(got, sizes, 2),
           finalize_feature_sums(want, sizes, 2))
    assert torch.equal(got[-1], got[0])


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


@pytest.mark.parametrize("h,w,b", [(64, 96, 7), (256, 256, 1), (128, 128, 48)])
def test_coarse_feature_sums_ciede(dev, h, w, b):
    args = _coarse_ciede_args(dev, h, w, b, h + w + b)
    sizes = [(h >> s) * (w >> s) for s in range(2, 6)]
    before = cuda_metric.coarse_feature_sums_ciede.launches
    sums, dcand = cuda_metric.coarse_feature_sums_ciede(*args)
    assert cuda_metric.coarse_feature_sums_ciede.launches == before + 1
    want_sums, want_d = cuda_metric._coarse_ciede_plain(*args)
    assert dcand.shape == (b, h, w)
    _close(dcand, want_d, DISTANCE_TOL)
    _close(finalize_feature_sums(sums, sizes, 2),
           finalize_feature_sums(want_sums, sizes, 2))
    assert torch.equal(sums[-1], sums[0])
    again = cuda_metric.coarse_feature_sums_ciede(*args)
    assert torch.equal(sums, again[0]) and torch.equal(dcand, again[1])


def test_coarse_feature_sums_ciede_rejects_uneven_frames(dev):
    args = _coarse_ciede_args(dev, 64, 64, 2, 3)
    crop = [args[0][:, :48, :48].contiguous(), args[1], args[2],
            args[3][:48, :48].contiguous(), args[4][:48, :48].contiguous(),
            args[5][:, :48, :48].contiguous(), args[6][:, :12, :12].contiguous(),
            args[7]]
    with pytest.raises(NotImplementedError, match="queue B item 6"):
        cuda_metric.coarse_feature_sums_ciede(*crop)


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
