"""The plain twins of kernels A, B and C against the JAX package's Pallas
kernels in interpret mode, and state carried between the packages.

On the CPU each kernel wrapper runs its twin, so these tests pin the
arithmetic the CUDA kernels are held to on the card (chip_smoke.py).
A is exact; B and C agree within 2e-4 on finalised features, the bound
tests/test_batched_kernels.py sets between the Pallas and XLA paths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.core.state import (
    new_state,
    pyramid_from_numpy,
    pyramid_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from snesimage_torch.config import QuantConfig
from snesimage_torch.ops import cuda_metric, cuda_prescreen
from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums
from snesimage_tpu.ops import pallas_metric as pm
from snesimage_tpu.ops import pallas_prescreen as pp
from snesimage_tpu.ops import ssimulacra2 as jss

TOL = 2e-4
H = W = 64


@pytest.fixture
def refp(rng):
    """The JAX package's reference pyramid of a random 64x64 image."""
    ref = rng.integers(0, 256, (H, W, 3)).astype(np.int32)
    return tuple(
        tuple(np.asarray(a) for a in s)
        for s in jss.reference_pyramid(jnp.asarray(ref))
    )


def _cmaj(refp, scales):
    return tuple(
        tuple(np.ascontiguousarray(np.moveaxis(a, -1, 0)) for a in refp[s])
        for s in scales
    )


def _launch_counts():
    return (cuda_prescreen.select_colors.launches,
            cuda_metric.multiscale_feature_sums.launches,
            cuda_metric.coarse_feature_sums_redmean.launches)


def test_select_colors_exact(rng):
    nk = 120
    key = rng.integers(0, nk + 1, (H, W)).astype(np.int32)
    table = rng.random((3, nk)).astype(np.float32)
    want = pp.select_colors(jnp.asarray(key), jnp.asarray(table),
                            interpret=True)
    before = _launch_counts()
    got = cuda_prescreen.select_colors(torch.from_numpy(key),
                                       torch.from_numpy(table))
    assert _launch_counts() == before  # CPU tensors take the twin
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[:, key == nk] == 0).all()


@pytest.mark.parametrize(
    # the main path's three call shapes, cut to 64x64
    "start,n,pre_ds,b", [(0, 6, 0, 1), (1, 1, 1, 4), (0, 1, 0, 2)]
)
def test_multiscale_feature_sums_twin(rng, refp, start, n, pre_ds, b):
    hs = H >> (start - pre_ds)
    frames = rng.random((b, 3, hs, hs)).astype(np.float32) ** 2.2
    ref_scales = _cmaj(refp, range(start, start + n))
    sizes = [(H >> s) ** 2 for s in range(start, start + n)]
    want = pm.multiscale_feature_sums(
        tuple(tuple(jnp.asarray(a) for a in t) for t in ref_scales),
        jnp.asarray(frames), pre_ds=pre_ds, interpret=True,
    )
    want = np.asarray(
        jss.finalize_feature_sums(want.reshape(b, -1, 6), sizes, start)
    )
    before = _launch_counts()
    got = cuda_metric.multiscale_feature_sums(
        tuple(tuple(torch.from_numpy(a) for a in t) for t in ref_scales),
        torch.from_numpy(frames), pre_ds=pre_ds,
    )
    assert _launch_counts() == before
    assert got.shape == (b, n, 3, 6)
    got = finalize_feature_sums(got.reshape(b, -1, 6), sizes, start)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _coarse_args(rng, refp, b):
    tg = rng.integers(0, 256, (3, H, W)).astype(np.int32)
    cand8 = rng.integers(0, 256, (b, 3)).astype(np.int32)
    cand8[-2:] = cand8[0]  # duplicate candidates: identical sums
    cand_lin = (cand8 / 255.0).astype(np.float32) ** 2.2
    bva = rng.integers(0, 150_000_000, (H, W)).astype(np.int32)
    bva[:8] = np.iinfo(np.int32).min  # masked rows: no candidate wins
    lnc = rng.random((3, H, W)).astype(np.float32)
    ml = np.where(bva > 0, lnc, 0.0).astype(np.float32)
    ds4 = lnc.reshape(3, H // 4, 4, W // 4, 4).mean(axis=(2, 4))
    flat = tuple(a for t in _cmaj(refp, range(2, 6)) for a in t)
    return (tg, cand8, cand_lin, bva, ml, ds4.astype(np.float32)), flat


def test_coarse_feature_sums_redmean_twin(rng, refp):
    b = 6
    args, flat = _coarse_args(rng, refp, b)
    sizes = [(H >> s) ** 2 for s in range(2, 6)]
    want = pm.coarse_feature_sums_redmean(
        *(jnp.asarray(a) for a in args), tuple(jnp.asarray(a) for a in flat),
        interpret=True,
    )
    want = np.asarray(jss.finalize_feature_sums(want, sizes, 2))
    before = _launch_counts()
    got = cuda_metric.coarse_feature_sums_redmean(
        *(torch.from_numpy(a) for a in args),
        tuple(torch.from_numpy(a) for a in flat),
    )
    assert _launch_counts() == before
    assert got.shape == (b, 12, 6)
    got = finalize_feature_sums(got, sizes, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[-1], got[0])


def test_state_round_trip(small_image, rng):
    cfg = QuantConfig(subpalette_count=3, subpalette_size=5, width=64,
                      height=64)
    st = new_state(small_image, cfg, "cpu")
    arrays = state_to_numpy(st)
    arrays["palette"] = rng.integers(0, 32, (3, 5, 3)).astype(np.int32)
    back = state_to_numpy(state_from_numpy(arrays, "cpu"))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == (np.uint8 if k == "original" else np.int32)


def test_pyramid_round_trip(refp):
    tp = pyramid_from_numpy(refp, "cpu")
    for s, scale in enumerate(tp):
        for a, want in zip(scale, refp[s]):
            assert a.shape == want.shape
            assert a.permute(2, 0, 1).is_contiguous()  # kernel layout
    back = pyramid_to_numpy(tp)
    for s in range(len(refp)):
        for a, want in zip(back[s], refp[s]):
            np.testing.assert_array_equal(a, want)
