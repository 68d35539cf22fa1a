"""The plain twins of kernels A, B, C, E and F against the JAX package's
Pallas kernels in interpret mode, and state carried between the packages.

On the CPU each kernel wrapper runs its twin, so these tests pin the
arithmetic the CUDA kernels are held to on the card (chip_smoke.py).
A is exact; B and C agree within 2e-4 on finalised features, the bound
tests/test_batched_kernels.py sets between the Pallas and XLA paths. E's
and F's mask counts are exact and their m*ML sums agree within 1e-5 (the
Pallas kernels pool W as a matrix product, the twins as a sum of 16
floats). F's distance planes are the standard CIEDE2000 and agree within
1e-4 with the Pallas kernel's algebraic-hue form; its thresholds are kept
1e-3 away from every distance, so that no tie turns on the formula."""

import jax
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
from snesimage_torch.testing import expect_launches
from snesimage_tpu.ops import color as jcolor
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


def test_select_colors_exact(rng):
    nk = 120
    key = rng.integers(0, nk + 1, (H, W)).astype(np.int32)
    table = rng.random((3, nk)).astype(np.float32)
    want = pp.select_colors(jnp.asarray(key), jnp.asarray(table),
                            interpret=True)
    with expect_launches():
        got = cuda_prescreen.select_colors(torch.from_numpy(key),
                                           torch.from_numpy(table))
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
    with expect_launches():
        got = cuda_metric.multiscale_feature_sums(
            tuple(tuple(torch.from_numpy(a) for a in t) for t in ref_scales),
            torch.from_numpy(frames), pre_ds=pre_ds,
        )
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
    with expect_launches():
        got = cuda_metric.coarse_feature_sums_redmean(
            *(torch.from_numpy(a) for a in args),
            tuple(torch.from_numpy(a) for a in flat),
        )
    assert got.shape == (b, 12, 6)
    got = finalize_feature_sums(got, sizes, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[-1], got[0])


# (image axis N or 0 for none, H, W, candidates)
POOLED_SHAPES = [(0, 24, 40, 5), (0, 40, 24, 7), (0, 48, 48, 4), (3, 24, 40, 3)]
POOLED_SUM_TOL = 1e-5


def _pooled_redmean_args(rng, n, h, w, b):
    lead = (n,) if n else ()
    tg = rng.integers(0, 256, lead + (3, h, w)).astype(np.int32)
    cand8 = rng.integers(0, 256, lead + (b, 3)).astype(np.int32)
    cand8[..., -1, :] = cand8[..., 0, :]  # a duplicate candidate
    bva = rng.integers(0, 150_000_000, lead + (h, w)).astype(np.int32)
    bva[..., :4, :] = np.iinfo(np.int32).min  # masked rows
    bva[..., 4:8, :] = np.iinfo(np.int32).max  # rows every candidate wins
    lnc = rng.random(lead + (3, h, w)).astype(np.float32)
    ml = np.where(np.expand_dims(bva, -3) > 0, lnc, 0.0).astype(np.float32)
    return (tg, cand8, bva, ml), lnc


def _check_pooled(got, want, n, b, h, w):
    assert got.shape == ((n,) if n else ()) + (b, 4, h // 4, w // 4)
    np.testing.assert_array_equal(got[..., 0, :, :], want[..., 0, :, :])
    np.testing.assert_allclose(got, want, rtol=0, atol=POOLED_SUM_TOL)
    np.testing.assert_array_equal(got[..., -1, :, :, :], got[..., 0, :, :, :])
    assert (got[..., 0, 0, :] == 0).all()  # masked rows never win


@pytest.mark.parametrize("n,h,w,b", POOLED_SHAPES)
def test_pooled_wins_redmean_twin(rng, n, h, w, b):
    args, _ = _pooled_redmean_args(rng, n, h, w, b)
    kernel = lambda *a: pp.pooled_wins_redmean(*a, interpret=True)  # noqa: E731
    want = (jax.vmap(kernel) if n else kernel)(*(jnp.asarray(a) for a in args))
    with expect_launches():
        got = cuda_prescreen.pooled_wins_redmean(
            *(torch.from_numpy(a) for a in args))
    _check_pooled(got.numpy(), np.asarray(want), n, b, h, w)
    assert (got.numpy()[..., 0, 1, :] == 16).all()
    # The frames of candidates that win nothing are the 4x4 means, bit for
    # bit: rows 0 of every cell plane are masked.
    lin = torch.rand((b, 3))
    ds4 = torch.rand((3, h // 4, w // 4))
    pooled = got if not n else got[0]
    frames = cuda_prescreen.coarse_frames(pooled, lin, ds4)
    assert torch.equal(frames[:, :, 0], ds4[None, :, 0].expand(b, -1, -1))


def _pooled_ciede_args(rng, n, h, w, b):
    """Kernel F's operands, every threshold more than 1e-3 from every
    candidate's distance (see the module docstring)."""
    lead = (n,) if n else ()
    tlab = np.array(jcolor.srgb_u8_to_lab(
        jnp.asarray(rng.integers(0, 256, lead + (h, w, 3)).astype(np.int32))))
    cand8 = rng.integers(0, 256, lead + (b, 3)).astype(np.int32)
    cand8[..., -1, :] = cand8[..., 0, :]
    cand_lab = np.array(jcolor.srgb_u8_to_lab(jnp.asarray(cand8)))
    d = np.asarray(jcolor.ciede2000(
        jnp.asarray(tlab)[..., None, :, :, :],
        jnp.asarray(cand_lab)[..., :, None, None, :]))  # lead + (b, h, w)
    bvalm = rng.uniform(0.0, 60.0, lead + (h, w)).astype(np.float32)
    for _ in range(100):
        near = (np.abs(d - np.expand_dims(bvalm, -3)) <= 2e-3).any(-3)
        if not near.any():
            break
        bvalm[near] += np.float32(0.01)
    assert not (np.abs(d - np.expand_dims(bvalm, -3)) <= 1e-3).any()
    bvalm[..., :4, :] = -3.0e38
    adj = rng.integers(0, 2, lead + (h, w)).astype(np.int32)
    lnc = rng.random(lead + (3, h, w)).astype(np.float32)
    ml = np.where(np.expand_dims(bvalm, -3) > 0, lnc, 0.0).astype(np.float32)
    return (np.ascontiguousarray(np.moveaxis(tlab, -1, -3)), cand_lab, bvalm,
            adj, ml), d


@pytest.mark.parametrize("n,h,w,b", POOLED_SHAPES)
def test_pooled_wins_ciede_twin(rng, n, h, w, b):
    args, d_std = _pooled_ciede_args(rng, n, h, w, b)
    kernel = lambda *a: pp.pooled_wins_ciede(  # noqa: E731
        *a, None, interpret=True)
    want, want_d = (jax.vmap(kernel) if n else kernel)(
        *(jnp.asarray(a) for a in args))
    with expect_launches():
        got, dcand = cuda_prescreen.pooled_wins_ciede(
            *(torch.from_numpy(a) for a in args))
    assert dcand.shape == ((n,) if n else ()) + (b, h, w)
    np.testing.assert_allclose(dcand.numpy(), np.asarray(want_d), rtol=0,
                               atol=1e-4)
    # ... and the standard formula of the JAX package, which it is
    np.testing.assert_allclose(dcand.numpy(), d_std, rtol=0, atol=1e-4)
    _check_pooled(got.numpy(), np.asarray(want), n, b, h, w)


def test_pooled_wins_features_match_the_jax_chain(rng):
    """Kernel E's twin, the frame assembly and kernel B's twin against the
    JAX package's chain for a geometry that is not 32-aligned: 2e-4 on the
    finalised scale-2..5 features."""
    from snesimage_torch.ops import ssimulacra2 as tss

    h, w, b = 40, 24, 6
    ref = rng.integers(0, 256, (h, w, 3)).astype(np.int32)
    jrefp = jss.reference_pyramid(jnp.asarray(ref))
    trefp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in s) for s in jrefp), "cpu")
    args, lnc = _pooled_redmean_args(rng, 0, h, w, b)
    cand_lin = rng.random((b, 3)).astype(np.float32)
    cand_lin[-1] = cand_lin[0]  # the duplicate candidate's colour
    ds4 = lnc.reshape(3, h // 4, 4, w // 4, 4).mean(axis=(2, 4))
    pooled = pp.pooled_wins_redmean(*(jnp.asarray(a) for a in args),
                                    interpret=True)
    frames = (jnp.asarray(cand_lin)[:, :, None, None] * pooled[:, :1]
              - pooled[:, 1:4]) / 16.0 + jnp.asarray(ds4)[None]
    want = jss.fused_scale_feature_block(jrefp, frames, 2, 4)
    got = tss.fused_scale_feature_block(
        trefp,
        cuda_prescreen.coarse_frames(
            cuda_prescreen.pooled_wins_redmean(
                *(torch.from_numpy(a) for a in args)),
            torch.from_numpy(cand_lin), torch.from_numpy(ds4)),
        2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got.numpy()[-1], got.numpy()[0])


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
