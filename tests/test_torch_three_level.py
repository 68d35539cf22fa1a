"""The three-level prescreen (`prescreen_pre`) against the JAX package on
the CPU: kernels C's and D's three-level mode (`pre_ds=1, emit_frames`),
the cascade, and slot visits that take it.

- The twins of C and D against the Pallas kernels in interpret mode, at
  N = 1 and N = 2 images: finalised features of scales 3-5 within 2e-4
  absolute (the bound tests/test_torch_kernels.py holds the two-level
  mode to) and the quarter frames within 1e-6 (the pooled sums are added
  in another order). D's operands keep every threshold more than 1e-3 from
  every distance, as in tests/test_torch_perceptual.py.
- The cascade: the scale-2..5 score of every candidate the scale-3..5 rank
  keeps equals the two-level score within 1e-4 (both are exact; only the
  order of the float32 sums differs).
- Slot visits with `prescreen_pre=16` give the JAX package's palette and
  map, at 64x64 (kernel C's twin) and at 64x40 (kernels E and B).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import refine as tref
from snesimage_torch.core.state import pyramid_from_numpy, state_from_numpy
from snesimage_torch.ops import cuda_metric
from snesimage_torch.ops.color import expand_5bit_to_8bit, srgb_u8_to_linear
from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums
from snesimage_torch.testing import expect_launches, single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core import refine as jref
from snesimage_tpu.core.state import new_state as j_new_state
from snesimage_tpu.ops import color as jcolor
from snesimage_tpu.ops import pallas_metric as pm
from snesimage_tpu.ops import ssimulacra2 as jss

FEATURE_TOL = 2e-4
FRAME_TOL = 1e-6
RANK_TOL = 1e-4
H = W = 64
BIG = 3.0e38
MODE = dict(pre_ds=1, emit_frames=True)
CFG = dict(subpalette_count=2, subpalette_size=4, width=64, height=64,
           schedule="channel", prescreen=8, prescreen_full=2,
           channel_explore=0, prescreen_pre=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    with single_torch_thread():
        yield


def _flat(rng, n_img):
    """Channel-major reference planes of scales 3-5 of n_img random
    images, (n_img, 3, h, w) each (n_img 0: no image axis)."""
    planes = []
    for _ in range(max(n_img, 1)):
        ref = rng.integers(0, 256, (H, W, 3)).astype(np.int32)
        pyr = jss.reference_pyramid(jnp.asarray(ref))
        planes.append([np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 0))
                       for s in range(3, 6) for a in pyr[s]])
    if not n_img:
        return tuple(planes[0])
    return tuple(np.stack(p) for p in zip(*planes))


def _redmean_args(rng, b):
    tg = rng.integers(0, 256, (3, H, W)).astype(np.int32)
    cand8 = rng.integers(0, 256, (b, 3)).astype(np.int32)
    cand8[-1] = cand8[0]  # a duplicate candidate: identical rows
    cand_lin = (cand8 / 255.0).astype(np.float32) ** 2.2
    bva = rng.integers(0, 150_000_000, (H, W)).astype(np.int32)
    bva[:8] = np.iinfo(np.int32).min  # masked rows: no candidate wins
    lnc = rng.random((3, H, W)).astype(np.float32)
    ml = np.where(bva > 0, lnc, 0.0).astype(np.float32)
    ds4 = lnc.reshape(3, H // 4, 4, W // 4, 4).mean(axis=(2, 4))
    return tg, cand8, cand_lin, bva, ml, ds4.astype(np.float32)


def _ciede_args(rng, b):
    tlab = np.array(jcolor.srgb_u8_to_lab(
        jnp.asarray(rng.integers(0, 256, (H, W, 3)).astype(np.int32))))
    cand8 = rng.integers(0, 256, (b, 3)).astype(np.int32)
    cand8[-1] = cand8[0]
    cand_lab = np.array(jcolor.srgb_u8_to_lab(jnp.asarray(cand8)))
    cand_lin = np.array(jcolor.srgb_u8_to_linear(jnp.asarray(cand8)))
    d = np.asarray(jcolor.ciede2000(jnp.asarray(tlab)[None],
                                    jnp.asarray(cand_lab)[:, None, None]))
    bvalm = rng.uniform(0.0, 60.0, (H, W)).astype(np.float32)
    for _ in range(100):
        near = (np.abs(d - bvalm[None]) <= 2e-3).any(0)
        if not near.any():
            break
        bvalm[near] += np.float32(0.01)
    assert not (np.abs(d - bvalm[None]) <= 1e-3).any()
    bvalm[:8] = -BIG
    adj = rng.integers(0, 2, (H, W)).astype(np.int32)
    lnc = rng.random((3, H, W)).astype(np.float32)
    ml = np.where(bvalm > 0, lnc, 0.0).astype(np.float32)
    ds4 = lnc.reshape(3, H // 4, 4, W // 4, 4).mean(axis=(2, 4))
    return (np.ascontiguousarray(np.moveaxis(tlab, -1, 0)), cand_lab,
            cand_lin, bvalm, adj, ml, ds4.astype(np.float32))


@pytest.mark.parametrize("kernel", ["redmean", "ciede"])
@pytest.mark.parametrize("n_img", [1, 2])
def test_three_level_twins_match_pallas(rng, kernel, n_img):
    """Kernel C's or D's twin in the three-level mode against the Pallas
    kernel in interpret mode, for one image and for two (the JAX package's
    custom_vmap image fold; the port's leading image axis)."""
    b = 5
    make = _redmean_args if kernel == "redmean" else _ciede_args
    per_image = [make(rng, b) for _ in range(n_img)]
    args = per_image[0] if n_img == 1 else tuple(
        np.stack(a) for a in zip(*per_image))
    flat = _flat(rng, 0 if n_img == 1 else n_img)
    fn = (pm.coarse_feature_sums_redmean if kernel == "redmean"
          else pm.coarse_feature_sums_ciede)
    twin = (cuda_metric.coarse_feature_sums_redmean if kernel == "redmean"
            else cuda_metric.coarse_feature_sums_ciede)

    def pallas(*a):
        return fn(*a[:-len(flat)], a[-len(flat):], interpret=True, **MODE)

    run = pallas if n_img == 1 else jax.vmap(pallas)
    want = run(*(jnp.asarray(a) for a in args + flat))
    with expect_launches() as record:
        got = twin(*(torch.from_numpy(a) for a in args),
                   tuple(torch.from_numpy(a) for a in flat), **MODE)
    counter = "c" if kernel == "redmean" else "d"
    assert record.total(f"{counter}.three_level_calls") == 1
    assert len(got) == len(want) == (2 if kernel == "redmean" else 3)
    lead = (b,) if n_img == 1 else (n_img, b)
    assert got[0].shape == lead + (9, 6)
    assert got[-1].shape == lead + (3, H // 4, W // 4)
    sizes = [(H >> s) ** 2 for s in range(3, 6)]
    feats = finalize_feature_sums(got[0], sizes, 3).numpy()
    want_feats = finalize_feature_sums(
        torch.from_numpy(np.asarray(want[0])), sizes, 3).numpy()
    np.testing.assert_allclose(feats, want_feats, rtol=0, atol=FEATURE_TOL)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[-1]), rtol=0,
                               atol=FRAME_TOL)
    if kernel == "ciede":
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=FEATURE_TOL)
    # The duplicate candidate's rows are the first's, bit for bit.
    np.testing.assert_array_equal(feats[..., -1, :, :, :],
                                  feats[..., 0, :, :, :])


@lru_cache(maxsize=None)
def _setup(image_bytes: bytes, h: int, w: int):
    """(JAX state, config, pyramid) after initialize + cluster of the
    image's first h rows and w columns, and the port's copies."""
    img = np.frombuffer(image_bytes, np.uint8).reshape(64, 64, 4)[:h, :w]
    kw = dict(CFG, width=w, height=h)
    jc, tc = JConfig(**kw), TConfig(**kw)
    js = jpipe.cluster(jpipe.initialize(j_new_state(np.ascontiguousarray(img),
                                                    jc), jc), jc)
    jrefp = jref.make_reference_pyramid(js)
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          "cpu")
    trefp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in s) for s in jrefp), "cpu")
    return (js, jc, jrefp), (ts, tc, trefp)


def test_cascade_keeps_the_two_level_scores(small_image):
    """Every candidate the scale-3..5 rank keeps gets the two-level
    scale-2..5 score within 1e-4; the others +inf. Exactly
    `prescreen_pre` are kept."""
    _, (ts, tc, trefp) = _setup(small_image.tobytes(), H, W)
    ctx = tref.slot_context(ts, tc, 0, 1, tref.compute_d_all(ts, tc))
    cand5 = torch.from_numpy(np.random.default_rng(3).integers(
        0, 32, (40, 3)).astype(np.int32))
    cand8 = expand_5bit_to_8bit(cand5)
    lin = srgb_u8_to_linear(cand8)
    sums3, frames_q = cuda_metric.coarse_feature_sums_redmean(
        *tref.coarse_inputs(ctx, cand8, lin, trefp, 3), **MODE)
    feats_pre = finalize_feature_sums(
        sums3, [(H >> s) ** 2 for s in range(3, 6)], 3)
    _, coarse3 = tref._pre_ranked(trefp, feats_pre, frames_q,
                                  tc.prescreen_pre, 0)
    sums2 = cuda_metric.coarse_feature_sums_redmean(
        *tref.coarse_inputs(ctx, cand8, lin, trefp))
    coarse2 = 100.0 - tref.score_from_features(finalize_feature_sums(
        sums2, [(H >> s) ** 2 for s in range(2, 6)], 2))
    kept = torch.isfinite(coarse3)
    assert int(kept.sum()) == tc.prescreen_pre
    np.testing.assert_allclose(coarse3[kept].numpy(), coarse2[kept].numpy(),
                               rtol=0, atol=RANK_TOL)
    # The kept rows are the best by the scale-3..5 score.
    pre = 100.0 - tref.score_from_features(feats_pre)
    assert pre[kept].max() <= pre[~kept].min()


@pytest.mark.parametrize("h,w", [(64, 64), (64, 40)])
def test_three_level_slot_visits_match_jax(small_image, h, w):
    """`refine_slot_channel` with `prescreen_pre=16`: the JAX package's
    palette and map, and its error within 5e-4 (tests/test_torch_refine.py),
    at a geometry kernels C and D take and one that goes through kernels E
    and B."""
    (js, jc, jrefp), (ts, tc, trefp) = _setup(small_image.tobytes(), h, w)
    assert tref._three_level(tc, 32, 1, h, w)
    for p, i, channel in [(0, 0, 0), (1, 2, 1), (0, 3, 2)]:
        want = jref.refine_slot_channel(js, jc, jrefp, p, i, channel)
        got = tref.refine_slot_channel(ts, tc, trefp, p, i, channel)
        np.testing.assert_array_equal(got.state.palette.numpy(),
                                      np.asarray(want.state.palette))
        np.testing.assert_array_equal(got.state.palette_map.numpy(),
                                      np.asarray(want.state.palette_map))
        assert abs(float(got.error) - float(want.error)) <= 5e-4
