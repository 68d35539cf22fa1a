"""The port's perceptual (CIEDE2000) path against the JAX package on the
CPU: Lab conversion, CIEDE2000, init, remap, the incremental distance
cache, kernel D's plain twin and one whole run.

Tolerances and why:
- Lab: within 1e-4 of the JAX values, and bit-equal for at least 99.8% of
  channels: the port takes the cube root as a float64 power rounded once,
  where XLA's CPU code calls glibc's ``powf``; they differ in the last bit
  for about 0.06% of channels (31614 of the 16.7M u8 colours).
- CIEDE2000: within 1e-4 (5.3e-5 was the largest difference over a million
  pairs), bit-equal for at least 80% of pairs: the port rounds correctly
  rounded float64 transcendentals, XLA uses its own float32 ones.
- Integer results (init artifacts, remaps, palettes, JSON bytes) are
  exact.
- Kernel D's twin against the Pallas kernel in interpret mode: 2e-4 on
  finalised features and on the distance planes (the TPU kernel's
  algebraic-hue formula differs from the standard one by up to 2e-4),
  with every pixel more than 1e-3 from a tie so that the two formulas
  cannot flip a win mask. Against the XLA chain the JAX package runs on
  the CPU (standard formula): 1e-4 on the distance planes and 5e-5 on
  the features.
- Step errors of a whole run within 1e-4, as for the red-mean path.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import _test_image
from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import init as tinit
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core import refine as tref
from snesimage_torch.core.state import new_state as t_new_state
from snesimage_torch.core.state import pyramid_from_numpy, state_from_numpy
from snesimage_torch.io.json_out import state_to_json as t_json
from snesimage_torch.ops import color as tcolor
from snesimage_torch.ops import cuda_metric
from snesimage_torch.ops import remap as tremap
from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import init as jinit
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core import refine as jref
from snesimage_tpu.core.state import new_state as j_new_state
from snesimage_tpu.io.json_out import state_to_json as j_json
from snesimage_tpu.ops import color as jcolor
from snesimage_tpu.ops import pallas_metric as pm
from snesimage_tpu.ops import pallas_prescreen as pp
from snesimage_tpu.ops import remap as jremap
from snesimage_tpu.ops import ssimulacra2 as jss

# chip_smoke.INIT_HASH_PERCEPTUAL: the JAX package's CPU value for the
# perceptual balanced config on bench._test_image(0).
INIT_HASH_PERCEPTUAL = (
    "80f887a8fcf9a066bc4a0917f65e84c987d136dcaf1d19466cb8d5413e73a7f9"
)
PERCEPTUAL = dict(
    subpalette_count=8, subpalette_size=15, max_steps=8, converge_tol=0.0,
    seed=0, schedule="channel", prescreen=8, prescreen_full=4,
    channel_explore=16, accept_margin=0.005, perceptual_palettes=True,
)
SMALL = dict(
    subpalette_count=2, subpalette_size=4, width=64, height=64, max_steps=2,
    converge_tol=0.0, schedule="channel", prescreen=8, prescreen_full=4,
    channel_explore=0, accept_margin=0.005, perceptual_palettes=True,
)
LAB_TOL = 1e-4
DE_TOL = 1e-4
FEATURE_TOL = 2e-4
H = W = 64
BIG = 3.0e38


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _init_hash(state) -> str:
    h = hashlib.sha256()
    for a in (state.tile_palettes, state.palette, state.palette_map):
        h.update(np.ascontiguousarray(_np(a), dtype=np.int32).tobytes())
    return h.hexdigest()


def _colors(rng, n):
    """All 256 greys, then n random 8-bit colours."""
    greys = np.repeat(np.arange(256, dtype=np.int32)[:, None], 3, axis=1)
    return np.concatenate([greys, rng.integers(0, 256, (n, 3))]).astype(
        np.int32)


def test_srgb_u8_to_lab_matches_jax(rng):
    rgb = _colors(rng, 200_000)
    want = np.asarray(jax.jit(jcolor.srgb_u8_to_lab)(jnp.asarray(rgb)))
    got = _np(tcolor.srgb_u8_to_lab(torch.from_numpy(rgb)))
    np.testing.assert_allclose(got, want, rtol=0, atol=LAB_TOL)
    assert (got == want).mean() >= 0.998
    np.testing.assert_array_equal(got[:256, 1:] == 0, want[:256, 1:] == 0)
    # The way back, with Rust's rounding: every u8 colour returns exactly.
    np.testing.assert_array_equal(
        _np(tcolor.lab_to_srgb_u8(torch.from_numpy(got))), rgb)
    lab = np.stack([rng.uniform(0, 100, 65536), rng.uniform(-110, 110, 65536),
                    rng.uniform(-110, 110, 65536)], -1).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tcolor.lab_to_srgb_u8(torch.from_numpy(lab))),
        np.asarray(jax.jit(jcolor.lab_to_srgb_u8)(jnp.asarray(lab))),
    )


def test_ciede2000_matches_jax(rng):
    n = 100_000
    t8 = _colors(rng, n)
    c8 = np.clip(rng.integers(0, 32, t8.shape) * 8 + 4, 0, 255).astype(
        np.int32)
    c8[:256] = t8[::-1][:256]  # grey pairs: zero chroma on both sides
    c8[256:1256] = t8[256:1256]  # identical colours: distance 0
    want = np.asarray(
        jax.jit(jcolor.ciede2000_srgb_u8)(jnp.asarray(t8), jnp.asarray(c8)))
    got = _np(tcolor.ciede2000_srgb_u8(torch.from_numpy(t8),
                                       torch.from_numpy(c8)))
    np.testing.assert_allclose(got, want, rtol=0, atol=DE_TOL)
    assert (got == want).mean() >= 0.8
    assert (got[256:1256] == 0).all()
    # Symmetric to the bit, so the distance cache (entry, target) and a
    # candidate's plane (target, candidate) agree.
    np.testing.assert_array_equal(
        _np(tcolor.ciede2000_srgb_u8(torch.from_numpy(c8),
                                     torch.from_numpy(t8))), got)


@pytest.mark.parametrize(
    "crop,c,s", [(False, 2, 4), (False, 1, 5), (True, 3, 7), (True, 4, 15)]
)
def test_perceptual_init_bit_equal_small(small_image, crop, c, s):
    """On small_image, or on a 64x64 crop of the bench image. Not every
    case agrees: the JAX package sums the k-means means as a float32
    matrix product whose order XLA picks, the port in float64, and on
    small_image at 3x7 one subpalette's k-means ends in another local
    optimum (ROADMAP fault class C-6; see
    test_lab_kmeans_matches_float64_reference)."""
    img = _test_image(0)[:64, :64] if crop else small_image
    kw = dict(SMALL, subpalette_count=c, subpalette_size=s)
    tc, jc = TConfig(**kw), JConfig(**kw)
    ta = tinit.assign_tiles(t_new_state(img, tc, "cpu"), tc)
    ja = jinit.assign_tiles(j_new_state(img, jc), jc)
    np.testing.assert_array_equal(_np(ta.tile_palettes), _np(ja.tile_palettes))
    np.testing.assert_array_equal(_np(ta.palette), _np(ja.palette))
    tr = tinit.recalculate_palettes(ta, tc)
    jr = jinit.recalculate_palettes(ja, jc)
    np.testing.assert_array_equal(_np(tr.palette), _np(jr.palette))
    t = tpipe.cluster(tpipe.initialize(t_new_state(img, tc, "cpu"), tc), tc)
    j = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    assert _init_hash(t) == _init_hash(j)


def _kmeans_f64(data, mask, k, max_iter=100, tol=1e-6):
    """Lloyd's k-means in float64 with plain squared distances: the
    contract of ops/kmeans.py (the first k valid points start, ties to the
    lower centre, empty clusters keep theirs), sharing none of its code."""
    data = data.astype(np.float64)
    first = np.flatnonzero(mask)[:k]
    centers = np.zeros((k, data.shape[1]))
    centers[:len(first)] = data[first]
    for _ in range(max_iter):
        assign = np.argmin(((data[:, None] - centers[None]) ** 2).sum(-1), 1)
        new = centers.copy()
        for j in range(k):
            if (mask & (assign == j)).any():
                new[j] = data[mask & (assign == j)].mean(0)
        shift = ((new - centers) ** 2).sum(-1).max()
        centers = new
        if shift <= tol:
            break
    return centers


@pytest.mark.parametrize(
    "crop,c,s", [(False, 2, 4), (False, 1, 5), (True, 3, 7), (True, 4, 15),
                 (False, 3, 7)]
)
def test_lab_kmeans_matches_float64_reference(small_image, crop, c, s):
    """The Lab pixel k-means of `recalculate_palettes` against a float64
    NumPy k-means of the same points: the port's palettes equal it in every
    case. On small_image at 3x7 (ROADMAP C-6) the JAX package's float32
    sums part from it in subpalette 0 alone, so that package drifts, not
    the port."""
    img = _test_image(0)[:64, :64] if crop else small_image
    kw = dict(SMALL, subpalette_count=c, subpalette_size=s)
    tc, jc = TConfig(**kw), JConfig(**kw)
    ta = tinit.assign_tiles(t_new_state(img, tc, "cpu"), tc)
    rgb, opaque = tinit.tile_pixels(ta, tc)
    lab = _np(tcolor.srgb_u8_to_lab(rgb)).reshape(-1, 3)
    tile_of_pixel = np.repeat(_np(ta.tile_palettes).reshape(-1), 64)
    want = np.stack([
        _np(tcolor.lab_to_srgb_u8(torch.from_numpy(_kmeans_f64(
            lab, (tile_of_pixel == p) & _np(opaque).reshape(-1), s,
        ).astype(np.float32)))) // 8
        for p in range(c)
    ])
    np.testing.assert_array_equal(
        _np(tinit.recalculate_palettes(ta, tc).palette), want)
    ja = jinit.assign_tiles(j_new_state(img, jc), jc)
    drift = [not np.array_equal(row, want[p]) for p, row in enumerate(
        np.asarray(jinit.recalculate_palettes(ja, jc).palette))]
    assert drift == [(crop, c, s, p) == (False, 3, 7, 0) for p in range(c)]


def test_perceptual_init_hash_pinned_bench_image():
    """initialize + cluster on the bench image with the perceptual balanced
    config: both packages give the hash chip_smoke.py checks on the card."""
    import chip_smoke

    img = _test_image(0)
    tc, jc = TConfig(**PERCEPTUAL), JConfig(**PERCEPTUAL)
    t = tpipe.cluster(tpipe.initialize(t_new_state(img, tc, "cpu"), tc), tc)
    j = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    assert _init_hash(j) == INIT_HASH_PERCEPTUAL
    assert _init_hash(t) == INIT_HASH_PERCEPTUAL
    assert chip_smoke.INIT_HASH_PERCEPTUAL == INIT_HASH_PERCEPTUAL
    assert chip_smoke.PERCEPTUAL == PERCEPTUAL


@pytest.mark.parametrize("c,s", [(2, 4), (4, 15)])
def test_remap_undithered_perceptual_exact(small_image, rng, c, s):
    tp = rng.integers(0, c, (H // 8, W // 8)).astype(np.int32)
    pal = rng.integers(0, 32, (c, s, 3)).astype(np.int32)
    pal[:, -1] = pal[:, 0]  # duplicate entries: the lowest index wins
    rgb = small_image[..., :3].astype(np.int32)
    alpha = small_image[..., 3].astype(np.int32)
    got = tremap.remap_undithered(
        *(torch.from_numpy(a) for a in (rgb, alpha, tp, pal)), True)
    want = jremap.remap_undithered(
        *(jnp.asarray(a) for a in (rgb, alpha, tp, pal)), True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _prepped(small_image):
    """The JAX package's perceptual state after init and its pyramid, and
    the port's copies of them."""
    jc, tc = JConfig(**SMALL), TConfig(**SMALL)
    js = jpipe.cluster(jpipe.initialize(j_new_state(small_image, jc), jc), jc)
    jrefp = jref.make_reference_pyramid(js)
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          "cpu")
    trefp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in s) for s in jrefp), "cpu")
    return (js, jc, jrefp), (ts, tc, trefp)


def test_incremental_matches_full_remap_perceptual(small_image, rng):
    """The port's version of tests/test_refine.py
    test_incremental_matches_full_remap_perceptual: a visit's cache update
    and palette map, built from kernel D's distance plane of the colour
    (its twin here), equal a full recompute with the colour set, and its
    scored candidates' errors equal the full-remap state's frame error."""
    (js, jc, _), (ts, tc, trefp) = _prepped(small_image)
    d_all = tref.compute_d_all(ts, tc)
    assert d_all.dtype == torch.float32
    np.testing.assert_allclose(_np(d_all), np.asarray(jref.compute_d_all(js, jc)),
                               rtol=0, atol=DE_TOL)
    p, i = 0, 1
    cand5 = rng.integers(0, 32, (40, 3)).astype(np.int32)
    cand5[0] = _np(ts.palette)[p, i]
    errors, final_map, new_d_all = tref._undithered_machinery(
        ts, tc, p, i, d_all)
    errs, dists = errors(trefp, torch.from_numpy(cand5))
    errs = _np(errs)
    assert np.isfinite(errs).sum() == tc.prescreen_full
    for k in [*np.flatnonzero(np.isfinite(errs)), 0, 1, 2]:
        dist = dists(torch.tensor([k]))[0]
        pal = ts.palette.clone()
        pal[p, i] = torch.from_numpy(cand5[k])
        full = tref.full_remap(ts.replace(palette=pal), tc)
        np.testing.assert_array_equal(_np(final_map(dist)),
                                      _np(full.palette_map))
        np.testing.assert_array_equal(_np(new_d_all(dist)),
                                      _np(tref.compute_d_all(full, tc)))
        if np.isfinite(errs[k]):
            exact = float(tref.frame_error_fused(full, tc, trefp))
            assert abs(errs[k] - exact) <= 1e-4


def _coarse_ciede_args(rng, refp, b):
    """Kernel D's operands at 64x64, with every pixel's threshold more than
    1e-3 from every candidate's distance (no tie either formula could
    flip)."""
    tlab = np.array(jcolor.srgb_u8_to_lab(
        jnp.asarray(rng.integers(0, 256, (H, W, 3)).astype(np.int32))))
    cand8 = rng.integers(0, 256, (b, 3)).astype(np.int32)
    cand8[-1] = cand8[0]  # a duplicate candidate: identical sums
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
    bvalm[:8] = -BIG  # masked rows: no candidate wins
    adj = rng.integers(0, 2, (H, W)).astype(np.int32)
    lnc = rng.random((3, H, W)).astype(np.float32)
    ml = np.where(bvalm > 0, lnc, 0.0).astype(np.float32)
    ds4 = lnc.reshape(3, H // 4, 4, W // 4, 4).mean(axis=(2, 4))
    flat = tuple(
        np.ascontiguousarray(np.moveaxis(a, -1, 0))
        for s in range(2, 6) for a in refp[s]
    )
    return (np.ascontiguousarray(np.moveaxis(tlab, -1, 0)), cand_lab, cand_lin,
            bvalm, adj, ml, ds4.astype(np.float32)), flat


@pytest.fixture
def refp(rng):
    ref = rng.integers(0, 256, (H, W, 3)).astype(np.int32)
    return tuple(tuple(np.asarray(a) for a in s)
                 for s in jss.reference_pyramid(jnp.asarray(ref)))


def _twin(args, flat):
    before = cuda_metric.coarse_feature_sums_ciede.launches
    sums, dcand = cuda_metric.coarse_feature_sums_ciede(
        *(torch.from_numpy(a) for a in args),
        tuple(torch.from_numpy(a) for a in flat))
    assert cuda_metric.coarse_feature_sums_ciede.launches == before
    return sums, dcand


def test_coarse_feature_sums_ciede_twin_vs_pallas(rng, refp):
    b = 6
    args, flat = _coarse_ciede_args(rng, refp, b)
    sizes = [(H >> s) ** 2 for s in range(2, 6)]
    want_sums, want_d = pm.coarse_feature_sums_ciede(
        *(jnp.asarray(a) for a in args), tuple(jnp.asarray(a) for a in flat),
        interpret=True)
    sums, dcand = _twin(args, flat)
    assert sums.shape == (b, 12, 6) and dcand.shape == (b, H, W)
    np.testing.assert_allclose(_np(dcand), np.asarray(want_d), rtol=0,
                               atol=FEATURE_TOL)
    got = _np(finalize_feature_sums(sums, sizes, 2))
    want = np.asarray(jss.finalize_feature_sums(want_sums, sizes, 2))
    np.testing.assert_allclose(got, want, rtol=FEATURE_TOL, atol=FEATURE_TOL)
    np.testing.assert_array_equal(got[-1], got[0])


def test_coarse_feature_sums_ciede_twin_vs_xla_chain(rng, refp):
    """The chain the JAX package runs for kernel D off the TPU:
    pooled_wins_ciede with color.ciede2000, the coarse frames, then
    fused_scale_feature_block."""
    b = 6
    args, flat = _coarse_ciede_args(rng, refp, b)
    tlab, cand_lab, cand_lin, bvalm, adj, ml, ds4 = (jnp.asarray(a)
                                                     for a in args)
    pooled, want_d = pp.pooled_wins_ciede(
        tlab, cand_lab, bvalm, adj, ml,
        lambda: jax.vmap(lambda c: jcolor.ciede2000(
            jnp.moveaxis(tlab, 0, -1), c))(cand_lab))
    frames = (cand_lin[:, :, None, None] * pooled[:, :1]
              - pooled[:, 1:4]) / 16.0 + ds4[None]
    want = np.asarray(jss.fused_scale_feature_block(
        tuple(tuple(jnp.asarray(a) for a in s) for s in refp), frames, 2, 4))
    sums, dcand = _twin(args, flat)
    np.testing.assert_allclose(_np(dcand), np.asarray(want_d), rtol=0,
                               atol=DE_TOL)
    got = _np(finalize_feature_sums(sums, [(H >> s) ** 2 for s in range(2, 6)],
                                    2))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_run_fused_perceptual_matches_jax(small_image):
    """No explore draws: the same palette and JSON bytes, step errors within
    1e-4, kernel D's twin in every visit and kernel C's in none."""
    tc, jc = TConfig(**SMALL), JConfig(**SMALL)
    before = (cuda_metric.coarse_feature_sums_ciede.launches,
              cuda_metric.coarse_feature_sums_redmean.launches)
    state, errors, info = tpipe.run_fused(small_image, tc, device="cpu")
    assert (cuda_metric.coarse_feature_sums_ciede.launches,
            cuda_metric.coarse_feature_sums_redmean.launches) == before
    jstate, jerrors, jinfo = jpipe.run_fused(small_image, jc)
    np.testing.assert_array_equal(_np(state.palette), np.asarray(jstate.palette))
    assert t_json(state, tc) == j_json(jstate, jc)
    assert len(errors) == len(jerrors) == 2
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=1e-4)
    assert abs(info["final_error"] - jinfo["final_error"]) <= 1e-4
    init = tpipe.cluster(tpipe.initialize(
        t_new_state(small_image, tc, "cpu"), tc), tc)
    assert not torch.equal(state.palette, init.palette)
    assert errors[1] <= errors[0]
