"""The port's slot visit and channel sweep against the JAX package's, from
the same state (the JAX package's, carried across as numpy arrays) on the
CPU. Candidates are made with numpy and fed to both: the two packages
draw explore candidates from different generators by construction.

The prescreen keeps the same candidates (the same finite/inf pattern), and
integer results (palette maps, distance caches, palettes) are exact. A
visit's candidate errors agree within 5e-4 (3e-6 relative at errors near
165): the two packages blur in float32 with other rounding (4e-7
relative), and the SSIM variance terms amplify that to 1.4e-5 relative
in the features, measured from identical XYB input. Errors carried
through a sweep, compared at its end, stay within 1e-4.

The dithered visit is compared the same way at 32x32: the palette maps of
all candidates are equal (the wavefront twin equals the JAX scan), the
same candidates stay finite, and their errors agree within 1e-3 (up to
4.9e-4 measured, 3.7e-6 relative at errors near 132): at 32x32 a scale
holds a quarter of the pixels of the 64x64 fixture, and the variance
terms' rounding weighs more in the mean."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import refine as tref
from snesimage_torch.core.state import pyramid_from_numpy, state_from_numpy
from snesimage_torch.ops.color import expand_5bit_to_8bit, red_mean_sq_scaled
from snesimage_torch.testing import single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core import refine as jref
from snesimage_tpu.core.state import new_state as j_new_state

VISIT_ERR_TOL = 5e-4
ERR_TOL = 1e-4
CFG = dict(
    subpalette_count=2, subpalette_size=4, width=64, height=64,
    schedule="channel", prescreen=8, prescreen_full=2, channel_explore=16,
    accept_margin=0.005,
)
# Colours far from every pixel of small_image's palettes: most of them win
# no pixel in a visit, so they score exactly alike and tie.
FAR = np.array(
    [[31, 0, 31], [0, 31, 31], [31, 31, 0], [0, 0, 31], [31, 0, 0],
     [0, 31, 0], [0, 0, 0], [31, 31, 31]], dtype=np.int32,
)


@lru_cache(maxsize=None)
def _setup(image_bytes: bytes, explore: int):
    """(JAX state, config, pyramid) after initialize + cluster, and the
    port's copies of them."""
    img = np.frombuffer(image_bytes, np.uint8).reshape(64, 64, 4)
    kw = dict(CFG, channel_explore=explore)
    jc, tc = JConfig(**kw), TConfig(**kw)
    js = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    jrefp = jref.make_reference_pyramid(js)
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          "cpu")
    trefp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in s) for s in jrefp), "cpu"
    )
    return (js, jc, jrefp), (ts, tc, trefp)


def _candidates(palette, p, i, channel, explore_rows):
    sweep = np.repeat(palette[p, i][None], 32, axis=0)
    sweep[:, channel] = np.arange(32)
    return np.concatenate([sweep, explore_rows]).astype(np.int32)


@pytest.mark.parametrize(
    "p,i,channel,ties", [(0, 0, 0, False), (1, 2, 1, False), (0, 3, 2, True),
                         (1, 0, 0, True)]
)
def test_visit_parity(small_image, p, i, channel, ties):
    (js, jc, jrefp), (ts, tc, trefp) = _setup(small_image.tobytes(), 16)
    rng = np.random.default_rng(100 * p + 10 * i + channel)
    explore = rng.integers(0, 32, (16, 3))
    if ties:
        explore[::2] = FAR  # eight far colours, most of them no-win ties
    cand5 = _candidates(np.asarray(js.palette), p, i, channel, explore)

    d_all_j = jref.compute_d_all(js, jc)
    j_err, j_map, j_dall = jref._undithered_machinery(js, jc, p, i, d_all_j)
    want = np.asarray(j_err(jrefp, jnp.asarray(cand5), carried_base=True))

    d_all_t = tref.compute_d_all(ts, tc)
    np.testing.assert_array_equal(d_all_t.numpy(), np.asarray(d_all_j))
    t_err, t_map, t_dall = tref._undithered_machinery(ts, tc, p, i, d_all_t)
    got, dists = t_err(trefp, torch.from_numpy(cand5), carried_base=True)
    got = got.numpy()

    ctx = tref.slot_context(ts, tc, p, i, d_all_t)
    c8 = expand_5bit_to_8bit(torch.from_numpy(cand5))
    np.testing.assert_array_equal(dists(torch.arange(len(c8))).numpy(),
                                  ctx.cand_dist(c8).numpy())
    if ties:
        no_win = [
            not bool((ctx.affected & ctx.opaque & ctx.wins(
                red_mean_sq_scaled(ctx.target_u8, c))).any())
            for c in c8
        ]
        assert sum(no_win) >= 4  # the case does hold tied candidates
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got).sum() == jc.prescreen_full
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=0, atol=VISIT_ERR_TOL)

    # The port's final_map and new_d_all take the colour's distance plane.
    for color in [cand5[int(np.argmin(want))], cand5[5], FAR[0]]:
        dist = ctx.cand_dist(expand_5bit_to_8bit(torch.from_numpy(color)))
        np.testing.assert_array_equal(
            t_map(dist).numpy(), np.asarray(j_map(jnp.asarray(color))),
        )
        np.testing.assert_array_equal(
            t_dall(dist).numpy(), np.asarray(j_dall(jnp.asarray(color))),
        )


@pytest.mark.parametrize("seed", [0, 1])
def test_smallest_orders_ties_like_top_k(seed):
    x = np.random.default_rng(seed).integers(0, 5, 48).astype(np.float32)
    _, want = jax.lax.top_k(-jnp.asarray(x), 8)
    got = tref._smallest(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_one_sweep_parity(small_image):
    """A channel sweep with explore off: the same palette and palette map,
    and the carried error within 1e-4."""
    (js, jc, jrefp), (ts, tc, trefp) = _setup(small_image.tobytes(), 0)
    want = jref.sweep_channel(js, jc, jrefp)
    state, err = tref.sweep_channel(ts, tc, trefp)
    np.testing.assert_array_equal(state.palette.numpy(),
                                  np.asarray(want.state.palette))
    np.testing.assert_array_equal(state.palette_map.numpy(),
                                  np.asarray(want.state.palette_map))
    assert not np.array_equal(state.palette.numpy(), np.asarray(js.palette))
    assert abs(float(err) - float(want.error)) <= ERR_TOL
    exact = float(tref.frame_error_fused(state, tc, trefp))
    assert abs(exact - float(err)) <= ERR_TOL


def test_frame_error_fused_parity(small_image):
    (js, jc, jrefp), (ts, tc, trefp) = _setup(small_image.tobytes(), 0)
    want = float(jref.frame_error_fused(js, jc, jrefp))
    got = tref.frame_error_fused(ts, tc, trefp)
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - want) <= ERR_TOL


DITHER_VISIT_ERR_TOL = 1e-3


@pytest.fixture
def one_torch_thread():
    with single_torch_thread():
        yield


@lru_cache(maxsize=None)
def _setup_dithered(image_bytes: bytes, perceptual: bool):
    """`_setup` for a 32x32 crop with dithering, in either distance mode."""
    img = np.frombuffer(image_bytes, np.uint8).reshape(64, 64, 4)
    img = np.ascontiguousarray(img[:32, :32])
    kw = dict(CFG, width=32, height=32, dither=True,
              perceptual_palettes=perceptual,
              prescreen_full=4 if perceptual else 2)
    jc, tc = JConfig(**kw), TConfig(**kw)
    js = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    jrefp = jref.make_reference_pyramid(js)
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          "cpu")
    trefp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in s) for s in jrefp), "cpu"
    )
    return (js, jc, jrefp), (ts, tc, trefp)


@pytest.mark.parametrize(
    "perceptual,p,i,channel,ties",
    [(False, 1, 2, 1, False), (False, 0, 0, 0, True), (True, 1, 2, 1, False),
     (True, 1, 1, 0, True)],
)
def test_dithered_visit_parity(small_image, one_torch_thread, perceptual, p,
                               i, channel, ties):
    from snesimage_tpu.ops.dither import dither_candidates as j_candidates

    (js, jc, jrefp), (ts, tc, trefp) = _setup_dithered(small_image.tobytes(),
                                                       perceptual)
    rng = np.random.default_rng(100 * p + 10 * i + channel)
    explore = rng.integers(0, 32, (16, 3))
    if ties:
        explore[::2] = FAR  # far colours: no pixel maps to them, so they tie
    cand5 = _candidates(np.asarray(js.palette), p, i, channel, explore)

    want = np.asarray(jref._candidate_errors_dithered(
        js, jc, jrefp, p, i, jnp.asarray(cand5), carried_base=True))
    got, maps = tref._candidate_errors_dithered(ts, tc, trefp, p, i,
                                                torch.from_numpy(cand5))
    got = got.numpy()
    want_maps = np.asarray(j_candidates(
        js.rgb, js.alpha, js.tile_palettes, js.palette, p, i,
        jnp.asarray(cand5), perceptual))
    np.testing.assert_array_equal(maps.numpy(), want_maps)
    if ties:
        affected = np.repeat(np.repeat(np.asarray(js.tile_palettes) == p, 8, 0),
                             8, 1)
        unused = [not ((want_maps[b] == i) & affected).any()
                  for b in range(len(cand5))]
        assert sum(unused) >= 4  # the case does hold tied candidates
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got).sum() == jc.prescreen_full
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=0, atol=DITHER_VISIT_ERR_TOL)


@pytest.mark.parametrize("perceptual", [False, True])
def test_dithered_visit_accepts_the_candidate_row(small_image,
                                                  one_torch_thread,
                                                  perceptual):
    """A dithered visit that accepts keeps row `bidx` of the candidates'
    maps; that row equals a full dithered remap with the new palette, and
    a visit that rejects returns the incoming state."""
    _, (ts, tc, trefp) = _setup_dithered(small_image.tobytes(), perceptual)
    err = tref.frame_error_fused(ts, tc, trefp)
    accepted = 0
    for p, i, channel in [(0, 0, 0), (0, 1, 1), (1, 2, 2), (1, 3, 0)]:
        state, new_err, cache = tref._slot_channel(
            ts, tc, trefp, p, i, channel, None, err)
        assert cache is None
        if torch.equal(state.palette, ts.palette):
            assert torch.equal(state.palette_map, ts.palette_map)
            assert float(new_err) == float(err)
            continue
        accepted += 1
        assert float(new_err) < float(err) - tc.accept_margin
        np.testing.assert_array_equal(
            state.palette_map.numpy(),
            tref.full_remap(state, tc).palette_map.numpy())
        exact = float(tref.frame_error_fused(state, tc, trefp))
        assert abs(exact - float(new_err)) <= ERR_TOL
    assert accepted >= 1
