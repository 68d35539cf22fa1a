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
through a sweep, compared at its end, stay within 1e-4."""

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
