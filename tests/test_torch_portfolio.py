"""The port's seed portfolio (snesimage_torch/parallel/batch.py
`portfolio_run`) on the CPU, against the JAX package's where no random
draw enters, at 64x64 with 2 subpalettes of 3 colours (dithered: 32x32).

The port's K seeds are a batch of K over one image whose image fields are
stride-0 views (`shared_states`); seed n draws row n of every visit's
draws, so its trajectories are not the JAX package's, and only degenerate
portfolios (every seed the same run) are compared with it.
"""

import logging

import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core import refine as tref
from snesimage_torch.core.state import (
    image_of,
    new_state,
    shared_states,
    shares_image,
)
from snesimage_torch.ops.cuda_dither import dither_remap_candidates
from snesimage_torch.ops.dither import dither_candidates
from snesimage_torch.ops.ssimulacra2 import shared_pyramid
from snesimage_torch.parallel import batch as tbatch
from snesimage_torch.testing import bench_image, single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.parallel import batch as jbatch

BASE = dict(subpalette_count=2, subpalette_size=3, width=64, height=64,
            max_steps=2, seed=0, schedule="channel", prescreen=8,
            prescreen_full=2, channel_explore=4, accept_margin=0.005)


@pytest.fixture(scope="module")
def image():
    return np.ascontiguousarray(bench_image(0)[64:128, 32:96])


@pytest.fixture(scope="module", autouse=True)
def torch_thread():
    with single_torch_thread():
        yield


@pytest.mark.parametrize("change", [
    dict(nes=True), dict(channel_explore=0), dict(schedule="reference"),
    dict(), dict(schedule="reference", nes=True),
])
def test_degenerate_detection_matches_jax(change):
    kw = dict(BASE, **change)
    assert (tbatch.portfolio_seeds_degenerate(TConfig(**kw))
            == jbatch.portfolio_seeds_degenerate(JConfig(**kw)))


def test_degenerate_portfolio_warns_and_matches_jax(image, caplog):
    """Explore off: every seed runs the same channel descent; both
    packages warn, and give the same seeds' finals and kept state."""
    kw = dict(BASE, channel_explore=0)
    with caplog.at_level(logging.WARNING):
        state, seed_errs, steps = tbatch.portfolio_run(
            image, TConfig(**kw), 2, device="cpu")
    assert "trajectories are identical" in caplog.text
    jstate, jseed_errs, jsteps = jbatch.portfolio_run(image, JConfig(**kw),
                                                      2)
    assert seed_errs[0] == seed_errs[1]
    np.testing.assert_allclose(seed_errs, np.asarray(jseed_errs), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(steps, jsteps, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(state.palette.numpy(),
                                  np.asarray(jstate.palette))
    np.testing.assert_array_equal(state.palette_map.numpy(),
                                  np.asarray(jstate.palette_map))


def test_two_seeds_draw_apart_and_the_best_is_kept(image):
    """ROADMAP C-13: with explore on, seed 0 and seed 1 draw different
    candidates and end apart; the kept state is the seed with the lowest
    final error, which is that state's own exact error."""
    config = TConfig(**BASE)
    state = tpipe.cluster(tpipe.initialize(new_state(image, config, "cpu"),
                                           config), config)
    seeds = shared_states(state, 3)
    assert shares_image(seeds)
    refp = shared_pyramid(tref.make_reference_pyramid(state), 3)
    gen = torch.Generator().manual_seed(0)
    draws = tref._draws(gen, (3,), config.channel_explore, "cpu")
    assert not torch.equal(draws[0], draws[1])
    seeds, errs = tpipe.optimize(seeds, config, refp=refp)
    assert not torch.equal(seeds.palette[0], seeds.palette[1])
    best, seed_errs, steps = tbatch.portfolio_run(image, config, 3,
                                                  device="cpu")
    np.testing.assert_array_equal(seed_errs, errs[-1].numpy())
    np.testing.assert_allclose(steps, errs.mean(-1).numpy(), rtol=1e-6)
    k = int(np.argmin(seed_errs))
    assert torch.equal(best.palette, seeds.palette[k])
    assert torch.equal(best.palette_map, seeds.palette_map[k])
    one_refp = tref.make_reference_pyramid(best)
    assert float(tref.frame_error_fused(best, config, one_refp)) == float(
        seed_errs.min())


def test_portfolio_of_one_is_run_fused(image):
    """K = 1 draws what `run_fused` draws: the same step errors and state,
    bit for bit."""
    config = TConfig(**BASE)
    state, seed_errs, steps = tbatch.portfolio_run(image, config, 1,
                                                   device="cpu")
    want, errors, info = tpipe.run_fused(image, config, device="cpu")
    assert steps == errors
    assert float(seed_errs[0]) == info["final_error"]
    assert torch.equal(state.palette, want.palette)
    assert torch.equal(state.palette_map, want.palette_map)


def test_dithered_portfolio_seed_maps_are_one_seed_twins(image):
    """A dithered K = 2 portfolio at 32x32: kernel G's twin over the two
    seed rows and the one shared image gives each seed the maps of a
    one-seed call, and each seed's final map is the full remap of its
    palette (the accepted candidate's row)."""
    img = np.ascontiguousarray(image[:32, :32])
    config = TConfig(**dict(BASE, width=32, height=32, dither=True,
                            max_steps=1))
    state = tpipe.cluster(tpipe.initialize(new_state(img, config, "cpu"),
                                           config), config)
    seeds = shared_states(state, 2)
    refp = shared_pyramid(tref.make_reference_pyramid(state), 2)
    seeds, _ = tpipe.optimize(seeds, config, refp=refp)
    assert not torch.equal(seeds.palette[0], seeds.palette[1])
    rgb, alpha, tiles = state.rgb, state.alpha, state.tile_palettes
    cand5 = torch.randint(0, 32, (2, 5, 3), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(3))
    maps = dither_remap_candidates(rgb, alpha, tiles, seeds.palette, 1, 2,
                                   cand5)
    for n in range(2):
        one = dither_candidates(rgb, alpha, tiles, seeds.palette[n], 1, 2,
                                cand5[n])
        assert torch.equal(maps[n], one)
        seed = image_of(seeds, n)
        assert torch.equal(tref.full_remap(seed, config).palette_map,
                           seed.palette_map)
