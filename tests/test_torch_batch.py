"""The port's image batch (snesimage_torch/parallel/batch.py) against the
JAX package's on the CPU, at 64x64 with 2 subpalettes of 3 colours.

The JAX side runs `batched_run` without a mesh (its kernels take their
plain XLA path on the CPU); its results are shared by the tests through
module-scoped fixtures. Trajectories are compared where no random draw
enters: the channel schedule with explore off, and NES sweeps. A batch of
the port equals its images' single runs bit for bit, and a batch of one
equals `run_fused` also with explore draws, because row n of a visit's
draws belongs to image n.
"""

import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core.state import new_state as t_new_state
from snesimage_torch.parallel import batch as tbatch
from snesimage_torch.testing import bench_image, single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.parallel import batch as jbatch

SIZE = 64
GEOMETRY = dict(subpalette_count=2, subpalette_size=3, width=SIZE,
                height=SIZE, max_steps=2, seed=0)
MODES = {
    "channel": dict(GEOMETRY, schedule="channel", prescreen=8,
                    prescreen_full=2, channel_explore=0, accept_margin=0.005),
    "nes": dict(GEOMETRY, nes=True),
}


@pytest.fixture(scope="module")
def images():
    """Three 64x64 crops of the bench image. Seeds 0, 1 and 4: the crop of
    seed 2 has a NES visit whose two best colours score within rounding of
    each other, and the two packages keep different ones (ROADMAP C-9)."""
    return np.stack([np.ascontiguousarray(bench_image(s)[64:128, 32:96])
                     for s in (0, 1, 4)])


@pytest.fixture(scope="module")
def torch_thread():
    with single_torch_thread():
        yield


@pytest.fixture(scope="module")
def jax_runs(images):
    out = {}
    for mode, kw in MODES.items():
        states, errors = jbatch.batched_run(images, JConfig(**kw))
        out[mode] = ({f: np.asarray(getattr(states, f))
                      for f in ("tile_palettes", "palette", "palette_map")},
                     errors)
    return out


@pytest.fixture(scope="module")
def port_runs(images, torch_thread):
    return {mode: tbatch.batched_run(images, TConfig(**kw), device="cpu",
                                     image_errors=True)
            for mode, kw in MODES.items()}


@pytest.mark.parametrize("perceptual", [False, True])
def test_init_artifacts_exact(images, perceptual, torch_thread):
    """binit + bcluster give every image the JAX package's init artifacts,
    and each image's own single-image init, bit for bit."""
    kw = dict(MODES["channel"], perceptual_palettes=perceptual)
    tc, jc = TConfig(**kw), JConfig(**kw)
    got = tbatch.bcluster(tbatch.binit(
        tbatch.make_batched_states(images, tc, "cpu"), tc), tc)
    want = jbatch.bcluster(jbatch.binit(
        jbatch.make_batched_states(images, jc), jc), jc)
    for f in ("tile_palettes", "palette", "palette_map"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for n in range(len(images)):
        one = tpipe.cluster(tpipe.initialize(
            t_new_state(images[n], tc, "cpu"), tc), tc)
        for f in ("tile_palettes", "palette", "palette_map"):
            assert torch.equal(getattr(got, f)[n], getattr(one, f)), f


@pytest.mark.parametrize("mode", list(MODES))
def test_batched_run_matches_jax(jax_runs, port_runs, mode):
    """Mean step errors within 1e-3 (as tests/test_torch_pipeline.py holds
    single runs), and every image's palette and map equal: no visit of
    these fixtures is decided by a near-tie (ROADMAP C-9)."""
    want, jerrors = jax_runs[mode]
    states, errors, per_image = port_runs[mode]
    assert len(errors) == len(jerrors) == 2
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=1e-3)
    np.testing.assert_allclose(errors, per_image.mean(1), rtol=1e-6)
    for f in ("tile_palettes", "palette", "palette_map"):
        np.testing.assert_array_equal(getattr(states, f).numpy(), want[f], f)


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_equals_single_runs(images, port_runs, mode, torch_thread):
    """Each image of a port batch is its own `run_fused`, bit for bit."""
    states, _, per_image = port_runs[mode]
    config = TConfig(**MODES[mode])
    for n in range(len(images)):
        state, errors, _ = tpipe.run_fused(images[n], config, device="cpu")
        np.testing.assert_array_equal(per_image[:, n],
                                      np.asarray(errors, np.float32))
        assert torch.equal(states.palette[n], state.palette)
        assert torch.equal(states.palette_map[n], state.palette_map)


@pytest.mark.parametrize("change", [
    dict(channel_explore=4),
    dict(channel_explore=4, perceptual_palettes=True, prescreen_full=4),
    dict(schedule="reference", max_steps=1, random_trials=8),
    dict(dither=True, max_steps=1, width=32, height=32),
])
def test_batch_of_one_equals_run_fused(images, change, torch_thread):
    """N = 1 draws what `run_fused` draws and gives its errors, palette and
    map to the bit, explore and random draws included."""
    config = TConfig(**dict(MODES["channel"], **change))
    img = np.ascontiguousarray(images[1][:config.height, :config.width])
    states, errors, per_image = tbatch.batched_run(
        img[None], config, device="cpu", image_errors=True)
    state, want, _ = tpipe.run_fused(img, config, device="cpu")
    np.testing.assert_array_equal(per_image[:, 0],
                                  np.asarray(want, np.float32))
    assert torch.equal(states.palette[0], state.palette)
    assert torch.equal(states.palette_map[0], state.palette_map)


def test_converge_tol_stops_at_the_jax_step(images, torch_thread):
    """With a tolerance the batch stops at the step the JAX package's
    `_plateau_stop` stops at, on the mean error."""
    kw = dict(MODES["channel"], max_steps=6, converge_tol=1.0)
    _, jerrors = jbatch.batched_run(images[:2], JConfig(**kw))
    _, errors = tbatch.batched_run(images[:2], TConfig(**kw), device="cpu")
    assert 1 < len(jerrors) < 6
    assert len(errors) == len(jerrors)
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=1e-3)


def _clustered_image(rng, h=64, w=64):
    """tests/test_kmeans.py's fixture: well-separated colour quadrants with
    noise and one transparent tile."""
    img = np.zeros((h, w, 4), np.uint8)
    bases = np.array([[220, 40, 40], [40, 220, 40], [40, 40, 220],
                      [220, 220, 40]])
    for q, (y0, x0) in enumerate([(0, 0), (0, w // 2), (h // 2, 0),
                                  (h // 2, w // 2)]):
        blk = bases[q] + rng.integers(-12, 13, (h // 2, w // 2, 3))
        img[y0:y0 + h // 2, x0:x0 + w // 2, :3] = blk.clip(0, 255)
    img[..., 3] = 255
    img[0:8, 0:8, 3] = 0
    return img


@pytest.mark.parametrize("perceptual,nes",
                         [(False, False), (True, False), (False, True)])
def test_init_pipeline_matches_cpp_oracle(perceptual, nes, torch_thread):
    """The port's twin of tests/test_kmeans.py
    `test_init_pipeline_matches_cpp_oracle`, on each image of a batch of
    two: tile assignment, flat fill, pixel k-means and the undithered remap
    against the independent scalar C++ oracle (native/oracle.cpp)."""
    from snesimage_tpu.native import (
        oracle_assign_tiles,
        oracle_recalculate,
        oracle_remap,
    )

    rng = np.random.default_rng(7)
    imgs = np.stack([_clustered_image(rng) for _ in range(2)])
    config = TConfig(subpalette_count=4, subpalette_size=3, width=64,
                     height=64, perceptual_palettes=perceptual, nes=nes)
    states = tbatch.binit(tbatch.make_batched_states(imgs, config, "cpu"),
                          config)
    clustered = tbatch.bcluster(states, config)
    for n, img in enumerate(imgs):
        tp_o, pal_o = oracle_assign_tiles(img, 4, 3, perceptual, nes)
        np.testing.assert_array_equal(states.tile_palettes[n].numpy(), tp_o)
        np.testing.assert_array_equal(states.palette[n].numpy(), pal_o)
        pal2_o = oracle_recalculate(img, tp_o, 4, 3, perceptual, nes)
        got = clustered.palette[n].numpy()
        if perceptual:
            # The oracle's float64 Lab can flip near-tie cluster members;
            # the 5-bit centres land within one code (as in the original).
            assert np.abs(got - pal2_o).max() <= 1
        else:
            np.testing.assert_array_equal(got, pal2_o)
            want_map = oracle_remap(img, tp_o, pal2_o, dither=False,
                                    perceptual=False)
            np.testing.assert_array_equal(
                clustered.palette_map[n].numpy(), want_map)


@pytest.mark.parametrize("path", ["batch", "portfolio"])
def test_gated_config_runs_ungated(images, torch_thread, path):
    """The twin of tests/test_parallel.py `test_batched_run_gated_config`
    and `test_portfolio_gated_config_runs`: a gated config (the `fast`
    recipe's gate_margin and tol) runs as a batch and as a portfolio, and
    scores exactly there, as the JAX package's batched paths do: its steps,
    errors and states equal those of the same config with the gate off."""
    kw = dict(GEOMETRY, max_steps=2, schedule="channel", prescreen=8,
              prescreen_full=2, gate_margin=0.01, converge_tol=0.5)
    gated, ungated = TConfig(**kw), TConfig(**dict(kw, gate_margin=0.0))
    assert tpipe.refine._gating_active(gated)
    if path == "batch":
        got = tbatch.batched_run(images[:2], gated, device="cpu")
        want = tbatch.batched_run(images[:2], ungated, device="cpu")
    else:
        got = tbatch.portfolio_run(images[0], gated, 2, device="cpu")
        want = tbatch.portfolio_run(images[0], ungated, 2, device="cpu")
    assert 1 <= len(got[-1]) <= 2 and got[-1] == want[-1]
    assert torch.equal(got[0].palette, want[0].palette)
    assert torch.equal(got[0].palette_map, want[0].palette_map)
