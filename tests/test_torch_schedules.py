"""The port's reference schedule, random visits and unprescreened scoring
against the JAX package on the CPU (tests/test_torch_nes.py holds NES mode).

A random visit's candidates come from the package's own generator, so the
JAX package's draws are handed to the port as `cand5`; the visit then scores
the current colour inside the batch (row 0), with and without a prescreen,
and the two packages agree on the pick and within 1e-5 of each error (9.5e-6
measured, 1.8e-3 at an error of 188; tests/test_torch_geometry.py says why,
and why the 40x24 image is the fixture's top-left corner). The schedule's
order of sweeps and its stop rule are pure Python and are compared with the
JAX package's selectors.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core import refine as tref
from snesimage_torch.core.state import (
    new_state,
    pyramid_from_numpy,
    state_from_numpy,
)
from snesimage_torch.models import presets as tpresets
from snesimage_torch.ops import ssimulacra2 as tss
from snesimage_torch.ops.color import expand_5bit_to_8bit, srgb_u8_to_linear
from snesimage_torch.ops.cuda_prescreen import pooled_wins_ciede
from snesimage_torch.testing import single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core import refine as jref
from snesimage_tpu.core.state import new_state as j_new_state
from snesimage_tpu.models import presets as jpresets
from snesimage_tpu.ops import ssimulacra2 as jss

VISIT_ERR_RTOL = 1e-5
FEATURE_TOL = 2e-4
ERR_TOL = 5e-4
SMALL = dict(subpalette_count=2, subpalette_size=4, width=64, height=64)
TRIALS = 24  # candidates of a random visit here (the default is 64)


@lru_cache(maxsize=None)
def _setup(image_bytes: bytes, items: tuple):
    """(JAX state, config, pyramid) after initialize + cluster for the
    config fields `items`, and the port's copies of them."""
    kw = dict(items)
    img = np.frombuffer(image_bytes, np.uint8).reshape(64, 64, 4)
    img = np.ascontiguousarray(img[:kw["height"], :kw["width"]])
    jc, tc = JConfig(**kw), TConfig(**kw)
    js = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    jrefp = jref.make_reference_pyramid(js)
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          "cpu")
    trefp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in s) for s in jrefp), "cpu")
    return (js, jc, jrefp), (ts, tc, trefp)


def _both(small_image, **kw):
    return _setup(small_image.tobytes(), tuple(sorted(kw.items())))


def _assert_same_state(state, jstate):
    for field in ("tile_palettes", "palette", "palette_map"):
        np.testing.assert_array_equal(getattr(state, field).numpy(),
                                      np.asarray(getattr(jstate, field)), field)


def _visit_frames(ts, tc, p, i, cand5):
    """(B, 3, H, W) frames of the candidates `cand5` of slot (p, i), from
    the port's distance planes (kernel F's twin in perceptual mode)."""
    ctx = tref.slot_context(ts, tc, p, i, tref.compute_d_all(ts, tc))
    cand8 = expand_5bit_to_8bit(cand5)
    if tc.perceptual_palettes:
        _, dist = pooled_wins_ciede(*tref.pooled_inputs(ctx, cand8))
    else:
        dist = ctx.cand_dist(cand8)
    return tref.candidate_frames(ctx, dist, srgb_u8_to_linear(cand8))


@pytest.mark.parametrize(
    "prescreen,prescreen_full,perceptual,width,height",
    [(8, 2, False, 64, 64), (0, 0, False, 64, 64), (8, 0, False, 64, 64),
     (8, 2, False, 40, 24), (0, 0, True, 40, 24)],
)
def test_slot_random_with_the_jax_draws(small_image, prescreen, prescreen_full,
                                        perceptual, width, height):
    """A random visit on draws of the JAX package's generator, the current
    colour scored inside the batch as row 0: the same rows stay finite, row
    0 among them, errors within 1e-5 of their value, and the port keeps the
    colour that the JAX package's rule keeps on its own errors."""
    (js, jc, jrefp), (ts, tc, trefp) = _both(
        small_image, **dict(SMALL, width=width, height=height,
                            prescreen=prescreen, prescreen_full=prescreen_full,
                            perceptual_palettes=perceptual,
                            random_trials=TRIALS))
    p, i = 1, 2
    cand5 = np.array(jax.random.randint(
        jax.random.key(4), (TRIALS, 3), 0, 32, dtype=jnp.int32))
    current = np.asarray(js.palette)[p, i]
    batch = np.concatenate([current[None], cand5])

    j_err = jref._undithered_machinery(js, jc, p, i)[0]
    want = np.asarray(j_err(jrefp, jnp.asarray(batch), carried_base=False))
    t_err = tref._undithered_machinery(ts, tc, p, i)[0]
    got, _ = t_err(trefp, torch.from_numpy(batch), carried_base=False)
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got[0])
    finite = np.isfinite(got).sum()
    if not prescreen:
        assert finite == len(batch)
    else:
        assert finite == 1 + (prescreen_full or prescreen)
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=VISIT_ERR_RTOL, atol=0)

    # The visit's own frames through both packages' metric: features within
    # 2e-4, so the tolerance on the scores hides no feature error; without a
    # prescreen the JAX package's features of these frames give its errors.
    frames = _visit_frames(ts, tc, p, i, torch.from_numpy(batch))
    t_feats = tss.fused_scale_feature_block(trefp, frames, 0, 6).numpy()
    j_feats = jss.fused_scale_feature_block(jrefp, jnp.asarray(frames.numpy()),
                                            0, 6)
    np.testing.assert_allclose(t_feats, np.asarray(j_feats),
                               rtol=FEATURE_TOL, atol=FEATURE_TOL)
    if not prescreen:
        np.testing.assert_allclose(
            100.0 - np.asarray(jss.score_from_features(j_feats)), want,
            rtol=VISIT_ERR_RTOL, atol=0)

    # The JAX package's `_pick` on its own errors: the first minimum of the
    # candidates' rows, kept where it beats row 0.
    best = int(np.argmin(want[1:]))
    accept = want[1 + best] < want[0] - jc.accept_margin
    color = cand5[best] if accept else current
    state, err, _ = tref._slot_random(ts, tc, trefp, p, i,
                                      cand5=torch.from_numpy(cand5))
    np.testing.assert_array_equal(state.palette[p, i].numpy(), color)
    others = np.ones(js.palette.shape[:2], bool)
    others[p, i] = False
    np.testing.assert_array_equal(state.palette.numpy()[others],
                                  np.asarray(js.palette)[others])
    kept = min(want[1 + best], want[0]) if accept and (
        color != current).any() else want[0]
    assert abs(float(err) - kept) <= VISIT_ERR_RTOL * kept
    changed = ts.replace(palette=state.palette)
    np.testing.assert_array_equal(
        state.palette_map.numpy(),
        tref.full_remap(changed, tc).palette_map.numpy())


def test_slot_random_draws_from_the_generator(small_image):
    """`refine_slot_random` draws `random_trials` candidates from the given
    generator: the same seed gives the same visit, and the visit equals the
    one on those draws handed over as `cand5`."""
    _, (ts, tc, trefp) = _both(small_image, **dict(
        SMALL, prescreen=8, prescreen_full=2, random_trials=TRIALS))
    gen = torch.Generator().manual_seed(5)
    res = tref.refine_slot_random(ts, tc, trefp, gen, 0, 0)
    again = tref.refine_slot_random(ts, tc, trefp,
                                    torch.Generator().manual_seed(5), 0, 0)
    assert torch.equal(res.state.palette, again.state.palette)
    assert float(res.error) == float(again.error)
    draws = torch.randint(0, 32, (tc.random_trials, 3),
                          generator=torch.Generator().manual_seed(5),
                          dtype=torch.int32)
    state, err, _ = tref._slot_random(ts, tc, trefp, 0, 0, cand5=draws)
    assert torch.equal(state.palette, res.state.palette)
    assert float(err) == float(res.error)
    assert bool(res.changed) == (not torch.equal(res.state.palette, ts.palette))


def test_refine_slot_channel_scores_the_baseline_in_the_batch(small_image):
    """The per-slot channel visit against the JAX package's (explore off):
    the same state and error."""
    (js, jc, jrefp), (ts, tc, trefp) = _both(
        small_image, **dict(SMALL, prescreen=8, prescreen_full=2))
    for p, i, channel in [(0, 0, 0), (1, 3, 2)]:
        want = jref.refine_slot_channel(js, jc, jrefp, p, i, channel)
        got = tref.refine_slot_channel(ts, tc, trefp, p, i, channel)
        _assert_same_state(got.state, want.state)
        assert abs(float(got.error) - float(want.error)) <= (
            VISIT_ERR_RTOL * float(want.error))
        assert bool(got.changed) == bool(want.changed)


def test_dithered_visit_with_an_in_batch_baseline(small_image):
    """The dithered visit keeps row 0 through both rankings, as the JAX
    package's does."""
    kw = dict(SMALL, width=32, height=32, dither=True, prescreen=8,
              prescreen_full=2)
    (js, jc, jrefp), (ts, tc, trefp) = _both(small_image, **kw)
    cand5 = np.array(jax.random.randint(jax.random.key(1), (15, 3), 0, 32,
                                         dtype=jnp.int32))
    batch = np.concatenate([np.asarray(js.palette)[1, 1][None], cand5])
    want = np.asarray(jref._candidate_errors_dithered(
        js, jc, jrefp, 1, 1, jnp.asarray(batch), carried_base=False))
    with single_torch_thread():
        got, _ = tref._candidate_errors_dithered(
            ts, tc, trefp, 1, 1, torch.from_numpy(batch), carried_base=False)
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got[0]) and np.isfinite(got).sum() == 3
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("prescreen,prescreen_full", [(0, 0), (8, 0)])
def test_run_fused_channel_without_the_two_level_prescreen(
        small_image, prescreen, prescreen_full):
    """One explore-free channel sweep with every candidate scored at six
    scales (`prescreen=0`) and with all finalists scored at scales 0 and 1
    in one call (`prescreen_full=0`): the JAX package's palette and map."""
    img = np.ascontiguousarray(small_image[:32, :32])
    kw = dict(SMALL, width=32, height=32, schedule="channel",
              prescreen=prescreen, prescreen_full=prescreen_full, max_steps=1)
    tc, jc = TConfig(**kw), JConfig(**kw)
    state, errors, _ = tpipe.run_fused(img, tc, device="cpu")
    jstate, jerrors, _ = jpipe.run_fused(img, jc)
    _assert_same_state(state, jstate)
    init = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    assert not np.array_equal(state.palette.numpy(), np.asarray(init.palette))
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=ERR_TOL)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(schedule="channel"), dict(nes=True),
     dict(nes=True, schedule="channel")],
)
def test_schedule_selectors_match_jax(kw):
    tc, jc = TConfig(**kw), JConfig(**kw)
    assert tpipe._stop_cycle(tc) == jpipe._stop_cycle(jc)
    for step in range(12):
        want = ("nes" if jc.nes else
                "random" if jpipe._is_random_step(jc, step) else "channel")
        assert tpipe.step_method(tc, step) == want
    if not kw:
        assert [tpipe.step_method(tc, s) for s in range(6)] == [
            "random", "random", "random", "random", "channel", "random"]
        assert tpipe._stop_cycle(tc) == 5


def _fake_sweeps(monkeypatch, errors):
    """Replaces the three sweeps by ones that record their name and return
    the next of `errors`."""
    calls = []
    feed = iter(errors)

    def fake(name):
        def sweep(state, config, refp, *rest):
            calls.append(name)
            return state, torch.tensor(next(feed), dtype=torch.float32)
        return sweep

    for name in ("random", "channel", "nes"):
        monkeypatch.setattr(tpipe.refine, f"sweep_{name}", fake(name))
    return calls


@pytest.mark.parametrize(
    "kw,errors,tol,want_steps",
    [
        # reference: compared one cycle apart, so weak random steps between
        # strong channel steps do not stop the run; step 9 gains 0.4 on
        # step 4 and stops it
        (dict(), [50, 49.9, 49.8, 49.7, 40, 39.9, 39.9, 39.9, 39.9, 39.6,
                  39.5, 39.4], 0.5, 10),
        # channel: compared with the step before
        (dict(schedule="channel"), [50, 45, 44.8, 44.7, 30], 0.5, 3),
        (dict(nes=True), [50, 51, 40], 0.5, 2),
        # no tolerance: the whole budget
        (dict(), [50, 50, 50, 50, 50, 50, 50], 0.0, 7),
    ],
)
def test_optimize_order_and_stop_rule(small_image, monkeypatch, kw, errors,
                                      tol, want_steps):
    calls = _fake_sweeps(monkeypatch, errors)
    tc = TConfig(**dict(SMALL, max_steps=len(errors), converge_tol=tol, **kw))
    _, got, info = tpipe.run_fused(small_image, tc, device="cpu")
    assert len(got) == want_steps
    np.testing.assert_allclose(got, errors[:want_steps])
    assert calls == [tpipe.step_method(tc, s) for s in range(want_steps)]
    # the rule, written out: stop once the error `cycle` steps back is
    # less than `tol` above this step's
    cycle = tpipe._stop_cycle(tc)
    stops = [s for s in range(cycle, len(errors))
             if tol > 0 and errors[s - cycle] - errors[s] < tol]
    assert want_steps == (stops[0] + 1 if stops else len(errors))


def test_run_fused_reference_cycle(small_image):
    """One cycle of the reference schedule (four random sweeps and a channel
    sweep) with no prescreen, as BASELINE config 1 runs it, on a 32x32
    corner: step errors never rise, the run improves on the init, the
    carried error is the state's, and the seed fixes the run."""
    img = np.ascontiguousarray(small_image[:32, :32])
    kw = dict(subpalette_count=1, subpalette_size=4, width=32, height=32,
              max_steps=5, random_trials=16)
    tc = TConfig(**kw)
    assert tc.schedule == "reference" and tc.prescreen == 0
    state, errors, info = tpipe.run_fused(img, tc, device="cpu")
    init = tpipe.cluster(tpipe.initialize(new_state(img, tc, "cpu"), tc), tc)
    refp = tref.make_reference_pyramid(init)
    err0 = float(tref.frame_error_fused(init, tc, refp))
    assert len(errors) == 5 and np.isfinite(errors).all()
    assert all(b <= a for a, b in zip([err0] + errors, errors))
    assert errors[-1] < err0
    exact = float(tref.frame_error_fused(state, tc, refp))
    assert abs(exact - errors[-1]) <= ERR_TOL
    assert torch.equal(state.palette_map,
                       tref.full_remap(state, tc).palette_map)
    short = dict(kw, max_steps=1)
    runs = [tpipe.run_fused(img, TConfig(**dict(short, seed=seed)),
                            device="cpu") for seed in (0, 0, 1)]
    assert runs[0][1] == runs[1][1] == errors[:1]
    assert torch.equal(runs[0][0].palette, runs[1][0].palette)
    assert not torch.equal(runs[2][0].palette, runs[0][0].palette)


def test_presets_match_jax():
    assert tpresets.PRESETS == jpresets.PRESETS
    assert tpresets.describe_presets() == jpresets.describe_presets()
    for name in tpresets.PRESETS:
        assert dataclasses.asdict(tpresets.get_preset(name)) == \
            dataclasses.asdict(jpresets.get_preset(name))
        assert tpresets.preset_fields(name) == jpresets.preset_fields(name)
    assert tpresets.get_preset("nes-compat", max_steps=2).max_steps == 2
    with pytest.raises(ValueError, match="Unknown preset"):
        tpresets.get_preset("snes-mode9")


