"""The port's rank-1 gate (core/refine.py) against the JAX package's on the
CPU, from the same state (the JAX package's, carried across as numpy
arrays), and kernel B's gate flag on its twin.

A gated visit ranks its eight finalists at scale 1 by the full error they
predict with the carried scale-0 term, and runs the scale-0 stage only
where the best prediction beats the carried error by more than the margin
(or an explore row reached the scale-0 finalists). The two packages score
in float32 with other rounding (tests/test_torch_refine.py: visit errors
within 5e-4 at errors near 165), so the gated visit's error is compared
within 1e-3 and the carry (weighted sums of about 1e-3 to 1e-1) within
1e-3 relative; palettes, maps and which candidates stay finite are exact.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core import refine as tref
from snesimage_torch.core.state import pyramid_from_numpy, state_from_numpy
from snesimage_torch.ops import cuda_metric
from snesimage_torch.testing import single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core import refine as jref
from snesimage_tpu.core.state import new_state as j_new_state

ERR_TOL = 1e-3
CARRY_RTOL = 1e-3
GATED = dict(
    subpalette_count=2, subpalette_size=4, width=64, height=64,
    schedule="channel", prescreen=8, prescreen_full=2, channel_explore=0,
    accept_margin=0.005, gate_margin=0.01, converge_tol=0.5,
)
# Explore rows: numpy-made, fed to both packages.
EXPLORE = np.random.default_rng(5).integers(0, 32, (16, 3)).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    with single_torch_thread():
        yield


@pytest.mark.parametrize("change", [
    {}, dict(gate_margin=0.0), dict(prescreen=0, prescreen_full=0),
    dict(prescreen_full=0), dict(prescreen_full=8), dict(dither=True),
    dict(nes=True), dict(perceptual_palettes=True, prescreen_full=4),
    dict(width=40, height=24), dict(channel_explore=16),
    dict(converge_tol=0.1), dict(schedule="reference"),
])
def test_gating_active_truth_table(change):
    kw = dict(GATED, **change)
    assert tref._gating_active(TConfig(**kw)) == jref._gating_active(
        JConfig(**kw))


@lru_cache(maxsize=None)
def _setup(image_bytes: bytes, margin: float):
    """(JAX state, config, pyramid) after initialize + cluster, and the
    port's copies of them."""
    img = np.frombuffer(image_bytes, np.uint8).reshape(64, 64, 4)
    kw = dict(GATED, gate_margin=margin)
    jc, tc = JConfig(**kw), TConfig(**kw)
    js = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    jrefp = jref.make_reference_pyramid(js)
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          "cpu")
    trefp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in s) for s in jrefp), "cpu")
    return (js, jc, jrefp), (ts, tc, trefp)


def test_gate_base_matches_jax(small_image):
    """The carry's two weighted sums within 1e-4 relative (the features
    agree within 1.4e-5 relative, tests/test_torch_refine.py; the scale-1
    sum is near 100 here, where 1e-4 absolute would be 1e-6 relative)."""
    (js, jc, jrefp), (ts, tc, trefp) = _setup(small_image.tobytes(), 0.01)
    want = np.asarray(jref.gate_base_fused(js, jc, jrefp))
    got = tref.gate_base_fused(ts, tc, trefp)
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0)
    assert (want > 0).all()


def _carried(js, jc, jrefp):
    """The carried error and gate carry of the JAX state, for both."""
    jerr = jref.frame_error_fused(js, jc, jrefp)
    jgb = jref.gate_base_fused(js, jc, jrefp)
    return (jerr, jgb), (torch.tensor(float(jerr)),
                         torch.from_numpy(np.array(jgb)))


@pytest.mark.parametrize("p,i,channel", [(0, 0, 0), (0, 2, 1), (1, 1, 2),
                                         (1, 3, 0)])
def test_gated_visit_matches_jax(small_image, p, i, channel):
    """One gated channel visit from the clustered state: the JAX package's
    palette and map, its error within 1e-3 and its carry within 1e-3
    relative."""
    (js, jc, jrefp), (ts, tc, trefp) = _setup(small_image.tobytes(), 0.01)
    (jerr, jgb), (err, gb) = _carried(js, jc, jrefp)
    res, _, jcarry = jref._slot_channel(
        js, jc, jrefp, p, i, channel, jref._init_cache(js, jc), jerr,
        gate_base=jgb)
    with tref.gate_tally() as tally:
        state, new_err, _, carry = tref._slot_channel(
            ts, tc, trefp, p, i, channel, tref.compute_d_all(ts, tc), err,
            gate_base=gb)
    assert tally["visits"] == 1 and int(tally["closed"]) in (0, 1)
    np.testing.assert_array_equal(state.palette.numpy(),
                                  np.asarray(res.state.palette))
    np.testing.assert_array_equal(state.palette_map.numpy(),
                                  np.asarray(res.state.palette_map))
    assert abs(float(new_err) - float(res.error)) <= ERR_TOL
    np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry),
                               rtol=CARRY_RTOL, atol=0)


def test_closed_gate_leaves_the_visit_unchanged(small_image):
    """With a huge margin every gate closes: the visit rejects, and state,
    error and carry come back as they went in, as in the JAX package."""
    (js, jc, jrefp), (ts, tc, trefp) = _setup(small_image.tobytes(), 1e9)
    (jerr, jgb), (err, gb) = _carried(js, jc, jrefp)
    for p, i, channel in [(0, 0, 0), (1, 2, 1)]:
        res, _, jcarry = jref._slot_channel(
            js, jc, jrefp, p, i, channel, jref._init_cache(js, jc), jerr,
            gate_base=jgb)
        assert not bool(res.changed)
        with tref.gate_tally() as tally:
            state, new_err, _, carry = tref._slot_channel(
                ts, tc, trefp, p, i, channel, tref.compute_d_all(ts, tc),
                err, gate_base=gb)
        assert int(tally["closed"]) == 1
        assert torch.equal(state.palette, ts.palette)
        assert torch.equal(state.palette_map, ts.palette_map)
        assert torch.equal(new_err, err) and torch.equal(carry, gb)
        np.testing.assert_array_equal(np.asarray(jcarry), np.asarray(jgb))


@pytest.mark.parametrize("margin,enable", [(0.01, True), (1e9, True),
                                           (1e9, False)])
def test_gated_errors_with_explore_rows_match_jax(small_image, margin,
                                                  enable):
    """The gated stage's errors and per-scale sums for 32 channel values
    and 16 explore rows (exempt from the gate) against the JAX package's
    errors closure: the same finite rows, errors within 1e-3, sums within
    1e-3 relative. `enable` False is the confirmation sweep's exact
    scoring, which keeps the gated ranking."""
    (js, jc, jrefp), (ts, tc, trefp) = _setup(small_image.tobytes(), margin)
    (jerr, jgb), (err, gb) = _carried(js, jc, jrefp)
    for p, i, channel in [(0, 1, 0), (1, 0, 2)]:
        sweep = np.repeat(np.asarray(js.palette)[p, i][None], 32, axis=0)
        sweep[:, channel] = np.arange(32)
        cand5 = np.concatenate([sweep, EXPLORE]).astype(np.int32)
        errors, _, _ = jref._slot_machinery(js, jc, p, i,
                                            jref._init_cache(js, jc))
        want, want_sums = errors(
            jrefp, jnp.asarray(cand5), carried_base=True,
            gate=(jgb, jerr, jnp.bool_(enable), 32))
        got, _, sums = tref._undithered_machinery(ts, tc, p, i)[0](
            trefp, torch.from_numpy(cand5), gate=(gb, err, enable, 32))
        want, want_sums = np.asarray(want), np.asarray(want_sums).T
        np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                      np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=0,
                                   atol=ERR_TOL)
        np.testing.assert_allclose(sums.numpy(), want_sums, rtol=CARRY_RTOL,
                                   atol=1e-7)


def test_fast_recipe_takes_the_jax_steps(small_image):
    """The `fast` profile's recipe (gated channel sweeps, no explore, so no
    random draws; tol 0.5 with the exact confirmation sweep) on a 2x3
    palette: the JAX package's number of steps, confirmation included,
    every step error within 1e-3, and its palette."""
    from snesimage_torch.cli import OPT_PROFILES

    kw = dict(OPT_PROFILES["fast"][1], subpalette_count=2, subpalette_size=3,
              width=64, height=64)
    state, errors, info = tpipe.run_fused(small_image, TConfig(**kw),
                                          device="cpu")
    jstate, jerrors, jinfo = jpipe.run_fused(small_image, JConfig(**kw))
    assert len(errors) == len(jerrors) >= 2
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=ERR_TOL)
    np.testing.assert_array_equal(state.palette.numpy(),
                                  np.asarray(jstate.palette))
    assert errors[-2] - errors[-1] < kw["converge_tol"]


def _b_operands(n_img: int):
    rng = np.random.default_rng(11)
    refs = tuple(tuple(torch.from_numpy(rng.random((n_img, 3, 16, 16),
                                                   np.float32))
                       for _ in range(3)) for _ in range(1))
    frames = torch.from_numpy(rng.random((n_img, 2, 3, 16, 16), np.float32))
    return refs, frames


@pytest.mark.parametrize("flags", [(0,), (1,), (1, 0), (0, 1), (0, 0)])
def test_kernel_b_gate_flag_twin(flags):
    """Kernel B's twin with a gate flag: a closed image gets zero sums, an
    open one the sums of a call without a flag, bit for bit."""
    refs, frames = _b_operands(len(flags))
    gate = torch.tensor(flags, dtype=torch.int32)
    if len(flags) == 1:
        refs = tuple(tuple(a[0] for a in t) for t in refs)
        frames = frames[0]
    got = cuda_metric.multiscale_feature_sums(refs, frames, gate=gate)
    want = cuda_metric.multiscale_feature_sums(refs, frames)
    assert got.shape == want.shape
    for n, flag in enumerate(flags):
        got_n = got[n] if len(flags) > 1 else got
        want_n = want[n] if len(flags) > 1 else want
        if flag:
            assert torch.equal(got_n, want_n)
        else:
            assert not got_n.any()
