"""Windowed channel descent (`channel_window`) against the JAX package on
the CPU: which steps are windowed, the candidates of a windowed visit, and
a whole run, whose stop fires only on an exhaustive sweep.

The channel schedule with no explore draws nothing, so a run draws what
the JAX package's draws (nothing) and its step errors agree within 1e-3
(tests/test_torch_pipeline.py's bound for whole runs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core import refine as tref
from snesimage_torch.core.state import pyramid_from_numpy, state_from_numpy
from snesimage_torch.testing import single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core import refine as jref
from snesimage_tpu.core.state import new_state as j_new_state

CFG = dict(subpalette_count=2, subpalette_size=4, width=64, height=64,
           schedule="channel", prescreen=8, prescreen_full=2,
           channel_explore=0, channel_window=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    with single_torch_thread():
        yield


@pytest.mark.parametrize("warmup,period", [(2, 3), (1, 2), (3, 5)])
def test_window_steps_match_jax(warmup, period):
    """`_is_window_step` over steps 0-30 equals the JAX package's, and
    windows are off on the reference schedule and with NES palettes."""
    kw = dict(CFG, channel_window_warmup=warmup, channel_window_period=period)
    tc, jc = TConfig(**kw), JConfig(**kw)
    got = [tpipe._is_window_step(tc, k) for k in range(31)]
    assert got == [bool(jpipe._is_window_step(jc, k)) for k in range(31)]
    assert any(got) and not all(got)
    for change in (dict(schedule="reference"), dict(nes=True)):
        assert not any(tpipe._is_window_step(TConfig(**dict(kw, **change)), k)
                       for k in range(31))


def test_window_values_match_jax():
    """The 2W values of a windowed visit, clamped at both ends of [0, 31]
    (a clamped value repeats), are the JAX package's: its slot visit's
    candidate colours, rebuilt here as it builds them."""
    w = CFG["channel_window"]
    offsets = np.concatenate([np.arange(-w, 0), np.arange(1, w + 1)])
    current = torch.tensor([[0, 17, 31], [30, 1, 2], [5, 31, 29]],
                           dtype=torch.int32)
    for channel in range(3):
        got = tref._channel_values(current, channel, w)
        want = np.asarray(jnp.clip(jnp.asarray(current.numpy())[:, channel,
                                                                None]
                                   + offsets, 0, 31))
        np.testing.assert_array_equal(got.numpy(), want)
    assert tref._channel_values(current, 0, 0).tolist() == [list(range(32))] * 3


def _setup(image):
    jc, tc = JConfig(**CFG), TConfig(**CFG)
    js = jpipe.cluster(jpipe.initialize(j_new_state(image, jc), jc), jc)
    jrefp = jref.make_reference_pyramid(js)
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          "cpu")
    trefp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in s) for s in jrefp), "cpu")
    return (js, jc, jrefp), (ts, tc, trefp)


def test_windowed_visits_match_jax(small_image):
    """Windowed channel visits (6 candidates and the current colour, no
    prescreen) give the JAX package's palette and map, and its error
    within 5e-4 (tests/test_torch_refine.py)."""
    (js, jc, jrefp), (ts, tc, trefp) = _setup(small_image)
    for p, i, channel in [(0, 0, 0), (1, 2, 1), (0, 3, 2)]:
        want = jref.refine_slot_channel(js, jc, jrefp, p, i, channel,
                                        window=True)
        got = tref.refine_slot_channel(ts, tc, trefp, p, i, channel,
                                       window=True)
        np.testing.assert_array_equal(got.state.palette.numpy(),
                                      np.asarray(want.state.palette))
        np.testing.assert_array_equal(got.state.palette_map.numpy(),
                                      np.asarray(want.state.palette_map))
        assert abs(float(got.error) - float(want.error)) <= 5e-4


def test_windowed_run_stops_only_on_exhaustive_sweeps(small_image):
    """A windowed run with a stop rule: the JAX package's step count and
    step errors within 1e-3, and its last step is an exhaustive sweep
    whose step fell below the tolerance."""
    kw = dict(CFG, max_steps=8, converge_tol=0.05)
    tc = TConfig(**kw)
    state, errors, _ = tpipe.run_fused(small_image, tc, device="cpu")
    jstate, jerrors, _ = jpipe.run_fused(small_image, JConfig(**kw))
    assert len(errors) == len(jerrors) < 8
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(state.palette.numpy(),
                                  np.asarray(jstate.palette))
    last = len(errors) - 1
    windowed = [tpipe._is_window_step(tc, k) for k in range(len(errors))]
    assert any(windowed) and not windowed[last]
    assert errors[-2] - errors[-1] < kw["converge_tol"]
    # A windowed step that improved by less than the tolerance did not
    # stop the run.
    assert any(w and errors[k - 1] - errors[k] < kw["converge_tol"]
               for k, w in enumerate(windowed) if k)
