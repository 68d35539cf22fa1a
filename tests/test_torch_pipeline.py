"""The port's run_fused against the JAX package's on the CPU, and the
options the port does not cover yet. tests/test_torch_geometry.py and
tests/test_torch_schedules.py hold the runs at other geometries and with
the reference and NES schedules."""

import time

import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.io.json_out import state_to_json as t_json
from snesimage_torch.testing import single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core.state import new_state as j_new_state
from snesimage_tpu.io.json_out import state_to_json as j_json

SMALL = dict(
    subpalette_count=2, subpalette_size=4, width=64, height=64, max_steps=2,
    converge_tol=0.0, schedule="channel", prescreen=8, prescreen_full=2,
    channel_explore=0, accept_margin=0.005,
)


def test_run_fused_matches_jax(small_image):
    """No explore draws, so no RNG enters: the same palette and JSON, step
    errors within 1e-4, and the run accepted moves."""
    tc, jc = TConfig(**SMALL), JConfig(**SMALL)
    state, errors, info = tpipe.run_fused(small_image, tc, device="cpu")
    jstate, jerrors, jinfo = jpipe.run_fused(small_image, jc)
    np.testing.assert_array_equal(state.palette.numpy(),
                                  np.asarray(jstate.palette))
    assert t_json(state, tc) == j_json(jstate, jc)
    assert len(errors) == len(jerrors) == 2
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=1e-4)
    assert abs(info["final_error"] - jinfo["final_error"]) <= 1e-4
    init = jpipe.cluster(jpipe.initialize(j_new_state(small_image, jc), jc), jc)
    assert not np.array_equal(state.palette.numpy(), np.asarray(init.palette))
    assert errors[1] <= errors[0]


def test_run_fused_explore_and_stop_rule(small_image):
    """Explore draws come from the run's own generator: the same seed gives
    the same run. converge_tol stops after the first step that improves by
    less than it, never at the first step."""
    kw = dict(SMALL, channel_explore=4, max_steps=3)
    a = tpipe.run_fused(small_image, TConfig(**kw), device="cpu")
    b = tpipe.run_fused(small_image, TConfig(**kw), device="cpu")
    assert a[1] == b[1]
    np.testing.assert_array_equal(a[0].palette.numpy(), b[0].palette.numpy())
    assert all(y <= x for x, y in zip(a[1], a[1][1:]))
    stop = tpipe.run_fused(small_image, TConfig(**dict(kw, converge_tol=1e9)),
                           device="cpu")
    assert len(stop[1]) == 2 and stop[1] == a[1][:2]


def test_run_fused_cuda_without_a_card_raises(small_image):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tpipe.run_fused(small_image, TConfig(**SMALL), device="cuda")


def test_run_fused_clock_starts_after_new_state(small_image, monkeypatch):
    """total_seconds leaves out new_state, as the JAX package's run_fused
    does (ROADMAP C-10): a new_state slowed by 0.3 s leaves the reported
    time at least 0.3 s below the call's wall time."""
    slow = 0.3
    real = tpipe.new_state

    def slow_new_state(*args, **kwargs):
        time.sleep(slow)
        return real(*args, **kwargs)

    monkeypatch.setattr(tpipe, "new_state", slow_new_state)
    t0 = time.perf_counter()
    _, errors, info = tpipe.run_fused(
        small_image, TConfig(**dict(SMALL, max_steps=0)), device="cpu")
    wall = time.perf_counter() - t0
    assert errors == []
    assert 0.0 < info["total_seconds"] <= wall - slow


@pytest.fixture
def one_torch_thread():
    with single_torch_thread():
        yield


@pytest.mark.parametrize("perceptual", [False, True])
def test_run_fused_dithered_matches_jax(small_image, one_torch_thread,
                                        perceptual):
    """A dithered run on a 32x32 crop with explore off, so no RNG enters:
    the same palette, palette map and JSON bytes as the JAX package's, step
    errors within 1e-3 (the dithered visits' bound, tests/
    test_torch_refine.py), and the run accepted moves."""
    img = np.ascontiguousarray(small_image[:32, :32])
    kw = dict(SMALL, width=32, height=32, dither=True,
              perceptual_palettes=perceptual,
              prescreen_full=4 if perceptual else 2)
    tc, jc = TConfig(**kw), JConfig(**kw)
    state, errors, info = tpipe.run_fused(img, tc, device="cpu")
    jstate, jerrors, jinfo = jpipe.run_fused(img, jc)
    np.testing.assert_array_equal(state.palette.numpy(),
                                  np.asarray(jstate.palette))
    np.testing.assert_array_equal(state.palette_map.numpy(),
                                  np.asarray(jstate.palette_map))
    assert t_json(state, tc) == j_json(jstate, jc)
    assert len(errors) == len(jerrors) == 2
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=1e-3)
    assert abs(info["final_error"] - jinfo["final_error"]) <= 1e-3
    init = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    assert not np.array_equal(state.palette.numpy(), np.asarray(init.palette))
    assert errors[1] <= errors[0]


@pytest.mark.parametrize(
    "change",
    [
        dict(dither=True, dither_proxy=8),
        dict(channel_window=2),
        dict(prescreen_pre=12),
        dict(prescreen_full=0, gate_margin=0.01, gate_coarse=True),
        dict(prescreen=0, prescreen_full=0, dither_proxy=4),
    ],
)
def test_off_slice_configs_raise(small_image, change):
    """The coarse gate, windows, the three-level prescreen and the dither
    proxy are not ported (ROADMAP queue A item 17), alone or with an
    option that is (scoring without a prescreen:
    tests/test_torch_schedules.py runs it)."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 1[17]"):
        tpipe.run_fused(small_image, TConfig(**dict(SMALL, **change)),
                        device="cpu")


@pytest.mark.parametrize("case", ["nes", "channel", "reference"])
def test_gated_configs_run(small_image, case):
    """A margin on a NES config does not gate (`_gating_active`), so the
    run is the ungated one, bit for bit. On SMALL with tol 0.5 the run is
    gated and draws nothing: the JAX package's step count, its exact
    confirmation sweep included, errors within 1e-3. On the reference
    schedule the random sweeps are gated and draw the port's own
    candidates: the errors never rise and end below the init's."""
    change = {
        "nes": dict(nes=True, gate_margin=0.01),
        "channel": dict(gate_margin=0.01, converge_tol=0.5, max_steps=8),
        "reference": dict(schedule="reference", gate_margin=0.01),
    }[case]
    kw = dict(SMALL, **change)
    tc = TConfig(**kw)
    assert tpipe.refine._gating_active(tc) == (case != "nes")
    state, errors, info = tpipe.run_fused(small_image, tc, device="cpu")
    if case == "nes":
        ungated = tpipe.run_fused(small_image, TConfig(**dict(
            kw, gate_margin=0.0)), device="cpu")
        assert errors == ungated[1]
        assert torch.equal(state.palette, ungated[0].palette)
    elif case == "channel":
        jstate, jerrors, _ = jpipe.run_fused(small_image, JConfig(**kw))
        assert 2 <= len(errors) == len(jerrors) < 8
        np.testing.assert_allclose(errors, jerrors, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(state.palette.numpy(),
                                      np.asarray(jstate.palette))
    else:
        init = tpipe.cluster(tpipe.initialize(
            tpipe.new_state(small_image, tc, "cpu"), tc), tc)
        err0 = float(tpipe.refine.frame_error_fused(
            init, tc, tpipe.refine.make_reference_pyramid(init)))
        assert all(b <= a for a, b in zip([err0] + errors, errors))
        assert errors[-1] < err0
