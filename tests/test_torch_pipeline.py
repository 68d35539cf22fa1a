"""The port's run_fused against the JAX package's on the CPU, and the
options the port does not cover yet."""

import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.io.json_out import state_to_json as t_json
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


@pytest.mark.parametrize(
    "change",
    [
        dict(dither=True),
        dict(perceptual_palettes=True, dither=True),
        dict(nes=True),
        dict(gate_margin=0.01, converge_tol=0.5),
        dict(schedule="reference"),
        dict(channel_window=2),
        dict(prescreen_pre=12),
        dict(prescreen_full=0),
        dict(prescreen=0, prescreen_full=0),
    ],
)
def test_off_slice_configs_raise(small_image, change):
    with pytest.raises(NotImplementedError):
        tpipe.run_fused(small_image, TConfig(**dict(SMALL, **change)),
                        device="cpu")
