"""NES mode of the port against the JAX package on the CPU.

NES visits draw nothing, so a NES sweep and a NES run are compared whole:
palette, palette map and JSON bytes equal, errors within 5e-4 (2.3e-4
measured at errors near 166: all 56 candidates go through six scales in
float32, in another order of additions than the JAX package's). A NES visit
never prescreens and always takes the best of the 56 colours.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core import refine as tref
from snesimage_torch.core.state import new_state
from snesimage_torch.io.json_out import state_to_json as t_json
from snesimage_torch.models import presets as tpresets
from snesimage_torch.ops import color as tcolor
from snesimage_torch.testing import bench_image, single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core import refine as jref
from snesimage_tpu.core.state import new_state as j_new_state
from snesimage_tpu.io.json_out import state_to_json as j_json
from snesimage_tpu.models import presets as jpresets
from snesimage_tpu.ops import color as jcolor
from test_torch_schedules import ERR_TOL, SMALL, _assert_same_state, _both

NES = dict(SMALL, nes=True, max_steps=2)


@pytest.mark.parametrize("perceptual", [False, True])
def test_nes_quantize_matches_jax(rng, perceptual):
    """Every 5-bit colour of a random batch and the NES colours themselves
    snap to the entry the JAX package picks."""
    rgb5 = np.concatenate([
        rng.integers(0, 32, (6, 50, 3)).astype(np.int32).reshape(-1, 3),
        np.asarray(jcolor.NES_PALETTE_5BIT),
    ])
    want = np.asarray(jcolor.nes_quantize(jnp.asarray(rgb5), perceptual))
    got = tcolor.nes_quantize(torch.from_numpy(rgb5), perceptual).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-56:], rgb5[-56:])
    shaped = tcolor.nes_quantize(torch.from_numpy(rgb5[:300].reshape(6, 50, 3)),
                                 perceptual)
    np.testing.assert_array_equal(shaped.numpy().reshape(-1, 3), want[:300])
    np.testing.assert_array_equal(tcolor.nes_palette_rgb8().numpy(),
                                  np.asarray(jcolor.nes_palette_rgb8()))


@pytest.mark.parametrize("perceptual", [False, True])
def test_nes_init_matches_jax(small_image, perceptual):
    """initialize + cluster with `nes`: every entry is a NES colour and the
    state equals the JAX package's."""
    kw = dict(NES, perceptual_palettes=perceptual)
    tc, jc = TConfig(**kw), JConfig(**kw)
    ts = tpipe.cluster(tpipe.initialize(new_state(small_image, tc, "cpu"), tc),
                       tc)
    js = jpipe.cluster(jpipe.initialize(j_new_state(small_image, jc), jc), jc)
    _assert_same_state(ts, js)
    nes = {tuple(c) for c in np.asarray(jcolor.NES_PALETTE_5BIT).tolist()}
    assert {tuple(c) for c in ts.palette.reshape(-1, 3).tolist()} <= nes


def test_sweep_nes_matches_jax(small_image):
    """One perceptual NES sweep from the JAX package's state (kernel F's
    twin gives the 56 distance planes, with no prescreen): the same palette
    and map, and its error, the last visit's best, within 5e-4 and equal to
    the state's exact error."""
    (js, jc, jrefp), (ts, tc, trefp) = _both(
        small_image, **dict(NES, perceptual_palettes=True))
    want = jref.sweep_nes(js, jc, jrefp)
    state, err = tref.sweep_nes(ts, tc, trefp)
    _assert_same_state(state, want.state)
    assert abs(float(err) - float(want.error)) <= ERR_TOL
    exact = float(tref.frame_error_fused(state, tc, trefp))
    assert abs(exact - float(err)) <= ERR_TOL


def test_run_fused_nes_matches_jax(small_image):
    """Two NES steps at 64x64: the JAX package's palette, map and JSON
    bytes, step errors within 5e-4, every entry a NES colour."""
    tc, jc = TConfig(**NES), JConfig(**NES)
    state, errors, info = tpipe.run_fused(small_image, tc, device="cpu")
    jstate, jerrors, jinfo = jpipe.run_fused(small_image, jc)
    _assert_same_state(state, jstate)
    assert t_json(state, tc) == j_json(jstate, jc)
    assert len(errors) == len(jerrors) == 2
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=ERR_TOL)
    assert abs(info["final_error"] - jinfo["final_error"]) <= ERR_TOL
    nes = {tuple(c) for c in np.asarray(jcolor.NES_PALETTE_5BIT).tolist()}
    assert {tuple(c) for c in state.palette.reshape(-1, 3).tolist()} <= nes


def test_run_fused_nes_dithered_matches_jax(small_image):
    """One dithered NES step at 32x32: 56 wavefront remaps per visit, all
    scored at six scales."""
    img = np.ascontiguousarray(small_image[:32, 32:])
    kw = dict(NES, width=32, height=32, dither=True, max_steps=1)
    tc, jc = TConfig(**kw), JConfig(**kw)
    with single_torch_thread():
        state, errors, _ = tpipe.run_fused(img, tc, device="cpu")
    jstate, jerrors, _ = jpipe.run_fused(img, jc)
    _assert_same_state(state, jstate)
    assert t_json(state, tc) == j_json(jstate, jc)
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=1e-3)


def test_nes_visit_always_replaces(small_image):
    """A NES visit takes the best of the 56 colours even where the current
    colour scores better: its error may rise, and the first minimum wins."""
    _, (ts, tc, trefp) = _both(small_image, **NES)
    nes5 = tcolor.nes_palette_5bit(torch.device("cpu"))
    off = torch.tensor([1, 2, 3], dtype=torch.int32)  # not a NES colour
    assert not bool((nes5 == off).all(dim=1).any())
    palette = ts.palette.clone()
    palette[1, 2] = off
    start = tref.full_remap(ts.replace(palette=palette), tc)
    res = tref.refine_slot_nes(start, tc, trefp, 1, 2)
    assert bool(res.changed)
    assert bool((nes5 == res.state.palette[1, 2]).all(dim=1).any())
    errs, _ = tref._undithered_machinery(start, tc, 1, 2)[0](
        trefp, nes5, allow_prescreen=False)
    assert bool(torch.isfinite(errs).all())
    first = int(torch.nonzero(errs == errs.min())[0])
    assert torch.equal(res.state.palette[1, 2], nes5[first])
    assert float(res.error) == float(errs.min())
    exact = float(tref.frame_error_fused(res.state, tc, trefp))
    assert abs(exact - float(res.error)) <= ERR_TOL


def test_nes_compat_init_hash():
    """initialize + cluster of the `nes-compat` preset on the bench image:
    the JAX package's state, whose hash chip_smoke.py pins for the card."""
    import chip_smoke

    img = bench_image(0)
    tc, jc = tpresets.get_preset("nes-compat"), jpresets.get_preset("nes-compat")
    ts = tpipe.cluster(tpipe.initialize(new_state(img, tc, "cpu"), tc), tc)
    js = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    _assert_same_state(ts, js)
    assert chip_smoke.init_hash(ts) == chip_smoke.INIT_HASH_NES
