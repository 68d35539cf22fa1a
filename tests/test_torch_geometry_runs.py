"""Whole runs of the port at geometries whose sides are not multiples of 32,
against the JAX package on the CPU, and the init at 256x240.

tests/test_torch_geometry.py holds the parts (kernel B's twin at odd
pyramids, a visit through kernel E's or F's twin) and says which crops of
the fixture are used and why. Two channel sweeps with explore off draw
nothing, so the runs are compared whole: palettes, palette maps and JSON
bytes equal, step errors within 5e-4 (1.7e-4 measured).
"""

import numpy as np
import pytest

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core.state import new_state
from snesimage_torch.io.json_out import state_to_json as t_json
from snesimage_torch.testing import bench_image, single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core.state import new_state as j_new_state
from snesimage_tpu.io.json_out import state_to_json as j_json
from test_torch_geometry import CFG, ERR_TOL, ROUTES, _crop, routes  # noqa: F401


@pytest.mark.parametrize(
    "width,height,perceptual",
    [(40, 24, False), (48, 48, False), (40, 24, True)],
)
def test_run_fused_any_geometry_matches_jax(small_image, routes, width, height,
                                            perceptual):
    """Two channel sweeps with explore off, so no RNG enters: the JAX
    package's palette, palette map and JSON bytes; step errors within 5e-4;
    every visit through E (or F), none through C or D."""
    img = _crop(small_image, width, height)
    kw = dict(CFG, width=width, height=height,
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
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=ERR_TOL)
    assert abs(info["final_error"] - jinfo["final_error"]) <= ERR_TOL
    visits = 2 * tc.subpalette_count * tc.subpalette_size * 3
    c, d, e, f = (routes[name] for name in ROUTES)
    assert (c, d) == (0, 0)
    assert (e, f) == ((0, visits) if perceptual else (visits, 0))
    init = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    assert not np.array_equal(state.palette.numpy(), np.asarray(init.palette))
    assert errors[1] <= errors[0]


def test_run_fused_aligned_control_takes_the_fused_kernels(small_image,
                                                           routes):
    """One sweep at 64x64: every visit through kernel C's wrapper, none
    through E's."""
    tc = TConfig(**dict(CFG, width=64, height=64, max_steps=1))
    tpipe.run_fused(small_image, tc, device="cpu")
    visits = tc.subpalette_count * tc.subpalette_size * 3
    assert [routes[name] for name in ROUTES] == [visits, 0, 0, 0]


@pytest.mark.parametrize(
    "change,name",
    [(dict(), "INIT_HASH_240"),
     (dict(perceptual_palettes=True), "INIT_HASH_240_PERCEPTUAL"),
     (dict(dither=True), "INIT_HASH_240_DITHER")],
)
def test_init_matches_jax_at_256x240(change, name):
    """initialize + cluster on the first 240 rows of the bench image, 8x15:
    tile assignment, palette and palette map equal the JAX package's (the
    values whose hashes chip_smoke.py pins for the card)."""
    import chip_smoke

    img = bench_image(0)[:240]
    kw = dict(subpalette_count=8, subpalette_size=15, width=256, height=240,
              **change)
    tc, jc = TConfig(**kw), JConfig(**kw)
    with single_torch_thread():
        ts = tpipe.cluster(tpipe.initialize(new_state(img, tc, "cpu"), tc),
                           tc)
    js = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    for field in ("tile_palettes", "palette", "palette_map"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)), field)
    assert chip_smoke.init_hash(ts) == getattr(chip_smoke, name)
