"""The port at geometries whose sides are not multiples of 32, against the
JAX package on the CPU.

At such a geometry the pyramid does not halve exactly (an odd side's last
row or column is replicated), the fused coarse kernels C and D do not run,
and a visit ranks its candidates through kernel E (red-mean) or F
(perceptual), the frame assembly and kernel B. On the CPU every wrapper
runs its plain twin, so these tests pin the arithmetic and the control
flow that the card runs through the kernels (chip_smoke.py and
tests/test_torch_cuda.py hold the kernels to the twins there).

Sizes are written width x height, as `QuantConfig` takes them: 40x24 is an
image of 24 rows and 40 columns, whose pyramid is 24x40, 12x20, 6x10, 3x5,
2x3, 1x2. Features agree within 2e-4 (tests/test_torch_ssimulacra2.py).
A visit's candidate errors agree within 1e-5 of their value (4.4e-6
measured, 7.6e-4 at an error of 173: the two packages blur in float32 with
other rounding, the SSIM variance terms amplify it, and the score's
polynomial is steeper at the high errors of these small fixtures than at
those of tests/test_torch_refine.py), a run's step errors within 5e-4
(1.7e-4 measured); palettes, palette maps and JSON bytes are equal.

The images are the top-left 40x24 and 48x48 of the 64x64 fixture. Not its
top-right corner, which has the transparent tiles: at 40x24 two sweeps
accept nothing there and most candidates of a visit score within two
float32 steps of each other, at 48x48 the first accepted visit has two such
candidates, and which of them a package keeps is then decided by rounding
(ROADMAP C-9). tests/test_torch_geometry_runs.py holds the whole runs.
"""

from functools import lru_cache

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
    state_to_numpy,
)
from snesimage_torch.io.json_out import state_to_json as t_json
from snesimage_torch.ops import ssimulacra2 as tss
from snesimage_torch.ops.color import nes_quantize
from snesimage_torch.testing import bench_image, single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core import refine as jref
from snesimage_tpu.core.state import new_state as j_new_state
from snesimage_tpu.io.json_out import state_to_json as j_json
from snesimage_tpu.ops import ssimulacra2 as jss

FEATURE_TOL = 2e-4
VISIT_ERR_RTOL = 1e-5
ERR_TOL = 5e-4
CFG = dict(
    subpalette_count=2, subpalette_size=4, schedule="channel", prescreen=8,
    prescreen_full=2, channel_explore=0, accept_margin=0.005, max_steps=2,
    converge_tol=0.0,
)
ROUTES = ("coarse_feature_sums_redmean", "coarse_feature_sums_ciede",
          "pooled_wins_redmean", "pooled_wins_ciede")


def _crop(image, width, height):
    """The top-left width x height part of the 64x64 fixture."""
    return np.ascontiguousarray(image[:height, :width])


@pytest.fixture
def routes(monkeypatch):
    """Counts the visit's calls of the coarse wrappers C, D, E and F (on
    the CPU each runs its twin and its launch counter stays)."""
    calls = dict.fromkeys(ROUTES, 0)

    def spy(name):
        fn = getattr(tref, name)

        def counted(*args):
            calls[name] += 1
            return fn(*args)

        return counted

    for name in ROUTES:
        monkeypatch.setattr(tref, name, spy(name))
    return calls


@pytest.mark.parametrize(
    # (start_scale, num_scales, pre_ds): the frame error, the scale-1 rank,
    # the scale-0 finalists, the coarse stage on quarter-resolution frames
    # and the dithered visit's coarse stage on full frames, at 24x40 (odd
    # from 3x5 on); the last at 60x60 (15x15, 8x8), whose frame error
    # tests/test_torch_ssimulacra2.py holds
    "h,w,start,n,pre_ds",
    [(24, 40, 0, 6, 0), (24, 40, 1, 1, 1), (24, 40, 0, 1, 0),
     (24, 40, 2, 4, 0), (24, 40, 2, 4, 2), (60, 60, 2, 4, 2)],
)
def test_fused_scale_feature_block_odd_pyramids(rng, h, w, start, n, pre_ds):
    ref = rng.integers(0, 256, (h, w, 3)).astype(np.int32)
    jp = jss.reference_pyramid(jnp.asarray(ref))
    tp = tss.reference_pyramid(torch.from_numpy(ref))
    for js, ts in zip(jp, tp):
        assert ts[0].shape == js[0].shape
    assert any(s[0].shape[0] % 2 or s[0].shape[1] % 2 for s in tp[:-1])
    fh, fw = tss.pyramid_size(h, w, start - pre_ds)
    frames = rng.random((3, 3, fh, fw)).astype(np.float32) ** 2.2
    want = jss.fused_scale_feature_block(jp, jnp.asarray(frames), start, n,
                                         pre_ds=pre_ds)
    got = tss.fused_scale_feature_block(tp, torch.from_numpy(frames), start,
                                        n, pre_ds=pre_ds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FEATURE_TOL, atol=FEATURE_TOL)


@lru_cache(maxsize=None)
def _setup(image_bytes: bytes, width: int, height: int, perceptual: bool):
    img = _crop(np.frombuffer(image_bytes, np.uint8).reshape(64, 64, 4),
                width, height)
    kw = dict(CFG, width=width, height=height,
              perceptual_palettes=perceptual,
              prescreen_full=4 if perceptual else 2)
    jc, tc = JConfig(**kw), TConfig(**kw)
    js = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    jrefp = jref.make_reference_pyramid(js)
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          "cpu")
    trefp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in s) for s in jrefp), "cpu")
    return (js, jc, jrefp), (ts, tc, trefp)


@pytest.mark.parametrize(
    "width,height,perceptual,p,i,channel",
    [(40, 24, False, 0, 0, 0), (40, 24, False, 1, 2, 1),
     (40, 24, True, 0, 1, 2), (64, 64, True, 0, 1, 2)],
)
def test_visit_parity_any_geometry(small_image, routes, width, height,
                                   perceptual, p, i, channel):
    """A visit's candidate errors against the JAX package's: the same
    candidates stay finite, within 1e-5 of their errors. At 40x24 the visit
    goes through E or F; the 64x64 control still goes through C or D."""
    (js, jc, jrefp), (ts, tc, trefp) = _setup(small_image.tobytes(), width,
                                              height, perceptual)
    rng = np.random.default_rng(100 * p + 10 * i + channel)
    cand5 = np.repeat(np.asarray(js.palette)[p, i][None], 32, axis=0)
    cand5[:, channel] = np.arange(32)
    far = np.array([[31, 0, 31], [0, 31, 31], [31, 31, 0], [0, 0, 31]])
    cand5 = np.concatenate(
        [cand5, rng.integers(0, 32, (12, 3)), far]).astype(np.int32)

    j_err, _, _ = jref._undithered_machinery(js, jc, p, i)
    want = np.asarray(j_err(jrefp, jnp.asarray(cand5), carried_base=True))
    t_err, t_map, t_dall = tref._undithered_machinery(ts, tc, p, i)
    got, dists = t_err(trefp, torch.from_numpy(cand5), carried_base=True)
    got = got.numpy()

    fused = width % 32 == 0 and height % 32 == 0
    c, d, e, f = (routes[name] for name in ROUTES)
    assert (c, d, e, f) == (
        (int(not perceptual), int(perceptual), 0, 0) if fused
        else (0, 0, int(not perceptual), int(perceptual)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got).sum() == tc.prescreen_full
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=VISIT_ERR_RTOL, atol=0)
    # The best candidate's map and cache plane, from its distance plane.
    best = int(np.argmin(want))
    dist = dists(torch.tensor([best]))[0]
    j_machinery = jref._undithered_machinery(js, jc, p, i)
    np.testing.assert_array_equal(
        t_map(dist).numpy(), np.asarray(j_machinery[1](jnp.asarray(cand5[best]))))
    if not perceptual:
        np.testing.assert_array_equal(
            t_dall(dist).numpy(),
            np.asarray(j_machinery[2](jnp.asarray(cand5[best]))))


def test_run_fused_dithered_any_geometry_matches_jax(small_image):
    """A dithered run at 40x24 (kernel B's twin meets odd scales in all
    three stages): the JAX package's palette, map and JSON bytes; step
    errors within 1e-3, the dithered visits' bound
    (tests/test_torch_refine.py)."""
    img = _crop(small_image, 40, 24)
    kw = dict(CFG, width=40, height=24, dither=True)
    tc, jc = TConfig(**kw), JConfig(**kw)
    with single_torch_thread():
        state, errors, _ = tpipe.run_fused(img, tc, device="cpu")
    jstate, jerrors, _ = jpipe.run_fused(img, jc)
    np.testing.assert_array_equal(state.palette.numpy(),
                                  np.asarray(jstate.palette))
    np.testing.assert_array_equal(state.palette_map.numpy(),
                                  np.asarray(jstate.palette_map))
    assert t_json(state, tc) == j_json(jstate, jc)
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=1e-3)


@pytest.mark.parametrize("nes", [False, True])
def test_state_round_trip_any_geometry(nes, rng):
    """`state_from_numpy` and `state_to_numpy` at 256x240 (30 x 32 tiles),
    with a palette snapped to the NES colours."""
    cfg = TConfig(subpalette_count=4, subpalette_size=3, width=256,
                  height=240, nes=nes)
    img = bench_image(0)[:240]
    st = new_state(img, cfg, "cpu")
    assert st.tile_palettes.shape == (30, 32)
    assert st.palette_map.shape == (240, 256)
    arrays = state_to_numpy(st)
    palette = torch.from_numpy(rng.integers(0, 32, (4, 3, 3)).astype(np.int32))
    if nes:
        palette = nes_quantize(palette, False)
    arrays["palette"] = palette.numpy()
    arrays["tile_palettes"] = rng.integers(0, 4, (30, 32)).astype(np.int32)
    arrays["palette_map"] = rng.integers(0, 3, (240, 256)).astype(np.int32)
    back = state_to_numpy(state_from_numpy(arrays, "cpu"))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == (np.uint8 if k == "original" else np.int32)
    np.testing.assert_array_equal(back["original"], img)


