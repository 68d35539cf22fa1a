"""Colour subset, k-means and init of the port, bit-equal to the JAX
package on the CPU."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import _test_image
from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import init as tinit
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core.state import new_state as t_new_state
from snesimage_torch.core.state import state_from_numpy
from snesimage_torch.ops import color as tcolor
from snesimage_torch.ops.kmeans import lloyd_kmeans as t_kmeans
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import init as jinit
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core.state import new_state as j_new_state
from snesimage_tpu.ops import color as jcolor
from snesimage_tpu.ops.kmeans import lloyd_kmeans as j_kmeans

# chip_smoke.INIT_HASH: the JAX package's CPU value for the balanced
# config on bench._test_image(0).
INIT_HASH = "db244f60c99d56558e113293b47e919710bcbb9d3a3929b5f83b1ba82ad4c6d9"
BALANCED = dict(
    subpalette_count=8, subpalette_size=15, max_steps=8, converge_tol=0.0,
    seed=0, schedule="channel", prescreen=8, prescreen_full=2,
    channel_explore=16, accept_margin=0.005,
)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _init_hash(state) -> str:
    h = hashlib.sha256()
    for a in (state.tile_palettes, state.palette, state.palette_map):
        h.update(np.ascontiguousarray(_np(a), dtype=np.int32).tobytes())
    return h.hexdigest()


def test_color_subset_exact(rng):
    c5 = np.arange(-5, 40, dtype=np.int32)
    np.testing.assert_array_equal(
        _np(tcolor.expand_5bit_to_8bit(torch.from_numpy(c5))),
        _np(jcolor.expand_5bit_to_8bit(jnp.asarray(c5))),
    )
    pal = rng.integers(0, 32, (8, 15, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tcolor.pack_bgr555(torch.from_numpy(pal))),
        _np(jcolor.pack_bgr555(jnp.asarray(pal))),
    )
    x = np.concatenate(
        [np.arange(0, 40, 0.5), rng.random(200) * 255]
    ).astype(np.float32)
    got = _np(tcolor.round_half_away_nonneg(torch.from_numpy(x)))
    np.testing.assert_array_equal(
        got, _np(jcolor.round_half_away_nonneg(jnp.asarray(x)))
    )
    assert got[1] == 1.0 and got[5] == 3.0  # 0.5 -> 1, 2.5 -> 3
    a = rng.integers(0, 256, (4096, 3)).astype(np.int32)
    b = rng.integers(0, 256, (4096, 3)).astype(np.int32)
    a[:2] = [[0, 0, 0], [255, 255, 255]]
    b[:2] = [[255, 255, 255], [0, 0, 0]]
    np.testing.assert_array_equal(
        _np(tcolor.red_mean_sq_scaled(torch.from_numpy(a), torch.from_numpy(b))),
        _np(jcolor.red_mean_sq_scaled(jnp.asarray(a), jnp.asarray(b))),
    )
    codes = np.arange(256, dtype=np.int32)
    np.testing.assert_array_equal(
        _np(tcolor.srgb_u8_to_linear(torch.from_numpy(codes))),
        _np(jcolor.srgb_u8_to_linear(jnp.asarray(codes))),
    )


@pytest.mark.parametrize("k", [3, 7])
def test_lloyd_kmeans_bit_equal(small_image, k):
    """On image data: the pixels of small_image and its 8x8 tile means."""
    rgb = small_image[..., :3].astype(np.float32)
    tiles = rgb.reshape(8, 8, 8, 8, 3).mean(axis=(1, 3)).reshape(-1, 3)
    for data, mask in (
        (rgb.reshape(-1, 3), small_image[..., 3].reshape(-1) > 0),
        (tiles, tiles.sum(-1) > 0),
    ):
        order = np.random.default_rng(k).permutation(len(data)).astype(np.int32)
        t = t_kmeans(torch.from_numpy(data), torch.from_numpy(mask), k,
                     init_order=torch.from_numpy(order))
        j = j_kmeans(jnp.asarray(data), jnp.asarray(mask), k,
                     init_order=jnp.asarray(order))
        np.testing.assert_array_equal(_np(t.centers), _np(j.centers))
        np.testing.assert_array_equal(
            _np(t.assignments)[mask], _np(j.assignments)[mask]
        )
        assert int(t.iterations) == int(j.iterations)
        assert bool(t.converged) == bool(j.converged)


def test_kmeans_square_add_rounds_once(rng):
    """`_square_add` is a fused multiply-add. (1 + 2^-12)^2 lies halfway
    between two float32 values; a small positive addend must lift it to the
    upper one, which the float64 sum rounded to float32 misses (it loses the
    addend and then breaks the tie to even). On random operands it equals
    the exact sum rounded once."""
    from fractions import Fraction

    from snesimage_torch.ops.kmeans import _square_add

    a = np.float32([1 + 2.0**-12, 1 + 2.0**-12, 1 + 3 * 2.0**-12, 3.0])
    c = np.float32([2.0**-60, -(2.0**-60), 2.0**-60, 7.0])
    got = _square_add(torch.from_numpy(a), torch.from_numpy(c)).numpy()
    naive = (a.astype(np.float64) ** 2 + c.astype(np.float64)).astype(
        np.float32)
    step_up = np.nextafter(naive, np.float32(np.inf))
    np.testing.assert_array_equal(
        got, [step_up[0], naive[1], step_up[2], np.float32(16.0)])

    a = (rng.random(200) * 255).astype(np.float32)
    c = (rng.random(200) * 1e5).astype(np.float32)
    got = _square_add(torch.from_numpy(a), torch.from_numpy(c)).numpy()
    for ai, ci, gi in zip(a, c, got):
        exact = Fraction(float(ai)) ** 2 + Fraction(float(ci))
        near = [np.nextafter(gi, np.float32(-np.inf)), gi,
                np.nextafter(gi, np.float32(np.inf))]
        assert min(near, key=lambda v: abs(Fraction(float(v)) - exact)) == gi


def _both_states(img, kwargs):
    tc, jc = TConfig(**kwargs), JConfig(**kwargs)
    return (t_new_state(img, tc, "cpu"), tc), (j_new_state(img, jc), jc)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(subpalette_count=2, subpalette_size=4, width=64, height=64),
        dict(subpalette_count=3, subpalette_size=7, width=64, height=64),
        dict(subpalette_count=1, subpalette_size=5, width=64, height=64),
    ],
)
def test_init_bit_equal_small(small_image, kwargs):
    (ts, tc), (js, jc) = _both_states(small_image, kwargs)
    ta, ja = tinit.assign_tiles(ts, tc), jinit.assign_tiles(js, jc)
    np.testing.assert_array_equal(_np(ta.tile_palettes), _np(ja.tile_palettes))
    np.testing.assert_array_equal(_np(ta.palette), _np(ja.palette))
    tr = tinit.recalculate_palettes(ta, tc)
    jr = jinit.recalculate_palettes(ja, jc)
    np.testing.assert_array_equal(_np(tr.palette), _np(jr.palette))
    # and from the JAX package's own assignment, carried across
    carried = state_from_numpy(
        {f: np.asarray(getattr(ja, f)) for f in ja._fields}, "cpu"
    )
    np.testing.assert_array_equal(
        _np(tinit.recalculate_palettes(carried, tc).palette), _np(jr.palette)
    )


def test_init_hash_pinned_bench_image():
    """initialize + cluster on the bench image with the balanced config:
    both packages give the pinned hash that chip_smoke.py checks on the
    card."""
    img = _test_image(0)
    (ts, tc), (js, jc) = _both_states(img, BALANCED)
    t = tpipe.cluster(tpipe.initialize(ts, tc), tc)
    j = jpipe.cluster(jpipe.initialize(js, jc), jc)
    np.testing.assert_array_equal(_np(t.tile_palettes), _np(j.tile_palettes))
    np.testing.assert_array_equal(_np(t.palette), _np(j.palette))
    np.testing.assert_array_equal(_np(t.palette_map), _np(j.palette_map))
    assert _init_hash(j) == INIT_HASH
    assert _init_hash(t) == INIT_HASH


def test_chip_smoke_pins_the_same_hash():
    import chip_smoke

    assert chip_smoke.INIT_HASH == INIT_HASH
    assert chip_smoke.BALANCED == BALANCED
