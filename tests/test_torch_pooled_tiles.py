"""Kernels E and F restricted to the tiles of the visited subpalette, on
the CPU (each wrapper runs its plain twin here; tests/test_torch_cuda.py
holds the kernels to the twins on the card).

A visit of slot (p, i) passes the tile map and p (`refine.pooled_inputs`),
and E and F then compute only the 8x8 tiles of subpalette p: 0 sums and
+inf distances elsewhere. The prologue's win rule lets no pixel off those
tiles win, so on a real visit's operands the restricted sums equal the
unrestricted ones bit for bit everywhere, and F's distance planes equal
them on the tiles of p. The visits here are built by `slot_context` on a
48x40 image (sides not multiples of 32: the route through E and F) with
three subpalettes, the third of which owns no tile, and transparent
pixels; the sums also agree with the JAX package's
`pooled_wins_redmean` (its Pallas kernel in interpret mode) and
`pooled_wins_ciede` (the XLA chain with `color.ciede2000`, as its tests
run it off the TPU): mask counts equal, the m*ML sums within 1e-5 (16
floats added in another order).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core import refine
from snesimage_torch.core.state import state_from_numpy
from snesimage_torch.ops import cuda_prescreen
from snesimage_torch.ops.color import expand_5bit_to_8bit
from snesimage_tpu.ops import color as jcolor
from snesimage_tpu.ops import pallas_prescreen as pp

H, W, C, S, B = 40, 48, 3, 4, 7
POOLED_SUM_TOL = 1e-5
# (p, i): both subpalettes with tiles, two slots each; p = 2 owns no tile
VISITS = [(0, 0), (0, 3), (1, 1), (2, 2)]


@lru_cache(maxsize=None)
def _state(perceptual: bool):
    rng = np.random.default_rng(8)
    original = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    original[..., 3] = 255
    original[8:13, 17:30, 3] = 0  # transparent pixels inside tiles
    tiles = rng.integers(0, 2, (H // 8, W // 8)).astype(np.int32)
    tiles[-1, :] = 1  # the last row of tiles all subpalette 1
    palette = rng.integers(0, 32, (C, S, 3)).astype(np.int32)
    state = state_from_numpy(dict(
        original=original, tile_palettes=tiles, palette=palette,
        palette_map=np.zeros((H, W), np.int32)), "cpu")
    config = QuantConfig(subpalette_count=C, subpalette_size=S, width=W,
                         height=H, perceptual_palettes=perceptual)
    return state, config, refine.compute_d_all(state, config)


def _visit(perceptual: bool, p: int, i: int):
    """The arguments `pooled_inputs` gives kernel E or F at a visit of slot
    (p, i): B candidates, the slot's own colour and a duplicate among
    them."""
    state, config, d_all = _state(perceptual)
    ctx = refine.slot_context(state, config, p, i, d_all)
    rng = np.random.default_rng(10 * p + i)
    cand5 = rng.integers(0, 32, (B, 3)).astype(np.int32)
    cand5[0] = state.palette[p, i].numpy()
    cand5[-1] = cand5[1]
    args = refine.pooled_inputs(ctx, expand_5bit_to_8bit(
        torch.from_numpy(cand5)))
    assert args[-1] == p and args[-2] is state.tile_palettes
    return ctx, args


def _wrapper(perceptual: bool):
    return (cuda_prescreen.pooled_wins_ciede if perceptual
            else cuda_prescreen.pooled_wins_redmean)


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("p,i", VISITS)
def test_restricted_equals_unrestricted(perceptual, p, i):
    """The restricted twin's sums equal the unrestricted twin's bit for bit
    everywhere; F's distance planes equal them on the tiles of p and are
    +inf elsewhere; a p without tiles gives only zeros."""
    ctx, args = _visit(perceptual, p, i)
    wrapper = _wrapper(perceptual)
    full, part = wrapper(*args[:-2]), wrapper(*args)
    if perceptual:
        (full, full_d), (part, part_d) = full, part
        pixels = ctx.affected
        assert part_d.shape == (B, H, W)
        assert torch.equal(part_d[:, pixels], full_d[:, pixels])
        assert bool(torch.isinf(part_d[:, ~pixels]).all())
        assert bool((part_d[:, ~pixels] > 0).all())
    assert part.shape == (B, 4, H // 4, W // 4)
    assert torch.equal(part, full)
    if not bool(ctx.affected.any()):
        assert p == 2 and not bool(part.any())
    else:
        assert float(part[:, 0].sum()) > 0  # some candidate wins a pixel


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("p,i", VISITS[:3])
def test_restricted_matches_jax(perceptual, p, i):
    """The restricted sums against the JAX package's on the same
    operands: mask counts equal, the m*ML sums within 1e-5."""
    _, args = _visit(perceptual, p, i)
    got = _wrapper(perceptual)(*args)
    ops = [jnp.asarray(a.numpy()) for a in args[:-2]]
    if perceptual:
        got, got_d = got
        tlab, cand_lab = ops[:2]
        want, want_d = pp.pooled_wins_ciede(
            *ops, lambda: jax.vmap(lambda c: jcolor.ciede2000(
                jnp.moveaxis(tlab, 0, -1), c))(cand_lab))
        on = np.isfinite(got_d.numpy())
        np.testing.assert_allclose(got_d.numpy()[on], np.asarray(want_d)[on],
                                   rtol=0, atol=1e-4)
    else:
        want = pp.pooled_wins_redmean(*ops, interpret=True)
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy()[:, 0], want[:, 0])
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=POOLED_SUM_TOL)


@pytest.mark.parametrize("perceptual", [False, True])
def test_restricted_takes_an_image_axis(perceptual):
    """With a leading image axis on every operand, the tile maps too, each
    image gives what it gives alone."""
    _, args = _visit(perceptual, 1, 1)
    *ops, tiles, p = args
    flipped = [a.flip(-2) if a.shape[-2:] == (H, W) else a for a in ops]
    pair = [torch.stack([a, b]) for a, b in zip(ops, flipped)]
    got = _wrapper(perceptual)(*pair, torch.stack([tiles, tiles.flip(0)]), p)
    alone = _wrapper(perceptual)(*flipped, tiles.flip(0), p)
    first = _wrapper(perceptual)(*args)
    for g, a, f in zip(*(o if perceptual else (o,)
                         for o in (got, alone, first))):
        assert torch.equal(g[0], f) and torch.equal(g[1], a)


def test_restricted_wrappers_reject_half_operands():
    _, args = _visit(False, 0, 0)
    with pytest.raises(ValueError, match="tile map and p together"):
        cuda_prescreen.pooled_wins_redmean(*args[:-1])
    _, args = _visit(True, 0, 0)
    with pytest.raises(ValueError, match="tile map and p together"):
        cuda_prescreen.pooled_wins_ciede(*args[:-2], None, 0)
