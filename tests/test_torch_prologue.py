"""Kernel A's fused entries (ops/cuda_prescreen.py `visit_prologue` and
`render_palette_maps`) against the JAX package on the CPU, and the entry
points' device default.

On the CPU each wrapper runs its plain twin, so these tests pin what the
CUDA entries are held to bit for bit on the card (chip_smoke.py,
tests/test_torch_cuda.py). Every comparison is exact: the outputs are
first minima, copies of table entries, comparisons and integer adds.

- The prologue against the expressions of snesimage_tpu/core/refine.py
  `_undithered_machinery` (the first minima, the no-candidate key and the
  frame from the JAX `select_colors` in interpret mode), and its win-rule
  operands against the torch composition the visit used before the
  prologue existed. The distance planes take few distinct values, so
  ties between entries are everywhere.
- The render entry against the JAX dithered visit's one-hot contraction
  over S (`_candidate_errors_dithered`).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core import pipeline
from snesimage_torch.core.state import new_state
from snesimage_torch.ops import cuda_prescreen
from snesimage_torch.testing import expect_launches
from snesimage_tpu.core import refine as jref
from snesimage_tpu.ops import pallas_prescreen as pp
from snesimage_tpu.ops.color import expand_5bit_to_8bit as j_expand
from snesimage_tpu.ops.color import srgb_u8_to_linear as j_linear

INT32_MAX = np.iinfo(np.int32).max
INT32_MIN = np.iinfo(np.int32).min


def _operands(seed, h, w, c, s, perceptual):
    """Distance planes full of ties, an alpha plane with scattered and
    block transparency, a tile map and a palette whose entries 0 and 1
    are duplicates."""
    rng = np.random.default_rng(seed)
    if perceptual:
        d_all = rng.choice(np.float32([0.0, 1.5, 2.25, 7.0]), (s, h, w))
    else:
        d_all = rng.integers(0, 5, (s, h, w)).astype(np.int32) * 1000
    alpha = np.full((h, w), 255, np.int32)
    alpha[::3, ::5] = 0
    alpha[h // 2:h // 2 + 5, 2:9] = 0
    tiles = rng.integers(0, c, (h // 8, w // 8)).astype(np.int32)
    pal = rng.integers(0, 32, (c, s, 3)).astype(np.int32)
    if s > 1:
        pal[:, 1] = pal[:, 0]
    d_all = d_all.astype(np.float32 if perceptual else np.int32)
    return d_all, alpha, tiles, pal


def _jax_prologue(d_all, alpha, tiles, pal, p, i):
    """snesimage_tpu/core/refine.py:263-284 on these operands."""
    s = pal.shape[1]
    d_all = jnp.asarray(d_all)
    big = INT32_MAX if d_all.dtype == jnp.int32 else jref._BIG
    excl = (jnp.arange(s) == i)[:, None, None]
    d_masked = jnp.where(excl, big, d_all)
    best_val = jnp.min(d_masked, axis=0)
    best_idx = jnp.argmin(d_masked, axis=0).astype(jnp.int32)
    base_idx = jnp.argmin(d_all, axis=0).astype(jnp.int32)
    tp_pix = jnp.repeat(jnp.repeat(jnp.asarray(tiles), 8, axis=0), 8, axis=1)
    affected = tp_pix == p
    opaque = jnp.asarray(alpha) > 0
    entries_lin_flat = j_linear(j_expand(jnp.asarray(pal))).reshape(-1, 3)
    idx_nc = jnp.where(affected, best_idx, base_idx)
    key_nc = jnp.where(opaque, tp_pix * s + idx_nc, entries_lin_flat.shape[0])
    lnc = pp.select_colors(key_nc, entries_lin_flat.T.astype(jnp.float32),
                           interpret=True)
    return {
        "best_val": best_val, "best_idx": best_idx, "base_idx": base_idx,
        "affected": affected, "map_nc": jnp.where(opaque, idx_nc, 0),
        "lnc": lnc, "opaque": opaque,
    }


def _composition(want, i, perceptual):
    """The win-rule operands as the visit composed them in torch before
    the prologue (refine.pooled_inputs), from the JAX values."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in want.items()}
    mask = t["affected"] & t["opaque"]
    adj = (i < t["best_idx"]).to(torch.int32)
    ml = torch.where(mask[None], t["lnc"], 0.0)
    if perceptual:
        return (torch.where(mask, t["best_val"], -3.0e38), adj), ml
    bva = torch.where(
        mask,
        torch.where(t["best_val"] == INT32_MAX, t["best_val"],
                    t["best_val"] + adj),
        INT32_MIN,
    )
    return (bva,), ml


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize(
    # a geometry that is not 32-aligned both ways, slot 0 and the last slot,
    # a full 15-entry subpalette, and one-entry subpalettes (no other entry:
    # the best value without slot i is the exclusion value itself)
    "h,w,c,s,p,i", [(40, 24, 3, 4, 1, 0), (24, 40, 2, 5, 0, 4),
                    (32, 32, 4, 15, 3, 7), (16, 24, 2, 1, 1, 0)],
)
def test_visit_prologue_matches_jax(h, w, c, s, p, i, perceptual):
    d_all, alpha, tiles, pal = _operands(h + w + s, h, w, c, s, perceptual)
    want = _jax_prologue(d_all, alpha, tiles, pal, p, i)
    with expect_launches():
        got = cuda_prescreen.visit_prologue(
            torch.from_numpy(d_all), torch.from_numpy(tiles),
            torch.from_numpy(alpha), torch.from_numpy(pal), p, i)
    for name in ("best_val", "best_idx", "base_idx", "affected", "map_nc",
                 "lnc"):
        value = getattr(got, name)
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[name]),
                                      err_msg=name)
    assert got.best_idx.dtype == got.base_idx.dtype == torch.int32
    assert got.map_nc.dtype == torch.int32 and got.affected.dtype == torch.bool
    assert got.best_val.dtype == (torch.float32 if perceptual else torch.int32)
    rule, ml = _composition(want, i, perceptual)
    assert len(got.rule) == len(rule)
    for a, b in zip(got.rule, rule):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(got.ml, ml)
    # transparent pixels: colour 0 and entry 0
    assert bool((got.lnc[:, torch.from_numpy(alpha) == 0] == 0).all())


@pytest.mark.parametrize(
    "h,w,c,s,b,p,i", [(40, 24, 3, 4, 5, 2, 0), (24, 40, 2, 5, 3, 0, 4)])
def test_render_palette_maps_matches_jax(h, w, c, s, b, p, i):
    _, alpha, tiles, pal = _operands(h * w + b, h, w, c, s, False)
    rng = np.random.default_rng(b)
    maps = rng.integers(0, s, (b, h, w)).astype(np.int32)
    cand5 = rng.integers(0, 32, (b, 3)).astype(np.int32)
    # JAX: the dithered visit's one-hot contraction over S.
    tp_pix = jnp.repeat(jnp.repeat(jnp.asarray(tiles), 8, axis=0), 8, axis=1)
    sub_lin_pix = j_linear(j_expand(jnp.asarray(pal)))[tp_pix]
    opaque = jnp.asarray(alpha) > 0
    cand_lin = j_linear(j_expand(jnp.asarray(cand5)))
    want = []
    for pm, c_lin in zip(jnp.asarray(maps), cand_lin):
        onehot = (pm[..., None] == jnp.arange(s)).astype(jnp.float32)
        lin = jnp.sum(sub_lin_pix * onehot[..., None], axis=-2)
        use_c = (tp_pix == p) & (pm == i) & opaque
        lin = jnp.where(use_c[..., None], c_lin, lin)
        want.append(jnp.moveaxis(jnp.where(opaque[..., None], lin, 0.0), -1, 0))
    with expect_launches():
        got = cuda_prescreen.render_palette_maps(
            torch.from_numpy(maps), torch.from_numpy(tiles),
            torch.from_numpy(alpha), torch.from_numpy(pal),
            torch.from_numpy(cand5), p, i)
    assert got.shape == (b, 3, h, w) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_entry_points_default_to_the_card(small_image, monkeypatch):
    """`run_fused` and `new_state` run on the card unless asked for the
    CPU; on a host without a card `run_fused` raises and does not fall
    back to the CPU."""
    for fn in (pipeline.run_fused, new_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                         height=64, max_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run_fused(small_image, config)
