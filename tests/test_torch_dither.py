"""The port's Floyd-Steinberg wavefront (ops/dither.py, the plain twin of
kernel G) against the JAX package on the CPU, from inputs made with numpy.

Tolerances, each asserted below:
- against the JAX scan (`snesimage_tpu.ops.dither.remap_dithered`, the
  semantic target): equal maps in both distance modes. Both sides work in
  float32 with the same operations in the same order, the red-mean
  distances are integers, and the port's Lab and CIEDE2000 repeat the JAX
  CPU arithmetic (tests/test_torch_perceptual.py);
- against the JAX Pallas kernel run with interpret=True: the share of equal
  pixels, at least 0.99 red-mean and 0.97 perceptual, because that kernel
  takes the red-mean in float32 (its terms pass 2^24) and Lab from a
  polynomial sRGB decode and an exp/log cube root, and error diffusion
  turns one flipped pixel into many;
- against the serial C++ oracle (float64 errors): the JAX tests' own
  shares, above 0.99 red-mean and above 0.97 perceptual.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core import refine as tref
from snesimage_torch.core.state import new_state as t_new_state
from snesimage_torch.core.state import state_from_numpy, state_to_numpy
from snesimage_torch.ops import cuda_dither
from snesimage_torch.ops import dither as tdither
from snesimage_torch.ops.remap import quantize_target_u8 as t_quantize
from snesimage_torch.ops.remap import remap_undithered as t_remap_undithered
from snesimage_torch.testing import bench_image, single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core import refine as jref
from snesimage_tpu.core.state import new_state as j_new_state
from snesimage_tpu.native import oracle_remap
from snesimage_tpu.ops import dither as jdither
from snesimage_tpu.ops.color import expand_5bit_to_8bit as j_expand
from snesimage_tpu.ops.color import srgb_u8_to_lab as j_lab
from snesimage_tpu.ops.pallas_dither import dither_remap_candidates as j_pallas
from snesimage_tpu.ops.remap import quantize_target_u8 as j_quantize

PALLAS_SHARE = {False: 0.99, True: 0.97}
ORACLE_SHARE = {False: 0.99, True: 0.97}
# chip_smoke.INIT_HASH_DITHER and INIT_HASH_DITHER_PERCEPTUAL: sha256 of the
# init artifacts on the bench image with the dithered balanced configs.
INIT_HASH_DITHER = (
    "7982a1753127d7659979b0cdd0dd7a4b66999a6b1f4dad01a62815cddd6da854"
)
INIT_HASH_DITHER_PERCEPTUAL = (
    "2f36a75bc43c5ab1daf98713d4461cf8b2cc31066d817954a1e87a16b655628c"
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    with single_torch_thread():
        yield


def _fixture(seed, h, w, c, s, smooth=False):
    """RGBA image with a transparent tile and an interior transparent block
    off the tile grid, a tile map, and a palette whose entries 0 and 1 are
    duplicates in every subpalette (exact distance ties)."""
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    if smooth:
        y, x = np.mgrid[0:h, 0:w]
        rgba[..., 0] = (x * 7) % 256
        rgba[..., 1] = (y * 5) % 256
        rgba[..., 2] = ((x + y) * 3) % 256
    rgba[..., 3] = 255
    rgba[0:8, 0:8, 3] = 0
    rgba[11:15, 9:14, 3] = 0
    tp = rng.integers(0, c, (h // 8, w // 8)).astype(np.int32)
    pal = rng.integers(0, 32, (c, s, 3)).astype(np.int32)
    pal[:, 1] = pal[:, 0]
    return rgba, tp, pal


def _t(rgba, tp, pal):
    return (torch.from_numpy(rgba[..., :3].astype(np.int32)),
            torch.from_numpy(rgba[..., 3].astype(np.int32)),
            torch.from_numpy(tp), torch.from_numpy(pal))


def _j(rgba, tp, pal):
    return (jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp), jnp.asarray(pal))


@pytest.mark.parametrize("h,w", [(16, 16), (8, 24), (32, 16)])
def test_skew_unskew_match_jax(rng, h, w):
    img = rng.integers(0, 256, (h, w, 3)).astype(np.int32)
    sk = tdither.skew(torch.from_numpy(img), fill=-1)
    np.testing.assert_array_equal(
        sk.numpy(), np.asarray(jdither.skew(jnp.asarray(img), fill=-1)))
    assert sk.shape == (h, w + 2 * h - 2, 3)
    np.testing.assert_array_equal(tdither.unskew(sk, h, w).numpy(), img)
    plane = torch.from_numpy(img[..., 0].copy())
    np.testing.assert_array_equal(
        tdither.unskew(tdither.skew(plane), h, w).numpy(), img[..., 0])


def test_quantize_target_u8_matches_jax(rng):
    x = np.concatenate([
        np.arange(-3, 260, 0.5), rng.uniform(-20, 280, 500)
    ]).astype(np.float32)
    np.testing.assert_array_equal(
        t_quantize(torch.from_numpy(x)).numpy(),
        np.asarray(j_quantize(jnp.asarray(x))))
    assert t_quantize(torch.tensor([0.5, 1.5, 2.5])).tolist() == [1, 2, 3]


def test_damped_weights_match_jax():
    from snesimage_tpu.constants import DITHER_DAMPING, DITHER_WEIGHTS

    want = np.asarray(jnp.asarray(DITHER_WEIGHTS) * DITHER_DAMPING)
    np.testing.assert_array_equal(tdither.damped_weights(), want)


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize(
    "seed,h,w,c,s,smooth",
    [(0, 32, 32, 2, 4, False), (1, 16, 32, 4, 15, True),
     (2, 32, 24, 4, 15, False), (3, 24, 24, 2, 4, True)],
)
def test_remap_dithered_equals_jax_scan(seed, h, w, c, s, smooth, perceptual):
    """Equal maps, with transparent regions and duplicate entries."""
    fx = _fixture(seed, h, w, c, s, smooth)
    want = np.asarray(jdither.remap_dithered(*_j(*fx), perceptual))
    got = tdither.remap_dithered(*_t(*fx), perceptual)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[0:8, 0:8] == 0).all()  # transparent pixels map to 0
    assert not (got.numpy() == 1).any()  # a duplicate never beats its first


@pytest.mark.parametrize("perceptual", [False, True])
def test_remap_dithered_against_oracle(perceptual):
    fx = _fixture(5, 32, 32, 2, 4)
    want = oracle_remap(*fx, dither=True, perceptual=perceptual)
    got = tdither.remap_dithered(*_t(*fx), perceptual).numpy()
    share = (got == want).mean()
    assert share > ORACLE_SHARE[perceptual], share


@pytest.mark.parametrize("perceptual", [False, True])
def test_zero_weights_equal_undithered(perceptual):
    fx = _fixture(6, 24, 32, 4, 15, smooth=True)
    got = tdither.remap_dithered(*_t(*fx), perceptual, weights=np.zeros(4))
    want = t_remap_undithered(*_t(*fx), perceptual)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _pallas_maps(rgba, tp, pal, p, i, cands, perceptual):
    """The JAX Pallas wavefront in interpret mode, unskewed to (B, H, W)."""
    h, w = rgba.shape[:2]
    orig_sk, entries_cm, tp_sk, aff_sk, alpha_sk, xof_sk, _ = (
        jdither._prep_skewed(*_j(rgba, tp, pal), p))
    cand8 = j_expand(jnp.asarray(cands))
    labs = ()
    if perceptual:
        ent8 = j_expand(jnp.asarray(pal))
        labs = (
            jnp.transpose(j_lab(ent8), (0, 2, 1)).reshape(-1, 3 * pal.shape[1]),
            j_lab(cand8),
        )
    out = j_pallas(orig_sk, entries_cm, tp_sk, aff_sk, alpha_sk, xof_sk,
                   cand8.astype(jnp.float32), i, *labs, img_w=w,
                   interpret=True)
    yy, cc = jdither._skew_indices(h, w)
    return np.asarray(jnp.swapaxes(out, 1, 2))[:, np.asarray(yy),
                                               np.asarray(cc)]


@pytest.mark.parametrize("perceptual", [False, True])
def test_dither_candidates_against_jax(perceptual):
    """Equal to the JAX scan fallback (a vmap over candidate palettes);
    within the stated share of the interpret-mode Pallas kernel."""
    rgba, tp, pal = _fixture(7, 16, 16, 2, 4)
    rng = np.random.default_rng(8)
    p, i = 1, 2
    cands = rng.integers(0, 32, (3, 3)).astype(np.int32)
    cands[2] = pal[p, 0]  # a candidate that ties with entry 0
    got = tdither.dither_candidates(*_t(rgba, tp, pal), p, i,
                                    torch.from_numpy(cands), perceptual)
    assert got.shape == (3, 16, 16) and got.dtype == torch.int32
    scan = np.asarray(jdither.dither_candidates(
        *_j(rgba, tp, pal), p, i, jnp.asarray(cands), perceptual))
    np.testing.assert_array_equal(got.numpy(), scan)
    share = (got.numpy() == _pallas_maps(rgba, tp, pal, p, i, cands,
                                         perceptual)).mean()
    assert share >= PALLAS_SHARE[perceptual], share


@pytest.mark.parametrize("perceptual", [False, True])
def test_candidate_row_equals_full_remap(perceptual):
    """Row b of dither_candidates is the remap with candidate b in the
    slot, so an accepted candidate's map needs no second wavefront; a
    negative p overrides nothing. The wrapper takes the twin on CPU
    tensors and counts no launch."""
    rgba, tp, pal = _fixture(9, 24, 16, 2, 4, smooth=True)
    rng = np.random.default_rng(10)
    p, i = 0, 3
    cands = rng.integers(0, 32, (4, 3)).astype(np.int32)
    before = cuda_dither.dither_remap_candidates.launches
    maps = cuda_dither.dither_remap_candidates(
        *_t(rgba, tp, pal), p, i, torch.from_numpy(cands), perceptual)
    assert cuda_dither.dither_remap_candidates.launches == before
    for b, c5 in enumerate(cands):
        changed = pal.copy()
        changed[p, i] = c5
        want = tdither.remap_dithered(*_t(rgba, tp, changed), perceptual)
        np.testing.assert_array_equal(maps[b].numpy(), want.numpy())
    plain = cuda_dither.dither_remap_candidates(
        *_t(rgba, tp, pal), -1, 0, torch.from_numpy(cands[:1]), perceptual)
    np.testing.assert_array_equal(
        plain[0].numpy(),
        tdither.remap_dithered(*_t(rgba, tp, pal), perceptual).numpy())


def _init_hash(state) -> str:
    h = hashlib.sha256()
    for a in (state.tile_palettes, state.palette, state.palette_map):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(np.ascontiguousarray(a, dtype=np.int32).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("perceptual", [False, True])
def test_full_remap_dithered_and_state_round_trip(small_image, perceptual):
    """`full_remap` with dither on a JAX state carried across: the same
    map; and the dithered state survives the way back."""
    kw = dict(subpalette_count=2, subpalette_size=4, width=32, height=32,
              schedule="channel", prescreen=8, prescreen_full=2, dither=True,
              perceptual_palettes=perceptual)
    img = small_image[:32, :32].copy()
    img[4:9, 20:27, 3] = 0
    jc, tc = JConfig(**kw), TConfig(**kw)
    js = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    fields = {f: np.asarray(getattr(js, f)) for f in js._fields}
    ts = state_from_numpy(fields, "cpu")
    again = tref.full_remap(ts.replace(palette_map=ts.palette_map * 0), tc)
    np.testing.assert_array_equal(again.palette_map.numpy(),
                                  fields["palette_map"])
    back = state_to_numpy(again)
    for f in js._fields:
        np.testing.assert_array_equal(back[f], fields[f])
    own = tpipe.cluster(tpipe.initialize(t_new_state(img, tc, "cpu"), tc), tc)
    assert _init_hash(own) == _init_hash(js)


@pytest.mark.parametrize(
    "perceptual,pinned",
    [(False, INIT_HASH_DITHER), (True, INIT_HASH_DITHER_PERCEPTUAL)],
    ids=["red-mean", "perceptual"],
)
def test_dithered_init_hash_pinned_bench_image(perceptual, pinned):
    """initialize + cluster on the bench image with the dithered balanced
    configs: both packages give the hash that chip_smoke.py checks on the
    card."""
    import chip_smoke

    params = chip_smoke.DITHER_PERCEPTUAL if perceptual else chip_smoke.DITHER
    img = bench_image(0)
    tc, jc = TConfig(**params), JConfig(**params)
    t = tpipe.cluster(tpipe.initialize(t_new_state(img, tc, "cpu"), tc), tc)
    j = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    np.testing.assert_array_equal(t.palette_map.numpy(),
                                  np.asarray(j.palette_map))
    assert _init_hash(j) == pinned
    assert _init_hash(t) == pinned
    assert pinned == (chip_smoke.INIT_HASH_DITHER_PERCEPTUAL if perceptual
                      else chip_smoke.INIT_HASH_DITHER)
