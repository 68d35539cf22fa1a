"""The perceptual path (`perceptual_palettes=True`) of the port against the
benchmark's plain reference (perfbench/reference/lab.py, perceptual.py) on
the CPU, with no JAX: CIELAB and CIEDE2000, the remap, the initial tiles
and palettes, and a two-sweep `run_fused` run whose JSON the benchmark's
perceptual check (perfbench/loops/images_perceptual.py) judges correct,
where the same check finds the bfloat16 control wrong."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import control, harness
from perfbench.reference import lab, perceptual
from snesimage_torch.config import QuantConfig
from snesimage_torch.core import pipeline
from snesimage_torch.core.state import new_state
from snesimage_torch.io.json_out import state_to_json
from snesimage_torch.ops import color
from snesimage_torch.testing import bench_image, single_torch_thread

ROOT = Path(__file__).resolve().parents[1]
CELL = "mode1-perceptual.balanced-256"
LIMITS = json.loads(
    (ROOT / "perfbench" / "limits" / f"{CELL}.json").read_text())
# Sharma, Wu and Dalal (2005), Table 1: pairs of CIELAB colours and their
# CIEDE2000 difference to four decimals, the 180-degree cases among them.
SHARMA = [
    ((50.0, 2.6772, -79.7751), (50.0, 0.0, -82.7485), 2.0425),
    ((50.0, 3.1571, -77.2803), (50.0, 0.0, -82.7485), 2.8615),
    ((50.0, 2.8361, -74.0200), (50.0, 0.0, -82.7485), 3.4412),
    ((50.0, 0.0, 0.0), (50.0, -1.0, 2.0), 2.3669),
    ((50.0, -1.0, 2.0), (50.0, 0.0, 0.0), 2.3669),
    ((50.0, 2.4900, -0.0010), (50.0, -2.4900, 0.0009), 7.1792),
    ((50.0, 2.4900, -0.0010), (50.0, -2.4900, 0.0010), 7.1792),
    ((50.0, 2.4900, -0.0010), (50.0, -2.4900, 0.0011), 7.2195),
    ((50.0, 2.4900, -0.0010), (50.0, -2.4900, 0.0012), 7.2195),
    ((50.0, -0.0010, 2.4900), (50.0, 0.0009, -2.4900), 4.8045),
    ((50.0, 2.5, 0.0), (73.0, 25.0, -18.0), 27.1492),
    ((50.0, 2.5, 0.0), (61.0, -5.0, 29.0), 22.8977),
    ((50.0, 2.5, 0.0), (56.0, -27.0, -3.0), 31.9030),
    ((50.0, 2.5, 0.0), (58.0, 24.0, 15.0), 19.4535),
    ((50.0, 2.5, 0.0), (50.0, 3.1736, 0.5854), 1.0000),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with single_torch_thread():
        yield


def _colours(n: int, seed: int) -> torch.Tensor:
    """n random 8-bit colours, then every grey."""
    rng = np.random.default_rng(seed)
    greys = np.repeat(np.arange(256)[:, None], 3, 1)
    return torch.from_numpy(np.concatenate(
        [rng.integers(0, 256, (n, 3)), greys]))


def test_ciede2000_meets_the_published_pairs():
    lab1 = torch.tensor([p[0] for p in SHARMA], dtype=torch.float64)
    lab2 = torch.tensor([p[1] for p in SHARMA], dtype=torch.float64)
    want = torch.tensor([p[2] for p in SHARMA], dtype=torch.float64)
    assert torch.allclose(lab.ciede2000(lab1, lab2), want, atol=5e-5)
    least, largest = lab.ciede2000(lab1, lab2, perceptual.LAB_ERROR)
    assert bool((least <= want + 5e-5).all() and (want - 5e-5 <= largest)
                .all())


def test_lab_restates_the_programs_float32_steps():
    """The reference's float32 Lab is the program's to the bit, and
    Lab -> 8-bit sRGB too; its float64 Lab is within LAB_ERROR."""
    rgb = _colours(1 << 14, 1)
    got = lab.srgb_to_lab(rgb, torch.float32)
    want = color.srgb_u8_to_lab(rgb.to(torch.int32))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert float((lab.srgb_to_lab(rgb) - want.double()).abs().max()) <= (
        perceptual.LAB_ERROR)
    pts = torch.rand((1 << 14, 3), generator=torch.Generator().manual_seed(2))
    pts = pts * torch.tensor([100.0, 200.0, 200.0]) - torch.tensor(
        [0.0, 100.0, 100.0])
    assert torch.equal(lab.lab_to_srgb_u8(pts),
                       color.lab_to_srgb_u8(pts).long())


def test_program_ciede2000_within_half_tau():
    """The program's float32 CIEDE2000 lies within TAU / 2 of the float64
    range of the formula's branches, grey targets among them."""
    targets = _colours(256, 3)
    rng = np.random.default_rng(4)
    entries = torch.from_numpy(rng.integers(0, 32, (512, 3)))
    entries8 = entries * 8 + entries // 4
    got = color.ciede2000(
        color.srgb_u8_to_lab(targets.to(torch.int32))[:, None],
        color.srgb_u8_to_lab(entries8.to(torch.int32)))
    least, largest = lab.ciede2000(lab.srgb_to_lab(targets)[:, None],
                                   lab.srgb_to_lab(entries8),
                                   perceptual.LAB_ERROR)
    got = got.double()
    outside = torch.maximum(got - largest, least - got).clamp(min=0)
    assert float(outside.max()) <= perceptual.TAU / 2


def _image(seed: int, size: int = 64) -> np.ndarray:
    """A crop of the bench image with noise, and a few grey and
    transparent pixels."""
    rng = np.random.default_rng(seed)
    lo = 64 + 32 * seed
    img = bench_image(seed)[lo:lo + size, lo:lo + size].copy()
    noise = rng.integers(-12, 13, img[..., :3].shape)
    img[..., :3] = np.clip(img[..., :3].astype(int) + noise, 0, 255)
    img[:4, :, :3] = np.arange(size)[None, :, None] * 4
    img[-8:, -8:, 3] = 0
    return np.ascontiguousarray(img)


def _config(**kw) -> QuantConfig:
    return QuantConfig(**dict(subpalette_count=2, subpalette_size=5,
                              width=64, height=64, perceptual_palettes=True,
                              **kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_initial_state_equals_the_programs(seed):
    """Tiles, palettes and (within TAU) the map of the program's Lab
    initialisation equal the reference's."""
    img = _image(seed)
    config = _config()
    state = pipeline.cluster(pipeline.initialize(
        new_state(img, config, "cpu"), config), config)
    tiles, palette5, _ = perceptual.initial_state(img, 2, 5)
    assert np.array_equal(state.tile_palettes.numpy(), tiles)
    assert np.array_equal(state.palette.numpy(), palette5)
    assert perceptual.remap_off(img[..., :3], img[..., 3], tiles, palette5,
                                state.palette_map.numpy()) == 0


def test_remap_off_counts_what_the_program_cannot_choose():
    """The program's remap under a random palette reads 0; a pixel moved
    to an entry further by more than TAU, or to an identical colour that
    comes later, reads 1 each."""
    img = _image(2)
    rng = np.random.default_rng(5)
    palette5 = rng.integers(0, 32, (2, 5, 3))
    palette5[1, 3] = palette5[1, 1]  # an identical colour, later
    tiles = rng.integers(0, 2, (8, 8))
    config = _config()
    state = new_state(img, config, "cpu").replace(
        tile_palettes=torch.from_numpy(tiles).to(torch.int32),
        palette=torch.from_numpy(palette5).to(torch.int32))
    from snesimage_torch.core import refine

    pmap = refine.full_remap(state, config).palette_map.numpy()
    rgb, alpha = img[..., :3], img[..., 3]
    assert perceptual.remap_off(rgb, alpha, tiles, palette5, pmap) == 0
    want = perceptual.palette_map(rgb, alpha, tiles, palette5)
    assert np.array_equal(want, pmap)
    y, x = 20, 20
    d = lab.ciede2000(lab.srgb_to_lab(rgb[y, x]),
                      lab.srgb_to_lab(palette5[tiles[y // 8, x // 8]] * 8
                                      + palette5[tiles[y // 8, x // 8]] // 4))
    moved = pmap.copy()
    moved[y, x] = int(torch.argmax(d))
    assert perceptual.remap_off(rgb, alpha, tiles, palette5, moved) == 1
    twin = np.argwhere((pmap == 1) & (np.repeat(np.repeat(tiles, 8, 0), 8, 1)
                                      == 1) & (alpha > 0))
    assert len(twin)
    moved = pmap.copy()
    moved[tuple(twin[0])] = 3
    assert perceptual.remap_off(rgb, alpha, tiles, palette5, moved) == 1


def test_run_judged_correct_and_control_not():
    """A two-sweep balanced perceptual `run_fused` at 64x64 (2 subpalettes
    of 3): the benchmark's perceptual check reads every number within the
    cell's limits; the bfloat16 control of the same output reads over
    them."""
    img = _image(0)
    spec = harness.cell_spec(CELL)
    small = dict(width=64, height=64, subpalette_count=2, subpalette_size=3)
    recipe = dict(spec.config, **spec.traffic["recipe"])
    recipe.update(small, max_steps=2)
    config = QuantConfig(**recipe, seed=7)
    state, errors, info = pipeline.run_fused(img, config, device="cpu")
    text = state_to_json(state, config)
    loop = harness.loop("images_perceptual")
    cfg = dict(spec.config, **small)
    got = loop.judge_answer(img, text, info["final_error"], cfg, True)
    got["steps_bad"] = loop.steps_bad(list(errors), info["final_error"],
                                      recipe)
    assert all(got[n] <= LIMITS[n] for n in LIMITS), got
    low = loop.control_answer(img, text, cfg, True,
                              loop.Scorer(img[..., :3]))
    assert any(low[n] > LIMITS[n] for n in LIMITS if n in low)
    assert control.LOW == torch.bfloat16
