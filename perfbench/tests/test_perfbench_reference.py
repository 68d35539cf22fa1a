"""The plain reference and the copied generators: nothing of the program or
of JAX imported, the copies pinned to their originals, and the reference
agreeing with the program on the CPU at small sizes."""

import ast
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import images
from perfbench.reference import init, json_format, remap, ssimulacra2
from perfbench.reference import ssimulacra2_consts as consts

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "snesimage_tpu", "snesimage_torch"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py"))
                         + [HERE / "judge.py", HERE / "images.py"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & BANNED


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "snesimage_tpu"}


# sha256 of the originals' bytes (snesimage_torch/testing.py bench_image;
# tools/margin_exp.py photo_image, poster_image, text_ui_image), taken once
# from the originals' sources.
ORIGINALS = {
    ("gradient", 0): "3691a0e339413a75848bd178e4c9e16e56c2f31d69bda892853afc24692de87a",
    ("gradient", 12345678901): "62cd90a540b96668471d991a9e98aeac626df212dbc7bb7da81e46009d201a6f",
    ("photo", 3): "cfb2691c8e961f8b619e020536c99e8698678a41dfd54e018cd4d757cbfd56c1",
    ("photo", 12345678901): "15dda769c65f25ce1bb802b63f25d42844acfdffcdc8c16cef11e1dc2030ee6e",
    ("poster", 0): "c4b3b34667661a79cf3e6b7f47176ccf39f19ebed56c51c53b6152800a6f8dfc",
    ("poster", 12345678901): "13fad9d8c848e1c37d7172771d63bcd41505fe1e9c8f8682802bb0bef9e8b920",
    ("text-ui", 3): "12cf23fa033db8eec287251fdf57363ba8d43bd3fda4e60f9d8b349c7fd4a97d",
    ("text-ui", 12345678901): "ff08685186dfdb0710fe4d51142d33c91659aa5314ab2416fbae28395db0de46",
}


@pytest.mark.parametrize("kind,seed", sorted(ORIGINALS))
def test_generators_pinned(kind, seed):
    img = images.KINDS[kind](seed)
    assert hashlib.sha256(img.tobytes()).hexdigest() == ORIGINALS[kind, seed]


def test_stream_same_set_for_every_seed():
    kinds = list(images.KINDS)
    s = images.Stream(2 ** 31 + 7, kinds, 2, 64, 64)
    first = [s.image(k) for k in range(16)]
    assert [f[1] for f in first] == kinds * 4
    # Each cycle of 8 holds every member once.
    assert sorted(f[0] for f in first[:8]) == list(range(8))
    assert sorted(f[0] for f in first[8:]) == list(range(8))
    again = images.Stream(2 ** 31 + 7, kinds, 2, 64, 64)
    assert [a[:3] for a in (again.image(k) for k in range(16))] == [
        f[:3] for f in first]
    other = images.Stream(3, kinds, 2, 64, 64)
    for m in range(8):
        assert np.array_equal(other.members[m], s.members[m])
    assert [other.member(k) for k in range(16)] != [f[0] for f in first]
    warm = images.Stream(2 ** 31 + 7, kinds, 2, 64, 64, images.WARMUP)
    assert not any(np.array_equal(w, m) for w in warm.members
                   for m in s.members)
    # Each member keeps its own run seed whatever the run's seed.
    assert [f[2] for f in first] == [s.run_seeds[f[0]] for f in first]
    assert other.run_seeds == s.run_seeds
    assert len(set(s.run_seeds)) == 8
    assert [other.image(k)[2] for k in range(16)] == [
        s.run_seeds[other.member(k)] for k in range(16)]


def test_final_error_counts_each_image_once():
    from perfbench import harness

    run = harness.Run(config={}, images=[
        dict(kind="a", member=0, reference_final=10.0),
        dict(kind="a", member=0, reference_final=12.0),
        dict(kind="a", member=2, reference_final=20.0),
        dict(kind="b", member=1, reference_final=40.0)])
    assert harness.reader("final_error")(run) == (((11.0 + 20.0) / 2) + 40.0) / 2


def test_consts_equal_the_programs():
    from snesimage_torch.ops import ssimulacra2_consts as port

    for name in dir(consts):
        if name.isupper():
            assert np.array_equal(np.asarray(getattr(consts, name)),
                                  np.asarray(getattr(port, name))), name


def test_round_f32_rounds_once():
    from fractions import Fraction

    one = float(np.float32(1.0))
    ulp = float(np.spacing(np.float32(1.0)))
    assert init.round_f32(Fraction(one) + Fraction(ulp) / 2) == one  # tie: even
    assert init.round_f32(Fraction(one) + Fraction(ulp) * 3 / 4) == one + ulp
    assert init.round_f32(Fraction(-3, 7)) == float(np.float32(-3 / 7))


@pytest.mark.parametrize("dither", [False, True], ids=["redmean", "dither"])
def test_reference_meets_the_program(dither):
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine
    from snesimage_torch.core.state import new_state
    from snesimage_torch.io.json_out import state_to_json

    img = images.photo_image(11)[:32, :48].copy()
    cfg = QuantConfig(subpalette_count=4, subpalette_size=7, width=48,
                      height=32, dither=dither)
    st = new_state(img, cfg, "cpu")
    st = pipeline.cluster(pipeline.initialize(st, cfg), cfg)
    tiles, palette5, pmap = init.initial_state(img, 4, 7, dither)
    assert np.array_equal(tiles, st.tile_palettes.numpy())
    assert np.array_equal(palette5, st.palette.numpy())
    assert np.array_equal(pmap, st.palette_map.numpy())
    text = state_to_json(st, cfg)
    assert json_format.encode(palette5, tiles, pmap, img[..., 3]) == text
    assert json_format.decode(text, 4, 7, img[..., 3])[3] == 0
    err = float(refine.frame_error_fused(
        st, cfg, refine.make_reference_pyramid(st)))
    ref = ssimulacra2.Scorer(img[..., :3]).error(
        remap.render(palette5, tiles, pmap, img[..., 3]))
    assert abs(err - ref) < 1e-2


def test_decode_counts_breaches():
    alpha = np.full((16, 16), 255, np.uint8)
    p5 = np.zeros((2, 3, 3), np.int64)
    tiles = np.zeros((2, 2), np.int64)
    pmap = np.zeros((16, 16), np.int64)
    text = json_format.encode(p5, tiles, pmap, alpha)
    assert json_format.decode(text, 2, 3, alpha)[3] == 0
    assert json_format.decode(text.replace('"tiles":[[1', '"tiles":[[4'), 2, 3,
                              alpha)[3] >= 1
    assert json_format.decode(text.replace(",", ", "), 2, 3, alpha)[3] == 1
    assert json_format.decode("{}", 2, 3, alpha)[3] == 1


def test_lower_precision_parts_from_the_reference():
    img = images.photo_image(5)[:32, :32].copy()
    tiles, palette5, pmap = init.initial_state(img, 2, 7, True)
    low = remap.dither(img[..., :3], img[..., 3], tiles, palette5,
                       torch.bfloat16)
    assert (low != pmap).sum() > 0
    frame = remap.render(palette5, tiles, pmap, img[..., 3])
    exact = ssimulacra2.Scorer(img[..., :3]).error(frame)
    assert abs(ssimulacra2.Scorer(img[..., :3], torch.bfloat16).error(frame)
               - exact) > 1.0
