"""The port's tile reassignment (core/reassign.py `auto_reassign_tiles`,
core/pipeline.py `reassign_tile`, `apply_tile_reassignments`,
`parse_reassignments`) against the JAX package's on the CPU. Tile maps
are integers, so they must be equal; a tile off the grid raises in both
packages (ROADMAP C-4: JAX would drop the scatter, torch would raise an
IndexError)."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core.reassign import auto_reassign_tiles
from snesimage_torch.core.state import state_from_numpy
from snesimage_torch.testing import single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core.reassign import (
    auto_reassign_tiles as j_auto_reassign_tiles,
)
from snesimage_tpu.core.state import new_state as j_new_state

GEOMETRY = dict(subpalette_count=3, subpalette_size=4, width=64, height=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    with single_torch_thread():
        yield


@lru_cache(maxsize=None)
def _clustered(image_bytes: bytes, perceptual: bool):
    """The JAX package's clustered state and the port's copy of it."""
    img = np.frombuffer(image_bytes, np.uint8).reshape(64, 64, 4)
    kw = dict(GEOMETRY, perceptual_palettes=perceptual)
    jc, tc = JConfig(**kw), TConfig(**kw)
    js = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    return js, jc, _port(js), tc


def _port(js):
    return state_from_numpy({f: np.asarray(getattr(js, f))
                             for f in js._fields}, "cpu")


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_auto_reassign_equals_the_jax_package(small_image, perceptual,
                                              shuffle):
    """On the clustered state, and with its subpalettes' entries shuffled
    between them (so most tiles move): the JAX package's tile map, exactly,
    fully transparent tiles on subpalette 0."""
    js, jc, ts, tc = _clustered(small_image.tobytes(), perceptual)
    if shuffle:
        pal = np.asarray(js.palette).reshape(-1, 3)
        pal = pal[np.random.default_rng(3).permutation(len(pal))]
        js = js._replace(palette=jnp.asarray(pal.reshape(3, 4, 3)))
        ts = _port(js)
    want = np.asarray(j_auto_reassign_tiles(js, jc).tile_palettes)
    got = auto_reassign_tiles(ts, tc)
    assert got.tile_palettes.dtype == torch.int32
    np.testing.assert_array_equal(got.tile_palettes.numpy(), want)
    assert got.tile_palettes[0, 6] == 0 and got.tile_palettes[0, 7] == 0
    assert torch.equal(got.palette, ts.palette)
    if shuffle:
        assert (want != np.asarray(js.tile_palettes)).any()


def test_reassign_separates_regions():
    """The twin of tests/test_reassign.py's: with hand-set red and blue
    palettes the red half goes to subpalette 0, the blue half to 1."""
    h = w = 64
    img = np.zeros((h, w, 4), dtype=np.uint8)
    x = np.mgrid[0:h, 0:w][1]
    img[:, : w // 2, 0] = 150 + (x[:, : w // 2] % 32) * 3
    img[:, w // 2:, 2] = 150 + (x[:, w // 2:] % 32) * 3
    img[..., 1] = 30
    img[..., 3] = 255
    config = TConfig(subpalette_count=2, subpalette_size=3, width=64,
                     height=64)
    state = tpipe.new_state(img, config, "cpu")
    palette = torch.tensor([[[18, 4, 0], [22, 4, 0], [26, 4, 0]],
                            [[0, 4, 18], [0, 4, 22], [0, 4, 26]]],
                           dtype=torch.int32)
    tp = auto_reassign_tiles(state.replace(palette=palette),
                             config).tile_palettes
    assert (tp[:, :4] == 0).all() and (tp[:, 4:] == 1).all()


@pytest.mark.parametrize("assignments", [
    [(3, 5), (0, 0, 2)], [(3, 5), (3, 5)], [(7, 7, 1), (0, 7)], [],
])
@pytest.mark.parametrize("recluster", [False, True])
def test_apply_tile_reassignments_equals_the_jax_package(
        small_image, assignments, recluster):
    """(x, y) cycles a tile's subpalette like one GUI click, (x, y, p) sets
    it; with `recluster` the palettes are re-fit and remapped. The JAX
    package's tile map, palette and palette map, exactly."""
    js, jc, ts, tc = _clustered(small_image.tobytes(), False)
    want = jpipe.apply_tile_reassignments(js, jc, assignments, recluster)
    got = tpipe.apply_tile_reassignments(ts, tc, assignments, recluster)
    for field in ("tile_palettes", "palette", "palette_map"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


@pytest.mark.parametrize("x,y", [(1, 2), (7, 7), (0, 0)])
def test_reassign_tile_equals_the_jax_package(small_image, x, y):
    js, jc, ts, tc = _clustered(small_image.tobytes(), False)
    want = jpipe.reassign_tile(js, jc, x, y, recluster=False)
    got = tpipe.reassign_tile(ts, tc, x, y, recluster=False)
    np.testing.assert_array_equal(got.tile_palettes.numpy(),
                                  np.asarray(want.tile_palettes))


@pytest.mark.parametrize("bad", [(8, 0), (0, -1), (-1, 3), (0, 8)])
def test_out_of_range_tiles_raise_in_both_packages(small_image, bad):
    js, jc, ts, tc = _clustered(small_image.tobytes(), False)
    for fn, st, cfg in ((tpipe.reassign_tile, ts, tc),
                        (jpipe.reassign_tile, js, jc)):
        with pytest.raises(ValueError, match="out of range"):
            fn(st, cfg, *bad)
    for mod, st, cfg in ((tpipe, ts, tc), (jpipe, js, jc)):
        with pytest.raises(ValueError):
            mod.apply_tile_reassignments(st, cfg, [bad])
        with pytest.raises(ValueError):
            mod.apply_tile_reassignments(st, cfg, [(0, 0, 3)])
        with pytest.raises(ValueError):
            mod.apply_tile_reassignments(st, cfg, [(0, 0, 1, 2)])


@pytest.mark.parametrize("text", [
    "# comment line\n 3 5   # one click\n0 0 1\n\n7 2\n", "", "1 2 3",
    "1 2 3 4", "1 a", "5", "  # only a comment",
])
def test_parse_reassignments_equals_the_jax_package(text):
    try:
        want = jpipe.parse_reassignments(text)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tpipe.parse_reassignments(text)
        assert str(got.value) == str(err)
    else:
        assert tpipe.parse_reassignments(text) == want
