"""Undithered remap, linear render and JSON output of the port against the
JAX package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core.state import state_from_numpy
from snesimage_torch.io.json_out import state_to_json as t_json
from snesimage_torch.ops import remap as tremap
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core.state import QuantState as JState
from snesimage_tpu.io.json_out import state_to_json as j_json
from snesimage_tpu.ops import remap as jremap


def _random_state(img, rng, c, s):
    ht, wt = img.shape[0] // 8, img.shape[1] // 8
    return {
        "original": img,
        "tile_palettes": rng.integers(0, c, (ht, wt)).astype(np.int32),
        "palette": rng.integers(0, 32, (c, s, 3)).astype(np.int32),
        "palette_map": rng.integers(0, s, img.shape[:2]).astype(np.int32),
    }


@pytest.mark.parametrize("c,s", [(2, 4), (4, 15), (1, 1)])
def test_remap_undithered_exact(small_image, rng, c, s):
    st = _random_state(small_image, rng, c, s)
    # duplicate entries force ties: the lowest index must win in both
    st["palette"][:, -1] = st["palette"][:, 0]
    rgb, alpha = small_image[..., :3].astype(np.int32), small_image[..., 3]
    got = tremap.remap_undithered(
        torch.from_numpy(rgb), torch.from_numpy(alpha.astype(np.int32)),
        torch.from_numpy(st["tile_palettes"]), torch.from_numpy(st["palette"]),
    )
    want = jremap.remap_undithered(
        jnp.asarray(rgb), jnp.asarray(alpha), jnp.asarray(st["tile_palettes"]),
        jnp.asarray(st["palette"]), False,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_render_linear(small_image, rng):
    st = _random_state(small_image, rng, 3, 7)
    alpha = small_image[..., 3].astype(np.int32)
    args = (st["palette_map"], alpha, st["tile_palettes"], st["palette"])
    got = tremap.render_linear(*(torch.from_numpy(a) for a in args))
    want = jremap.render_linear(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    assert (got.numpy()[alpha == 0] == 0).all()


@pytest.mark.parametrize("c,s", [(2, 4), (8, 15)])
def test_state_to_json_bytes(small_image, rng, c, s):
    st = _random_state(small_image, rng, c, s)
    kw = dict(subpalette_count=c, subpalette_size=s, width=64, height=64)
    got = t_json(state_from_numpy(st, "cpu"), TConfig(**kw))
    want = j_json(JState(**{k: jnp.asarray(v) for k, v in st.items()}),
                  JConfig(**kw))
    assert got.encode() == want.encode()
