"""Test images and helpers for the port's bench, smoke test, profiler and
tests.

`bench_image` is the JAX package's bench image (bench.py `_test_image`),
copied so that the port's scripts import nothing of that harness;
tests/test_torch_consts.py pins the copy to the original. The init hashes
pin the init artifacts of eight configs on that image to the JAX package's
CPU values; `card_line` reads the card's name and power limit, which every
number taken on the card is written beside.
"""

from __future__ import annotations

import contextlib
import hashlib
import subprocess

import numpy as np
import torch

# sha256 of (tile_palettes, palette, palette_map) as int32 bytes after
# initialize + cluster on bench_image(0) with the balanced config and
# with the perceptual one: the JAX package's CPU values
# (tests/test_torch_color_init.py and tests/test_torch_perceptual.py keep
# them honest against both packages).
INIT_HASH = "db244f60c99d56558e113293b47e919710bcbb9d3a3929b5f83b1ba82ad4c6d9"
INIT_HASH_PERCEPTUAL = (
    "80f887a8fcf9a066bc4a0917f65e84c987d136dcaf1d19466cb8d5413e73a7f9"
)
# The same after initialize + cluster with dithering, red-mean and
# perceptual (tests/test_torch_dither.py pins them against both packages).
INIT_HASH_DITHER = (
    "7982a1753127d7659979b0cdd0dd7a4b66999a6b1f4dad01a62815cddd6da854"
)
INIT_HASH_DITHER_PERCEPTUAL = (
    "2f36a75bc43c5ab1daf98713d4461cf8b2cc31066d817954a1e87a16b655628c"
)
# The same on the first 240 rows of the image (256x240, the geometry that
# is not 32-aligned), red-mean, perceptual and dithered, and on the whole
# image with the `nes-compat` preset (4x3 palettes snapped to the NES
# colours): the JAX package's CPU values; tests/test_torch_geometry.py and
# tests/test_torch_schedules.py pin them against both packages.
INIT_HASH_240 = (
    "c83af996f347226769eb65dfb60cd1407d53880d0e82171903f2bfe5c77b6bd1"
)
INIT_HASH_240_PERCEPTUAL = (
    "796bb8d0f0361be819058726d76f9e338d2a85da236355a5046db83a7da025e3"
)
INIT_HASH_240_DITHER = (
    "7038cc450f0c80249eb8482a1279ad4820ef65d30e2ca0ca86883024825e91a4"
)
INIT_HASH_NES = (
    "b1ab121f52022f89aaa651d3c616df41deedad6cb6836c35de521fcbe691a6d6"
)


def init_hash(state) -> str:
    """sha256 of the state's init artifacts, (tile_palettes, palette,
    palette_map) as int32 bytes: the form of the INIT_HASH values."""
    h = hashlib.sha256()
    for t in (state.tile_palettes, state.palette, state.palette_map):
        h.update(t.to(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()


def card_line() -> str:
    """The first card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def single_torch_thread():
    """Run the body with torch's thread pool at one thread. The wavefront
    twin is a long loop of small tensor operations: with several test
    workers on one machine, the pool only makes them wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def bench_image(seed: int = 0) -> np.ndarray:
    """Natural-ish 256x256 RGBA image: gradients and 24 blended blocks."""
    rng = np.random.default_rng(seed)
    h = w = 256
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 4), dtype=np.uint8)
    img[..., 0] = (128 + 90 * np.sin(x / 17) + 30 * np.cos(y / 31)).clip(0, 255)
    img[..., 1] = (128 + 80 * np.cos((x + y) / 23)).clip(0, 255)
    img[..., 2] = (128 + 100 * np.sin(y / 13) * np.cos(x / 41)).clip(0, 255)
    img[..., 3] = 255
    blob = rng.integers(0, 256, (8, 8, 3))
    for _ in range(24):
        cy, cx = rng.integers(0, h - 32), rng.integers(0, w - 32)
        img[cy : cy + 32, cx : cx + 32, :3] = (
            img[cy : cy + 32, cx : cx + 32, :3] // 2
            + np.kron(blob, np.ones((4, 4, 1), dtype=np.uint8)) // 2
        )
    return img


def with_transparency(img: np.ndarray) -> np.ndarray:
    """A copy of an RGBA image with transparent regions: a band of whole
    tiles, an interior block off the tile grid and a scatter of single
    pixels, with garbage colour underneath."""
    out = img.copy()
    h, w = out.shape[:2]
    out[h // 8 : h // 4, : w // 2, 3] = 0
    out[h // 2 + 3 : h // 2 + 29, w // 2 + 5 : w // 2 + 23, 3] = 0
    out[::7, ::5, 3] = 0
    out[..., :3][out[..., 3] == 0] = 77
    return out
