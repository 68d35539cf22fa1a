"""Test images and helpers for the port's smoke test, profiler and tests.

`bench_image` is the JAX package's bench image (bench.py `_test_image`),
copied so that the port's scripts import nothing of that harness;
tests/test_torch_consts.py pins the copy to the original.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


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
