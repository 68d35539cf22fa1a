"""Image loading (any format -> RGBA8) and saving.

Counterpart of snesimage_tpu/io/image.py, replacing the reference's
`image::open(..).into_rgba8()` (src/lib.rs:836).
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def load_rgba(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 4) uint8 RGBA (a writable array)."""
    with Image.open(path) as im:
        return np.array(im.convert("RGBA"), dtype=np.uint8)


def check_size(img: np.ndarray, width: int, height: int) -> None:
    """Strict size check. The reference's check is buggy (`&&` instead of
    `||`, src/lib.rs:838: a 256x512 image passes and then corrupts tile
    indexing via the hardcoded 32-tile stride at src/lib.rs:58,565). We
    enforce the intended contract instead."""
    h, w = img.shape[:2]
    if (w, h) != (width, height):
        raise ValueError(f"Image size must be {width}x{height}, got {w}x{h}")


def save_rgba(path: str, img: np.ndarray) -> None:
    Image.fromarray(np.asarray(img, dtype=np.uint8), "RGBA").save(path)


def save_rgb(path: str, img: np.ndarray) -> None:
    Image.fromarray(np.asarray(img, dtype=np.uint8), "RGB").save(path)
