"""The images a run converts, made from its seed.

Four kinds of content, copied from the repository's measurement scripts so
that later changes to those scripts do not move the benchmark
(perfbench/tests pin each copy to the original's bytes):

- gradient: `snesimage_torch/testing.py` `bench_image` (the JAX package's
  bench image): smooth gradients under 24 blended blocks;
- photo, poster, text-ui: `tools/margin_exp.py` `photo_image`,
  `poster_image` and `text_ui_image`: smooth fields with texture noise,
  flat blocky colours, and hard-edged panels, rules, checkerboards and
  glyph speckle.

`Stream` hands out a run's images: a fixed set of images of each kind,
each with a fixed run seed of its own (the program's random draws), in an
order that the run's seed draws. So every seed gives the program the same
work, and an image converted twice gives the same answer. Warm-up images
come from another set, so that no window image is ever warmed.
"""

from __future__ import annotations

import numpy as np


def gradient_image(seed: int = 0) -> np.ndarray:
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


def photo_image(seed=3):
    """Photo-like: smooth low-freq fields + texture noise."""
    rng = np.random.default_rng(seed)
    h = w = 256
    base = rng.normal(0, 1, (3, 8, 8)).astype(np.float32)
    up = np.kron(base, np.ones((32, 32), np.float32))
    img = np.zeros((h, w, 4), np.uint8)
    for c in range(3):
        field = up[c] + 0.35 * rng.normal(0, 1, (h, w))
        img[..., c] = np.clip(128 + 60 * field, 0, 255)
    img[..., 3] = 255
    return img


def poster_image(seed=5):
    """Flat poster art: few solid colors in blocky shapes."""
    rng = np.random.default_rng(seed)
    h = w = 256
    img = np.zeros((h, w, 4), np.uint8)
    colors = rng.integers(0, 256, (12, 3))
    img[..., :3] = colors[0]
    for k in range(1, 12):
        cy, cx = rng.integers(0, h, 2)
        hh, ww = rng.integers(24, 120, 2)
        img[cy : cy + hh, cx : cx + ww, :3] = colors[k]
    img[..., 3] = 255
    return img


def text_ui_image(seed=7):
    """Hard-edged UI/text-like content: panels, 1px rules, checkerboard
    textures, glyph-ish speckle."""
    rng = np.random.default_rng(seed)
    h = w = 256
    img = np.zeros((h, w, 4), np.uint8)
    img[..., :3] = 24
    for _ in range(10):
        cy, cx = rng.integers(0, h - 40, 2)
        hh, ww = rng.integers(30, 100, 2)
        img[cy:cy + hh, cx:cx + ww, :3] = rng.integers(40, 230, 3)
    for _ in range(30):
        y = rng.integers(0, h)
        x0, x1 = sorted(rng.integers(0, w, 2))
        img[y, x0:x1, :3] = rng.integers(0, 256, 3)
    for _ in range(6):
        cy, cx = rng.integers(0, h - 32, 2)
        yy, xx = np.mgrid[0:32, 0:32]
        mask = ((yy + xx) % 2).astype(bool)
        img[cy:cy + 32, cx:cx + 32, :3][mask] = rng.integers(0, 256, 3)
    for row in range(16, 240, 24):
        cols = rng.integers(0, w, 300)
        img[row:row + 6, cols % w, :3] = 235
    img[..., 3] = 255
    return img


KINDS = {
    "gradient": gradient_image,
    "photo": photo_image,
    "poster": poster_image,
    "text-ui": text_ui_image,
}
# Branches of a run's seed, and of the fixed sets of images: the window's,
# the warm-up's.
WINDOW, WARMUP = 0, 1
# Entropy of the members' fixed run seeds (the seed of no run).
MEMBER_SEEDS = 1103


class Stream:
    """The images of one run. A mix has a fixed set of `per_kind` images of
    each kind (member j of a kind is made from sub-seed 1000 * (branch + 1)
    + j, whatever the run's seed), each with a fixed run seed, so that
    every seed gives the program the same work; the seed sets only the
    order. The window goes through the set in cycles, kinds in turn (image
    k is of kind k mod the number of kinds), each kind's members in an
    order the seed draws afresh for every cycle. `image(k)` is (member,
    kind, run seed, RGBA array of height x width, the top-left crop of the
    256x256 image)."""

    def __init__(self, seed: int, kinds: list[str], per_kind: int,
                 height: int, width: int, branch: int = WINDOW):
        for kind in kinds:
            if kind not in KINDS:
                raise ValueError(f"unknown image kind {kind!r}")
        if not (0 < height <= 256 and 0 < width <= 256):
            raise ValueError(f"images are at most 256x256, not {width}x{height}")
        self.kinds, self.per_kind = list(kinds), per_kind
        self.rng = np.random.default_rng([seed % 2 ** 64, branch])
        self.members = [
            np.ascontiguousarray(
                KINDS[kind](1000 * (branch + 1) + j)[:height, :width])
            for j in range(per_kind) for kind in self.kinds]
        self.run_seeds = [int(s) for s in np.random.default_rng(
            [MEMBER_SEEDS, branch]).integers(0, 2 ** 31, len(self.members))]
        self.order: list[int] = []

    def member(self, k: int) -> int:
        """Which member of the set image k is (kind index + number of kinds
        x member index)."""
        n = len(self.kinds)
        while len(self.order) <= k:
            perms = [self.rng.permutation(self.per_kind) for _ in range(n)]
            self.order += [perms[i % n][i // n] * n + i % n
                           for i in range(n * self.per_kind)]
        return int(self.order[k])

    def image(self, k: int) -> tuple[int, str, int, np.ndarray]:
        member = self.member(k)
        return (member, self.kinds[member % len(self.kinds)],
                self.run_seeds[member], self.members[member])

    def drawn_seed(self) -> int:
        """A run seed drawn from the run's seed (after the order of the
        cycles drawn so far), for a loop whose one image stands for a
        session of its own."""
        return int(self.rng.integers(0, 2 ** 31))
