"""Shared constants for the snesimage-tpu framework.

Numeric contracts mirror the reference implementation (aexoden/snesimage):

- NES master palette: 56 hand-coded 5-bit RGB entries
  (reference: src/lib.rs:684-745).
- Floyd-Steinberg dither weights [E, SW, S, SE] = [7/16, 3/16, 5/16, 1/16]
  and the 0.8 error damping multiplier (reference: src/lib.rs:426-432).
- Image geometry: 256x256 pixels, 8x8 tiles => 32x32 tiles
  (reference: src/lib.rs:29-31).
"""

from __future__ import annotations

import numpy as np

WIDTH = 256
HEIGHT = 256
TILE = 8
WIDTH_TILES = WIDTH // TILE
HEIGHT_TILES = HEIGHT // TILE
NUM_TILES = WIDTH_TILES * HEIGHT_TILES

NES_COLOR_COUNT = 56

# 56 NES master-palette entries as 5-bit (r, g, b) rows
# (reference: src/lib.rs:685-745; out-of-range index maps to (0, 0, 0)).
NES_PALETTE_5BIT = np.array(
    [
        (13, 13, 13), (0, 2, 16), (3, 0, 17), (7, 0, 15), (10, 0, 10),
        (11, 0, 3), (9, 2, 0), (7, 3, 0), (4, 6, 0), (0, 7, 0),
        (0, 8, 0), (0, 7, 4), (0, 5, 10), (0, 0, 0), (23, 23, 23),
        (3, 10, 24), (9, 6, 28), (14, 4, 26), (18, 3, 21), (19, 5, 11),
        (19, 6, 0), (15, 9, 0), (11, 12, 0), (4, 14, 0), (0, 15, 0),
        (0, 14, 8), (0, 13, 17), (0, 0, 0), (31, 31, 31), (13, 20, 31),
        (17, 19, 31), (22, 16, 31), (27, 14, 31), (28, 14, 23), (28, 17, 13),
        (26, 19, 5), (22, 21, 1), (15, 24, 2), (10, 25, 8), (8, 25, 16),
        (8, 24, 24), (9, 9, 9), (31, 31, 31), (25, 29, 31), (27, 27, 31),
        (29, 27, 31), (31, 26, 31), (31, 26, 30), (31, 27, 25), (31, 28, 22),
        (30, 30, 21), (27, 31, 21), (25, 31, 23), (24, 31, 26), (24, 30, 30),
        (23, 24, 23),
    ],
    dtype=np.int32,
)
assert NES_PALETTE_5BIT.shape == (NES_COLOR_COUNT, 3)

# Floyd-Steinberg error-diffusion weights for the E, SW, S, SE neighbors
# and the global damping multiplier (reference: src/lib.rs:426-432).
DITHER_WEIGHTS = np.array([7.0, 3.0, 5.0, 1.0], dtype=np.float32) / 16.0
DITHER_DAMPING = 0.8

# Candidate-search sizes (reference: src/lib.rs:205, 202, 296, 252).
RANDOM_TRIALS = 64  # random candidates per slot visit
FIVE_BIT_LEVELS = 32  # channel sweep candidates / 5-bit value range

# Scheduler: steps with step % 5 < 4 use the random method, the remaining
# step uses the exhaustive channel sweep (reference: src/lib.rs:890).
RANDOM_STEPS_PER_CYCLE = 4
SCHEDULE_CYCLE = 5
