"""Kernel G's memory schedule (csrc/dither.cu), replayed on the CPU.

The kernel cannot run here, so this replays, step by step, what each row
slot of `dither_remap_kernel` loads and stores: its stream cursor (ly, lx),
the ring of three four-pixel groups g0, g1, g2 that turns at c % 4 == 3,
the pixel `pixel_at` takes (o + odd of g0 and g1), the tile subpalette
that a group at x % 8 == 4 takes from its left neighbour, and the 16-byte
store of the last four entries at x % 4 == 3. Each pixel is named by its
(row, column): every valid step must take its own pixel and tile, and the
stores must write every pixel of the map once, each with its own entry.
"""

import pytest

from snesimage_torch.ops.cuda_dither import row_slots


def _load_group(h, w, y, x, left):
    """What `load_group` gives: the four pixels from (y, x) and their
    tile, or None off the image."""
    if not (y < h and x >= 0):
        return None
    assert x % 4 == 0 and x + 4 <= w
    tile = left[1] if x & 4 else (y // 8, x // 8)
    return [(y, x + q) for q in range(4)], tile


def _pixel_at(g0, g1, o):
    g = g1 if o >= 4 else g0
    return None if g is None else (g[0][o & 3], g[1])


def _replay(h, w):
    """Every map write of the kernel, as {(row, column): entry}."""
    n_slots = row_slots(h, w)
    n_steps = w + 2 * h - 2
    steps = -(-n_steps // 4) * 4  # the loop unrolled four times
    written = {}
    for slot in range(n_slots):
        y = slot
        odd = (y & 1) * 2
        cursor = [y, -2 * y - odd]  # (ly, lx)

        def next_group(left, cursor=cursor):
            g = _load_group(h, w, *cursor, left)
            cursor[1] += 4
            if cursor[1] == w:
                cursor[:] = [cursor[0] + n_slots, 0]
            return g

        g0 = next_group(None)
        g1 = next_group(g0)
        g2 = next_group(g1)
        done = [None] * 4
        for c in range(steps):
            x = c - 2 * y
            valid = y < h and x >= 0
            o = c & 3
            px = _pixel_at(g0, g1, o + odd)
            if o == 3:
                g0, g1 = g1, g2
                g2 = next_group(g1)
            if valid:
                assert x < w, (slot, c)
                assert px == ((y, x), (y // 8, x // 8)), (slot, c, px)
                done = done[1:] + [(y, x)]  # the entry chosen for (y, x)
                if x & 3 == 3:
                    for q, entry in enumerate(done):
                        assert (y, x - 3 + q) not in written
                        written[(y, x - 3 + q)] = entry
            if x == w - 1:
                y += n_slots
    return written


@pytest.mark.parametrize("h,w", [
    (256, 256), (240, 256), (64, 24), (48, 16), (264, 32), (8, 8), (16, 8),
    (8, 64), (40, 24), (64, 96)])
def test_every_pixel_loaded_and_stored_once(h, w):
    written = _replay(h, w)
    assert len(written) == h * w
    assert all(entry == pos for pos, entry in written.items())
