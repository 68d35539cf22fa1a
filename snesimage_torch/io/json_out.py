"""JSON output contract, byte-identical to snesimage_tpu/io/json_out.py.

Reference `as_json` (src/lib.rs:579-625) + serde_json: ``palette`` holds
16 u16 values per subpalette (slot 0 transparent, entries packed BGR555,
zero padding), ``tiles`` the row-major tiles of ``palette_map + 1`` (0 for
transparent pixels), ``tile_palettes`` the per-tile subpalette ids. Keys
are alphabetical with compact separators, as serde_json's BTreeMap
serialization writes them.
"""

from __future__ import annotations

import json

import numpy as np

from snesimage_torch.config import QuantConfig
from snesimage_torch.core.state import QuantState
from snesimage_torch.ops.color import pack_bgr555


def state_to_json_obj(state: QuantState, config: QuantConfig) -> dict:
    packed = pack_bgr555(state.palette).cpu().numpy()  # (C, S)
    pmap = state.palette_map.cpu().numpy()
    alpha = state.original[..., 3].cpu().numpy()
    tp = state.tile_palettes.cpu().numpy()

    c, s = packed.shape
    palette = []
    for pi in range(c):
        for i in range(16):
            palette.append(0 if i == 0 or i > s else int(packed[pi, i - 1]))

    ht, wt = tp.shape
    values = np.where(alpha > 0, pmap + 1, 0)
    tiles = values.reshape(ht, 8, wt, 8).transpose(0, 2, 1, 3).reshape(ht * wt, 64)
    return {
        "palette": palette,
        "tile_palettes": tp.reshape(-1).astype(int).tolist(),
        "tiles": tiles.astype(int).tolist(),
    }


def state_to_json(state: QuantState, config: QuantConfig) -> str:
    """Serialize exactly like serde_json's `to_string` (compact)."""
    return json.dumps(
        state_to_json_obj(state, config), separators=(",", ":"), ensure_ascii=False
    )


def write_json(path: str, state: QuantState, config: QuantConfig) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(state_to_json(state, config))
