"""Optimizer state as a small dataclass of tensors on one device.

Counterpart of snesimage_tpu/core/state.py. Fields:
  original:      (H, W, 4) uint8 RGBA source pixels.
  tile_palettes: (Ht, Wt) int32 subpalette id per 8x8 tile.
  palette:       (C, S, 3) int32 5-bit palette entries.
  palette_map:   (H, W) int32 entry index per pixel.

`state_from_numpy` / `state_to_numpy` and their pyramid twins carry state
and reference pyramids between numpy arrays (for example the JAX
package's, converted with ``np.asarray``) and the port.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from snesimage_torch.config import QuantConfig

_FIELDS = ("original", "tile_palettes", "palette", "palette_map")
_DTYPES = {
    "original": torch.uint8,
    "tile_palettes": torch.int32,
    "palette": torch.int32,
    "palette_map": torch.int32,
}


@dataclasses.dataclass
class QuantState:
    original: torch.Tensor
    tile_palettes: torch.Tensor
    palette: torch.Tensor
    palette_map: torch.Tensor

    @property
    def rgb(self) -> torch.Tensor:
        return self.original[..., :3].to(torch.int32)

    @property
    def alpha(self) -> torch.Tensor:
        return self.original[..., 3].to(torch.int32)

    @property
    def device(self) -> torch.device:
        return self.original.device

    def replace(self, **changes) -> "QuantState":
        return dataclasses.replace(self, **changes)


def new_state(
    source_rgba: np.ndarray | torch.Tensor,
    config: QuantConfig,
    device: torch.device | str = "cuda",
) -> QuantState:
    """Fresh all-black state for a source image (src/lib.rs:45-65), on the
    card unless the caller asks for the CPU."""
    device = torch.device(device)
    if isinstance(source_rgba, torch.Tensor):
        source = source_rgba.to(device=device, dtype=torch.uint8)
    else:
        source = torch.from_numpy(
            np.ascontiguousarray(source_rgba, dtype=np.uint8)
        ).to(device)
    h, w = config.height, config.width
    if tuple(source.shape) != (h, w, 4):
        raise ValueError(
            f"expected source of shape {(h, w, 4)}, got {tuple(source.shape)}"
        )
    zeros = dict(dtype=torch.int32, device=device)
    return QuantState(
        original=source,
        tile_palettes=torch.zeros(
            (config.height_tiles, config.width_tiles), **zeros
        ),
        palette=torch.zeros(
            (config.subpalette_count, config.subpalette_size, 3), **zeros
        ),
        palette_map=torch.zeros((h, w), **zeros),
    )


def state_from_numpy(
    arrays: Mapping[str, np.ndarray], device: torch.device | str
) -> QuantState:
    """QuantState from a mapping of the four field arrays."""
    return QuantState(
        **{
            f: torch.from_numpy(np.array(arrays[f])).to(
                device=torch.device(device), dtype=_DTYPES[f]
            )
            for f in _FIELDS
        }
    )


def state_to_numpy(state: QuantState) -> dict[str, np.ndarray]:
    return {f: getattr(state, f).cpu().numpy() for f in _FIELDS}


def pyramid_from_numpy(refp, device: torch.device | str):
    """Reference pyramid (per-scale (img1, mu1, s11), each (h, w, 3)) from
    numpy arrays, in the port's storage layout (see
    ops/ssimulacra2.py reference_pyramid)."""
    from snesimage_torch.ops.ssimulacra2 import channel_major_storage

    return tuple(
        tuple(
            channel_major_storage(
                torch.from_numpy(np.array(a, dtype=np.float32)).to(
                    torch.device(device)
                )
            )
            for a in scale
        )
        for scale in refp
    )


def pyramid_to_numpy(refp):
    return tuple(tuple(a.cpu().numpy() for a in scale) for scale in refp)
