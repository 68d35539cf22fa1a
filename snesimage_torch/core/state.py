"""Optimizer state as a small dataclass of tensors on one device.

Counterpart of snesimage_tpu/core/state.py. Fields:
  original:      (H, W, 4) uint8 RGBA source pixels.
  tile_palettes: (Ht, Wt) int32 subpalette id per 8x8 tile.
  palette:       (C, S, 3) int32 5-bit palette entries.
  palette_map:   (H, W) int32 entry index per pixel.

A batched state (the JAX package's `make_batched_states`) has a leading
image axis N on every field: `stack_states` builds one from N states,
`image_of` takes image n back out. A seed portfolio's state
(`shared_states`) is a batched state of K seeds whose `original` and
`tile_palettes` are views of one image's with stride 0 on the seed axis.

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
from snesimage_torch.utils import profiling

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
        profiling.count("host_waits")
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


def is_batched(state: QuantState) -> bool:
    return state.original.dim() == 4


def stack_states(states) -> QuantState:
    """One batched state (leading image axis N) from N states."""
    return QuantState(**{f: torch.stack([getattr(st, f) for st in states])
                         for f in _FIELDS})


def image_of(state: QuantState, n: int) -> QuantState:
    """Image (or seed) n of a batched state."""
    return QuantState(**{f: getattr(state, f)[n] for f in _FIELDS})


def shared_states(state: QuantState, k: int) -> QuantState:
    """K seeds of one state: `original` and `tile_palettes` as stride-0
    views of the state's own, `palette` and `palette_map` as K copies that
    each seed changes on its own."""
    return QuantState(
        original=state.original.expand(k, *state.original.shape),
        tile_palettes=state.tile_palettes.expand(k,
                                                 *state.tile_palettes.shape),
        palette=state.palette.expand(k, *state.palette.shape).clone(),
        palette_map=state.palette_map.expand(k,
                                             *state.palette_map.shape).clone(),
    )


def shares_image(state: QuantState) -> bool:
    """Whether a batched state's images are one image (`shared_states`)."""
    return is_batched(state) and state.original.stride(0) == 0
