"""Checkpoint of the full optimizer state in one `.npz` file.

Counterpart of snesimage_tpu/io/checkpoint.py, in the same format
(version 1): the state's four fields as numpy arrays, the config as JSON,
the per-step errors and the step count. A checkpoint written by either
package loads in the other. The CLI writes them (`--checkpoint`, and
mid-run with `--dump-every`) and resumes from them (`--resume`).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core.state import QuantState, state_from_numpy

_FORMAT_VERSION = 1


def save_checkpoint(
    path: str,
    state: QuantState,
    config: QuantConfig,
    *,
    errors: list[float] | None = None,
    step: int = 0,
) -> None:
    """Write the checkpoint atomically to exactly `path`: through a file
    object, so np.savez appends no '.npz', and by a rename of a finished
    temporary file, so an interrupted write leaves the previous file."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            format_version=_FORMAT_VERSION,
            config=json.dumps(dataclasses.asdict(config)),
            original=state.original.cpu().numpy(),
            tile_palettes=state.tile_palettes.cpu().numpy(),
            palette=state.palette.cpu().numpy(),
            palette_map=state.palette_map.cpu().numpy(),
            errors=np.asarray(
                errors if errors is not None else [], dtype=np.float64
            ),
            step=step,
        )
    os.replace(tmp, path)


def load_checkpoint(
    path: str, device: torch.device | str = "cuda"
) -> tuple[QuantState, QuantConfig, dict]:
    """(state on `device`, config, {"errors", "step"}) of a checkpoint."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"Unsupported checkpoint version {version}")
        config = QuantConfig(**json.loads(str(z["config"])))
        state = state_from_numpy(
            {f: z[f] for f in ("original", "tile_palettes", "palette",
                               "palette_map")}, device)
        meta = {"errors": z["errors"].tolist(), "step": int(z["step"])}
    return state, config, meta
