"""End-to-end pipeline: the balanced profile's main path.

Counterpart of snesimage_tpu/core/pipeline.py `initialize`, `cluster` and
`run_fused`:

  1. `initialize` — tile->subpalette assignment, flat palettes, remap
                    (reference `initialize_tiles`, src/lib.rs:79-189);
  2. `cluster`    — per-subpalette pixel k-means and remap (reference
                    `recalculate_palettes`, src/lib.rs:407-415);
  3. the reference pyramid, then `max_steps` channel sweeps
     (core/refine.py) with `_optimize_fused`'s stop rule.

The steps run eagerly on the state's device. The run waits for the device
once, at the end, unless `converge_tol > 0`: the stop rule then reads each
step's error on the host.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core import refine
from snesimage_torch.core.init import assign_tiles, recalculate_palettes
from snesimage_torch.core.state import QuantState, new_state

log = logging.getLogger("snesimage_torch")


def initialize(state: QuantState, config: QuantConfig) -> QuantState:
    """Stage 1: tile assignment, initial palettes and remap."""
    if config.subpalette_count == 1:
        state = recalculate_palettes(state, config)
    else:
        state = assign_tiles(state, config)
    return refine.full_remap(state, config)


def cluster(state: QuantState, config: QuantConfig) -> QuantState:
    """Stage 2: per-subpalette k-means and remap."""
    state = recalculate_palettes(state, config)
    return refine.full_remap(state, config)


def _optimize(state, config, refp):
    """Channel sweeps with the stop rule of the JAX package's
    `_optimize_fused`: stop once a step improves the exact error by less
    than `converge_tol` (0 = a fixed budget of `max_steps` steps).
    Returns (state, per-step errors as a 1-d tensor)."""
    generator = None
    if config.channel_explore > 0:
        generator = torch.Generator(device=state.device)
        generator.manual_seed(config.seed)
    err = refine.frame_error_fused(state, config, refp)
    errors = []
    prev = float("inf")  # the first step never stops the run
    for _ in range(config.max_steps):
        state, err = refine.sweep_channel(state, config, refp, err, generator)
        errors.append(err)
        if config.converge_tol > 0:
            full = float(err)
            if prev - full < config.converge_tol:
                break
            prev = full
    if not errors:
        return state, err.new_empty((0,))
    return state, torch.stack(errors)


def run_fused(
    source_rgba: np.ndarray,
    config: QuantConfig,
    *,
    device: torch.device | str,
) -> tuple[QuantState, list[float], dict]:
    """Full pipeline on `device`: initialize, cluster, the reference
    pyramid and the refinement loop. Returns (state, per-step errors,
    {"total_seconds", "final_error"}), like the JAX package's run_fused."""
    refine.check_slice(config)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_fused: no CUDA device is available")
    t0 = time.perf_counter()
    state = new_state(source_rgba, config, device)
    state = cluster(initialize(state, config), config)
    refp = refine.make_reference_pyramid(state)
    state, errs = _optimize(state, config, refp)
    if len(errs):
        final = errs[-1]
    else:
        final = refine.frame_error_fused(state, config, refp)
    summary = torch.cat([errs, final.view(1)]).cpu().numpy()  # the one sync
    elapsed = time.perf_counter() - t0
    errors = [float(e) for e in summary[:-1]]
    for step, err in enumerate(errors):
        log.info("step %d error: %f", step, err)
    return state, errors, {
        "total_seconds": elapsed,
        "final_error": float(summary[-1]),
    }
