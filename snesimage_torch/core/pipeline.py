"""End-to-end pipeline.

Counterpart of snesimage_tpu/core/pipeline.py `initialize`, `cluster` and
`run_fused`:

  1. `initialize` — tile->subpalette assignment, flat palettes, remap
                    (reference `initialize_tiles`, src/lib.rs:79-189);
  2. `cluster`    — per-subpalette pixel k-means and remap (reference
                    `recalculate_palettes`, src/lib.rs:407-415);
  3. the reference pyramid, then up to `max_steps` sweeps (core/refine.py)
     in the schedule and with the stop rule of `_optimize_fused`: NES
     sweeps with `nes`; channel sweeps with `schedule="channel"`; else the
     reference's cycle of four random sweeps and one channel sweep
     (src/lib.rs:888-932).

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
from snesimage_torch.constants import RANDOM_STEPS_PER_CYCLE, SCHEDULE_CYCLE
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


def _stop_cycle(config: QuantConfig) -> int:
    """Steps between the two errors the stop rule compares: the reference
    schedule mixes weak random steps with strong channel steps, so it
    compares one whole cycle apart; the channel and NES schedules compare
    successive steps."""
    if config.nes or config.schedule == "channel":
        return 1
    return SCHEDULE_CYCLE


def step_method(config: QuantConfig, step: int) -> str:
    """Which sweep step `step` runs: "nes", "random" or "channel"."""
    if config.nes:
        return "nes"
    if (config.schedule == "channel"
            or step % SCHEDULE_CYCLE >= RANDOM_STEPS_PER_CYCLE):
        return "channel"
    return "random"


def _optimize(state, config, refp):
    """The sweeps of `step_method` with the stop rule of the JAX package's
    `_optimize_fused`: stop once a step's exact error improves on the
    error `_stop_cycle` steps before by less than `converge_tol` (0 = a
    fixed budget of `max_steps` steps). Random candidates and explore
    draws come from one generator seeded with `config.seed`. Returns
    (state, per-step errors as a 1-d tensor)."""
    generator = torch.Generator(device=state.device)
    generator.manual_seed(config.seed)
    explore = generator if config.channel_explore > 0 else None
    err = refine.frame_error_fused(state, config, refp)
    errors = []
    cycle = _stop_cycle(config)
    window = [float("inf")] * cycle  # the first cycle never stops the run
    for step in range(config.max_steps):
        method = step_method(config, step)
        if method == "nes":
            state, err = refine.sweep_nes(state, config, refp, err)
        elif method == "random":
            state, err = refine.sweep_random(state, config, refp, generator,
                                             err)
        else:
            state, err = refine.sweep_channel(state, config, refp, err,
                                              explore)
        errors.append(err)
        if config.converge_tol > 0:
            full = float(err)
            if window[step % cycle] - full < config.converge_tol:
                break
            window[step % cycle] = full
    if not errors:
        return state, err.new_empty((0,))
    return state, torch.stack(errors)


def run_fused(
    source_rgba: np.ndarray,
    config: QuantConfig,
    *,
    device: torch.device | str = "cuda",
) -> tuple[QuantState, list[float], dict]:
    """Full pipeline on `device` (the card unless the caller asks for the
    CPU; without a card it raises): initialize, cluster, the reference
    pyramid and the refinement loop. Returns (state, per-step errors,
    {"total_seconds", "final_error"}), like the JAX package's run_fused."""
    refine.check_slice(config)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_fused: no CUDA device is available")
    state = new_state(source_rgba, config, device)
    t0 = time.perf_counter()  # after new_state, as the JAX package's clock
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
