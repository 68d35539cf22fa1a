"""End-to-end pipeline.

Counterpart of snesimage_tpu/core/pipeline.py:

  1. `initialize` — tile->subpalette assignment, flat palettes, remap
                    (reference `initialize_tiles`, src/lib.rs:79-189);
  2. `cluster`    — per-subpalette pixel k-means and remap (reference
                    `recalculate_palettes`, src/lib.rs:407-415);
  3. `optimize`   — the reference pyramid, then up to `max_steps` sweeps
     (core/refine.py) in the schedule (`schedule`, `step_method`) and with
     the stop rule of `_optimize_fused`: NES sweeps with `nes`; channel
     sweeps with `schedule="channel"`; else the reference's cycle of four
     random sweeps and one channel sweep (src/lib.rs:888-932).

`run_fused`, `run`, `run_fused_hybrid` and the host-stepped loop (hooks
after each sweep or slot visit, periodic tile reassignment) are one code
path, `optimize`: a hook reads the state and errors but changes no bit of
the run. On the card the sweeps replay CUDA graphs of them, each captured
once a key (core/graphs.py, the counterpart of the JAX package's jitted
fori_loop sweeps and `_optimize_fused`); on the CPU, with `eager=True` or
with `on_slot`, the sweeps run eagerly. The run waits for the device once,
at the end, unless `converge_tol > 0` or a hook reads each step's error on
the host.

Spans and counters (utils/profiling.py): `run` records itself, with the
stages `init`, `cluster`, `pyramid`, `optimize` and `final` as spans, the
first four timed on the card's clock too; `run_fused`, `run_fused_hybrid`
and `optimize` mark the same stages for a caller that records or profiles
them. `optimize` adds `stop_read` and `hook`, core/graphs.py the sweep's
spans. The counter "host_waits" counts each place where the program
blocks on the device.

The GUI's manual tile reassignment (clicking a tile cycles its subpalette,
src/lib.rs:1005-1024) is `reassign_tile` and `apply_tile_reassignments`.

The random stream is keyed by step: step k of a run draws what step k of
an uninterrupted run from step 0 draws, whatever `start_step` the run
began at (`step_stream`). The JAX package instead starts a resumed run on
the new stream fold_in(seed, start_step), which avoids replaying draws
but does not continue the stream; the port's property is the stronger one
(ROADMAP C-11).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterator

import numpy as np
import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.constants import RANDOM_STEPS_PER_CYCLE, SCHEDULE_CYCLE
from snesimage_torch.core import graphs, refine
from snesimage_torch.core.init import assign_tiles, recalculate_palettes
from snesimage_torch.core.reassign import auto_reassign_tiles
from snesimage_torch.core.state import QuantState, new_state
from snesimage_torch.utils import profiling
from snesimage_torch.utils.profiling import span

log = logging.getLogger("snesimage_torch")


@dataclasses.dataclass
class SlotVisit:
    """One scheduler position: which slot, which method."""

    step: int
    palette: int
    index: int
    method: str  # "random" | "channel" | "nes"
    channel: int  # only meaningful for "channel"


def _step_visits(config: QuantConfig, step: int) -> Iterator[SlotVisit]:
    """Slot visits of one scheduler step, reference order."""
    method = step_method(config, step)
    for palette in range(config.subpalette_count):
        for index in range(config.subpalette_size):
            if method == "channel":
                for channel in range(3):
                    yield SlotVisit(step, palette, index, method, channel)
            else:
                yield SlotVisit(step, palette, index, method, 0)


def schedule(config: QuantConfig, max_steps: int) -> Iterator[SlotVisit]:
    """Reference scheduler order (src/lib.rs:888-932) for `max_steps` full
    steps, the NES triple-visit quirk coalesced. Whether a channel step is
    windowed is `_is_window_step`'s to say."""
    for step in range(max_steps):
        yield from _step_visits(config, step)


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


def _check_tile(config: QuantConfig, x: int, y: int) -> None:
    """Raises ValueError for a tile off the grid: torch raises on an
    out-of-range index where JAX drops the scatter, so both packages
    validate first (ROADMAP C-4)."""
    if not (0 <= x < config.width_tiles and 0 <= y < config.height_tiles):
        raise ValueError(
            f"tile ({x}, {y}) out of range for a {config.width_tiles}x"
            f"{config.height_tiles} tile grid"
        )


def reassign_tile(state: QuantState, config: QuantConfig, tile_x: int,
                  tile_y: int, recluster: bool = True) -> QuantState:
    """Cycle one tile's subpalette id (GUI click, src/lib.rs:1005-1024)."""
    return apply_tile_reassignments(state, config, [(tile_x, tile_y)],
                                    recluster)


def apply_tile_reassignments(state: QuantState, config: QuantConfig,
                             assignments: list[tuple],
                             recluster: bool = True) -> QuantState:
    """A batch of manual tile reassignments, the GUI's one state-editing
    interaction: `(x, y)` cycles that tile's subpalette once, like one
    click; `(x, y, palette)` sets it. Applied on the host in one pass, then
    reclustered once, as the reference re-fits its palettes after a
    click."""
    profiling.count("host_waits", 2)  # the ids to the host and back
    tp = state.tile_palettes.cpu().numpy().copy()
    for item in assignments:
        if len(item) not in (2, 3):
            raise ValueError(
                f"reassignment must be (x, y) or (x, y, palette), got {item!r}"
            )
        x, y = item[:2]
        _check_tile(config, x, y)
        if len(item) == 2:
            tp[y, x] = (tp[y, x] + 1) % config.subpalette_count
        elif 0 <= item[2] < config.subpalette_count:
            tp[y, x] = item[2]
        else:
            raise ValueError(
                f"palette {item[2]} outside [0, {config.subpalette_count})"
            )
    state = state.replace(
        tile_palettes=torch.from_numpy(tp).to(state.tile_palettes.device))
    return cluster(state, config) if recluster else state


def parse_reassignments(text: str) -> list[tuple]:
    """A tile-reassignment spec: one tile per line, `x y` (cycle once) or
    `x y palette` (set); blank lines and #-comments ignored."""
    out: list[tuple] = []
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) not in (2, 3):
            raise ValueError(
                f"line {ln}: expected 'x y' or 'x y palette', got {raw!r}"
            )
        try:
            out.append(tuple(int(part) for part in parts))
        except ValueError:
            raise ValueError(f"line {ln}: non-integer field in {raw!r}")
    return out


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


def _windowing_active(config: QuantConfig) -> bool:
    """Whether windowed channel descent (`channel_window`) applies at all:
    on the channel schedule, never with NES palettes."""
    return (config.channel_window > 0 and config.schedule == "channel"
            and not config.nes)


def _is_window_step(config: QuantConfig, step: int) -> bool:
    """Whether step `step` (counted from the run's first step, so that a
    resumed run lands on the same windows) is a windowed channel sweep:
    the first `channel_window_warmup` sweeps and every
    `channel_window_period`-th sweep after them are exhaustive, the rest
    windowed. The stop rule fires only on exhaustive sweeps."""
    if not _windowing_active(config):
        return False
    warm, per = config.channel_window_warmup, config.channel_window_period
    return step >= warm and (step - warm) % per != per - 1


def plateau_stop(history: list, cycle: int, tol: float) -> bool:
    """The stop rule of `optimize` (the JAX package's `_plateau_stop` and
    `_optimize_fused`): stop once the latest error in `history` (the mean
    over a batch's images) improves on the one `cycle` steps before by
    less than `tol`; the first cycle of a window never stops a run."""
    prev = history[-1 - cycle] if len(history) > cycle else float("inf")
    return prev - history[-1] < tol


def _draw_sizes(config: QuantConfig, step: int) -> tuple[int, int]:
    """(visits, candidates) of the random draws of step `step`: every
    visit of a random step draws `random_trials` colours, every visit of a
    channel step `channel_explore`, NES none."""
    method = step_method(config, step)
    visits = config.subpalette_count * config.subpalette_size
    if method == "random":
        return visits, config.random_trials
    if method == "channel" and config.channel_explore > 0:
        return 3 * visits, config.channel_explore
    return 0, 0


def step_stream(config: QuantConfig, state: QuantState,
                start_step: int = 0) -> torch.Generator:
    """The run's generator on the state's device, seeded with
    `config.seed` and advanced by the draws of steps 0..start_step - 1, so
    that step k draws what it draws in an uninterrupted run (ROADMAP C-11).
    A torch.Generator has no fold_in: the draws are replayed, one call of
    each visit's shape, which is what keeps the stream's position exact on
    the CPU's and the card's generators alike. Each step's draws depend on
    its schedule method, so a run resumed under another recipe (hybrid's
    phase 2) continues that recipe's stream."""
    generator = torch.Generator(device=state.device)
    generator.manual_seed(config.seed)
    lead = tuple(state.palette.shape[:-3])
    for step in range(start_step):
        visits, n = _draw_sizes(config, step)
        for _ in range(visits):
            refine._draws(generator, lead, n, state.device)
    return generator


def _observed_step(state, config, refp, step, generator, on_slot):
    """One step visit by visit through `refine_slot_*` (the current colour
    scored inside each visit's batch; never gated), `on_slot(visit,
    error)` after each. Draws what the sweep of the step draws."""
    err = None
    window = _is_window_step(config, step)
    for visit in _step_visits(config, step):
        p, i = visit.palette, visit.index
        if visit.method == "nes":
            res = refine.refine_slot_nes(state, config, refp, p, i)
        elif visit.method == "random":
            res = refine.refine_slot_random(state, config, refp, generator,
                                            p, i)
        else:
            res = refine.refine_slot_channel(state, config, refp, p, i,
                                             visit.channel, generator,
                                             window)
        state, err = res.state, res.error
        profiling.count("host_waits")
        on_slot(visit, float(err))
    return state, err


def optimize(
    state: QuantState,
    config: QuantConfig,
    *,
    refp=None,
    max_steps: int | None = None,
    start_step: int = 0,
    reassign_every: int = 0,
    on_slot: Callable[[SlotVisit, float], None] | None = None,
    on_step: Callable[[int, QuantState, list[float]], None] | None = None,
    on_step_state: Callable[
        [int, QuantState, list[float]], QuantState | None
    ] | None = None,
    gate: bool = True,
    eager: bool = False,
) -> tuple[QuantState, torch.Tensor]:
    """Stage 3: up to `max_steps` (default `config.max_steps`) sweeps from
    step `start_step` of the schedule, with the stop rule `plateau_stop`
    on the carried exact error (tol 0 = a fixed budget; the reference
    schedule compares one cycle apart, `_stop_cycle`). Where the config
    gates (`refine._gating_active`), a starved gated step forces the next
    step exact, and only an exact step's sub-tol improvement stops the run.
    With `channel_window`, the steps `_is_window_step` names sweep windowed
    visits; such a step never stops the run, and a pending confirmation
    waits for the next exhaustive step.

    Hooks, as the JAX package's: `on_step(step, state, errors_so_far)`
    after every sweep (the CLI's `--dump-every`); `on_step_state(step,
    state, errors_so_far)` may return a replacement state (the live
    `--reassign-tiles`), which restarts the plateau window and the
    confirmation; `reassign_every` N re-fits the tiles
    (`reassign.auto_reassign_tiles`, then `full_remap`) after every N
    steps, with the same restart; `on_slot(visit, error)` after every slot
    visit (`-v`), which runs each step visit by visit through
    `refine_slot_*`, never gated. The hooks read the run; without a
    replacement or a reassignment they change no bit of it. Unlike the
    JAX package's host-stepped loop, the stop rule reads the carried exact
    error (as its fused loop does), not an error scored afresh.

    `gate=False` scores every visit exactly where the config would gate
    (the batched paths, as in the JAX package).

    On the card a step replays a CUDA graph of its sweep where
    core/graphs.py `SweepRunner` keeps one, or captures one with
    `graphs.CAPTURE_LEFT` steps of the run left or after
    `graphs.CAPTURE_RUNS` earlier runs of the key (never at a sweep key's
    first sweep in the process), bit for bit what the eager sweep gives;
    `eager=True` runs every sweep eagerly instead (the graph's plain twin,
    for comparisons). `on_slot` runs visit by visit and waits for each
    visit's error, as the JAX package's per-slot loop, so it stays eager
    by design. On the CPU every sweep runs eagerly.

    Returns (state, per-step errors as a (steps,) tensor on the device, or
    (steps, N) for a batched state). The whole is the span `optimize`."""
    with span("optimize", device=True):
        return _optimize(state, config, refp, max_steps, start_step,
                         reassign_every, on_slot, on_step, on_step_state,
                         gate, eager)


def _optimize(state, config, refp, max_steps, start_step, reassign_every,
              on_slot, on_step, on_step_state, gate, eager):
    if refp is None:
        refp = refine.make_reference_pyramid(state)
    steps = config.max_steps if max_steps is None else max_steps
    generator = step_stream(config, state, start_step)
    runner = graphs.SweepRunner(state.device,
                                eager=eager or on_slot is not None)
    err = refine.frame_error_fused(state, config, refp)
    gates = refine._gating_active(config)  # the sweeps take gate keywords
    gating = gate and on_slot is None and gates
    need_exact = False
    errors, history, host_errors = [], [], []
    cycle = _stop_cycle(config)
    for local in range(steps):
        step = start_step + local
        method = step_method(config, step)
        window = _is_window_step(config, step)
        # A pending confirmation lands only on an exhaustive sweep: a
        # windowed one can never stop the run.
        this_exact = gating and need_exact and not window
        sweep_kw = dict(use_gate=not this_exact, gate=gate) if gates else {}
        if window:
            # The keyword only where the step is windowed: the sweeps
            # take the same arguments as ever on every other step.
            sweep_kw["window"] = True
        if on_slot is not None:
            state, err = _observed_step(state, config, refp, step, generator,
                                        on_slot)
        else:
            state, err = runner.sweep(method, state, config, refp, err,
                                      generator, _draw_sizes(config, step),
                                      left=steps - local, **sweep_kw)
        errors.append(err)
        replacement = None
        if on_step is not None or on_step_state is not None:
            with span("hook"):
                profiling.count("host_waits")
                host_errors.append(float(err))
                if on_step is not None:
                    on_step(step, runner.release(state), host_errors)
                if on_step_state is not None:
                    replacement = on_step_state(step, runner.release(state),
                                                host_errors)
        if replacement is not None:
            # The state changed outside the descent (a mid-run tile
            # reassignment usually worsens the error before it pays off):
            # restart the plateau window and the confirmation, and carry
            # the new state's own error.
            state = replacement
            err = refine.frame_error_fused(state, config, refp)
            history.clear()
            need_exact = False
        if config.converge_tol > 0:
            with span("stop_read"):
                profiling.count("host_waits")
                history.append(float(err.mean()))
            # A windowed sweep's small step never stops the run: the next
            # exhaustive sweep may still jump.
            starved = (plateau_stop(history, cycle, config.converge_tol)
                       and not window)
            if gating:
                # Exact confirmation before any stop: a starved gated sweep
                # forces the next exhaustive sweep exact, and only an exact
                # sweep's sub-tol step stops the run.
                if starved and this_exact:
                    break
                need_exact = (need_exact and window) or (
                    starved and not this_exact)
            elif starved:
                break
        if reassign_every > 0 and (local + 1) % reassign_every == 0:
            # Re-fit the tiles to the evolved palettes, then remap (an
            # extension the reference wishes for, TODO.md:36-37).
            state = refine.full_remap(auto_reassign_tiles(state, config),
                                      config)
            err = refine.frame_error_fused(state, config, refp)
            log.info("step %d: tiles reassigned", step)
            history.clear()
            need_exact = False
    state = runner.release(state)
    if not errors:
        return state, err.new_empty((0, *err.shape))
    return state, torch.stack(errors)


def log_steps(errors, start_step: int = 0) -> None:
    """The reference-format line of each step's error."""
    for local, err in enumerate(errors):
        log.info("step %d error: %f", start_step + local, err)


def _check_device(device, what: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device is available")
    return device


def _final(state, config, refp, errs) -> np.ndarray:
    """The per-step errors and the run's final exact error (the last step's
    carried one, or the state's own where no step ran) on the host: the
    run's last wait for the device, which first completes the reads of
    its device counts."""
    final = errs[-1] if len(errs) else refine.frame_error_fused(state,
                                                                config, refp)
    profiling.queue_reads()
    profiling.count("host_waits")
    return torch.cat([errs, final.view(1)]).cpu().numpy()


def _start(state, config):
    """`initialize` and `cluster`, the spans `init` and `cluster`."""
    with span("init", device=True):
        state = initialize(state, config)
    with span("cluster", device=True):
        return cluster(state, config)


def _pyramid(state):
    with span("pyramid", device=True):
        return refine.make_reference_pyramid(state)


def run_fused(
    source_rgba: np.ndarray,
    config: QuantConfig,
    *,
    max_steps: int | None = None,
    start_step: int = 0,
    device: torch.device | str = "cuda",
) -> tuple[QuantState, list[float], dict]:
    """Full pipeline on `device` (the card unless the caller asks for the
    CPU; without a card it raises): initialize, cluster, the reference
    pyramid and `optimize` for `max_steps` (default `config.max_steps`)
    steps from step `start_step` of the schedule and its random stream.
    Returns (state, per-step errors, {"total_seconds", "final_error"}),
    like the JAX package's run_fused; the host waits for the device once."""
    device = _check_device(device, "run_fused")
    state = new_state(source_rgba, config, device)
    t0 = time.perf_counter()  # after new_state, as the JAX package's clock
    state = _start(state, config)
    refp = _pyramid(state)
    state, errs = optimize(state, config, refp=refp,
                           max_steps=max_steps, start_step=start_step)
    with span("final"):
        summary = _final(state, config, refp, errs)  # the one sync
    elapsed = time.perf_counter() - t0
    errors = [float(e) for e in summary[:-1]]
    log_steps(errors, start_step)
    return state, errors, {
        "total_seconds": elapsed,
        "final_error": float(summary[-1]),
    }


# Fields both phases of `run_fused_hybrid` must share: the state's layout
# and the reference pyramid.
_HYBRID_SHARED = ("width", "height", "subpalette_count", "subpalette_size",
                  "dither", "perceptual_palettes", "nes")


def run_fused_hybrid(
    source_rgba: np.ndarray,
    config_fast: QuantConfig,
    config_quality: QuantConfig,
    *,
    device: torch.device | str = "cuda",
) -> tuple[QuantState, list[float], dict]:
    """Two phases: `config_fast` (the gated channel recipe) to its
    plateau, then `config_quality` (explore polish) from phase 1's state,
    starting at phase 1's step count in the schedule and the random stream.
    Returns what `run_fused` returns, the info with "phase_steps" (phase
    1's steps, phase 2's). Phase 1's stop rule reads its errors on the
    host, so its step count is known when phase 2 starts."""
    for field in _HYBRID_SHARED:
        if getattr(config_fast, field) != getattr(config_quality, field):
            raise ValueError(
                f"hybrid phases disagree on {field}: "
                f"{getattr(config_fast, field)!r} vs "
                f"{getattr(config_quality, field)!r}"
            )
    device = _check_device(device, "run_fused_hybrid")
    state = new_state(source_rgba, config_fast, device)
    t0 = time.perf_counter()
    state = _start(state, config_fast)
    refp = _pyramid(state)
    state, errs1 = optimize(state, config_fast, refp=refp)
    state, errs2 = optimize(state, config_quality, refp=refp,
                            start_step=len(errs1))
    errs = torch.cat([errs1, errs2])
    with span("final"):
        summary = _final(state, config_quality, refp, errs)
    elapsed = time.perf_counter() - t0
    errors = [float(e) for e in summary[:-1]]
    log_steps(errors)
    return state, errors, {
        "total_seconds": elapsed,
        "final_error": float(summary[-1]),
        "phase_steps": (len(errs1), len(errs2)),
    }


def run(
    source_rgba: np.ndarray,
    config: QuantConfig,
    *,
    device: torch.device | str = "cuda",
) -> tuple[QuantState, list[float], dict]:
    """Full pipeline, timed by stage: init and cluster, then `optimize`.
    Returns (state, per-step errors, {"init_seconds", "optimize_seconds",
    "final_error"}); each clock stops after the device has finished its
    stage. The run is recorded (`profiling.recording`): one record of its
    spans and counters in `profiling.runs()`."""
    device = _check_device(device, "run")
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    with profiling.recording(device):
        t0 = time.perf_counter()
        state = _start(new_state(source_rgba, config, device), config)
        profiling.count("host_waits")
        sync()
        t_init = time.perf_counter() - t0
        refp = _pyramid(state)
        t1 = time.perf_counter()
        state, errs = optimize(state, config, refp=refp)
        profiling.count("host_waits")
        sync()
        t_opt = time.perf_counter() - t1
        with span("final"):
            summary = _final(state, config, refp, errs)
    errors = [float(e) for e in summary[:-1]]
    log_steps(errors)
    return state, errors, {
        "init_seconds": t_init,
        "optimize_seconds": t_opt,
        "final_error": float(summary[-1]),
    }
