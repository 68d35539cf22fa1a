"""Where the time of the port's balanced main path goes on one CUDA card.

    python3 profile_torch.py

Runs on the bench image (bench._test_image(0)) with the balanced profile
of chip_smoke.py, after a warm-up run. Three phases, one JSON line each:

  profile  one channel sweep (360 visits) under torch.profiler: the
           device's busy time (the union of its kernel and copy
           intervals), its idle share of the sweep's host-clock time,
           device operations per visit, device time by kernel, and device
           time per wrapper call of kernels A, B and C;
  seeds    the balanced run's step and final errors for seeds 0, 1, 2;
  parity   the balanced run with channel_explore=0 (no random draws) for
           2 steps on the card, and the same run with the plain twins
           on the CPU: the palettes must be equal and the step errors
           within chip_smoke.py's kernel-vs-twin bound on the frame
           error (kernel B and its twin sum 65536 pixels in different
           orders).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from chip_smoke import BALANCED, ERROR_TOL

# Device kernels of each wrapper (csrc/*.cu), by the name the profiler shows.
KERNEL_OF = {
    "select_colors_kernel": "select_colors",
    "ds2_kernel": "multiscale_feature_sums",
    "tiled_scale_kernel": "multiscale_feature_sums",
    "reduce_tiles_kernel": "multiscale_feature_sums",
    "resident_kernel": "multiscale_feature_sums",
    "coarse_redmean_kernel": "coarse_feature_sums_redmean",
}
SEEDS = (0, 1, 2)
PARITY_STEPS = 2


def _prepared(img, config):
    from snesimage_torch.core import pipeline, refine
    from snesimage_torch.core.state import new_state

    state = new_state(img, config, "cuda")
    state = pipeline.cluster(pipeline.initialize(state, config), config)
    refp = refine.make_reference_pyramid(state)
    return state, refp, refine.frame_error_fused(state, config, refp)


def _wrappers():
    from snesimage_torch.ops import cuda_metric, cuda_prescreen

    return {
        "select_colors": cuda_prescreen.select_colors,
        "multiscale_feature_sums": cuda_metric.multiscale_feature_sums,
        "coarse_feature_sums_redmean": cuda_metric.coarse_feature_sums_redmean,
    }


def _union_ms(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def phase_profile(img):
    from torch.profiler import ProfilerActivity, profile

    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import refine

    config = QuantConfig(**BALANCED)
    state, refp, err = _prepared(img, config)
    visits = config.subpalette_count * config.subpalette_size * 3

    def sweep():
        # The first sweep of the run, the same work on every call.
        gen = torch.Generator(device="cuda")
        gen.manual_seed(config.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refine.sweep_channel(state, config, refp, err, gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = sweep()
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall = sweep()
    calls = {name: fn.launches for name, fn in wrappers.items()}

    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel, by_wrapper = {}, dict.fromkeys(calls, 0.0)
    for e in device:
        us = e.time_range.end - e.time_range.start
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + us
        for kname, wrapper in KERNEL_OF.items():
            if kname in e.name:
                by_wrapper[wrapper] += us
    busy_ms = _union_ms((e.time_range.start, e.time_range.end) for e in device)
    glue_ms = (sum(by_kernel.values()) - sum(by_wrapper.values())) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {
        "phase": "profile",
        "sweep_wall_s": wall,
        "profiled_sweep_wall_s": profiled_wall,
        "device_ops": len(device),
        "device_ops_per_visit": len(device) / visits,
        "device_busy_ms": busy_ms,
        # against the unprofiled sweep: the profiler slows the host only
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "wrapper_calls": calls,
        "wrapper_device_ms": {k: v / 1e3 for k, v in by_wrapper.items()},
        "device_ms_per_wrapper_call": {
            k: (by_wrapper[k] / 1e3 / calls[k]) if calls[k] else None
            for k in calls
        },
        "other_device_ms": glue_ms,
        "top_device_ms": [[name[:80], us / 1e3] for name, us in top],
    }


def phase_seeds(img, seeds):
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline

    runs = {}
    for seed in seeds:
        config = QuantConfig(**dict(BALANCED, seed=seed))
        _, errors, info = pipeline.run_fused(img, config, device="cuda")
        runs[seed] = {"step_errors": errors, "final_error": info["final_error"],
                      "seconds": info["total_seconds"]}
    return {"phase": "seeds", "runs": runs}


def phase_parity(img, steps):
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline

    config = QuantConfig(**dict(BALANCED, channel_explore=0, max_steps=steps))
    card, card_err, _ = pipeline.run_fused(img, config, device="cuda")
    t0 = time.perf_counter()
    cpu, cpu_err, _ = pipeline.run_fused(img, config, device="cpu")
    cpu_s = time.perf_counter() - t0
    diff = float(np.max(np.abs(np.subtract(card_err, cpu_err))))
    same = torch.equal(card.palette.cpu(), cpu.palette)
    return {
        "phase": "parity", "steps": steps, "palette_equal": same,
        "palette_map_equal": torch.equal(card.palette_map.cpu(),
                                         cpu.palette_map),
        "card_step_errors": card_err, "cpu_step_errors": cpu_err,
        "max_step_error_diff": diff, "cpu_seconds": cpu_s,
        "ok": same and diff <= ERROR_TOL,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device is available", file=sys.stderr)
        return 1
    from bench import _test_image
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline

    img = _test_image(0)
    pipeline.run_fused(img, QuantConfig(**dict(BALANCED, max_steps=1)),
                       device="cuda")  # build and warm up
    ok = True
    for out in (phase_profile(img), phase_seeds(img, SEEDS),
                phase_parity(img, PARITY_STEPS)):
        print(json.dumps(out), flush=True)
        ok = ok and out.get("ok", True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
