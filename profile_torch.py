"""Where the time of the port's main paths goes on one CUDA card.

    python3 profile_torch.py [phase ...]

Runs on the bench image (snesimage_torch.testing.bench_image(0)) with the
balanced, perceptual and dithered profiles of chip_smoke.py, after a
warm-up run. With no arguments every phase runs; with arguments, only the
phases named (kernels, seeds, parity, walk, profile). The phases print one
JSON line each, profiles last:

  kernels  device time per call, from CUDA events around 20 launches, of
           kernel G (red-mean and perceptual, B = 48 and B = 1) and of
           kernel B at each call shape of the undithered and the dithered
           visit;
  profile  one channel sweep (360 visits) under torch.profiler, once per
           profile: the device's busy time (the union of its kernel and
           copy intervals), its idle share of the sweep's host-clock time
           (the same sweep unprofiled, timed before any profiler ran),
           device operations per visit, device time by kernel, and device
           time per wrapper call of kernels A, B and C (balanced), A, B
           and D (perceptual) or A, B and G (dithered);
  seeds    the balanced run's step and final errors for seeds 0, 1, 2;
  parity   once per profile, the run with channel_explore=0 (no random
           draws) for 2 steps on the card, and the same run with the
           plain twins on the CPU: the palettes must be equal and the
           step errors within chip_smoke.py's kernel-vs-twin bound on the
           frame error (kernel B and its twin sum 65536 pixels in
           different orders);
  walk     where the perceptual parity runs part: Lab of every 8-bit
           colour and CIEDE2000 of 2^22 random pairs of them, card against
           CPU; then the first explore-off sweep visit by visit, each visit
           run on the card and, from a CPU copy of the card's state, with
           the twins, listing the visits whose distance planes, finalists,
           pick or cache differ; and the first 45 visits of the dithered
           sweep the same way (palette maps, finalists, pick).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from chip_smoke import (
    BALANCED,
    DITHER,
    DITHER_PERCEPTUAL,
    ERROR_TOL,
    PERCEPTUAL,
    kernel_wrappers,
    prepared_state,
    visit_candidates,
)

# Device kernels of each wrapper (csrc/*.cu), by the name the profiler shows.
KERNEL_OF = {
    "select_colors_kernel": "select_colors",
    "ds2_kernel": "multiscale_feature_sums",
    "tiled_scale_kernel": "multiscale_feature_sums",
    "reduce_tiles_kernel": "multiscale_feature_sums",
    "resident_kernel": "multiscale_feature_sums",
    "coarse_redmean_kernel": "coarse_feature_sums_redmean",
    "coarse_ciede_kernel": "coarse_feature_sums_ciede",
    "dither_remap_kernel": "dither_remap_candidates",
}
SEEDS = (0, 1, 2)
PARITY_STEPS = 2
WALK_DITHER_VISITS = 45  # the first subpalette; a CPU twin visit takes seconds


def _prepared(img, config, device="cuda"):
    from snesimage_torch.core import pipeline, refine
    from snesimage_torch.core.state import new_state

    state = new_state(img, config, device)
    state = pipeline.cluster(pipeline.initialize(state, config), config)
    refp = refine.make_reference_pyramid(state)
    return state, refp, refine.frame_error_fused(state, config, refp)


def _device_ms(fn, runs: int = 20) -> float:
    """Device time of fn() per call: CUDA events around `runs` launches."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def phase_kernels(img):
    """Device ms per call of kernels G and B at the paths' call shapes."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_dither, cuda_metric

    out = {"phase": "kernels", "dither_remap_candidates": {},
           "multiscale_feature_sums": {}}
    for label, params in (("red-mean", DITHER),
                          ("perceptual", DITHER_PERCEPTUAL)):
        state, config = prepared_state(img, params)
        cand5 = visit_candidates(state)
        common = (state.rgb, state.alpha, state.tile_palettes, state.palette)
        for shape, args in (("B=48", (0, 0, cand5)),
                            ("B=1", (-1, 0, cand5[:1]))):
            out["dither_remap_candidates"][f"{label}, {shape}"] = _device_ms(
                lambda: cuda_dither.dither_remap_candidates(
                    *common, *args, config.perceptual_palettes),
                runs=20 if label == "red-mean" else 5)
        if label == "red-mean":
            refp = refine.make_reference_pyramid(state)
            maps = cuda_dither.dither_remap_candidates(*common, 0, 0, cand5)
            frames = refine.candidate_frames_dithered(state, config, 0, 0,
                                                      cand5, maps)
            for shape, fr, start, n, pre_ds in (
                    ("B=1, n=6", frames[:1], 0, 6, 0),
                    ("B=8, pre_ds=1, n=1", frames[:8], 1, 1, 1),
                    ("B=2, n=1", frames[:2], 0, 1, 0),
                    ("B=4, n=1", frames[:4], 0, 1, 0),
                    ("B=48, pre_ds=2, n=4", frames, 2, 4, 2)):
                refs = tuple(tuple(a.permute(2, 0, 1) for a in refp[start + s])
                             for s in range(n))
                fr = fr.contiguous()
                out["multiscale_feature_sums"][shape] = _device_ms(
                    lambda: cuda_metric.multiscale_feature_sums(
                        refs, fr, pre_ds=pre_ds))
    return out


def _union_ms(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _sweeper(img, params: dict):
    """(config, sweep): sweep() runs the first sweep of the run, the same
    work on every call, and returns its host-clock seconds."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import refine

    config = QuantConfig(**params)
    state, refp, err = _prepared(img, config)

    def sweep():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(config.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refine.sweep_channel(state, config, refp, err, gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return config, sweep


def phase_profile(label: str, config, sweep, wall: float):
    """One profiled sweep; `wall` is the same sweep's unprofiled time."""
    from torch.profiler import ProfilerActivity, profile

    visits = config.subpalette_count * config.subpalette_size * 3
    wrappers = kernel_wrappers()
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
        "profile": label,
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
            k: by_wrapper[k] / 1e3 / calls[k] for k in calls if calls[k]
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


def phase_parity(img, label: str, params: dict, steps: int):
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline

    config = QuantConfig(**dict(params, channel_explore=0, max_steps=steps))
    card, card_err, _ = pipeline.run_fused(img, config, device="cuda")
    t0 = time.perf_counter()
    cpu, cpu_err, _ = pipeline.run_fused(img, config, device="cpu")
    cpu_s = time.perf_counter() - t0
    diff = float(np.max(np.abs(np.subtract(card_err, cpu_err))))
    same = torch.equal(card.palette.cpu(), cpu.palette)
    return {
        "phase": "parity", "profile": label, "steps": steps,
        "palette_equal": same,
        "palette_map_equal": torch.equal(card.palette_map.cpu(),
                                         cpu.palette_map),
        "card_step_errors": card_err, "cpu_step_errors": cpu_err,
        "max_step_error_diff": diff, "cpu_seconds": cpu_s,
        "ok": same and diff <= ERROR_TOL,
    }


def _visit(state, config, refp, err, d_all, t_lab, p, i, channel):
    """One explore-off visit; returns ((errors, dists), (state, err,
    d_all)) as `refine._slot_channel` computes them."""
    from snesimage_torch.core import refine

    current = state.palette[p, i]
    cand5 = current[None].repeat(32, 1)
    cand5[:, channel] = torch.arange(32, dtype=torch.int32,
                                     device=current.device)
    errors, final_map, new_d_all = refine._undithered_machinery(
        state, config, p, i, d_all, t_lab)
    scored = errors(refp, cand5)
    return scored, refine._pick(
        lambda *_, **__: scored, final_map, new_d_all, state, d_all, refp,
        cand5, current, err, p, i, config.accept_margin)


def phase_walk(img, params: dict):
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import refine
    from snesimage_torch.ops.color import ciede2000, srgb_u8_to_lab

    u8 = torch.arange(1 << 24, dtype=torch.int32)
    u8 = torch.stack([u8 >> 16, (u8 >> 8) & 255, u8 & 255], dim=-1)
    lab = srgb_u8_to_lab(u8)
    lab_diff = int((srgb_u8_to_lab(u8.cuda()).cpu() != lab).sum())
    gen = torch.Generator().manual_seed(0)
    pairs = [lab[torch.randint(0, 1 << 24, (1 << 22,), generator=gen)]
             for _ in range(2)]
    de_diff = int((ciede2000(*(x.cuda() for x in pairs)).cpu()
                   != ciede2000(*pairs)).sum())

    config = QuantConfig(**dict(params, channel_explore=0))
    card, refp, err = _prepared(img, config)
    cpu, refp_cpu, _ = _prepared(img, config, "cpu")
    d_all = refine.compute_d_all(card, config)
    t_lab = refine.target_lab(card, config)
    d_all_cpu = refine.compute_d_all(cpu, config)
    t_lab_cpu = refine.target_lab(cpu, config)
    out = {"phase": "walk", "lab_channels_differing": lab_diff,
           "ciede2000_pairs_differing": de_diff,
           "same_init": torch.equal(card.palette_map.cpu(), cpu.palette_map)
           and torch.equal(card.palette.cpu(), cpu.palette),
           "d_all_pixels_differing": int((d_all.cpu() != d_all_cpu).sum())}
    s, parted = config.subpalette_size, []
    for k in range(config.subpalette_count * s * 3):
        where = (k // (s * 3), (k // 3) % s, k % 3)
        (errs, dists), (nxt, nerr, nd) = _visit(
            card, config, refp, err, d_all, t_lab, *where)
        (errs_c, dists_c), (nxt_c, nerr_c, nd_c) = _visit(
            cpu.replace(tile_palettes=card.tile_palettes.cpu(),
                        palette=card.palette.cpu(),
                        palette_map=card.palette_map.cpu()),
            config, refp_cpu, err.cpu(), d_all.cpu(), t_lab_cpu, *where)
        ix = torch.arange(32)
        rec = {
            "visit": k,
            "dist_pixels_differing": int(
                (dists(ix.cuda()).cpu() != dists_c(ix)).sum()),
            "same_finalists": torch.equal(torch.isfinite(errs).cpu(),
                                          torch.isfinite(errs_c)),
            "same_palette": torch.equal(nxt.palette.cpu(), nxt_c.palette),
            "same_cache": torch.equal(nd.cpu(), nd_c),
        }
        if not all(rec[key] for key in ("same_finalists", "same_palette",
                                        "same_cache")) or rec[
                "dist_pixels_differing"]:
            rec["finalist_errors"] = {
                name: {j: float(e[j]) for j in
                       torch.nonzero(torch.isfinite(e)).flatten().tolist()}
                for name, e in (("card", errs.cpu()), ("cpu", errs_c))}
            parted.append(rec)
        card, err, d_all = nxt, nerr, nd
    out.update(visits=config.subpalette_count * s * 3, parted=parted)
    return out


def phase_walk_dither(img, params: dict, visits: int):
    """The first `visits` explore-off visits of a dithered sweep, each run
    on the card (kernels G, A, B) and, from a CPU copy of the card's state,
    with the twins: where the maps, the finalists or the pick differ."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import refine

    config = QuantConfig(**dict(params, channel_explore=0))
    card, refp, err = _prepared(img, config)
    cpu, refp_cpu, _ = _prepared(img, config, "cpu")
    out = {"phase": "walk_dither", "visits": visits,
           "same_init": torch.equal(card.palette_map.cpu(), cpu.palette_map)
           and torch.equal(card.palette.cpu(), cpu.palette)}
    s, parted, accepted = config.subpalette_size, [], 0
    for k in range(visits):
        p, i, channel = k // (s * 3), (k // 3) % s, k % 3
        twin_state = cpu.replace(tile_palettes=card.tile_palettes.cpu(),
                                 palette=card.palette.cpu(),
                                 palette_map=card.palette_map.cpu())
        results = []
        for state, pyramid, base in ((card, refp, err),
                                     (twin_state, refp_cpu, err.cpu())):
            current = state.palette[p, i]
            cand5 = current[None].repeat(32, 1)
            cand5[:, channel] = torch.arange(32, dtype=torch.int32,
                                             device=current.device)
            errs, maps = refine._candidate_errors_dithered(
                state, config, pyramid, p, i, cand5)
            nxt, nerr, _ = refine._pick(
                lambda *_, **__: (errs, lambda ix: maps[ix]), lambda pm: pm,
                None, state, None, pyramid, cand5, current, base, p, i,
                config.accept_margin)
            results.append((errs.cpu(), maps.cpu(), nxt, nerr))
        (errs, maps, nxt, nerr), (errs_c, maps_c, nxt_c, _) = results
        rec = {
            "visit": k,
            "map_pixels_differing": int((maps != maps_c).sum()),
            "same_finalists": torch.equal(torch.isfinite(errs),
                                          torch.isfinite(errs_c)),
            "same_palette": torch.equal(nxt.palette.cpu(), nxt_c.palette),
            "same_map": torch.equal(nxt.palette_map.cpu(), nxt_c.palette_map),
        }
        accepted += int(not torch.equal(nxt.palette, card.palette))
        if rec["map_pixels_differing"] or not all(
                rec[key] for key in ("same_finalists", "same_palette",
                                     "same_map")):
            rec["finalist_errors"] = {
                name: {j: float(e[j]) for j in
                       torch.nonzero(torch.isfinite(e)).flatten().tolist()}
                for name, e in (("card", errs), ("cpu", errs_c))}
            parted.append(rec)
        card, err = nxt, nerr
    out.update(accepted=accepted, parted=parted)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device is available", file=sys.stderr)
        return 1
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline
    from snesimage_torch.testing import bench_image

    phases = set(sys.argv[1:]) or {"kernels", "seeds", "parity", "walk",
                                   "profile"}
    img = bench_image(0)
    profiles = {"balanced": BALANCED, "perceptual": PERCEPTUAL,
                "dither": DITHER}
    for params in profiles.values():  # build and warm up
        pipeline.run_fused(img, QuantConfig(**dict(params, max_steps=1)),
                           device="cuda")
    sweeps, walls = {}, {}
    if "profile" in phases:
        sweeps = {label: _sweeper(img, p) for label, p in profiles.items()}
        # Every unprofiled time is taken before any profiler has run.
        walls = {label: sweep() for label, (_, sweep) in sweeps.items()}
    # The explore-off parity runs again on the CPU with the twins; the
    # dithered twin takes too long there for whole sweeps at full size, so
    # the dithered path is walked over its first visits only.
    todo = [
        ("kernels", lambda: phase_kernels(img)),
        ("seeds", lambda: phase_seeds(img, SEEDS)),
        *(("parity", lambda label=label, p=p: phase_parity(
            img, label, p, PARITY_STEPS))
          for label, p in profiles.items() if label != "dither"),
        ("walk", lambda: phase_walk(img, PERCEPTUAL)),
        ("walk", lambda: phase_walk_dither(img, DITHER, WALK_DITHER_VISITS)),
        *(("profile", lambda label=label: phase_profile(
            label, *sweeps[label], walls[label])) for label in sweeps),
    ]
    ok = True
    for name, run in todo:
        if name not in phases:
            continue
        out = run()
        print(json.dumps(out), flush=True)
        ok = ok and out.get("ok", True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
