"""Where the time of the port's main paths goes on one CUDA card.

    python3 profile_torch.py [phase ...] [--parent DIR]

Runs on the bench image (snesimage_torch.testing.bench_image(0)) with the
balanced, perceptual, dithered and dithered perceptual profiles of
chip_smoke.py, and on its first 240 rows (256x240, the route through
kernels E and F) with the balanced and perceptual ones, after a warm-up
run. With no arguments every phase runs; with arguments, only the phases
named (kernels, multiscale, pair, seeds, parity, walk, walk_run,
profile, batch, gate, init). The phases print one JSON line each, profiles last:

  kernels  device time per call, from CUDA events around 20 launches, of
           kernel G (red-mean and perceptual, B = 48 and B = 1), of every
           variant of kernel G built (lanes per row slot, blocks per
           candidate) at B = 48 with its maps checked against the default
           variant's, and the compiler's register and spill report of each
           (`-Xptxas -v`, from the build log); of kernel B at each call
           shape of the undithered and the dithered visit, and, at
           256x240, of kernels E and F (B = 48) at the first visit of each
           subpalette p, restricted to its tiles as the visit calls them
           (and at p = 0 over every tile), a sweep's E or F time estimated
           from them, their register report, and of kernel B on the 48
           quarter-resolution frames assembled from E's sums; of kernels C
           and D at the first visit (B = 48, 256x256), with the clusters the
           card holds at once, their register report, and F and B on the
           perceptual visit, D's yardstick;
  multiscale
           kernel B at every call shape chip_smoke.py drives (14 shapes) and
           kernels C and D at the first visit: device ms per call (CUDA
           events around 50 calls behind a spin kernel, two runs), device
           kernels per call (torch.profiler), bound, launches per call and
           the clusters the card holds at once for each, B's register
           report; with --parent DIR (a `git archive` of another commit
           unpacked in a directory .gitignore lists, such as
           snesimage_torch/build/parent) also that tree's kernels on the
           same operands in a process of their own, before and after this
           tree's (parent, this tree, this tree, parent), and whether their
           sums are bit-equal;
  profile  one channel sweep (360 visits) under torch.profiler, once per
           profile, run eagerly and replayed as a CUDA graph
           (core/graphs.py; its record says "graphed", and its device
           operations are the graph's nodes a sweep): the device's busy
           time (the union of its kernel and copy intervals), its idle
           share of the sweep's host-clock time
           (the same sweep unprofiled, timed before any profiler ran),
           device operations per visit, device time by kernel, and device
           time per wrapper call of kernels A, B and C (balanced), A, B
           and D (perceptual), A, B and G (dithered) or A, B and E or F
           (256x240); then the 8-step dithered perceptual run once
           (seconds, step errors, launches);
  batch    the `profile` phase's records (eager and graphed) for one
           sweep of the image batch
           and the seed portfolio (core/refine.py with a leading image
           axis): a NES sweep of one `nes-compat` image and of a batch of
           16 (BASELINE config 5's first 16 images, as chip_smoke.py
           phase 28 makes them), and a balanced channel sweep of one image
           and of portfolios of K = 2 and 4 seeds over it;
  gate     the `profile` phase's records (eager and graphed) for one
           sweep of the `fast` profile
           (8x15, the rank-1 gate on) from the state after its first
           GATE_WARM_STEPS steps, and for the same sweep with
           gate_margin=0 (every visit scored exactly), with the share of
           closed gates (core/refine.py `gate_tally`) and kernel B's device
           ms in both: what a closed gate saves on the card;
  init     `pipeline.run` with one step, twice a path (the balanced,
           perceptual and dithered recipes at 256x256, balanced at
           256x240, `nes-compat`): the init's seconds (new_state,
           initialize and cluster, ending in a device sync) and the step's;
  pair     seconds of the 8-step balanced run at 256x256 and at 256x240
           taken in turns (256, 240, 240, 256), red-mean and perceptual:
           the host's clock moves between calls and within one, so two
           geometries are compared only so;
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
           sweep the same way (palette maps, finalists, pick);
  walk_run the balanced run without explore the same way, sweep after
           sweep, up to the end of the first sweep in which the card and
           the twins pick differently (at most 8; about a minute and a
           half a sweep on the card's host): where a whole explore-free
           run on the card parts from the CPU's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import (
    BALANCED,
    fast_params,
    DITHER,
    DITHER_PERCEPTUAL,
    ERROR_TOL,
    GEOMETRY,
    GEOMETRY_DITHER,
    GEOMETRY_PERCEPTUAL,
    PERCEPTUAL,
    REFERENCE,
    b_bound,
    device_ms,
    first_visit,
    kernel_wrappers,
    prepared_state,
    unfused_coarse_ms,
    visit_candidates,
    visit_of,
)

# Device kernels of each wrapper (csrc/*.cu), by the name the profiler shows.
KERNEL_OF = {
    "select_colors_kernel": "select_colors",
    "prologue_kernel": "select_colors",
    "render_kernel": "select_colors",
    "multiscale_kernel": "multiscale_feature_sums",
    "coarse_redmean_kernel": "coarse_feature_sums_redmean",
    "coarse_ciede_kernel": "coarse_feature_sums_ciede",
    "pooled_wins_redmean_kernel": "pooled_wins_redmean",
    "pooled_wins_ciede_kernel": "pooled_wins_ciede",
    "dither_remap_kernel": "dither_remap_candidates",
}
SEEDS = (0, 1, 2)
PARITY_STEPS = 2
WALK_DITHER_VISITS = 45  # the first subpalette; a CPU twin visit takes seconds
WALK_RUN_STEPS = 8  # the balanced run's budget


def _prepared(img, config, device="cuda"):
    from snesimage_torch.core import pipeline, refine
    from snesimage_torch.core.state import new_state

    state = new_state(img, config, device)
    state = pipeline.cluster(pipeline.initialize(state, config), config)
    refp = refine.make_reference_pyramid(state)
    return state, refp, refine.frame_error_fused(state, config, refp)


def _ptxas_report(names) -> dict:
    """The compiler's resource lines (`-Xptxas -v`, kept in the build log)
    of every kernel whose mangled name holds one of `names`."""
    from snesimage_torch.ops import _kernels

    report, current = {}, None
    for line in _kernels.build().with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            current = name if any(n in name for n in names) else None
            if current:
                report[current] = []
        elif current and ("Used" in line or "spill" in line):
            report[current].append(line.split(":", 1)[-1].strip())
    return report


def phase_g_variants(img):
    """Device ms per call of every built variant of kernel G at the
    dithered visit's shape (B = 48, 256x256), with its maps checked against
    the default variant's, and each variant's register report."""
    from snesimage_torch.ops import cuda_dither

    out = {"phase": "g_variants", "variants": {}}
    for label, params in (("red-mean", DITHER),
                          ("perceptual", DITHER_PERCEPTUAL)):
        state, config = prepared_state(img, params)
        args = (state.rgb, state.alpha, state.tile_palettes, state.palette,
                0, 0, visit_candidates(state), config.perceptual_palettes)
        want = cuda_dither.dither_remap_candidates(*args)
        steps = 256 + 2 * 256 - 2
        perc = config.perceptual_palettes
        for lanes, cluster in cuda_dither.VARIANTS[perc]:

            def run(lanes=lanes, cluster=cluster):
                return cuda_dither._dither_remap_cuda(
                    *args, lanes=lanes, cluster=cluster)

            ms = device_ms(run, runs=20 if not perc else 5)
            out["variants"][f"{label}, L={lanes}, blocks={cluster}"] = {
                "device_ms": ms, "us_per_step": ms * 1e3 / steps,
                "maps_equal_default": torch.equal(run(), want),
            }
    out["ptxas"] = _ptxas_report(("dither_remap_kernel", "prologue_kernel",
                                  "render_kernel"))
    return out


def phase_coarse(img):
    """Device ms per call of kernels C and D at the first visit's shapes
    (B = 48, 256x256), with the clusters the card holds at once and each
    kernel's register report; kernels F and B on the perceptual visit (the
    unfused route, D's yardstick)."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_metric

    out = {"phase": "coarse"}
    for label, params, wrapper in (
            ("red-mean", BALANCED, cuda_metric.coarse_feature_sums_redmean),
            ("perceptual", PERCEPTUAL, cuda_metric.coarse_feature_sums_ciede)):
        _, refp, ctx, cand8, cand_lin = first_visit(img, params)
        args = refine.coarse_inputs(ctx, cand8, cand_lin, refp)
        out[label] = {
            "device_ms": device_ms(lambda: wrapper(*args)),
            "blocks_per_candidate": cuda_metric.CLUSTER_BLOCKS,
            "active_clusters": cuda_metric.active_clusters(
                label == "perceptual", 256, 256),
        }
        if label == "perceptual":
            unfused = unfused_coarse_ms(ctx, cand8, cand_lin, refp)
            unfused.pop("planes")
            out["unfused_f_plus_b"] = unfused
    out["ptxas"] = _ptxas_report(("coarse_redmean_kernel",
                                  "coarse_ciede_kernel"))
    return out


def _b_shapes(img):
    """Kernel B's operands at every call shape chip_smoke.py drives, from
    the same states: (label, refs, frames, pre_ds) each."""
    from snesimage_torch.core import refine
    from snesimage_torch.models.presets import preset_fields
    from snesimage_torch.ops import cuda_dither, cuda_prescreen
    from snesimage_torch.ops.color import (
        expand_5bit_to_8bit,
        nes_palette_5bit,
        srgb_u8_to_linear,
    )
    from snesimage_torch.ops.remap import render_linear

    def refs_of(refp, start, n):
        return tuple(tuple(a.permute(2, 0, 1) for a in refp[start + s])
                     for s in range(n))

    def frames_of(ctx, cand5):
        cand8 = expand_5bit_to_8bit(cand5)
        return refine.candidate_frames(ctx, ctx.cand_dist(cand8),
                                       srgb_u8_to_linear(cand8)).contiguous()

    cases = []
    img240 = np.ascontiguousarray(img[:240])
    for tag, image, params in (("", img, BALANCED),
                               ("256x240: ", img240, GEOMETRY)):
        state, refp, ctx, cand8, cand_lin = first_visit(image, params)
        frame = render_linear(state.palette_map, state.alpha,
                              state.tile_palettes, state.palette)
        finals = refine.candidate_frames(ctx, ctx.cand_dist(cand8[:8]),
                                         cand_lin[:8])
        cases += [
            (f"{tag}B=1, n=6", refs_of(refp, 0, 6),
             frame.permute(2, 0, 1)[None].contiguous(), 0),
            (f"{tag}B=8, pre_ds=1, n=1", refs_of(refp, 1, 1), finals, 1),
            (f"{tag}B=2, n=1", refs_of(refp, 0, 1),
             finals[:2].contiguous(), 0),
            (f"{tag}B=4, n=1", refs_of(refp, 0, 1),
             finals[:4].contiguous(), 0),
        ]
        if tag:
            pooled = cuda_prescreen.pooled_wins_redmean(
                *refine.pooled_inputs(ctx, cand8))
            quarter = cuda_prescreen.coarse_frames(
                pooled, cand_lin, refine.ds4_no_candidate(ctx)).contiguous()
            cases.append((f"{tag}B=48 of 60x64, n=4", refs_of(refp, 2, 4),
                          quarter, 0))
    for tag, image, params in (("", img, DITHER),
                               ("256x240: ", img240, GEOMETRY_DITHER)):
        state, _ = prepared_state(image, params)
        cand5 = visit_candidates(state)
        maps = cuda_dither.dither_remap_candidates(
            state.rgb, state.alpha, state.tile_palettes, state.palette, 0, 0,
            cand5, False)
        frames = cuda_prescreen.render_palette_maps(
            maps, state.tile_palettes, state.alpha, state.palette, cand5, 0,
            0)
        cases.append((f"{tag}B=48, pre_ds=2, n=4",
                      refs_of(refine.make_reference_pyramid(state), 2, 4),
                      frames, 2))
    state, refp, ctx, _, _ = first_visit(img, REFERENCE)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    draws = torch.randint(0, 32, (64, 3), generator=gen, device="cuda",
                          dtype=torch.int32)
    cases += [
        ("B=64, n=6 (random visit)", refs_of(refp, 0, 6),
         frames_of(ctx, draws), 0),
        ("B=32, n=6 (channel visit)", refs_of(refp, 0, 6),
         frames_of(ctx, visit_candidates(state)[:32]), 0),
    ]
    _, refp, ctx, _, _ = first_visit(
        img, dict(preset_fields("nes-compat"), seed=0))
    cases.append(("B=56, n=6 (NES visit)", refs_of(refp, 0, 6),
                  frames_of(ctx, nes_palette_5bit("cuda")), 0))
    return cases


def _kernels_per_call(fn, calls: int = 5):
    """Device kernels per call of fn(), over `calls` calls under
    torch.profiler; None if three profiler sessions recorded no device
    event at all (a session now and then records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
        if n:
            return n / calls
    return None


def kernel_times(cases) -> dict:
    """Kernels B, C and D with whichever snesimage_torch is imported, at
    each case (label, kernel, operands): the sums, device ms per call (50
    calls behind a spin kernel) and device kernels per call."""
    from snesimage_torch.ops import cuda_metric

    wrappers = {
        "B": lambda refs, frames, pre_ds: cuda_metric.multiscale_feature_sums(
            refs, frames, pre_ds=pre_ds),
        "C": cuda_metric.coarse_feature_sums_redmean,
        "D": lambda *args: cuda_metric.coarse_feature_sums_ciede(*args)[0],
    }
    out = {}
    for label, kernel, args in cases:

        def run(fn=wrappers[kernel], args=args):
            return fn(*args)

        out[label] = {"sums": run().cpu(), "device_ms": device_ms(run),
                      "kernels_per_call": _kernels_per_call(run)}
    return out


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_multiscale(img, parent):
    """Kernel B at every call shape chip_smoke.py drives: device ms per
    call, kernels per call, bound and clusters held at once; kernels C and
    D at the first visit (B = 48, 256x256), which share B's cluster pass.
    With `parent` (an unpacked tree of another commit, in a directory
    .gitignore lists) also that tree's kernels on the same operands, in
    turns (parent, this tree, this tree, parent, each parent run in a
    process of its own), and whether the sums are bit-equal."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import _kernels, cuda_metric

    b_cases = _b_shapes(img)
    cases = [(label, "B", (refs, frames, pre_ds))
             for label, refs, frames, pre_ds in b_cases]
    for kernel, params in (("C", BALANCED), ("D", PERCEPTUAL)):
        _, refp, ctx, cand8, cand_lin = first_visit(img, params)
        cases.append((f"kernel {kernel}, B=48", kernel,
                      refine.coarse_inputs(ctx, cand8, cand_lin, refp)))
    path = _kernels.BUILD_DIR / "multiscale_cases.pt"
    torch.save(cases, path)

    def parent_run(k):
        dst = _kernels.BUILD_DIR / f"multiscale_parent_{k}.pt"
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--b-times", parent, str(path), str(dst)], check=True)
        return torch.load(dst)

    before = parent_run(0) if parent else None
    runs = [kernel_times(cases), kernel_times(cases)]
    after = parent_run(1) if parent else None
    out = {"phase": "multiscale", "card": _card(), "shapes": {}}
    for label, kernel, args in cases:
        got = runs[0][label]
        rec = {
            "device_ms": [r[label]["device_ms"] for r in runs],
            "kernels_per_call": got["kernels_per_call"],
            "same_bits_twice": torch.equal(got["sums"], runs[1][label]["sums"]),
        }
        if kernel == "B":
            held = cuda_metric.multiscale_launches(*args)
            rec.update(launches_per_call=len(held), active_clusters=held,
                       **b_bound(*args[:2], got["sums"], args[2]))
        if parent:
            rec.update(
                parent_device_ms=[before[label]["device_ms"],
                                  after[label]["device_ms"]],
                parent_kernels_per_call=before[label]["kernels_per_call"],
                bits_equal_parent=torch.equal(got["sums"],
                                              before[label]["sums"]))
        out["shapes"][label] = rec
    out["ptxas"] = _ptxas_report(("multiscale_kernel",))
    out["ok"] = all(r["same_bits_twice"]
                    and r["kernels_per_call"] == r.get("launches_per_call", 1)
                    and r.get("bits_equal_parent", True)
                    for r in out["shapes"].values())
    return out


def phase_dither_perceptual_8(img):
    """The dithered perceptual run at 8 steps, once: seconds, step errors
    and each kernel's launches."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    _, errors, info = pipeline.run_fused(
        img, QuantConfig(**dict(DITHER_PERCEPTUAL, max_steps=8)),
        device="cuda")
    return {"phase": "dither_perceptual_8", "steps": 8,
            "seconds": info["total_seconds"], "step_errors": errors,
            "final_error": info["final_error"],
            "launches": {k: fn.launches for k, fn in wrappers.items()}}


def _pooled_times(img, params: dict, wrapper) -> dict:
    """Kernel E or F (`wrapper`), device ms per call at the first visit of
    each subpalette p (slot (p, 0), channel 0, B = 48) as the visit calls
    it, on the tiles of p; at p = 0 also over every tile (no tile map);
    and the device ms of a sweep's calls estimated from them: each
    subpalette's S * 3 visits at its first visit's time."""
    from snesimage_torch.core import refine

    state, config = prepared_state(img, params)
    d_all = refine.compute_d_all(state, config)
    out = {"card": _card(), "by_p": {}}
    for p in range(config.subpalette_count):
        ctx, cand8 = visit_of(state, config, d_all, p)
        args = refine.pooled_inputs(ctx, cand8)
        out["by_p"][p] = {
            "tiles": int((state.tile_palettes == p).sum()),
            "device_ms": device_ms(lambda: wrapper(*args))}
        if p == 0:
            out["B=48, 256x240, p=0, every tile"] = device_ms(
                lambda: wrapper(*args[:-2]))
    times = [r["device_ms"] for r in out["by_p"].values()]
    out["mean_device_ms"] = sum(times) / len(times)
    out["sweep_device_ms_estimate"] = config.subpalette_size * 3 * sum(times)
    out["ptxas"] = _ptxas_report((f"{wrapper.__name__}_kernel",))
    return out


def phase_kernels(img):
    """Device ms per call of kernels G, B, E and F at the paths' call
    shapes."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_dither, cuda_metric, cuda_prescreen

    out = {"phase": "kernels", "dither_remap_candidates": {},
           "multiscale_feature_sums": {}}
    img240 = np.ascontiguousarray(img[:240])
    for name, wrapper, params in (
            ("pooled_wins_redmean", cuda_prescreen.pooled_wins_redmean,
             GEOMETRY),
            ("pooled_wins_ciede", cuda_prescreen.pooled_wins_ciede,
             GEOMETRY_PERCEPTUAL)):
        out[name] = _pooled_times(img240, params, wrapper)
        _, refp, ctx, cand8, cand_lin = first_visit(img240, params)
        args = refine.pooled_inputs(ctx, cand8)
        if name == "pooled_wins_redmean":
            quarter = cuda_prescreen.coarse_frames(
                wrapper(*args), cand_lin,
                refine.ds4_no_candidate(ctx)).contiguous()
            refs = tuple(tuple(a.permute(2, 0, 1) for a in refp[s])
                         for s in range(2, 6))
            out["multiscale_feature_sums"]["256x240: B=48 of 60x64, n=4"] = (
                device_ms(lambda: cuda_metric.multiscale_feature_sums(
                    refs, quarter)))
    for label, params in (("red-mean", DITHER),
                          ("perceptual", DITHER_PERCEPTUAL)):
        state, config = prepared_state(img, params)
        cand5 = visit_candidates(state)
        common = (state.rgb, state.alpha, state.tile_palettes, state.palette)
        for shape, args in (("B=48", (0, 0, cand5)),
                            ("B=1", (-1, 0, cand5[:1]))):
            out["dither_remap_candidates"][f"{label}, {shape}"] = device_ms(
                lambda: cuda_dither.dither_remap_candidates(
                    *common, *args, config.perceptual_palettes),
                runs=20 if label == "red-mean" else 5)
        if label == "red-mean":
            refp = refine.make_reference_pyramid(state)
            maps = cuda_dither.dither_remap_candidates(*common, 0, 0, cand5)
            frames = cuda_prescreen.render_palette_maps(
                maps, state.tile_palettes, state.alpha, state.palette, cand5,
                0, 0)
            for shape, fr, start, n, pre_ds in (
                    ("B=1, n=6", frames[:1], 0, 6, 0),
                    ("B=8, pre_ds=1, n=1", frames[:8], 1, 1, 1),
                    ("B=2, n=1", frames[:2], 0, 1, 0),
                    ("B=4, n=1", frames[:4], 0, 1, 0),
                    ("B=48, pre_ds=2, n=4", frames, 2, 4, 2)):
                refs = tuple(tuple(a.permute(2, 0, 1) for a in refp[start + s])
                             for s in range(n))
                fr = fr.contiguous()
                out["multiscale_feature_sums"][shape] = device_ms(
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


def _timed(fn):
    """sweep(): runs fn, waits for the card, returns the host-clock
    seconds."""
    def sweep():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    return sweep


def _graphed(method: str, state, config, refp, err, **sweep_kw):
    """A function that replays a CUDA graph of one sweep of `method` from
    (state, err) with the run's first draws (core/graphs.py `SweepRunner`),
    the same work on every call. Its first two calls run here: the key's
    first sweep eagerly, the second captures."""
    from snesimage_torch.core import graphs, pipeline

    def once():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(config.seed)
        graphs.SweepRunner(state.device).sweep(
            method, state, config, refp, err, gen,
            pipeline._draw_sizes(config, 0), left=graphs.CAPTURE_LEFT,
            **sweep_kw)

    once()
    once()
    return once


def _sweeper(img, params: dict):
    """(config, sweep, graphed sweep): sweep() runs the first sweep of the
    run, the same work on every call, and returns its host-clock seconds;
    the graphed sweep replays a graph of it."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import refine

    config = QuantConfig(**params)
    state, refp, err = _prepared(img, config)

    def sweep():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(config.seed)
        refine.sweep_channel(state, config, refp, err, gen)

    return config, _timed(sweep), _timed(_graphed("channel", state, config,
                                                   refp, err))


def _batch_sweepers(img) -> dict:
    """(config, sweep, graphed sweep) of the `batch` phase's five sweeps,
    by label: sweep() runs the first sweep of a batched run (or a single
    one), the same work on every call, and returns its host-clock seconds;
    the graphed sweep replays a graph of it."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import refine
    from snesimage_torch.core.state import shared_states
    from snesimage_torch.models.presets import preset_fields
    from snesimage_torch.ops.ssimulacra2 import shared_pyramid
    from snesimage_torch.parallel import batch as pb
    from snesimage_torch.testing import bench_image

    nes = QuantConfig(**dict(preset_fields("nes-compat"), max_steps=2,
                             converge_tol=0.0, seed=0))
    seeds = np.random.default_rng(1).integers(0, 1 << 31, 16)
    images = np.stack([bench_image(int(s)) for s in seeds])
    states = pb.bcluster(pb.binit(
        pb.make_batched_states(images, nes, "cuda"), nes), nes)
    refp = pb.brefp(states, nes)
    err = refine.frame_error_fused(states, nes, refp)
    one, one_refp, one_err = _prepared(images[0], nes)
    out = {
        "nes-compat, one image": (nes, _timed(lambda: refine.sweep_nes(
            one, nes, one_refp, one_err)), _timed(_graphed(
                "nes", one, nes, one_refp, one_err))),
        "nes-compat, batch of 16": (nes, _timed(lambda: refine.sweep_nes(
            states, nes, refp, err)), _timed(_graphed(
                "nes", states, nes, refp, err, gate=False))),
    }
    config = QuantConfig(**BALANCED)
    state, refp1, err1 = _prepared(img, config)
    for k in (1, 2, 4):
        seeds_k = shared_states(state, k) if k > 1 else state
        refp_k = shared_pyramid(refp1, k) if k > 1 else refp1
        err_k = err1.expand(k).contiguous() if k > 1 else err1

        def sweep(s=seeds_k, r=refp_k, e=err_k):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(config.seed)
            refine.sweep_channel(s, config, r, e, gen)

        out["balanced" if k == 1 else f"balanced, K = {k} seeds"] = (
            config, _timed(sweep), _timed(_graphed(
                "channel", seeds_k, config, refp_k, err_k, gate=False)))
    return out


def phase_profile(label: str, config, sweep, wall: float,
                  graphed: bool = False):
    """One profiled sweep; `wall` is the same sweep's unprofiled time.
    `graphed`: the sweep replays a CUDA graph, whose nodes are the device
    operations counted."""
    from torch.profiler import ProfilerActivity, profile

    visits = (config.subpalette_count * config.subpalette_size
              * (1 if config.nes else 3))
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
        "graphed": graphed,
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


# Steps of the `fast` run before the sweep the `gate` phase profiles: late
# sweeps are where most gates close.
GATE_WARM_STEPS = 2


def _gate_sweepers(img) -> dict:
    """(config, sweep, tally) of one `fast` sweep from the state after
    GATE_WARM_STEPS gated steps, gated and with gate_margin=0, each eagerly
    and replayed as a CUDA graph (labels with ", graphed"): sweep() runs
    the same work on every call and returns its host-clock seconds; tally
    counts its gated visits and closed gates."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine

    gated = QuantConfig(**fast_params())
    state, _, _ = pipeline.run_fused(img, QuantConfig(**fast_params(
        max_steps=GATE_WARM_STEPS)), device="cuda")
    refp = refine.make_reference_pyramid(state)
    err = refine.frame_error_fused(state, gated, refp)
    out = {}
    for label, config in (("fast, gated", gated),
                          ("fast, gate_margin=0", QuantConfig(
                              **fast_params(gate_margin=0.0)))):
        gate_kw = (dict(use_gate=True, gate=True)
                   if refine._gating_active(config) else {})
        with refine.gate_tally():  # the graph of a sweep inside a tally
            graphed = _graphed("channel", state, config, refp, err,
                               **gate_kw)
        for suffix, fn in (("", lambda config=config: refine.sweep_channel(
                state, config, refp, err)), (", graphed", graphed)):
            tally = {"visits": 0, "closed": None}

            def sweep(fn=fn, tally=tally):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with refine.gate_tally() as t:
                    fn()
                torch.cuda.synchronize()
                tally.update(visits=t["visits"], closed=t["closed"])
                return time.perf_counter() - t0

            out[label + suffix] = (config, sweep, tally)
    return out


def phase_gate(label: str, config, sweep, tally, wall: float):
    """The `profile` record of one `fast` sweep, with its closed gates."""
    out = phase_profile(label, config, sweep, wall,
                        graphed=label.endswith(", graphed"))
    closed = 0 if tally["closed"] is None else int(tally["closed"])
    out.update(phase="gate", gated_visits=tally["visits"],
               closed_gates=closed,
               closed_share=closed / max(tally["visits"], 1), card=_card())
    return out


def phase_init(img):
    """`pipeline.run` with one step, twice a path: init and step seconds."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline
    from snesimage_torch.models.presets import preset_fields

    img240 = np.ascontiguousarray(img[:240])
    nes = dict(preset_fields("nes-compat"), converge_tol=0.0, seed=0)
    out = {"phase": "init", "card": _card()}
    for label, image, params in (
            ("balanced", img, BALANCED), ("perceptual", img, PERCEPTUAL),
            ("dither", img, DITHER), ("256x240", img240, GEOMETRY),
            ("nes-compat", img, nes)):
        config = QuantConfig(**dict(params, max_steps=1))
        runs = [pipeline.run(image, config, device="cuda")[2]
                for _ in range(2)]
        out[label] = {k: [r[k] for r in runs] for k in runs[0]}
    return out


def phase_pair(img):
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline

    img240 = np.ascontiguousarray(img[:240])
    out = {"phase": "pair", "order": ["256x256", "256x240", "256x240",
                                      "256x256"]}
    for label, square, cut in (("red-mean", BALANCED, GEOMETRY),
                               ("perceptual", PERCEPTUAL,
                                GEOMETRY_PERCEPTUAL)):
        turns = ((img, square), (img240, cut), (img240, cut), (img, square))
        out[label] = [
            pipeline.run_fused(image, QuantConfig(**params),
                               device="cuda")[2]["total_seconds"]
            for image, params in turns]
    return out


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


def _finalist_errors(errs) -> dict:
    return {j: float(errs[j])
            for j in torch.nonzero(torch.isfinite(errs)).flatten().tolist()}


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
            rec["finalist_errors"] = {"card": _finalist_errors(errs.cpu()),
                                      "cpu": _finalist_errors(errs_c)}
            parted.append(rec)
        card, err, d_all = nxt, nerr, nd
    out.update(visits=config.subpalette_count * s * 3, parted=parted)
    return out


def phase_walk_run(img, params: dict, steps: int):
    """The explore-off run of `params` visit by visit, sweep after sweep:
    each visit on the card and, from a CPU copy of the card's state, with
    the twins, up to the end of the first sweep in which a pick differs (at
    most `steps` sweeps). Lists the visits whose finalists, pick or cache
    differ, with the finalists' errors on both sides, and the card's error
    after each sweep, which must be the run's step errors ("ok")."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine

    config = QuantConfig(**dict(params, channel_explore=0))
    _, run_errors, _ = pipeline.run_fused(
        img, QuantConfig(**dict(params, channel_explore=0,
                                max_steps=steps)), device="cuda")
    card, refp, err = _prepared(img, config)
    cpu, refp_cpu, _ = _prepared(img, config, "cpu")
    d_all = refine.compute_d_all(card, config)
    t_lab = refine.target_lab(card, config)
    t_lab_cpu = refine.target_lab(cpu, config)
    s = config.subpalette_size
    per_sweep = config.subpalette_count * s * 3
    parted, sweep_errors = [], []
    for step in range(steps):
        for k in range(per_sweep):
            where = (k // (s * 3), (k // 3) % s, k % 3)
            (errs, _), (nxt, nerr, nd) = _visit(
                card, config, refp, err, d_all, t_lab, *where)
            (errs_c, _), (nxt_c, _, nd_c) = _visit(
                cpu.replace(tile_palettes=card.tile_palettes.cpu(),
                            palette=card.palette.cpu(),
                            palette_map=card.palette_map.cpu()),
                config, refp_cpu, err.cpu(), d_all.cpu(), t_lab_cpu, *where)
            rec = {
                "step": step, "visit": k, "slot": where,
                "same_finalists": torch.equal(torch.isfinite(errs).cpu(),
                                              torch.isfinite(errs_c)),
                "same_palette": torch.equal(nxt.palette.cpu(), nxt_c.palette),
                "same_cache": torch.equal(nd.cpu(), nd_c),
            }
            if not all(rec[key] for key in ("same_finalists", "same_palette",
                                            "same_cache")):
                rec.update(card_kept=nxt.palette[where[:2]].tolist(),
                           cpu_kept=nxt_c.palette[where[:2]].tolist(),
                           carried_error=float(err),
                           finalist_errors={
                               "card": _finalist_errors(errs.cpu()),
                               "cpu": _finalist_errors(errs_c)})
                parted.append(rec)
            card, err, d_all = nxt, nerr, nd
        sweep_errors.append(float(err))
        if any(not r["same_palette"] for r in parted):
            break
    run_errors = run_errors[:len(sweep_errors)]
    return {"phase": "walk_run", "explore": 0, "sweeps": len(sweep_errors),
            "ok": sweep_errors == run_errors, "sweep_errors": sweep_errors,
            "run_step_errors": run_errors, "parted": parted}


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
            rec["finalist_errors"] = {"card": _finalist_errors(errs),
                                      "cpu": _finalist_errors(errs_c)}
            parted.append(rec)
        card, err = nxt, nerr
    out.update(accepted=accepted, parted=parted)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device is available", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args[:1] == ["--b-times"]:  # a parent tree's kernel B (multiscale)
        parent, cases, dst = args[1:]
        sys.path.insert(0, os.path.abspath(parent))
        torch.save(kernel_times(torch.load(cases)), dst)
        return 0
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = os.path.abspath(args[i + 1])
        del args[i:i + 2]
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline
    from snesimage_torch.testing import bench_image

    phases = set(args) or {"kernels", "multiscale", "pair", "seeds",
                           "parity", "walk", "walk_run", "profile", "batch",
                           "gate", "init"}
    img = bench_image(0)
    img240 = np.ascontiguousarray(img[:240])
    profiles = {"balanced": BALANCED, "perceptual": PERCEPTUAL,
                "dither": DITHER, "dither perceptual": DITHER_PERCEPTUAL}
    geometry = {"256x240": GEOMETRY, "256x240 perceptual": GEOMETRY_PERCEPTUAL}
    for image, group in ((img, profiles), (img240, geometry)):
        for params in group.values():  # build and warm up
            pipeline.run_fused(image, QuantConfig(**dict(params, max_steps=1)),
                               device="cuda")
    sweeps, walls = {}, {}
    if "profile" in phases:
        sweeps = {label: _sweeper(img, p) for label, p in profiles.items()}
        sweeps.update((label, _sweeper(img240, p))
                      for label, p in geometry.items())
    batch = _batch_sweepers(img) if "batch" in phases else {}
    for group in (sweeps, batch):  # each sweep also replayed from a graph
        for label in list(group):
            config, eager, graphed = group[label]
            group[label] = (config, eager)
            group[label + ", graphed"] = (config, graphed)
    for _, sweep in batch.values():  # a first run at the batch's shapes
        sweep()
    # Every unprofiled time is taken before any profiler has run.
    walls = {label: sweep() for group in (sweeps, batch)
             for label, (_, sweep) in group.items()}
    gate = _gate_sweepers(img) if "gate" in phases else {}
    for _, sweep, _ in gate.values():  # a first run at the gate's shapes
        sweep()
    walls.update((label, sweep()) for label, (_, sweep, _) in gate.items())
    # The explore-off parity runs again on the CPU with the twins; the
    # dithered twin takes too long there for whole sweeps at full size, so
    # the dithered path is walked over its first visits only.
    todo = [
        ("kernels", lambda: phase_kernels(img)),
        ("kernels", lambda: phase_coarse(img)),
        ("multiscale", lambda: phase_multiscale(img, parent)),
        ("kernels", lambda: phase_g_variants(img)),
        ("init", lambda: phase_init(img)),
        ("pair", lambda: phase_pair(img)),
        ("seeds", lambda: phase_seeds(img, SEEDS)),
        *(("parity", lambda label=label, p=p: phase_parity(
            img, label, p, PARITY_STEPS))
          for label, p in profiles.items() if "dither" not in label),
        ("walk", lambda: phase_walk(img, PERCEPTUAL)),
        ("walk", lambda: phase_walk_dither(img, DITHER, WALK_DITHER_VISITS)),
        ("walk_run", lambda: phase_walk_run(img, BALANCED, WALK_RUN_STEPS)),
        *(("profile", lambda label=label: phase_profile(
            label, *sweeps[label], walls[label],
            graphed=label.endswith(", graphed"))) for label in sweeps),
        ("profile", lambda: phase_dither_perceptual_8(img)),
        *(("batch", lambda label=label: phase_profile(
            label, *batch[label], walls[label],
            graphed=label.endswith(", graphed"))) for label in batch),
        *(("gate", lambda label=label: phase_gate(
            label, *gate[label], walls[label])) for label in gate),
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
