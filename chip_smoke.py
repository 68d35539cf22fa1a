"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from snesimage_torch/csrc, holds each
against its plain PyTorch twin on the card at the main paths' shapes, pins
the init hashes to the JAX package's CPU values, and drives nine paths once
each through `run_fused` and `state_to_json`. At 256x256, 8x15 palettes:
the balanced profile (8 channel sweeps with 16 explore candidates), the
same recipe with perceptual (CIEDE2000) palettes, the same recipe with
Floyd-Steinberg dithering, two sweeps of the dithered perceptual recipe,
and one cycle of the reference schedule (four random sweeps and a channel
sweep, every candidate scored at six scales). On the image's first 240
rows (256x240, sides that are not multiples of 32, so the visit ranks its
candidates through kernels E or F and kernel B): the balanced recipe,
red-mean and perceptual, and one dithered sweep. And two NES sweeps of the
`nes-compat` preset. Kernel B is also held against its twin at the batches
of the visits that score every candidate at six scales (64 random draws, 32
channel values, the 56 NES colours), and G, A and B at the 256x240 dithered
visit's shapes. Each phase prints one line. Then come, each on its own
line, the kernels' JSON record and the card's name and power limit; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before it.

Each kernel's record holds its wrapper's wall time and its twin's at the
main paths' shapes (`median_ms`), its launches in the run of the path that
uses it (A, B and C: the balanced run; D: the perceptual run; G: the
dithered run; E and F: the 256x240 runs; `launches_by_path` has all nine),
and its bound: the larger of the bytes it must move over the card's memory
rate and the arithmetic it does over the card's peak rate for that
arithmetic (`bound`, from this run's tensors). Kernel A's cases also hold
its device time and its wrapper's host time (`_a_times`): its key/table
entry beside one gather, its fused entries beside the card time of the
torch sequences they replace: the undithered visit's prologue at each
undithered path's first visit (256x256 and 256x240, red-mean and
perceptual, and the 4x3 palette of `nes-compat`; the reference cycle's is
the balanced one's shape), the dithered visit's render at 256x256 and
256x240. A's `library_ms` is the gather's time over the key/table cases,
and `library_cases_ms` A's own wall time over those same cases. C's and
D's records also hold their device time at the first visit (`device_ms`)
and how many of their four-block clusters the card holds at once
(`active_clusters`); D's also the device times of kernels F and B on the
same visit (`unfused`), the route that computes D's function unfused.
Kernel B's cases hold its device time per call (`device_ms`, CUDA events
behind a spin kernel) at every shape, and B must give the same bits twice.
E's and F's cases are the first visit of each subpalette p = 0..7 at
256x240, which the kernels compute on the tiles of p only, as the visit
calls them, each with its tile count, device time and two bounds (the
tiles of p, `bound_ms`, and the whole image), their means over p
(`mean_over_p`), and the first visit over every tile and for two images.

Kernel F also serves every perceptual visit that has no prescreen, at any
geometry: it alone writes the candidates' distance planes there, and its
pooled sums go unused. No path driven here is such a visit, so F's
launches are 0 or one per visit of a 256x240 perceptual run.

Then three more paths, each driven with the counts set to 0 just before it
and read just after: BASELINE config 5 (phase 28: 64 images of the
`nes-compat` preset, two steps, in four `batched_run` batches of 16, the
first four images held to their own `run_fused` bit for bit, then
`batch_cli` on 16 of them as PNGs, whose JSON must equal the batch's byte
for byte); `cli.main --opt-profile robust` (phase 29: a K = 2 seed
portfolio; portfolios of K = 1, 2 and 4 are timed beside `run_fused`, and
K = 1 must give `run_fused`'s step errors to the bit); and a dithered
K = 2 portfolio (phase 30: kernel G's two seed rows over the shared image
against two one-seed launches). Phase 31 runs every kernel at N = 4 images
against its N = 1 launches, bit for bit, and its twin, and adds device ms
at N = 1 and N = 4 to each record (`image_axis`).

Then the host-stepped driver, resume, reassignment and the rank-1 gate.
Phase 32 holds kernel B at the gated visit's shapes: the gate's carry
(B = 1, scales 0-1) against its twin, and the scale-0 finalists (B = 2)
with a closed and an open gate flag at N = 1 and N = 2 images (open: the
unflagged call's bits; closed: zero sums), B's `gate_cases`. Each path
after it is driven with the counts set to 0 just before it and read just
after: `cli --opt-profile fast -c 8 -s 15` at 256x256 and the same recipe
through `run_fused` at 256x240 (phase 33: steps, step errors, the stop,
which a gated run takes only on an exact sweep, the share of closed gates,
seconds beside the balanced run's); the balanced recipe through the CLI's
host-stepped loop, 4 steps with `--dump-every 2 --checkpoint` and then
`--resume` for 4 more, whose 8 step errors and JSON must equal phase 4's
run to the bit (phase 34); `--reassign-tiles`, `--reassign-every 2
--dump-every 2` and `-v` on 2 balanced steps (phase 35, one log line a
visit); `run_fused_hybrid` (phase 36); and `--profile-dir` (phase 37: the
trace names kernels A, B and C).

Then the four options of the optimizer the paths above leave off. Phase
38 holds kernels C and D in their three-level mode (`pre_ds=1,
emit_frames`) against their twins at the first balanced and perceptual
visits (B = 48): scales 3-5 within FEATURE_TOL, the quarter frames within
FRAME_TOL, D's distance planes bit-equal, N = 2 images bit-equal to N = 1
launches, device ms beside the two-level mode's; and kernel B at the
three-level visit's shapes (scale 2 of the 16 survivors' quarter frames;
scales 3-5 of 256x240's quarter frames after one 2x2 mean). Each path after
it is driven with the counts set to 0 just before it and read just after,
and its step errors must never rise and end below its init's: the
three-level prescreen (`prescreen_pre` 16) on the balanced recipe for 4
steps, the perceptual one for 2 and the balanced one at 256x240 for 2
(phase 39, C's, D's and E's paths, with the three-level launches counted
apart, `.frame_launches`); `cli --opt-profile fast --gate-coarse` to its
stop, with the shares of closed coarse and rank-1 gates (phase 40); the
dither proxy (`dither_proxy` 8) on the dithered recipe for 2 steps and the
dithered perceptual one for 1, with kernel G's device ms a sweep at 8 rows
and at 48 (phase 41); and the balanced recipe with `channel_window` 4 for 8
steps through `pipeline.optimize`, which steps were windowed and the
seconds of each sweep (phase 42). C's and D's three-level records join the
`kernels` line (`<name>_three_level`, their launches from phase 39).

Last the port's own bench and BASELINE runner (phase 43,
`snesimage_torch.bench` and `snesimage_torch.benchmarks`), each path
driven with the counts set to 0 just before it and read just after:
`bench.measure` of the balanced recipe (its step errors must equal phase
4's to the bit) and of `fast` (phase 33's step count, its final within
1e-4), the balanced init hash and the bench's JSON line; balanced at seeds
1 and 2 and without explore beside the frozen JAX CPU runs
(tests/data/bench_finals_jax.json; the explore-free run's first two steps
within 1e-3 of the JAX package's); and `benchmarks.main` at one step, a
batch of 16 for config 5 (a line of the card, then c1-c5, each with a
finite final error).

Every run above goes through `pipeline.optimize`, which on the card
replays a CUDA graph of each sweep where a run captured one
(snesimage_torch/core/graphs.py: not at a key's first sweep, and only with
`CAPTURE_LEFT` steps of the run left or after `CAPTURE_RUNS` earlier runs
of the key), so the launch counts it checks are
partly replayed ones: a replay adds its graph's kernel nodes, counted by
kernel name through libcuda when the graph was captured, and the
capture raises unless they equal the launches its wrappers made. Phase 44
then drives every path both ways through `pipeline.optimize`: eagerly
(`eager=True`) and graphed, twice, with the graphs dropped before each
path and captured at a key's second sweep (`CAPTURE_LEFT` 1 for the
phase; the rule itself is held in tests/test_torch_graphs.py), so that
the first graphed run captures and in the second every sweep must replay,
at least three sweeps each: the balanced, perceptual,
dithered and dithered perceptual recipes, the three 256x240 paths, the
reference cycle, `nes-compat`, a config 5 batch of 16, `robust` (K = 2),
`fast` inside `gate_tally`, host-stepped + resume with an `on_step` hook,
a replacement state and `reassign_every`, a windowed and a three-level
run. Every graphed run's step errors, final state, launches and readings
must equal the eager run's bit for bit; between two replays of the
balanced graph kernel B's tile scratch grows by a larger call, and the
replay must still equal eager (ROADMAP C-12). It prints each path's
seconds a sweep eager and graphed and each graph's capture, node count and
instantiation seconds, nodes and kernel nodes.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

# The balanced recipe (bench.py's headline config) and the init hashes
# every phase below pins, with the function that computes them.
from snesimage_torch.bench import BALANCED
from snesimage_torch.testing import (
    INIT_HASH,
    INIT_HASH_240,
    INIT_HASH_240_DITHER,
    INIT_HASH_240_PERCEPTUAL,
    INIT_HASH_DITHER,
    INIT_HASH_DITHER_PERCEPTUAL,
    INIT_HASH_NES,
    INIT_HASH_PERCEPTUAL,
    card_line,
    init_hash,
)

FEATURE_TOL = 2e-4  # kernel vs twin, finalised features (rtol and atol)
# Kernel D's distance planes vs its twin (atol and rtol). The kernel takes
# the twin's steps, but its fmaf rounds once where the twin's float64
# product-and-sum may round twice, and its libm is CUDA's.
DISTANCE_TOL = 1e-4
ERROR_TOL = 1e-3  # kernel vs twin, full-frame error
# The balanced recipe with CIEDE2000 palettes; QuantConfig raises
# prescreen_full to 4 for perceptual runs, so it is given here.
PERCEPTUAL = dict(BALANCED, prescreen_full=4, perceptual_palettes=True)
# BASELINE config 3 at the balanced recipe, and config 4 with dithering at
# two sweeps (kernel G's CIEDE2000 mode takes several times its red-mean
# mode's time).
DITHER = dict(BALANCED, dither=True)
DITHER_PERCEPTUAL = dict(PERCEPTUAL, dither=True, max_steps=2)
# The same recipes on the first 240 rows of the image: 256x240 is 30 rows of
# tiles, its pyramid meets an odd side at 15x16, and the visit ranks its
# candidates through kernel E (red-mean) or F (perceptual) and kernel B.
GEOMETRY = dict(BALANCED, width=256, height=240)
GEOMETRY_PERCEPTUAL = dict(PERCEPTUAL, width=256, height=240)
GEOMETRY_DITHER = dict(DITHER, width=256, height=240, max_steps=1)
# BASELINE config 2 as the reference runs it: four random sweeps and one
# channel sweep, no prescreen, the stop rule off.
REFERENCE = dict(subpalette_count=8, subpalette_size=15, max_steps=5,
                 converge_tol=0.0, seed=0)
NES_STEPS = 2  # of the `nes-compat` preset (BASELINE config 5's palettes)
POOLED_SUM_TOL = 1e-5  # kernels E and F vs twins, the three m*ML sums
# Clock cycles of the spin kernel that holds the card while a timed run of
# launches is enqueued (`device_ms`): about 0.1 s, longer than any run
# here takes the host to launch.
HOLD_CYCLES = 200_000_000
WRAPPERS = ("select_colors", "multiscale_feature_sums",
            "coarse_feature_sums_redmean", "coarse_feature_sums_ciede",
            "pooled_wins_redmean", "pooled_wins_ciede",
            "dither_remap_candidates")

# The bound of a kernel call. Rates: NVIDIA's H100 SXM data sheet at the
# full 700 W (HBM3, float32 outside the tensor cores).
MEMORY_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Arithmetic per pixel, counted from the device code. One pyramid scale of
# the metric (csrc/metric_common.cuh): 2x2 mean 12, positive XYB 32, the
# horizontal blur of three fields 255 and the vertical 306, moments 75.
METRIC_OPS_PER_PX = 680
# A red-mean distance, the win test and the pooled sums (kernel C).
REDMEAN_OPS_PER_PX = 17
# CIEDE2000 (csrc/ciede2000.cuh): 141 float32 operations with the win
# test and pooled sums, plus nine transcendentals (two atan2, two sin,
# four cos, one exp), each counted as one float32 operation, the fewest
# any implementation takes. The function needs float32 only; the device
# code takes the transcendentals in double to round as its twin does,
# which is the port's choice and not part of the work bounded here.
CIEDE_OPS_PER_PX = 141 + 9
# The same CIEDE2000 as kernels D and F run it, for a second bound of F:
# each transcendental in double precision, an estimate of 25 double
# multiply-adds (range reduction and polynomial; not measured), 50 FLOPs,
# against the H100 SXM's 34 TFLOP/s of FP64 outside the tensor cores.
CIEDE_F64_FLOPS_PER_CALL = 50
F64_FLOPS_PER_S = 34e12
# Kernel G (csrc/dither.cu), per pixel and candidate: the window update,
# masks and hand-down 40; per live pixel the target and its quantisation 15
# and, for each of the S entries, a red-mean distance and compare 14 (int32
# arithmetic, counted at the float32 rate) or a CIEDE2000 and compare; in
# perceptual mode the target's Lab 35 (three cube roots counted as one
# operation each).
DITHER_OPS_PER_PX = 40
DITHER_OPS_PER_LIVE_PX = 15
DITHER_REDMEAN_OPS_PER_ENTRY = 14
DITHER_LAB_OPS_PER_LIVE_PX = 35


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def median_ms(fn, runs: int = 20) -> float:
    """Median wall time of fn() in ms, each run fenced by synchronize()."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, runs: int = 50) -> float:
    """Device time of fn() per call: CUDA events around `runs` calls,
    enqueued while a spin kernel holds the card (HOLD_CYCLES), so that they
    run back to back and the events read the card's time, not the rate at
    which the host launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def host_wall_ms(fn, calls: int = 1000) -> float:
    """Host-clock time per call of `calls` back-to-back calls, unfenced:
    the clock stops when the last call returns, before the device ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return wall


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float = 0.0):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over their peak rate."""
    t_bytes = n_bytes / MEMORY_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def metric_ops(b: int, sizes) -> float:
    """Operations of the metric on b frames over scales of `sizes` pixels."""
    return b * METRIC_OPS_PER_PX * sum(sizes)


def max_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Largest |got - want|; fails where it exceeds tol + tol * |want|."""
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    check(bool((diff <= tol + tol * want.abs()).all()),
          f"kernel and twin differ by {float(diff.max()):.3g}")
    return float(diff.max())


def phase_device():
    smi = card_line()
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are enabled")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    from snesimage_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.library()
    build_s = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: nvidia-smi '{smi}', torch '{name}', "
          f"kernel build {build_s:.3f} s", flush=True)
    return smi, name


def prepared_state(img, params: dict):
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline
    from snesimage_torch.core.state import new_state

    config = QuantConfig(**params)
    state = new_state(img, config, "cuda")
    return pipeline.cluster(pipeline.initialize(state, config), config), config


def first_visit(img, params: dict):
    """What the main path's first visit, slot (0, 0) channel 0, gives the
    kernels: the state's pyramid and slot context, and its 32 channel
    values plus 16 explore draws (B = 48) in 8-bit and linear RGB."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops.color import srgb_u8_to_linear

    state, config = prepared_state(img, params)
    refp = refine.make_reference_pyramid(state)
    ctx, cand8 = visit_of(state, config, refine.compute_d_all(state, config),
                          0)
    return state, refp, ctx, cand8, srgb_u8_to_linear(cand8)


def visit_of(state, config, d_all, p: int):
    """The slot context and 8-bit candidates of the first visit of
    subpalette p, slot (p, 0) channel 0 (`visit_candidates`)."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops.color import expand_5bit_to_8bit

    ctx = refine.slot_context(state, config, p, 0, d_all)
    return ctx, expand_5bit_to_8bit(visit_candidates(state, p))


def visit_candidates(state, p: int = 0):
    """The 5-bit candidates of the first visit of subpalette p: the 32
    values of channel 0 of slot (p, 0) and 16 explore draws (B = 48)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cand5 = state.palette[p, 0][None].repeat(32, 1)
    cand5[:, 0] = torch.arange(32, dtype=torch.int32, device="cuda")
    return torch.cat([cand5, torch.randint(
        0, 32, (16, 3), generator=gen, device="cuda", dtype=torch.int32)])


def unfused_coarse_ms(ctx, cand8, cand_lin, refp) -> dict:
    """Kernel D's function by the unfused route on the same visit: the
    device ms of kernel F's pooled sums and distance planes on the tiles of
    the visited subpalette, as the visit calls it, and of kernel B on the
    48 quarter-resolution frames assembled from them (scales 2-5); and F's
    planes over the whole image (F without the tile map), which equal
    D's."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_metric, cuda_prescreen

    args = refine.pooled_inputs(ctx, cand8)
    planes = cuda_prescreen.pooled_wins_ciede(*args[:-2])[1]
    pooled, _ = cuda_prescreen.pooled_wins_ciede(*args)
    frames = cuda_prescreen.coarse_frames(
        pooled, cand_lin, refine.ds4_no_candidate(ctx)).contiguous()
    refs = tuple(tuple(a.permute(2, 0, 1) for a in refp[s])
                 for s in range(2, 6))
    return dict(
        f_ms=device_ms(lambda: cuda_prescreen.pooled_wins_ciede(*args)),
        b_ms=device_ms(
            lambda: cuda_metric.multiscale_feature_sums(refs, frames)),
        planes=planes)


def _coarse_bound(args, out_bytes: int, px_ops: float):
    """Bound of a coarse kernel call (C or D) on `args`, with `px_ops`
    operations per full-resolution pixel and candidate."""
    *planes, flat_refs = args
    b, (h, w) = planes[1].shape[0], planes[3].shape
    sizes = [(h >> s) * (w >> s) for s in range(2, 6)]
    return bound(
        nbytes(*planes, *flat_refs) + out_bytes,
        b * h * w * px_ops + b * sizes[0] * 9 + metric_ops(b, sizes),
    )


def _print_records(phase: str, records) -> None:
    print(f"{phase} kernels vs twins: " + "; ".join(
        f"{r['name']} max_abs_err {r['max_abs_err']:.3g} "
        f"kernel {r['ms']:.4f} ms"
        + (f" ({r['device_ms']:.4f} ms device)" if "device_ms" in r else "")
        + f" twin {r['plain_ms']:.4f} ms "
        f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
        for r in records), flush=True)


def _print_a_cases(phase: str, cases) -> None:
    print(f"{phase} kernel A vs twin (bit-equal): " + "; ".join(
        f"{c['shape']} ({c['mode']}): kernel {c['ms']:.4f} ms wall, "
        f"{c['device_ms']:.5f} ms device, {c['host_ms']:.4f} ms host; twin "
        f"{c['plain_ms']:.4f} ms" + (
            f" ({c['plain_device_ms']:.4f} ms device)"
            if "plain_device_ms" in c else "")
        + (f"; library {c['library_ms']:.4f} ms"
           if c.get("library_ms") is not None else "")
        + f"; bound {c['bound_ms']:.5f} ms ({c['bound_by']})"
        for c in cases), flush=True)


def _b_case(label: str, refp, frames, start: int, n: int, pre_ds: int):
    """Kernel B against its twin on `frames` for scales start..start+n-1
    after `pre_ds` 2x2 means."""
    from snesimage_torch.ops import cuda_metric
    from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums

    refs = tuple(tuple(a.permute(2, 0, 1) for a in refp[start + s])
                 for s in range(n))
    sizes = [t[0].shape[-2] * t[0].shape[-1] for t in refs]
    b = len(frames)

    def kernel():
        return cuda_metric.multiscale_feature_sums(refs, frames,
                                                   pre_ds=pre_ds)

    def plain():
        return cuda_metric._multiscale_feature_sums_plain(refs, frames,
                                                          pre_ds)

    raw = kernel()
    got = finalize_feature_sums(raw.reshape(b, -1, 6), sizes, start)
    want = finalize_feature_sums(plain().reshape(b, -1, 6), sizes, start)
    check(torch.equal(raw, kernel()), "kernel B gave other bits a second time")
    return dict(
        shape=label, max_abs_err=max_err(got, want, FEATURE_TOL),
        ms=median_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=median_ms(plain), **b_bound(refs, frames, raw, pre_ds),
    )


def b_bound(refs, frames, raw, pre_ds: int) -> dict:
    """Bound of one call of kernel B: the frames, reference planes and sums
    moved once; the metric's operations on every scale and the `pre_ds`
    2x2 means (three operations a frame pixel and mean)."""
    sizes = [t[0].shape[-2] * t[0].shape[-1] for t in refs]
    return bound(nbytes(frames, *(a for t in refs for a in t), raw),
                 metric_ops(len(frames), sizes)
                 + pre_ds * len(frames) * frames[0].numel())


def _sum_cases(record: dict, cases) -> dict:
    """`record` with the times and bounds of a kernel's call shapes summed.
    `library_ms` sums the library calls of the cases that have one; where
    other cases have none, `library_cases_ms` is the kernel's wall time over
    the same cases, the number to hold against it."""
    lib = [c for c in cases if c.get("library_ms") is not None]
    record.update(
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=sum(c["ms"] for c in cases),
        plain_ms=sum(c["plain_ms"] for c in cases),
        library_ms=sum(c["library_ms"] for c in lib) if lib else None,
        bound_ms=sum(c["bound_ms"] for c in cases),
        bound_by=max(cases, key=lambda c: c["bound_ms"])["bound_by"],
        cases=list(cases),
    )
    if lib and len(lib) < len(cases):
        record["library_cases_ms"] = sum(c["ms"] for c in lib)
    return record


def _a_times(fn) -> dict:
    """Kernel A's times for one call shape: the median fenced wall time
    (`ms`), the device time (`device_ms`), and the wrapper's host time
    (`host_ms`): unfenced back-to-back calls per call less the device
    time."""
    dev, unfenced = device_ms(fn, runs=100), host_wall_ms(fn)
    return dict(ms=median_ms(fn), device_ms=dev, unfenced_ms=unfenced,
                host_ms=unfenced - dev)


def _a_case(label: str, key, table):
    """Kernel A's key/table entry against its twin, exact, on one key plane
    and table or on a stack of them. Its library call is one gather from
    the table with the transparent sentinel's zero column appended."""
    from snesimage_torch.ops import cuda_prescreen

    got = cuda_prescreen.select_colors(key, table)
    want = cuda_prescreen._select_colors_plain(key, table)
    check(torch.equal(got, want), f"select_colors is not bit-exact ({label})")
    padded = torch.cat([table, torch.zeros_like(table[..., :1])], dim=-1)
    if key.dim() == 2:
        index = key.long()

        def library():
            return padded[:, index]
    else:
        n, h, w = key.shape
        index = key.long().reshape(n, 1, h * w).expand(n, 3, h * w)

        def library():
            return torch.gather(padded, 2, index).reshape(n, 3, h, w)

    check(torch.equal(library(), want), f"the gather differs from A ({label})")
    return dict(
        shape=label, mode="key/table",
        max_abs_err=float((got - want).abs().max()),
        **_a_times(lambda: cuda_prescreen.select_colors(key, table)),
        plain_ms=median_ms(
            lambda: cuda_prescreen._select_colors_plain(key, table)),
        library_ms=median_ms(library),
        library_device_ms=device_ms(library, runs=100),
        **bound(nbytes(key, table, want)),
    )


def _planes(out) -> list:
    """The tensors of a kernel A result: a tensor, or a VisitPrologue."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for v in out for t in (v if isinstance(v, tuple) else (v,))]


def _a_fused_case(label: str, mode: str, wrapper, twin, args):
    """One of kernel A's fused entries against its twin (the torch code it
    replaces) on the same card tensors: every output bit-equal. There is
    no single library call; `plain_device_ms` is the card time of the
    twin's torch sequence."""
    got, want = _planes(wrapper(*args)), _planes(twin(*args))
    check(len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
        for g, w in zip(got, want)), f"kernel A's {mode} is not bit-exact "
        f"({label})")
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    operands = [a for a in args if isinstance(a, torch.Tensor)]
    return dict(
        shape=label, mode=mode, max_abs_err=err,
        **_a_times(lambda: wrapper(*args)),
        plain_ms=median_ms(lambda: twin(*args)),
        plain_device_ms=device_ms(lambda: twin(*args), runs=20),
        library_ms=None,
        **bound(nbytes(*operands, *got)),
    )


def _prologue_case(label: str, state, config):
    """Kernel A's visit prologue at the first visit of the path of
    `config`, slot (0, 0)."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_prescreen as cp

    args = (refine.compute_d_all(state, config), state.tile_palettes,
            state.alpha, state.palette, 0, 0)
    return _a_fused_case(label, "prologue", cp.visit_prologue,
                         cp._visit_prologue_plain, args)


def _render_cases(label: str, state, cand5, maps):
    """Kernel A on the dithered visit's maps: the render entry, and the
    key/table entry on the keys and tables the render replaces."""
    from snesimage_torch.ops import cuda_prescreen as cp

    args = (maps, state.tile_palettes, state.alpha, state.palette, cand5, 0,
            0)
    return [
        _a_fused_case(f"{label}, render", "render", cp.render_palette_maps,
                      cp._render_plain, args),
        _a_case(f"{label}, one table per candidate",
                *cp.render_operands(*args)),
    ]


def _a_record(cases) -> dict:
    return _sum_cases(dict(
        name="select_colors", source="snesimage_torch/csrc/select_colors.cu",
        replaces="snesimage_tpu/ops/pallas_prescreen.py:384"), cases)


def _b_record(cases) -> dict:
    record = _sum_cases(dict(
        name="multiscale_feature_sums",
        source="snesimage_torch/csrc/multiscale.cu",
        replaces="snesimage_tpu/ops/pallas_metric.py:194"), cases)
    record["device_ms"] = sum(c["device_ms"] for c in cases)
    return record


def _print_b_cases(phase: str, what: str, cases) -> None:
    print(f"{phase} kernel B {what}: " + "; ".join(
        f"{c['shape']} max_abs_err {c['max_abs_err']:.3g} kernel "
        f"{c['ms']:.4f} ms wall, {c['device_ms']:.5f} ms device, twin "
        f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.5f} ms "
        f"({c['bound_by']})" for c in cases), flush=True)


def phase_kernels(img):
    """Kernels A, C and B against their twins on the bench image's own
    balanced state, at the shapes one main-path visit gives them."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_metric
    from snesimage_torch.ops.remap import render_linear
    from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums

    from snesimage_torch.config import QuantConfig
    from snesimage_torch.ops.cuda_prescreen import no_candidate_key

    state, refp, ctx, cand8, cand_lin = first_visit(img, BALANCED)
    config = QuantConfig(**BALANCED)
    records = []

    # A: the undithered visit's prologue, and the key/table entry on the
    # no-candidate key and table the prologue replaces.
    *_, key_nc, table = no_candidate_key(
        refine.compute_d_all(state, config), state.tile_palettes,
        state.alpha, state.palette, 0, 0)
    records.append(_a_record([
        _prologue_case("256x256, red-mean", state, config),
        _a_case("256x256, one table", key_nc, table)]))

    # C: 32 channel values plus 16 explore draws, B = 48.
    args = refine.coarse_inputs(ctx, cand8, cand_lin, refp)
    sizes = [(256 >> s) ** 2 for s in range(2, 6)]
    raw = cuda_metric.coarse_feature_sums_redmean(*args)
    got = finalize_feature_sums(raw, sizes, 2)
    want = finalize_feature_sums(cuda_metric._coarse_plain(*args), sizes, 2)
    again = cuda_metric.coarse_feature_sums_redmean(*args)
    check(torch.equal(raw, again), "kernel C gave other bits a second time")
    records.append(dict(
        name="coarse_feature_sums_redmean",
        source="snesimage_torch/csrc/coarse_redmean.cu",
        replaces="snesimage_tpu/ops/pallas_metric.py:522",
        max_abs_err=max_err(got, want, FEATURE_TOL),
        ms=median_ms(lambda: cuda_metric.coarse_feature_sums_redmean(*args)),
        device_ms=device_ms(
            lambda: cuda_metric.coarse_feature_sums_redmean(*args)),
        blocks_per_candidate=cuda_metric.CLUSTER_BLOCKS,
        active_clusters=cuda_metric.active_clusters(False, 256, 256),
        plain_ms=median_ms(lambda: cuda_metric._coarse_plain(*args)),
        library_ms=None,
        shape="B=48, 256x256 -> scales 2-5",
        **_coarse_bound(args, nbytes(raw), REDMEAN_OPS_PER_PX),
    ))

    # B: the frame error (B=1, six scales), the scale-1 rank (B=8,
    # pre_ds=1) and the scale-0 finalists (B=2).
    frame = render_linear(state.palette_map, state.alpha,
                          state.tile_palettes, state.palette)
    frame = frame.permute(2, 0, 1)[None].contiguous()
    finals = refine.candidate_frames(ctx, ctx.cand_dist(cand8[:8]),
                                     cand_lin[:8])
    records.append(_b_record([
        _b_case("B=1, n=6", refp, frame, 0, 6, 0),
        _b_case("B=8, pre_ds=1, n=1", refp, finals, 1, 1, 1),
        _b_case("B=2, n=1", refp, finals[:2].contiguous(), 0, 1, 0),
    ]))
    for r in records:
        r["route"] = "cuda"
    _print_records("phase 2", records)
    _print_a_cases("phase 2", records[0]["cases"])
    _print_b_cases("phase 2", "at the main path's shapes", records[2]["cases"])
    return records


def phase_kernel_d(img, a_record):
    """Kernel D against its twin on the bench image's perceptual state, at
    the shapes of the perceptual path's first visit (B = 48); and kernel A's
    prologue there."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_metric
    from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums

    state, refp, ctx, cand8, cand_lin = first_visit(img, PERCEPTUAL)
    a_case = _prologue_case("256x256, perceptual", state,
                            QuantConfig(**PERCEPTUAL))
    a_record.update(_a_record(a_record["cases"] + [a_case]))
    args = refine.coarse_inputs(ctx, cand8, cand_lin, refp)
    sizes = [(256 >> s) ** 2 for s in range(2, 6)]
    sums, dcand = cuda_metric.coarse_feature_sums_ciede(*args)
    want_sums, want_d = cuda_metric._coarse_ciede_plain(*args)
    feat_err = max_err(finalize_feature_sums(sums, sizes, 2),
                       finalize_feature_sums(want_sums, sizes, 2),
                       FEATURE_TOL)
    d_err = max_err(dcand, want_d, DISTANCE_TOL)
    check(torch.equal(dcand, want_d),
          f"kernel D's distance planes differ from the twin's "
          f"({float((dcand == want_d).float().mean())} equal)")
    again = cuda_metric.coarse_feature_sums_ciede(*args)
    check(torch.equal(sums, again[0]) and torch.equal(dcand, again[1]),
          "kernel D gave other bits a second time")
    kernel = lambda: cuda_metric.coarse_feature_sums_ciede(*args)  # noqa: E731
    record = dict(
        name="coarse_feature_sums_ciede", route="cuda",
        source="snesimage_torch/csrc/coarse_ciede.cu",
        replaces="snesimage_tpu/ops/pallas_metric.py:594",
        max_abs_err=max(feat_err, d_err), feature_max_abs_err=feat_err,
        distance_max_abs_err=d_err,
        distance_exact_share=float((dcand == want_d).float().mean()),
        ms=median_ms(kernel), device_ms=device_ms(kernel),
        blocks_per_candidate=cuda_metric.CLUSTER_BLOCKS,
        active_clusters=cuda_metric.active_clusters(True, 256, 256),
        plain_ms=median_ms(lambda: cuda_metric._coarse_ciede_plain(*args)),
        library_ms=None,
        shape="B=48, 256x256 -> scales 2-5 and distance planes",
        **_coarse_bound(args, nbytes(sums, dcand), CIEDE_OPS_PER_PX),
        unfused=unfused_coarse_ms(ctx, cand8, cand_lin, refp),
    )
    check(torch.equal(dcand, record["unfused"].pop("planes")),
          "kernel D's distance planes differ from kernel F's")
    _print_records("phase 5", [record])
    u = record["unfused"]
    print(f"phase 5 kernel D {record['device_ms']:.4f} ms device against "
          f"F + B on the same visit {u['f_ms']:.4f} + {u['b_ms']:.4f} = "
          f"{u['f_ms'] + u['b_ms']:.4f} ms", flush=True)
    _print_a_cases("phase 5", [a_case])
    return record


def _g_bound(state, b: int, s_entries: int, perceptual: bool, out):
    """Bound of one call of kernel G: every operand read once, the maps
    written once; the distance search counted for opaque pixels only."""
    h, w = state.palette_map.shape
    live = int((state.alpha > 0).sum())
    per_entry = (CIEDE_OPS_PER_PX if perceptual
                 else DITHER_REDMEAN_OPS_PER_ENTRY)
    per_live = DITHER_OPS_PER_LIVE_PX + s_entries * per_entry + (
        DITHER_LAB_OPS_PER_LIVE_PX if perceptual else 0)
    return bound(
        nbytes(state.rgb, state.alpha, state.tile_palettes, state.palette,
               out) + b * 12,
        b * (h * w * DITHER_OPS_PER_PX + live * per_live),
    )


def _g_case(label: str, state, config, p: int, i: int, cand5):
    """Kernel G against its twin for candidates `cand5` of slot (p, i):
    the maps must be bit-equal in both distance modes. Where they are not,
    the failure names the first differing pixel of the wavefront and both
    choices' distances there. The time per step is the device time per
    call over the W + 2H - 2 steps of the wavefront."""
    from snesimage_torch.ops import cuda_dither
    from snesimage_torch.ops.color import ciede2000_srgb_u8, expand_5bit_to_8bit
    from snesimage_torch.ops.dither import dither_candidates

    perceptual = config.perceptual_palettes
    args = (state.rgb, state.alpha, state.tile_palettes, state.palette, p, i,
            cand5, perceptual)
    got = cuda_dither.dither_remap_candidates(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, targets = dither_candidates(*args, return_targets=True)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    check(got.shape == want.shape and got.dtype == torch.int32,
          f"kernel G gave {tuple(got.shape)} {got.dtype}")
    check(bool(((got >= 0) & (got < config.subpalette_size)).all()),
          "kernel G wrote an entry index out of range")
    share = float((got == want).float().mean())
    lanes, cluster = cuda_dither.variant(perceptual, *got.shape[1:])
    case = dict(shape=label, equal_share=share, lanes=lanes,
                blocks_per_candidate=cluster,
                max_abs_err=float((got - want).abs().max()))
    if share < 1.0:
        # Up to the first differing pixel in wavefront order both sides saw
        # the same error, so the twin's target there is the kernel's too.
        h, w = got.shape[1:]
        order = (torch.arange(w, device="cuda")[None, :]
                 + 2 * torch.arange(h, device="cuda")[:, None])
        first = torch.where(got != want, order[None], h * w * 4)
        b, y, x = (int(v) for v in torch.unravel_index(first.argmin(),
                                                       first.shape))
        sub = int(state.tile_palettes[y // 8, x // 8])
        entries = state.palette[sub].clone()
        if sub == p:
            entries[i] = cand5[b]
        picks = (int(got[b, y, x]), int(want[b, y, x]))
        dists = [float(ciede2000_srgb_u8(
            expand_5bit_to_8bit(entries[k]), targets[b, y, x])) for k in picks]
        first = dict(
            candidate=b, y=y, x=x, kernel_entry=picks[0], twin_entry=picks[1],
            kernel_entry_distance=dists[0], twin_entry_distance=dists[1])
        check(False, f"kernel G's maps differ from the twin's ({label}: "
              f"{share} equal; first difference {first})")
    kernel = lambda: cuda_dither.dither_remap_candidates(*args)  # noqa: E731
    case["ms"] = median_ms(kernel, runs=10)
    case["device_ms"] = device_ms(kernel, runs=10)
    case["plain_ms"] = twin_ms  # one run: W + 2H - 2 steps of torch ops
    case["ms_per_step"] = case["device_ms"] / (got.shape[2]
                                               + 2 * got.shape[1] - 2)
    case.update(_g_bound(state, len(cand5), config.subpalette_size,
                         perceptual, got))
    return case


def phase_kernel_g(img, a_record, b_record):
    """Kernel G against its twin in both distance modes at the dithered
    paths' shapes: the first visit's 48 candidates and the full remap
    (B = 1) on the bench image after its dithered init, and 48 candidates
    on a copy of the image with transparent regions. Then the rest of the
    dithered visit's shapes: kernel A rendering the 48 maps, one table per
    candidate, and kernel B at the coarse shape, 48 full-resolution frames,
    two in-kernel 2x2 means, scales 2..5."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_dither, cuda_prescreen
    from snesimage_torch.testing import with_transparency

    cases, a_cases, frames_case = [], [], None
    for label, params in (("red-mean", DITHER),
                          ("perceptual", DITHER_PERCEPTUAL)):
        state, config = prepared_state(img, params)
        cand5 = visit_candidates(state)
        cases.append(_g_case(f"{label}, B=48, 256x256", state, config, 0, 0,
                             cand5))
        cases.append(_g_case(f"{label}, B=1, 256x256, no slot", state, config,
                             -1, 0, state.palette[0, 0][None]))
        clear, _ = prepared_state(with_transparency(img), params)
        # A tile inside the transparent block: its subpalette has
        # transparent pixels (and the scattered ones touch every tile).
        p_clear = int(clear.tile_palettes[17, 17])
        cases.append(_g_case(f"{label}, B=48, 256x256, transparent regions",
                             clear, config, p_clear, 3,
                             visit_candidates(clear)))
        if frames_case is None:
            maps = cuda_dither.dither_remap_candidates(
                state.rgb, state.alpha, state.tile_palettes, state.palette,
                0, 0, cand5, False)
            a_cases = _render_cases("B=48, 256x256", state, cand5, maps)
            frames = cuda_prescreen.render_palette_maps(
                maps, state.tile_palettes, state.alpha, state.palette, cand5,
                0, 0)
            frames_case = _b_case(
                "B=48, pre_ds=2, n=4", refine.make_reference_pyramid(state),
                frames, 2, 4, 2)
    a_record.update(_a_record(a_record["cases"] + a_cases))
    b_record.update(_b_record(b_record["cases"] + [frames_case]))
    main = cases[0]  # the dithered path's visit
    record = dict(
        name="dither_remap_candidates", route="cuda",
        source="snesimage_torch/csrc/dither.cu",
        replaces="snesimage_tpu/ops/pallas_dither.py:483",
        max_abs_err=max(c["max_abs_err"] for c in cases),
        equal_share=min(c["equal_share"] for c in cases),
        ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        shape=main["shape"], device_ms=main["device_ms"],
        ms_per_step=main["ms_per_step"], lanes=main["lanes"],
        blocks_per_candidate=main["blocks_per_candidate"], cases=cases,
    )
    _print_g_cases("phase 8", cases)
    _print_a_cases("phase 9", a_cases)
    _print_b_cases("phase 9", "at the dithered shape", [frames_case])
    return record


def _print_g_cases(phase: str, cases) -> None:
    print(f"{phase} kernel G vs twin (bit-equal maps): " + "; ".join(
        f"{c['shape']}: L = {c['lanes']} over {c['blocks_per_candidate']} "
        f"block(s), kernel {c['ms']:.4f} ms wall, {c['device_ms']:.4f} ms "
        f"device ({c['ms_per_step'] * 1e3:.3f} us a step), twin "
        f"{c['plain_ms']:.1f} ms, bound {c['bound_ms']:.5f} ms "
        f"({c['bound_by']})" for c in cases), flush=True)


def _pooled_case(label: str, wrapper, twin, args, px_ops: float,
                 exact_planes: bool):
    """Kernel E or F against its twin on the operands `args` (those of
    `refine.pooled_inputs`, with or without the image axis; with or without
    its last two, the tile map and the subpalette p): mask counts equal,
    the three m*ML sums within POOLED_SUM_TOL, F's distance planes
    bit-equal. Its bound counts the work of this call: with a tile map,
    the operands' pixels on the tiles of p and the arithmetic there
    (`bound_ms`), beside the bound of the whole image (`bound_whole_ms`)."""
    from snesimage_torch.ops.cuda_prescreen import tile_masks

    restricted = isinstance(args[-1], int)
    tensors = list(args[:-2] if restricted else args)
    tiles, p = args[-2:] if restricted else (None, None)
    batched = tensors[0].dim() == 4
    twin_args = [*tensors, tiles] if batched else [
        None if a is None else a[None] for a in (*tensors, tiles)]

    def plain():
        out = twin(*twin_args, p=p)
        if batched:
            return out
        return tuple(o[0] for o in out) if exact_planes else out[0]

    got, want = wrapper(*args), plain()
    outputs = got if exact_planes else (got,)
    if exact_planes:
        (got, planes), (want, want_planes) = got, want
        check(torch.equal(planes, want_planes),
              f"kernel F's distance planes differ from the twin's ({label}: "
              f"{float((planes == want_planes).float().mean())} equal)")
    check(got.shape == want.shape, f"pooled sums of shape {tuple(got.shape)}")
    check(torch.equal(got[..., 0, :, :], want[..., 0, :, :]),
          f"pooled mask counts differ from the twin's ({label})")
    again = wrapper(*args)
    check(all(torch.equal(a, b) for a, b in zip(
        outputs, again if exact_planes else (again,))),
        f"kernel {'F' if exact_planes else 'E'} gave other bits a second "
        f"time ({label})")
    h, w = tensors[2].shape[-2:]
    n_img = tensors[0].shape[0] if batched else 1
    b = tensors[1].shape[-2]  # candidates an image
    n_px = whole_px = n_img * h * w
    per_px = nbytes(*(a for a in tensors if a.shape[-2:] == (h, w))) / n_px
    other = nbytes(*(a for a in tensors if a.shape[-2:] != (h, w)), *outputs)
    if restricted:
        n_px = int(tile_masks(tiles, p)[1].sum())
        other += nbytes(tiles)
    case = dict(
        shape=label, tiles=n_px // 64,
        max_abs_err=max_err(got, want, POOLED_SUM_TOL),
        mask_count=float(got[..., 0, :, :].sum()),
        ms=median_ms(lambda: wrapper(*args)),
        device_ms=device_ms(lambda: wrapper(*args)),
        plain_ms=median_ms(plain, runs=5), library_ms=None,
        **bound(per_px * n_px + other, b * n_px * px_ops),
        bound_whole_ms=bound(per_px * whole_px + other,
                             b * whole_px * px_ops)["bound_ms"])
    if exact_planes:
        case["bound_fp64_ms"] = ciede_fp64_bound_ms(per_px * n_px + other,
                                                    b * n_px)
        case["bound_fp64_whole_ms"] = ciede_fp64_bound_ms(
            per_px * whole_px + other, b * whole_px)
    return case


def ciede_fp64_bound_ms(n_bytes: float, n_px: int) -> float:
    """F's bound as its device code runs CIEDE2000: the float32 operations
    without the transcendentals over the float32 rate, and the nine
    double-precision transcendental calls, at CIEDE_F64_FLOPS_PER_CALL each,
    over the FP64 rate; the larger of those and the bytes."""
    t_f32 = n_px * (CIEDE_OPS_PER_PX - 9) / F32_OPS_PER_S
    t_f64 = n_px * 9 * CIEDE_F64_FLOPS_PER_CALL / F64_FLOPS_PER_S
    return max(n_bytes / MEMORY_BYTES_PER_S, t_f32, t_f64) * 1e3


def phase_kernels_ef(img, a_record):
    """Kernels E and F against their twins at 256x240 (B = 48) on the
    operands of the first visit of each subpalette p = 0..7 (slot (p, 0),
    channel 0), restricted to the tiles of p as the visit calls them; on
    the first visit's operands also over every tile (no tile map) and on
    two images at once (the visit's planes and tile map and their
    upside-down copies), the wrappers' leading axis; and kernel A's
    prologue at that visit, red-mean and perceptual."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_prescreen as cp

    records, a_cases = [], []
    for params, name, wrapper, twin, px_ops, tpu_line in (
            (GEOMETRY, "pooled_wins_redmean", cp.pooled_wins_redmean,
             cp._pooled_wins_redmean_plain, REDMEAN_OPS_PER_PX, 124),
            (GEOMETRY_PERCEPTUAL, "pooled_wins_ciede", cp.pooled_wins_ciede,
             cp._pooled_wins_ciede_plain, CIEDE_OPS_PER_PX, 264)):
        state, config = prepared_state(img, params)
        mode = ("perceptual" if params.get("perceptual_palettes")
                else "red-mean")
        a_cases.append(_prologue_case(f"256x240, {mode}", state, config))
        d_all = refine.compute_d_all(state, config)
        exact = name == "pooled_wins_ciede"
        visits = [refine.pooled_inputs(*visit_of(state, config, d_all, p))
                  for p in range(config.subpalette_count)]
        per_p = [_pooled_case(f"B=48, 256x240, p={p}", wrapper, twin,
                              list(args), px_ops, exact)
                 for p, args in enumerate(visits)]
        main = per_p[0]
        check(main["mask_count"] > 0, f"no candidate of {name} wins a pixel")
        *tensors, tiles, p = visits[0]
        plane = tuple(tensors[2].shape)  # planes flip, the candidates stay
        pair = [torch.stack([a, a.flip(-2) if a.shape[-2:] == plane else a])
                for a in tensors]
        cases = per_p + [
            _pooled_case("B=48, 256x240, p=0, every tile", wrapper, twin,
                         tensors, px_ops, exact),
            _pooled_case("N=2, B=48, 256x240, p=0", wrapper, twin,
                         pair + [torch.stack([tiles, tiles.flip(0)]), p],
                         px_ops, exact)]
        mean = {k: statistics.mean(c[k] for c in per_p)
                for k in ("device_ms", "bound_ms", "bound_whole_ms", "tiles")}
        records.append(dict(
            name=name, route="cuda",
            source="snesimage_torch/csrc/pooled_wins.cu",
            replaces=f"snesimage_tpu/ops/pallas_prescreen.py:{tpu_line}",
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=main["ms"], device_ms=main["device_ms"],
            plain_ms=main["plain_ms"], library_ms=None,
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            bound_whole_ms=main["bound_whole_ms"], shape=main["shape"],
            mean_over_p=mean, cases=cases))
    print("phase 14 kernels E and F vs twins (mask counts equal, F's "
          "distance planes bit-equal): " + "; ".join(
              f"{r['name']} {c['shape']} ({c['tiles']} tiles) max_abs_err "
              f"{c['max_abs_err']:.3g} kernel {c['ms']:.4f} ms wall, "
              f"{c['device_ms']:.5f} ms device, twin {c['plain_ms']:.4f} ms, "
              f"bound {c['bound_ms']:.5f} ms ({c['bound_by']}; whole image "
              f"{c['bound_whole_ms']:.5f})"
              + (f", with double transcendentals {c['bound_fp64_ms']:.5f} "
                 f"(whole image {c['bound_fp64_whole_ms']:.5f})"
                 if "bound_fp64_ms" in c else "")
              for r in records for c in r["cases"]), flush=True)
    print("phase 14 mean over p = 0..7: " + "; ".join(
        f"{r['name']} {r['mean_over_p']['tiles']:.1f} tiles, "
        f"{r['mean_over_p']['device_ms']:.5f} ms device, bound "
        f"{r['mean_over_p']['bound_ms']:.5f} ms (whole image "
        f"{r['mean_over_p']['bound_whole_ms']:.5f})" for r in records),
        flush=True)
    _print_a_cases("phase 14", a_cases)
    a_record.update(_a_record(a_record["cases"] + a_cases))
    return records


def phase_kernel_b_geometry(img, b_record):
    """Kernel B against its twin at the call shapes of a 256x240 visit,
    whose pyramid is 240x256, 120x128, 60x64, 30x32, 15x16, 8x8: the frame
    error (B = 1, six scales), the coarse stage on the 48 frames assembled
    from kernel E's sums (60x64 down to 8x8), the scale-1 rank (B = 8, one
    in-kernel 2x2 mean), and the scale-0 finalists (B = 2; 4 perceptual)."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_prescreen as cp
    from snesimage_torch.ops.remap import render_linear

    state, refp, ctx, cand8, cand_lin = first_visit(img, GEOMETRY)
    frame = render_linear(state.palette_map, state.alpha,
                          state.tile_palettes, state.palette)
    frame = frame.permute(2, 0, 1)[None].contiguous()
    pooled = cp.pooled_wins_redmean(*refine.pooled_inputs(ctx, cand8))
    quarter = cp.coarse_frames(pooled, cand_lin,
                               refine.ds4_no_candidate(ctx)).contiguous()
    finals = refine.candidate_frames(ctx, ctx.cand_dist(cand8[:8]),
                                     cand_lin[:8])
    cases = [
        _b_case("256x240: B=1, n=6", refp, frame, 0, 6, 0),
        _b_case("256x240: B=48 of 60x64, n=4", refp, quarter, 2, 4, 0),
        _b_case("256x240: B=8, pre_ds=1, n=1", refp, finals, 1, 1, 1),
        _b_case("256x240: B=2, n=1", refp, finals[:2].contiguous(), 0, 1, 0),
        _b_case("256x240: B=4, n=1", refp, finals[:4].contiguous(), 0, 1, 0),
    ]
    b_record.update(_b_record(b_record["cases"] + cases))
    _print_b_cases("phase 15", "at the 256x240 shapes", cases)


def phase_kernel_b_unprescreened(img, b_record):
    """Kernel B against its twin at the call shapes of the visits that
    score every candidate at all six scales in one batch, on the frames of
    a real visit of slot (0, 0): the reference cycle's random visit (64
    draws) and channel visit (32 values) at 256x256, and the `nes-compat`
    visit (the 56 NES colours)."""
    from snesimage_torch.core import refine
    from snesimage_torch.models.presets import preset_fields
    from snesimage_torch.ops.color import (
        expand_5bit_to_8bit,
        nes_palette_5bit,
        srgb_u8_to_linear,
    )

    def frames_of(ctx, cand5):
        cand8 = expand_5bit_to_8bit(cand5)
        return refine.candidate_frames(ctx, ctx.cand_dist(cand8),
                                       srgb_u8_to_linear(cand8)).contiguous()

    state, refp, ctx, _, _ = first_visit(img, REFERENCE)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    draws = torch.randint(0, 32, (64, 3), generator=gen, device="cuda",
                          dtype=torch.int32)
    cases = [
        _b_case("256x256: B=64, n=6 (random visit)", refp,
                frames_of(ctx, draws), 0, 6, 0),
        _b_case("256x256: B=32, n=6 (channel visit, no prescreen)", refp,
                frames_of(ctx, visit_candidates(state)[:32]), 0, 6, 0),
    ]
    _, refp, ctx, _, _ = first_visit(
        img, dict(preset_fields("nes-compat"), seed=0))
    cases.append(_b_case("256x256: B=56, n=6 (NES visit)", refp,
                         frames_of(ctx, nes_palette_5bit("cuda")), 0, 6, 0))
    b_record.update(_b_record(b_record["cases"] + cases))
    _print_b_cases("phase 26", "at the unprescreened visits' shapes", cases)


def phase_kernels_geometry_dither(img, a_record, b_record, g_record):
    """Kernels G, A and B against their twins at the shapes of the 256x240
    dithered visit: 48 candidates' wavefronts over 240 rows, the 48 maps
    rendered with one table per candidate, and 48 full 240x256 frames taken
    down twice inside kernel B to scales 2..5 (60x64, 30x32, 15x16, 8x8)."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_dither, cuda_prescreen

    state, config = prepared_state(img, GEOMETRY_DITHER)
    cand5 = visit_candidates(state)
    g_case = _g_case("red-mean, B=48, 256x240", state, config, 0, 0, cand5)
    maps = cuda_dither.dither_remap_candidates(
        state.rgb, state.alpha, state.tile_palettes, state.palette, 0, 0,
        cand5, False)
    a_cases = _render_cases("B=48, 256x240", state, cand5, maps)
    frames = cuda_prescreen.render_palette_maps(
        maps, state.tile_palettes, state.alpha, state.palette, cand5, 0, 0)
    b_case = _b_case("256x240: B=48, pre_ds=2, n=4",
                     refine.make_reference_pyramid(state), frames, 2, 4, 2)
    a_record.update(_a_record(a_record["cases"] + a_cases))
    b_record.update(_b_record(b_record["cases"] + [b_case]))
    g_record["cases"].append(g_case)
    g_record["max_abs_err"] = max(g_record["max_abs_err"],
                                  g_case["max_abs_err"])
    g_record["equal_share"] = min(g_record["equal_share"],
                                  g_case["equal_share"])
    _print_g_cases("phase 27", [g_case])
    _print_a_cases("phase 27", a_cases)
    _print_b_cases("phase 27", "at the 256x240 dithered shape", [b_case])


def phase_prologue_nes(state, params: dict, a_record):
    """Kernel A's prologue at the first visit of the `nes-compat` run: a
    4x3 palette, so a 12-entry table and S = 3 distance planes."""
    from snesimage_torch.config import QuantConfig

    a_case = _prologue_case("256x256, nes-compat 4x3", state,
                            QuantConfig(**params))
    a_record.update(_a_record(a_record["cases"] + [a_case]))
    _print_a_cases("phase 22", [a_case])


def phase_init_hash(img, params: dict, want: str, phase: str):
    state, _ = prepared_state(img, params)
    got = init_hash(state)
    check(got == want, f"init hash {got} != {want}")
    print(f"{phase} init hash: {got} (equals the JAX CPU value)", flush=True)
    return state


def kernel_wrappers() -> dict:
    from snesimage_torch.ops import cuda_dither, cuda_metric, cuda_prescreen

    fns = (cuda_prescreen.select_colors, cuda_metric.multiscale_feature_sums,
           cuda_metric.coarse_feature_sums_redmean,
           cuda_metric.coarse_feature_sums_ciede,
           cuda_prescreen.pooled_wins_redmean,
           cuda_prescreen.pooled_wins_ciede,
           cuda_dither.dither_remap_candidates)
    return dict(zip(WRAPPERS, fns))


def phase_main_path(img, init_state, smi, params: dict, phase: str,
                    label: str, present: tuple, timed_runs: int,
                    always_replaces: bool = False, record=None):
    """One run of a path through `run_fused`, checked; then its warm time
    as the best of `timed_runs` runs (with 0, the checked run's own time:
    the phases before it have warmed every kernel). Returns each wrapper's
    launches in the checked run: the wrappers in `present` must have
    launched and no other, kernel G once per visit and twice in the init
    where the path dithers, and kernel E or F once per channel visit.
    `always_replaces` (NES) lifts the check that step errors never rise.
    A `record` dict receives the run's step errors and warm seconds."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine
    from snesimage_torch.io.json_out import state_to_json
    from snesimage_torch.ops.remap import render_linear
    from snesimage_torch.ops.ssimulacra2 import (
        score_from_features,
        scale_features,
    )

    config = QuantConfig(**params)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    state, errors, info = pipeline.run_fused(img, config, device="cuda")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for name, n in launches.items():
        if name in present:
            check(n > 0, f"the {label} path never launched {name}")
        else:
            check(n == 0, f"the {label} path launched {name}")
    visits = (config.max_steps * config.subpalette_count
              * config.subpalette_size * 3)
    if config.dither:
        check(launches["dither_remap_candidates"] >= visits + 2,
              f"kernel G launched {launches['dither_remap_candidates']} "
              f"times in {visits} visits")
    for name in ("pooled_wins_redmean", "pooled_wins_ciede"):
        check(launches[name] in (0, visits),
              f"{name} launched {launches[name]} times in {visits} visits")

    refp = refine.make_reference_pyramid(init_state)
    err0 = float(refine.frame_error_fused(init_state, config, refp))
    check(len(errors) == config.max_steps, f"{len(errors)} steps ran")
    check(all(np.isfinite(errors)), "non-finite step error")
    check(always_replaces
          or all(b <= a for a, b in zip([err0] + errors, errors)),
          "step errors increase")
    check(errors[-1] < err0, "the run did not improve on the init error")
    if config.nes:
        from snesimage_torch.ops.color import nes_palette_5bit

        nes = {tuple(c) for c in nes_palette_5bit(state.device).tolist()}
        entries = {tuple(c) for c in state.palette.reshape(-1, 3).tolist()}
        check(entries <= nes, f"entries off the NES palette: {entries - nes}")

    out = json.loads(state_to_json(state, config))
    tiles = config.num_tiles
    check(len(out["palette"]) == config.subpalette_count * 16, "palette")
    check(len(out["tile_palettes"]) == tiles, "tile_palettes")
    check(len(out["tiles"]) == tiles and all(len(t) == 64
                                             for t in out["tiles"]), "tiles")

    kernel_err = float(refine.frame_error_fused(state, config, refp))
    frame = render_linear(state.palette_map, state.alpha,
                          state.tile_palettes, state.palette)
    twin_err = float(100.0 - score_from_features(scale_features(refp, frame)))
    check(abs(kernel_err - twin_err) <= ERROR_TOL,
          f"final error {kernel_err} (kernel) vs {twin_err} (twin)")

    runs = []
    for _ in range(timed_runs):
        t0 = time.perf_counter()
        pipeline.run_fused(img, config, device="cuda")
        runs.append(time.perf_counter() - t0)
    runs = runs or [info["total_seconds"]]
    if record is not None:
        record.update(errors=errors, seconds=min(runs), state=state)
    print(f"{phase} main path: {label} {config.width}x{config.height} "
          f"{config.subpalette_count}x{config.subpalette_size}, "
          f"{len(errors)} step(s), warm best of {len(runs)} {min(runs):.3f} s "
          f"(runs {runs}), init "
          f"error {err0}, final error {info['final_error']}, step errors "
          f"{errors}, frame error kernel {kernel_err} twin {twin_err}, "
          f"launches {launches}, card '{smi}'", flush=True)
    return launches


# The image batch of BASELINE config 5 as benchmarks.py runs it: 64 images
# of the `nes-compat` preset, two steps, in four batches of 16; the first
# four images are held against their own single-image runs.
BATCH_IMAGES = 64
BATCH_CHUNK = 16
BATCH_STEPS = 2
BATCH_CHECKED = 4
PORTFOLIO_KS = (1, 2, 4)  # seeds of the timed balanced portfolios
N_RECORD = 4  # images of the kernels' image-axis records


def _batch_seeds():
    return np.random.default_rng(1).integers(0, 1 << 31, BATCH_IMAGES)


def _zero_counts() -> dict:
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
        if hasattr(fn, "frame_launches"):
            fn.frame_launches = 0
    return wrappers


def _read_counts(wrappers: dict, label: str, present: tuple) -> dict:
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for name, n in launches.items():
        if name in present:
            check(n > 0, f"the {label} path never launched {name}")
        else:
            check(n == 0, f"the {label} path launched {name}")
    return launches


def phase_batch(smi, nes: dict):
    """BASELINE config 5 through `batched_run`, then `batch_cli` on the
    first 16 images written as PNGs: every JSON must equal `state_to_json`
    of its image's batched state, byte for byte."""
    import tempfile
    from pathlib import Path

    from PIL import Image

    from snesimage_torch import batch_cli
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline
    from snesimage_torch.core.state import image_of
    from snesimage_torch.io.json_out import state_to_json
    from snesimage_torch.parallel import batch as pb
    from snesimage_torch.testing import bench_image

    config = QuantConfig(**dict(nes, max_steps=BATCH_STEPS))
    images = np.stack([bench_image(int(s)) for s in _batch_seeds()])
    wrappers = _zero_counts()
    chunks, secs = [], []
    for c in range(0, BATCH_IMAGES, BATCH_CHUNK):
        t0 = time.perf_counter()
        chunks.append(pb.batched_run(images[c:c + BATCH_CHUNK], config,
                                     device="cuda", image_errors=True))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    a, b = WRAPPERS[:2]
    launches = _read_counts(wrappers, "image batch", (a, b))
    for states, means, per in chunks:
        check(per.shape == (BATCH_STEPS, BATCH_CHUNK), f"errors {per.shape}")
        check(bool(np.isfinite(per).all()), "non-finite batch error")
        check(tuple(states.palette.shape) == (BATCH_CHUNK, 4, 3, 3),
              "batched palettes")
    states0, _, per0 = chunks[0]
    single_s = []
    for n in range(BATCH_CHECKED):
        t0 = time.perf_counter()
        state, errors, _ = pipeline.run_fused(images[n], config,
                                              device="cuda")
        single_s.append(time.perf_counter() - t0)
        check(np.array_equal(np.asarray(errors, np.float32), per0[:, n]),
              f"image {n}: batch {per0[:, n]} vs single {errors}")
        check(torch.equal(state.palette, states0.palette[n])
              and torch.equal(state.palette_map, states0.palette_map[n]),
              f"image {n}: batched palette or map differs from its run")
    # Where a batch's seconds go: the init, image by image, against the
    # sweeps, all images at once (the first batch again, split).
    t0 = time.perf_counter()
    states = pb.bcluster(pb.binit(pb.make_batched_states(
        images[:BATCH_CHUNK], config, "cuda"), config), config)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pb.batched_optimize(states, config)
    sweeps_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        indir, outdir = Path(tmp) / "in", Path(tmp) / "out"
        indir.mkdir()
        for n in range(BATCH_CHUNK):
            Image.fromarray(images[n], "RGBA").save(indir / f"im{n:02d}.png")
        t0 = time.perf_counter()
        rc = batch_cli.main([str(indir), str(outdir), "--preset",
                             "nes-compat", "--steps", str(BATCH_STEPS)])
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"batch_cli exited {rc}")
        for n in range(BATCH_CHUNK):
            got = (outdir / f"im{n:02d}.json").read_text()
            check(got == state_to_json(image_of(states0, n), config),
                  f"batch_cli's im{n:02d}.json differs from the batch's")
    total = sum(secs)
    print(f"phase 28 image batch: BASELINE config 5, nes-compat 4x3, "
          f"{BATCH_IMAGES} images in {len(secs)} batches of {BATCH_CHUNK}, "
          f"{BATCH_STEPS} steps: {BATCH_IMAGES / total:.3f} images/s, "
          f"seconds per batch {secs}, mean step errors "
          f"{[c[1] for c in chunks]}; images 0-{BATCH_CHECKED - 1} equal "
          f"their own run_fused (step errors {per0[:, :BATCH_CHECKED].T.tolist()}"
          f"), {statistics.mean(single_s):.3f} s a single run; a batch "
          f"split: init {init_s:.3f} s, sweeps {sweeps_s:.3f} s; batch_cli "
          f"on {BATCH_CHUNK} PNGs {cli_s:.3f} s, every JSON "
          f"equal; launches {launches}, card '{smi}'", flush=True)
    return launches


def phase_robust(img, smi, balanced: dict):
    """`cli.main --opt-profile robust -c 8 -s 15` (a K = 2 portfolio of the
    balanced recipe at config 2's geometry), the portfolio's checks, and
    seconds at K = 1, 2, 4 beside run_fused's (phase 4's warm run,
    `balanced`)."""
    import tempfile
    from pathlib import Path

    from PIL import Image

    from snesimage_torch import cli
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import refine
    from snesimage_torch.io.json_out import state_to_json
    from snesimage_torch.parallel.batch import portfolio_run

    config = QuantConfig(**BALANCED)
    init, _ = prepared_state(img, BALANCED)
    err0 = float(refine.frame_error_fused(
        init, config, refine.make_reference_pyramid(init)))
    state, errors = balanced["state"], balanced["errors"]
    secs = {"run_fused": balanced["seconds"]}
    runs = {}
    for k in PORTFOLIO_KS:
        t0 = time.perf_counter()
        runs[k] = portfolio_run(img, config, k, device="cuda")
        secs[f"K={k}"] = time.perf_counter() - t0
    best1, finals1, steps1 = runs[1]
    check(steps1 == errors and float(finals1[0]) == errors[-1],
          f"a portfolio of one gave {steps1}, run_fused {errors}")
    check(torch.equal(best1.palette, state.palette)
          and torch.equal(best1.palette_map, state.palette_map),
          "a portfolio of one kept another state than run_fused's")
    for k, (best, finals, steps) in runs.items():
        check(bool(np.isfinite(finals).all()) and bool((finals < err0).all()),
              f"K={k}: seed finals {finals} against the init's {err0}")
        # The kept state's exact error, scored afresh, against the lowest
        # carried final (the two round apart, as a run's final error and
        # its frame error do in the main-path phases).
        kept = float(refine.frame_error_fused(
            best, config, refine.make_reference_pyramid(best)))
        check(abs(kept - float(finals.min())) <= ERROR_TOL,
              f"K={k}: kept error {kept}, seed finals {finals}")
    best2, finals2, _ = runs[2]
    check(finals2[0] != finals2[1], "the two seeds ran one trajectory")
    with tempfile.TemporaryDirectory() as tmp:
        src, out = Path(tmp) / "src.png", Path(tmp) / "out.json"
        Image.fromarray(img, "RGBA").save(src)
        wrappers = _zero_counts()
        t0 = time.perf_counter()
        # The profile's recipe at config 2's geometry, as BALANCED has it
        # (the CLI's own default is the reference's 1 x 7).
        rc = cli.main([str(src), str(out), "--opt-profile", "robust", "-c",
                       str(config.subpalette_count), "-s",
                       str(config.subpalette_size)])
        secs["cli robust"] = time.perf_counter() - t0
        a, b, c = WRAPPERS[:3]
        launches = _read_counts(wrappers, "robust", (a, b, c))
        check(rc == 0, f"cli.main robust exited {rc}")
        check(out.read_text() == state_to_json(best2, config),
              "the robust CLI's JSON is not the K = 2 portfolio's")
    print(f"phase 29 robust: cli --opt-profile robust exit 0, seed finals "
          f"{finals2.tolist()} kept {float(finals2.min())} (init error "
          f"{err0}); K=1 equals run_fused (step errors {errors}); seconds "
          f"{secs}; K=4 finals {runs[4][1].tolist()}; launches {launches}, "
          f"card '{smi}'", flush=True)
    return launches


def phase_dither_portfolio(img, smi):
    """A dithered balanced portfolio, K = 2, one step; kernel G at N = 2
    seed rows over the shared image against two N = 1 launches."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_dither
    from snesimage_torch.parallel.batch import portfolio_run

    params = dict(DITHER, max_steps=1)
    config = QuantConfig(**params)
    init, _ = prepared_state(img, params)
    err0 = float(refine.frame_error_fused(
        init, config, refine.make_reference_pyramid(init)))
    wrappers = _zero_counts()
    t0 = time.perf_counter()
    best, finals, steps = portfolio_run(img, config, 2, device="cuda")
    secs = time.perf_counter() - t0
    a, b = WRAPPERS[:2]
    launches = _read_counts(wrappers, "dithered portfolio",
                            (a, b, WRAPPERS[6]))
    check(bool((finals < err0).all()), f"seed finals {finals} vs {err0}")
    cand = torch.stack([visit_candidates(init, 0), visit_candidates(init, 1)])
    pals = torch.stack([init.palette, init.palette.clone()])
    pals[1, 1, 0] = cand[1, 5]
    image = (init.rgb, init.alpha, init.tile_palettes)
    got = cuda_dither.dither_remap_candidates(*image, pals, 0, 0, cand)
    for n in range(2):
        one = cuda_dither.dither_remap_candidates(*image, pals[n], 0, 0,
                                                  cand[n])
        check(torch.equal(got[n], one),
              f"kernel G's seed row {n} differs from its own launch")
    ms = {n: device_ms(lambda: cuda_dither.dither_remap_candidates(
        *image, pals[:n], 0, 0, cand[:n]), runs=10) for n in (1, 2)}
    print(f"phase 30 dithered portfolio: K=2, 1 step, {secs:.3f} s, seed "
          f"finals {finals.tolist()} (init error {err0}); kernel G at N=2 "
          f"seed rows equals two N=1 launches bit for bit; G device ms N=1 "
          f"{ms[1]:.5f}, N=2 {ms[2]:.5f}; launches {launches}, card "
          f"'{smi}'", flush=True)
    return launches


def _batch_visit(params: dict, rows=None):
    """A batch of N_RECORD of config 5's images under `params`, after init,
    and the first visit of subpalette 0 (slot (0, 0), channel 0): its
    pyramids, slot context and per-image 5-bit candidates (N, 48, 3)."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import refine
    from snesimage_torch.core.state import image_of
    from snesimage_torch.parallel import batch as pb
    from snesimage_torch.testing import bench_image

    config = QuantConfig(**params)
    images = np.stack([np.ascontiguousarray(bench_image(int(s))[:rows])
                       for s in _batch_seeds()[:N_RECORD]])
    states = pb.bcluster(pb.binit(
        pb.make_batched_states(images, config, "cuda"), config), config)
    refp = pb.brefp(states, config)
    cand5 = torch.stack([visit_candidates(image_of(states, n), 0)
                         for n in range(N_RECORD)])
    ctx = None
    if not config.dither:
        ctx = refine.slot_context(states, config, 0, 0,
                                  refine.compute_d_all(states, config))
    return states, config, refp, ctx, cand5


def _axis_case(label: str, fn, twin=None, tol=None, exact=True):
    """One image-axis record: `fn(rows)` on the first n images for n = 1
    and N_RECORD, the batched outputs held to the N = 1 launches of each
    image bit for bit, and to `twin` (bit for bit, or within `tol` on the
    tensors `twin` returns beside the kernel's); device ms at N = 1 and
    N = N_RECORD."""
    got = fn(N_RECORD)
    for n in range(N_RECORD):
        one = fn((n, n + 1))
        for a, b in zip(_planes(got), _planes(one)):
            check(torch.equal(a[n:n + 1], b),
                  f"{label}: image {n} differs from its own launch")
    case = dict(shape=label, n=N_RECORD, bits_equal_n1=True)
    if twin is not None:
        mine, want = twin(got)
        if exact:
            check(all(torch.equal(a, b) for a, b in zip(mine, want)),
                  f"{label}: kernel and twin differ")
            case["max_abs_err"] = 0.0
        else:
            case["max_abs_err"] = max(max_err(a, b, tol)
                                      for a, b in zip(mine, want))
    case["device_ms_n1"] = device_ms(lambda: fn(1))
    case[f"device_ms_n{N_RECORD}"] = device_ms(lambda: fn(N_RECORD))
    return case


def _rows(x, sel):
    """Images sel (an int n: the first n; a pair: a range) of a batched
    operand; tuples of planes plane by plane."""
    lo, hi = (0, sel) if isinstance(sel, int) else sel
    if isinstance(x, tuple):
        return tuple(_rows(a, sel) for a in x)
    return x[lo:hi] if isinstance(x, torch.Tensor) and x.dim() else x


def phase_image_axis(records):
    """Every kernel at N = 4 images of config 5's bench images (the image
    fold) against its N = 1 launches, bit for bit, and its twin; device ms
    at N = 1 and N = 4, added to each kernel's record as `image_axis`."""
    from snesimage_torch.core import refine
    from snesimage_torch.models.presets import preset_fields
    from snesimage_torch.ops import cuda_dither, cuda_metric, cuda_prescreen
    from snesimage_torch.ops.color import expand_5bit_to_8bit, srgb_u8_to_linear
    from snesimage_torch.ops.dither import dither_candidates
    from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums

    cases = {name: [] for name in WRAPPERS}
    sizes = [(256 >> s) ** 2 for s in range(2, 6)]

    # A's prologue and C on the balanced visit.
    states, config, refp, ctx, cand5 = _batch_visit(BALANCED)
    d_all = refine.compute_d_all(states, config)
    pro_args = (d_all, states.tile_palettes, states.alpha, states.palette)
    cases["select_colors"].append(_axis_case(
        "prologue, 256x256 red-mean", lambda s: cuda_prescreen.visit_prologue(
            *_rows(pro_args, s), 0, 0),
        twin=lambda got: (_planes(got), _planes(cuda_prescreen._stack_prologues(
            [cuda_prescreen._visit_prologue_plain(*(a[n] for a in pro_args),
                                                  0, 0)
             for n in range(N_RECORD)])))))
    cand8 = expand_5bit_to_8bit(cand5)
    c_args = refine.coarse_inputs(ctx, cand8, srgb_u8_to_linear(cand8), refp)
    cases["coarse_feature_sums_redmean"].append(_axis_case(
        "B=48, 256x256", lambda s: cuda_metric.coarse_feature_sums_redmean(
            *_rows(c_args, s)),
        twin=lambda got: ([finalize_feature_sums(got, sizes, 2)], [
            finalize_feature_sums(cuda_metric._coarse_plain(*c_args), sizes,
                                  2)]), tol=FEATURE_TOL, exact=False))

    # D on the perceptual visit.
    states, config, refp, ctx, cand5 = _batch_visit(PERCEPTUAL)
    cand8 = expand_5bit_to_8bit(cand5)
    d_args = refine.coarse_inputs(ctx, cand8, srgb_u8_to_linear(cand8), refp)

    def d_twin(got):
        want = cuda_metric._coarse_ciede_plain(*d_args)
        return ([finalize_feature_sums(got[0], sizes, 2), got[1]],
                [finalize_feature_sums(want[0], sizes, 2), want[1]])

    cases["coarse_feature_sums_ciede"].append(_axis_case(
        "B=48, 256x256", lambda s: cuda_metric.coarse_feature_sums_ciede(
            *_rows(d_args, s)), twin=d_twin, tol=DISTANCE_TOL,
        exact=False))

    # E and F on the 256x240 visits, each image on its own tiles of p = 0.
    for perceptual, name in ((False, "pooled_wins_redmean"),
                             (True, "pooled_wins_ciede")):
        states, config, refp, ctx, cand5 = _batch_visit(
            GEOMETRY_PERCEPTUAL if perceptual else GEOMETRY, rows=240)
        e_args = refine.pooled_inputs(ctx, expand_5bit_to_8bit(cand5))
        wrapper = getattr(cuda_prescreen, name)

        def ef_twin(got, name=name, a=e_args):
            """The pooled sums within POOLED_SUM_TOL; the mask counts, and
            F's distance planes (+inf off the tiles of p), bit for bit."""
            want = getattr(cuda_prescreen, f"_{name}_plain")(*a[:-1],
                                                             p=a[-1])
            got, want = _planes(got), _planes(want)
            check(all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])),
                  f"{name}'s distance planes differ from the twin's")
            check(torch.equal(got[0][..., 0, :, :], want[0][..., 0, :, :]),
                  f"{name}'s mask counts differ from the twin's")
            return got[:1], want[:1]

        cases[name].append(_axis_case(
            "B=48, 256x240, tiles of p = 0",
            lambda s, w=wrapper, a=e_args: w(*_rows(a[:-1], s), a[-1]),
            twin=ef_twin, tol=POOLED_SUM_TOL, exact=False))

    # B on the NES visit's 56 frames at six scales: a pyramid an image, and
    # one pyramid that every row shares (a portfolio's seeds).
    nes = dict(preset_fields("nes-compat"), max_steps=NES_STEPS,
               converge_tol=0.0, seed=0)
    states, config, refp, ctx, _ = _batch_visit(nes)
    from snesimage_torch.ops.color import nes_palette_5bit

    cand8 = expand_5bit_to_8bit(nes_palette_5bit("cuda"))
    cand8 = cand8.expand(N_RECORD, *cand8.shape)
    frames = refine.candidate_frames(ctx, ctx.cand_dist(cand8),
                                     srgb_u8_to_linear(cand8))
    triples = tuple(tuple(a.movedim(-1, -3) for a in sc) for sc in refp)
    shared = tuple(tuple(a[0] for a in sc) for sc in triples)
    six = [(256 >> s) ** 2 for s in range(6)]

    def features(raw):
        return finalize_feature_sums(raw.reshape(*raw.shape[:2], -1, 6), six,
                                     0)

    for label, refs in (("B=56 an image, six scales", triples),
                        ("B=56, one shared pyramid", shared)):
        cases["multiscale_feature_sums"].append(_axis_case(
            label, lambda s, r=refs: cuda_metric.multiscale_feature_sums(
                _rows(r, s) if r is triples else r, _rows(frames, s)),
            twin=lambda got, r=refs: ([features(got)], [features(
                cuda_metric._multiscale_feature_sums_plain(r, frames))]),
            tol=FEATURE_TOL, exact=False))

    # G and A's render on the dithered visit.
    states, config, refp, _, cand5 = _batch_visit(DITHER)
    g_args = (states.rgb, states.alpha, states.tile_palettes, states.palette)

    def g_twin(got):  # image 0 only: the twin walks 766 steps in torch
        return [got[0]], [dither_candidates(*(a[0] for a in g_args), 0, 0,
                                            cand5[0])]

    cases["dither_remap_candidates"].append(_axis_case(
        "B=48, 256x256", lambda s: cuda_dither.dither_remap_candidates(
            *_rows(g_args, s), 0, 0, _rows(cand5, s)), twin=g_twin))
    maps = cuda_dither.dither_remap_candidates(*g_args, 0, 0, cand5)
    r_args = (maps, states.tile_palettes, states.alpha, states.palette, cand5)
    cases["select_colors"].append(_axis_case(
        "render, B=48, 256x256", lambda s: cuda_prescreen.render_palette_maps(
            *_rows(r_args, s), 0, 0),
        twin=lambda got: ([got], [torch.stack([
            cuda_prescreen._render_plain(*(a[n] for a in r_args), 0, 0)
            for n in range(N_RECORD)])])))

    for r in records:
        r["image_axis"] = cases[r["name"]]
    for name, cs in cases.items():
        for c in cs:
            print(f"phase 31 image axis: {name} {c['shape']}: N={N_RECORD} "
                  f"equals N=1 launches bit for bit, max abs err vs twin "
                  f"{c.get('max_abs_err')}, device ms N=1 "
                  f"{c['device_ms_n1']:.5f}, N={N_RECORD} "
                  f"{c[f'device_ms_n{N_RECORD}']:.5f}", flush=True)


# The `fast` profile at BASELINE config 2's geometry (the profile's own
# fields; the CLI's default palette is the reference's 1 x 7).
FAST_GEOMETRY = ("-c", "8", "-s", "15")
# Steps of the hybrid run's phases: phase 1 (fast) and phase 2 (the
# explore polish), capped as `--steps` caps them in the CLI.
HYBRID_STEPS = (3, 2)


def fast_params(**change) -> dict:
    from snesimage_torch.cli import OPT_PROFILES

    return dict(OPT_PROFILES["fast"][1], subpalette_count=8,
                subpalette_size=15, seed=0, **change)


def _b_flag_case(label: str, refs, frames, flags, unflagged):
    """Kernel B with a gate flag an image against the same call without
    one: open images bit-equal, closed ones zero sums; device ms."""
    from snesimage_torch.ops import cuda_metric

    gate = torch.tensor(flags, dtype=torch.int32, device="cuda")

    def kernel():
        return cuda_metric.multiscale_feature_sums(refs, frames, gate=gate)

    got = kernel()
    for k, flag in enumerate(flags):
        g_k = got[k] if len(flags) > 1 else got
        w_k = unflagged[k] if len(flags) > 1 else unflagged
        check(torch.equal(g_k, w_k) if flag else not bool(g_k.any()),
              f"kernel B's gate flag {flags} ({label}): image {k} wrong")
    check(torch.equal(cuda_metric.multiscale_feature_sums(refs, frames),
                      unflagged), "a flagged call changed the next call")
    # The bound: the flags read and the sums written, and for the open
    # images their frames, the shared reference planes and the metric.
    per_image = frames if len(flags) > 1 else frames[None]
    n_open = sum(flags)
    sizes = [t[0].shape[-2] * t[0].shape[-1] for t in refs]
    n_bytes = (nbytes(gate, got) + n_open * nbytes(per_image[0])
               + (nbytes(*(a for t in refs for a in t)) if n_open else 0))
    return dict(shape=label, flags=list(flags), device_ms=device_ms(kernel),
                unflagged_device_ms=device_ms(
                    lambda: cuda_metric.multiscale_feature_sums(refs,
                                                                frames)),
                **bound(n_bytes, n_open * metric_ops(per_image.shape[1],
                                                     sizes)))


def phase_kernel_b_gate(img, b_record):
    """Kernel B at the gated visit's shapes: the gate's carry (B = 1,
    scales 0-1) against its twin, and the scale-0 finalists (B = 2) with a
    closed and an open flag, at N = 1 and N = 2 images, against the
    unflagged call."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_metric
    from snesimage_torch.ops.remap import render_linear

    state, refp, ctx, cand8, cand_lin = first_visit(img, BALANCED)
    frame = render_linear(state.palette_map, state.alpha,
                          state.tile_palettes, state.palette)
    frame = frame.permute(2, 0, 1)[None].contiguous()
    carry = _b_case("B=1, n=2 (the gate's carry)", refp, frame, 0, 2, 0)
    b_record.update(_b_record(b_record["cases"] + [carry]))
    finals = refine.candidate_frames(ctx, ctx.cand_dist(cand8[:2]),
                                     cand_lin[:2]).contiguous()
    refs = (tuple(a.permute(2, 0, 1) for a in refp[0]),)
    one = cuda_metric.multiscale_feature_sums(refs, finals)
    two = torch.stack([finals, finals.flip(0)])
    both = cuda_metric.multiscale_feature_sums(refs, two)
    cases = [_b_flag_case("B=2, n=1, closed", refs, finals, (0,), one),
             _b_flag_case("B=2, n=1, open", refs, finals, (1,), one)]
    cases += [_b_flag_case(f"N=2 x B=2, n=1, flags {f}", refs, two, f, both)
              for f in ((1, 0), (0, 1), (0, 0), (1, 1))]
    b_record["gate_cases"] = cases
    _print_b_cases("phase 32", "at the gate's carry", [carry])
    print("phase 32 kernel B gate flag (open bit-equal to the unflagged "
          "call, closed zero): " + "; ".join(
              f"{c['shape']} {c['device_ms']:.5f} ms device (unflagged "
              f"{c['unflagged_device_ms']:.5f}), bound {c['bound_ms']:.3g} "
              f"ms ({c['bound_by']})" for c in cases), flush=True)


def _cli(argv, quiet: bool = False):
    """cli.main on the card; with `quiet` its log lines are kept (and
    returned) instead of printed. Returns (exit code, log lines, s)."""
    import contextlib
    import io

    from snesimage_torch import cli

    buf = io.StringIO()
    ctx = contextlib.redirect_stdout(buf) if quiet else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        rc = cli.main([str(a) for a in argv])
    return rc, buf.getvalue().splitlines(), time.perf_counter() - t0


def _gate_share(tally) -> float:
    closed = 0 if tally["closed"] is None else int(tally["closed"])
    return closed / max(tally["visits"], 1)


def _check_fast_run(label, config, errors, err0, may_run_out=False):
    """A `fast` run's checks: finite errors that never rise, a final below
    the init's, and a stop before the step budget, which a gated run takes
    only on an exact sweep (`need_exact`) whose step improved by less than
    the tolerance; with `may_run_out` the run may end at its budget
    instead. Returns whether an exact sweep ended the run."""
    check(all(np.isfinite(errors)), f"{label}: non-finite step error")
    check(all(b <= a for a, b in zip([err0] + errors, errors)),
          f"{label}: step errors increase")
    check(errors[-1] < err0, f"{label}: no improvement on {err0}")
    exact_stop = (1 < len(errors) < config.max_steps
                  and errors[-2] - errors[-1] < config.converge_tol)
    ran_out = may_run_out and len(errors) == config.max_steps
    check(exact_stop or ran_out, f"{label}: {len(errors)} steps, not "
          "stopped by an exact sweep")
    return exact_stop


def phase_fast(img, smi, balanced: dict, record: dict):
    """`cli --opt-profile fast -c 8 -s 15` at 256x256 (the gated channel
    recipe, kernels A, B and C) and the same recipe through `run_fused` at
    256x240 (kernels A, B and E; the CLI takes 256x256 images only): steps,
    step errors, the stop, the share of closed gates and seconds beside
    the balanced run's. `record` receives the 256x256 run's step
    errors."""
    import tempfile
    from pathlib import Path

    from PIL import Image

    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine
    from snesimage_torch.io.checkpoint import load_checkpoint
    from snesimage_torch.io.json_out import state_to_json

    a, b, c, _, e, _, _ = WRAPPERS
    config = QuantConfig(**fast_params())
    init, _ = prepared_state(img, fast_params())
    err0 = float(refine.frame_error_fused(
        init, config, refine.make_reference_pyramid(init)))
    with tempfile.TemporaryDirectory() as tmp:
        src, out, ck = (Path(tmp) / n for n in ("src.png", "out.json",
                                                "ck.npz"))
        Image.fromarray(img, "RGBA").save(src)
        wrappers = _zero_counts()
        with refine.gate_tally() as tally:
            rc, _, secs = _cli([src, out, "--opt-profile", "fast",
                                *FAST_GEOMETRY, "--checkpoint", ck])
        launches = _read_counts(wrappers, "fast", (a, b, c))
        check(rc == 0, f"cli --opt-profile fast exited {rc}")
        state, _, meta = load_checkpoint(str(ck), "cuda")
        check(out.read_text() == state_to_json(state, config),
              "the fast CLI's JSON is not its checkpoint's state")
    errors = meta["errors"]
    exact = _check_fast_run("fast", config, errors, err0)
    share = _gate_share(tally)

    img240 = np.ascontiguousarray(img[:240])
    params240 = fast_params(width=256, height=240)
    config240 = QuantConfig(**params240)
    init240, _ = prepared_state(img240, params240)
    err0_240 = float(refine.frame_error_fused(
        init240, config240, refine.make_reference_pyramid(init240)))
    wrappers = _zero_counts()
    with refine.gate_tally() as tally240:
        _, errors240, info240 = pipeline.run_fused(img240, config240,
                                                   device="cuda")
    launches240 = _read_counts(wrappers, "fast 256x240", (a, b, e))
    exact240 = _check_fast_run("fast 256x240", config240, errors240,
                               err0_240)
    print(f"phase 33 fast: cli --opt-profile fast 256x256 8x15 exit 0, "
          f"{len(errors)} steps, ended by an exact sweep {exact}, init error "
          f"{err0}, step errors {errors}, closed gates {share:.4f} of "
          f"{tally['visits']} gated visits, {secs:.3f} s (the balanced run "
          f"{balanced['seconds']:.3f} s); launches {launches}. 256x240 "
          f"run_fused: {len(errors240)} steps, ended by an exact sweep "
          f"{exact240}, init error {err0_240}, step errors {errors240}, "
          f"closed gates {_gate_share(tally240):.4f} of "
          f"{tally240['visits']}, {info240['total_seconds']:.3f} s; launches "
          f"{launches240}; card '{smi}'", flush=True)
    record.update(errors=errors)
    return launches, launches240


def phase_host_stepped(img, smi, balanced: dict):
    """The balanced recipe through the CLI's host-stepped loop: 4 steps
    with `--dump-every 2 --checkpoint` (an `on_step` hook after every
    sweep), then `--resume` from that checkpoint for 4 more. The 8 step
    errors must equal phase 4's `run_fused` run to the bit (the hook
    changes nothing, and the resumed stream draws what the uninterrupted
    one draws at steps 4-7), and so must the final state's JSON."""
    import tempfile
    from pathlib import Path

    from PIL import Image

    from snesimage_torch.config import QuantConfig
    from snesimage_torch.io.checkpoint import load_checkpoint
    from snesimage_torch.io.json_out import state_to_json

    a, b, c, *_ = WRAPPERS
    config = QuantConfig(**BALANCED)
    with tempfile.TemporaryDirectory() as tmp:
        src, out, ck = (Path(tmp) / n for n in ("src.png", "out.json",
                                                "ck.npz"))
        Image.fromarray(img, "RGBA").save(src)
        wrappers = _zero_counts()
        rc1, log1, s1 = _cli([src, out, "--opt-profile", "balanced",
                              *FAST_GEOMETRY, "--steps", "4", "--dump-every",
                              "2", "--checkpoint", ck], quiet=True)
        rc2, log2, s2 = _cli([src, out, "--resume", ck, "--steps", "4",
                              "--checkpoint", ck], quiet=True)
        launches = _read_counts(wrappers, "host-stepped", (a, b, c))
        check(rc1 == rc2 == 0, f"the host-stepped CLI exited {rc1}, {rc2}")
        dumps = [ln for ln in log1 if "Mid-run output written" in ln]
        check(len(dumps) == 2, f"{len(dumps)} mid-run dumps in 4 steps")
        state, _, meta = load_checkpoint(str(ck), "cuda")
        errors = meta["errors"]
        check(meta["step"] == 8, f"the resumed checkpoint says step "
              f"{meta['step']}")
        check(errors == balanced["errors"],
              f"host-stepped 4 + resumed 4 gave {errors}, run_fused "
              f"{balanced['errors']}")
        check(out.read_text() == state_to_json(balanced["state"], config),
              "the resumed run ended in another state than run_fused's")
    print(f"phase 34 host-stepped: cli balanced --steps 4 --dump-every 2 "
          f"({s1:.3f} s, 2 mid-run dumps) then --resume --steps 4 "
          f"({s2:.3f} s): step errors {errors} equal phase 4's run_fused to "
          f"the bit, JSON equal; launches {launches}; card '{smi}'",
          flush=True)
    return launches


def phase_interactive(img, smi):
    """`--reassign-tiles` (two clicks at start), `--reassign-every 2
    --dump-every 2` and `-v` (one log line a visit, through the per-visit
    path) on 2 balanced steps."""
    import json as _json
    import tempfile
    from pathlib import Path

    from PIL import Image

    a, b, c, *_ = WRAPPERS
    with tempfile.TemporaryDirectory() as tmp:
        src, out, tiles = (Path(tmp) / n for n in ("src.png", "out.json",
                                                   "tiles.txt"))
        Image.fromarray(img, "RGBA").save(src)
        tiles.write_text("# two clicks\n3 5\n0 0 1\n")
        wrappers = _zero_counts()
        rc, log, secs = _cli([src, out, "--opt-profile", "balanced",
                              *FAST_GEOMETRY, "--steps", "2",
                              "--reassign-tiles", tiles, "--reassign-every",
                              "2", "--dump-every", "2", "-v"], quiet=True)
        launches = _read_counts(wrappers, "interactive", (a, b, c))
        check(rc == 0, f"the interactive CLI exited {rc}")
        steps = [ln.rsplit(" ", 1)[1] for ln in log
                 if "] step " in ln and " error: " in ln]
        counts = {text: sum(text in ln for ln in log) for text in (
            "] slot (", "Applied 2 tile reassignments", "tiles reassigned",
            "Mid-run output written")}
        check(counts == {"] slot (": 2 * 8 * 15 * 3,
                         "Applied 2 tile reassignments": 1,
                         "tiles reassigned": 1,
                         "Mid-run output written": 1} and len(steps) == 2,
              f"interactive log lines {counts}, steps {steps}")
        out_json = _json.loads(out.read_text())
        check(len(out_json["tiles"]) == 1024, "interactive JSON")
    print(f"phase 35 interactive: --reassign-tiles + --reassign-every 2 "
          f"--dump-every 2 -v on 2 balanced steps exit 0 in {secs:.3f} s, "
          f"log lines {counts}, step errors {steps}; launches {launches}; "
          f"card '{smi}'", flush=True)
    return launches


def phase_hybrid(img, smi):
    """`run_fused_hybrid` with the CLI's two configs: phase 1 the `fast`
    recipe, phase 2 the `hybrid` profile's explore polish from phase 1's
    step count in the stream, capped at HYBRID_STEPS."""
    from snesimage_torch.cli import OPT_PROFILES
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine

    a, b, c, *_ = WRAPPERS
    fast = QuantConfig(**fast_params(max_steps=HYBRID_STEPS[0]))
    quality = QuantConfig(**dict(OPT_PROFILES["hybrid"][1], seed=0,
                                 subpalette_count=8, subpalette_size=15,
                                 max_steps=HYBRID_STEPS[1]))
    init, _ = prepared_state(img, fast_params())
    err0 = float(refine.frame_error_fused(
        init, fast, refine.make_reference_pyramid(init)))
    wrappers = _zero_counts()
    _, errors, info = pipeline.run_fused_hybrid(img, fast, quality,
                                                device="cuda")
    launches = _read_counts(wrappers, "hybrid", (a, b, c))
    k1, k2 = info["phase_steps"]
    check(1 <= k1 <= HYBRID_STEPS[0] and k2 == HYBRID_STEPS[1]
          and len(errors) == k1 + k2, f"hybrid phase steps {(k1, k2)}")
    check(all(b <= a for a, b in zip([err0] + errors, errors))
          and errors[-1] < err0, f"hybrid step errors {errors}")
    print(f"phase 36 hybrid: phase steps {(k1, k2)}, init error {err0}, "
          f"step errors {errors}, {info['total_seconds']:.3f} s; launches "
          f"{launches}; card '{smi}'", flush=True)
    return launches


# Kernel names in a trace of the fast path: A's prologue, B, C.
TRACE_KERNELS = ("prologue_kernel", "multiscale_kernel",
                 "coarse_redmean_kernel")


def phase_profile_dir(img, smi):
    """`cli --opt-profile fast -c 2 -s 3 --steps 1 --profile-dir DIR` (a
    small palette keeps the trace short): the trace (torch.profiler,
    Chrome format) names kernels A, B and C."""
    import tempfile
    from pathlib import Path

    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        src, out, prof = (Path(tmp) / n for n in ("src.png", "out.json",
                                                  "prof"))
        Image.fromarray(img, "RGBA").save(src)
        rc, _, secs = _cli([src, out, "--opt-profile", "fast", "-c", "2",
                            "-s", "3", "--steps", "1", "--profile-dir",
                            prof], quiet=True)
        check(rc == 0, f"cli --profile-dir exited {rc}")
        events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    named = {k: sum(k in e["name"] for e in kernels) for k in TRACE_KERNELS}
    check(all(named.values()), f"the trace's kernels {named}")
    print(f"phase 37 profile-dir: {len(kernels)} kernel events of "
          f"{len(events)}, by kernel {named}, {secs:.3f} s; card '{smi}'",
          flush=True)


# The three-level prescreen's pre-rank keeps this many candidates
# (`prescreen_pre`; the JAX package's tests use 16 too).
PRESCREEN_PRE = 16
FRAME_TOL = 1e-6  # kernels C and D vs twins, the three-level quarter frames
THREE_LEVEL = ("coarse_feature_sums_redmean", "coarse_feature_sums_ciede")


def _three_level_bound(args, frames, out_bytes: int, px_ops: float):
    """Bound of a coarse kernel call in the three-level mode: C's or D's
    pooling of every pixel and quarter cell, the 2x2 means, the metric on
    scales 3-5, the operands read once and the sums, planes and quarter
    frames written once."""
    *planes, flat_refs = args
    b, (h, w) = planes[1].shape[0], planes[3].shape
    n_q = (h // 4) * (w // 4)
    sizes = [(h >> s) * (w >> s) for s in range(3, 6)]
    return bound(
        nbytes(*planes, *flat_refs, frames) + out_bytes,
        b * h * w * px_ops + b * n_q * 9 + b * sizes[0] * 3 * 4
        + metric_ops(b, sizes),
    )


def _same_launches(label: str, wrapper, args, mode: dict) -> None:
    """`wrapper` at N = 2 images against its N = 1 launches, bit for bit."""
    both = wrapper(*_rows(args, 2), **mode)
    for n in range(2):
        one = wrapper(*_rows(args, (n, n + 1)), **mode)
        check(all(torch.equal(a[n:n + 1], b) for a, b in zip(both, one)),
              f"{label}: image {n} of N = 2 differs from its own launch")


def phase_three_level_kernels(img, b_record):
    """Kernels C and D in their three-level mode (pre_ds=1, emit_frames)
    against their twins at the first visits of the balanced and perceptual
    paths (B = 48, 256x256): the sums of scales 3-5, the quarter frames
    (bit-equal or within FRAME_TOL), D's distance planes (bit-equal); at
    N = 2 images against the N = 1 launches; device ms beside the two-level
    mode's. Then kernel B at the three-level visit's shapes: scale 2 alone
    on the PRESCREEN_PRE survivors' quarter frames (64x64), and scales 3-5
    with pre_ds=1 on 256x240's 60x64 quarter frames (kernel E's). Returns
    C's and D's three-level records."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_metric, cuda_prescreen
    from snesimage_torch.ops.color import expand_5bit_to_8bit, srgb_u8_to_linear
    from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums

    mode = dict(pre_ds=1, emit_frames=True)
    sizes = [(256 >> s) ** 2 for s in range(3, 6)]
    records, survivors = [], None
    for perceptual, params, wrapper, twin, source, line in (
            (False, BALANCED, cuda_metric.coarse_feature_sums_redmean,
             cuda_metric._coarse_plain, "coarse_redmean.cu", 522),
            (True, PERCEPTUAL, cuda_metric.coarse_feature_sums_ciede,
             cuda_metric._coarse_ciede_plain, "coarse_ciede.cu", 594)):
        _, refp, ctx, cand8, cand_lin = first_visit(img, params)
        args = refine.coarse_inputs(ctx, cand8, cand_lin, refp, 3)
        two_args = refine.coarse_inputs(ctx, cand8, cand_lin, refp)
        got, want = wrapper(*args, **mode), twin(*args, **mode)
        feat_err = max_err(finalize_feature_sums(got[0], sizes, 3),
                           finalize_feature_sums(want[0], sizes, 3),
                           FEATURE_TOL)
        frame_err = max_err(got[-1], want[-1], FRAME_TOL)
        if perceptual:
            check(torch.equal(got[1], want[1]),
                  "kernel D's three-level distance planes differ from the "
                  "twin's")
        again = wrapper(*args, **mode)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{wrapper.__name__} (three-level) gave other bits a second "
              "time")
        if survivors is None:
            survivors = (refp, got[-1][:PRESCREEN_PRE].contiguous())
        states, _, brefp, bctx, cand5 = _batch_visit(params)
        b8 = expand_5bit_to_8bit(cand5)
        _same_launches(f"{wrapper.__name__} (three-level)", wrapper,
                       refine.coarse_inputs(bctx, b8, srgb_u8_to_linear(b8),
                                            brefp, 3), mode)
        kernel = lambda: wrapper(*args, **mode)  # noqa: E731
        records.append(dict(
            name=f"{wrapper.__name__}_three_level", route="cuda",
            source=f"snesimage_torch/csrc/{source}",
            replaces=f"snesimage_tpu/ops/pallas_metric.py:{line}",
            mode="pre_ds=1, emit_frames=True",
            max_abs_err=max(feat_err, frame_err), feature_max_abs_err=feat_err,
            frame_max_abs_err=frame_err,
            frames_bit_equal=torch.equal(got[-1], want[-1]),
            ms=median_ms(kernel), device_ms=device_ms(kernel),
            two_level_device_ms=device_ms(lambda: wrapper(*two_args)),
            blocks_per_candidate=cuda_metric.CLUSTER_BLOCKS,
            active_clusters=cuda_metric.active_clusters(perceptual, 256, 256,
                                                        1),
            plain_ms=median_ms(lambda: twin(*args, **mode)),
            library_ms=None,
            shape="B=48, 256x256 -> scales 3-5, quarter frames"
                  + (" and distance planes" if perceptual else ""),
            **_three_level_bound(args, got[-1], nbytes(*got[:-1]),
                                 CIEDE_OPS_PER_PX if perceptual
                                 else REDMEAN_OPS_PER_PX),
        ))
    refp, frames_q = survivors
    img240 = np.ascontiguousarray(img[:240])
    _, refp240, ctx240, cand8, cand_lin = first_visit(img240, GEOMETRY)
    pooled = cuda_prescreen.pooled_wins_redmean(
        *refine.pooled_inputs(ctx240, cand8))
    frames240 = cuda_prescreen.coarse_frames(
        pooled, cand_lin, refine.ds4_no_candidate(ctx240)).contiguous()
    cases = [
        _b_case(f"B={PRESCREEN_PRE}, 64x64 quarter frames, scale 2", refp,
                frames_q, 2, 1, 0),
        _b_case("B=48, 60x64 quarter frames, pre_ds=1, scales 3-5",
                refp240, frames240, 3, 3, 1),
    ]
    b_record.update(_b_record(b_record["cases"] + cases))
    _print_records("phase 38", records)
    print("phase 38 kernels C and D three-level vs two-level device ms: "
          + "; ".join(f"{r['name']} {r['device_ms']:.4f} ms (two-level "
                      f"{r['two_level_device_ms']:.4f} ms), frames bit-equal "
                      f"{r['frames_bit_equal']}, frames max_abs_err "
                      f"{r['frame_max_abs_err']:.3g}, N=2 bit-equal to N=1, "
                      f"active clusters {r['active_clusters']}"
                      for r in records), flush=True)
    _print_b_cases("phase 38", "at the three-level visit's shapes", cases)
    return records


def _run_checked(label: str, img, params: dict, present: tuple,
                 frame_kernel=None):
    """One run of a path through `run_fused` with the counts set to 0 just
    before it and read just after: its step errors never rise and end below
    the init's. `frame_kernel` must have launched in its three-level mode.
    Returns (errors, seconds, launches, three-level launches, init error)."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine

    config = QuantConfig(**params)
    init, _ = prepared_state(img, params)
    err0 = float(refine.frame_error_fused(
        init, config, refine.make_reference_pyramid(init)))
    wrappers = _zero_counts()
    _, errors, info = pipeline.run_fused(img, config, device="cuda")
    launches = _read_counts(wrappers, label, present)
    frames = {name: wrappers[name].frame_launches for name in THREE_LEVEL}
    if frame_kernel is not None:
        check(frames[frame_kernel] > 0,
              f"the {label} path never ran {frame_kernel}'s three-level mode")
    check(all(np.isfinite(errors)), f"{label}: non-finite step error")
    check(all(b <= a for a, b in zip([err0] + errors, errors)),
          f"{label}: step errors increase")
    check(errors[-1] < err0, f"{label}: no improvement on {err0}")
    return errors, info["total_seconds"], launches, frames, err0


def phase_three_level_runs(img, smi, balanced: dict):
    """The three-level prescreen (`prescreen_pre`) on three paths: the
    balanced recipe at 256x256 for 4 steps (kernel C's three-level mode),
    the perceptual one for 2 steps (D's), and the balanced one at 256x240
    for 2 steps (kernels E and B)."""
    a, b, c, d, e, _, _ = WRAPPERS
    img240 = np.ascontiguousarray(img[:240])
    runs, frames = {}, {}
    for key, label, image, params, present, kernel in (
            ("three_level", "three-level balanced", img,
             dict(BALANCED, prescreen_pre=PRESCREEN_PRE, max_steps=4),
             (a, b, c), c),
            ("three_level_perceptual", "three-level perceptual", img,
             dict(PERCEPTUAL, prescreen_pre=PRESCREEN_PRE, max_steps=2),
             (a, b, d), d),
            ("three_level_240", "three-level 256x240", img240,
             dict(GEOMETRY, prescreen_pre=PRESCREEN_PRE, max_steps=2),
             (a, b, e), None)):
        errors, secs, launches, frames[key], err0 = _run_checked(
            label, image, params, present, kernel)
        runs[key] = launches
        print(f"phase 39 {label}: prescreen_pre {PRESCREEN_PRE}, "
              f"{len(errors)} steps, {secs:.3f} s, init error {err0}, step "
              f"errors {errors}, launches {launches}, three-level launches "
              f"{frames[key]}" + (
                  f" (the two-level balanced run: 8 steps "
                  f"{balanced['seconds']:.3f} s, step errors "
                  f"{balanced['errors'][:4]}...)" if key == "three_level"
                  else "") + f"; card '{smi}'", flush=True)
    return runs, frames


def phase_gate_coarse(img, smi, balanced: dict):
    """`cli --opt-profile fast --gate-coarse -c 8 -s 15` to its stop (an
    exact sweep's sub-tolerance step, or the profile's 10 steps): the
    coarse gate before the rank-1 gate; the share of visits each gate
    closed."""
    import tempfile
    from pathlib import Path

    from PIL import Image

    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import refine
    from snesimage_torch.io.checkpoint import load_checkpoint
    from snesimage_torch.io.json_out import state_to_json

    a, b, c, *_ = WRAPPERS
    params = fast_params(gate_coarse=True)
    config = QuantConfig(**params)
    init, _ = prepared_state(img, params)
    err0 = float(refine.frame_error_fused(
        init, config, refine.make_reference_pyramid(init)))
    with tempfile.TemporaryDirectory() as tmp:
        src, out, ck = (Path(tmp) / n for n in ("src.png", "out.json",
                                                "ck.npz"))
        Image.fromarray(img, "RGBA").save(src)
        wrappers = _zero_counts()
        with refine.gate_tally() as tally:
            rc, _, secs = _cli([src, out, "--opt-profile", "fast",
                                "--gate-coarse", *FAST_GEOMETRY,
                                "--checkpoint", ck])
        launches = _read_counts(wrappers, "fast --gate-coarse", (a, b, c))
        check(rc == 0, f"cli --opt-profile fast --gate-coarse exited {rc}")
        state, _, meta = load_checkpoint(str(ck), "cuda")
        check(out.read_text() == state_to_json(state, config),
              "the --gate-coarse CLI's JSON is not its checkpoint's state")
    errors = meta["errors"]
    exact = _check_fast_run("fast --gate-coarse", config, errors, err0,
                            may_run_out=True)
    visits = max(tally["visits"], 1)
    coarse = (0 if tally["closed_coarse"] is None
              else int(tally["closed_coarse"]))
    print(f"phase 40 fast --gate-coarse: cli 256x256 8x15 exit 0, "
          f"{len(errors)} steps, ended by an exact sweep {exact}, init error "
          f"{err0}, step errors {errors}, closed coarse gates "
          f"{coarse / visits:.4f} and closed rank-1 gates "
          f"{_gate_share(tally):.4f} of {tally['visits']} gated visits, "
          f"{secs:.3f} s (the balanced run {balanced['seconds']:.3f} s); "
          f"launches {launches}; card '{smi}'", flush=True)
    return launches


def _g_sweep_ms(img, params: dict, rows=(8, 48)) -> list:
    """Kernel G's device ms per channel sweep with each of `rows`
    candidates a visit: its device ms at the first visit's shape times the
    sweep's visits."""
    from snesimage_torch.ops import cuda_dither

    state, config = prepared_state(img, params)
    visits = config.subpalette_count * config.subpalette_size * 3
    out = []
    for n in rows:
        cand5 = visit_candidates(state)[:n].contiguous()
        out.append(visits * device_ms(
            lambda: cuda_dither.dither_remap_candidates(
                state.rgb, state.alpha, state.tile_palettes, state.palette,
                0, 0, cand5, config.perceptual_palettes), runs=10))
    return out


def phase_dither_proxy(img, smi, dithered: dict):
    """The dither proxy (`dither_proxy` 8): the dithered recipe for 2 steps
    and the dithered perceptual one for 1 step, each visit ranking its 48
    candidates by their undithered coarse score (kernel A's prologue and
    kernel C or D) before kernel G remaps the top 8. Kernel G's device ms
    per sweep at 8 rows against 48."""
    a, b, c, d, _, _, g = WRAPPERS
    out = {}
    for key, label, params, present in (
            ("proxy", "dithered, dither_proxy 8",
             dict(DITHER, dither_proxy=8, max_steps=2), (a, b, c, g)),
            ("proxy_perceptual", "dithered perceptual, dither_proxy 8",
             dict(DITHER_PERCEPTUAL, dither_proxy=8, max_steps=1),
             (a, b, d, g))):
        errors, secs, launches, _, err0 = _run_checked(label, img, params,
                                                       present)
        out[key] = launches
        g8, g48 = _g_sweep_ms(img, params)
        print(f"phase 41 {label}: {len(errors)} steps, {secs:.3f} s ("
              + (f"the unproxied dithered run {dithered['seconds']:.3f} s "
                 f"for {len(dithered['errors'])} steps; "
                 if key == "proxy" else "")
              + f"kernel G {g8:.3f} ms device a sweep at 8 rows, {g48:.3f} "
              f"ms at 48), init error {err0}, step errors {errors}, "
              f"launches {launches}; card '{smi}'", flush=True)
    return out


WINDOW = 4  # channel_window of the windowed run


def phase_windows(img, smi):
    """Windowed channel descent: the balanced recipe with `channel_window`
    4 for 8 steps through `pipeline.optimize`, whose `on_step` hook
    (which changes no bit of the run) stamps each sweep's end on the host
    clock; which steps were windowed, and the seconds of a windowed sweep
    against an exhaustive one."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine

    a, b, c, *_ = WRAPPERS
    params = dict(BALANCED, channel_window=WINDOW)
    config = QuantConfig(**params)
    state, _ = prepared_state(img, params)
    refp = refine.make_reference_pyramid(state)
    err0 = float(refine.frame_error_fused(state, config, refp))
    stamps = [time.perf_counter()]
    wrappers = _zero_counts()
    _, errs = pipeline.optimize(
        state, config, refp=refp,
        on_step=lambda *_: stamps.append(time.perf_counter()))
    launches = _read_counts(wrappers, "windowed", (a, b, c))
    errors = [float(e) for e in errs]
    check(len(errors) == config.max_steps, f"{len(errors)} windowed steps")
    check(all(np.isfinite(errors)), "windowed: non-finite step error")
    check(all(y <= x for x, y in zip([err0] + errors, errors)),
          "windowed: step errors increase")
    check(errors[-1] < err0, f"windowed: no improvement on {err0}")
    windowed = [pipeline._is_window_step(config, k)
                for k in range(config.max_steps)]
    check(any(windowed) and not all(windowed), f"windowed steps {windowed}")
    secs = np.diff(stamps)
    win = [float(t) for t, w in zip(secs, windowed) if w]
    full = [float(t) for t, w in zip(secs, windowed) if not w]
    print(f"phase 42 windows: balanced channel_window {WINDOW}, windowed "
          f"steps {[k for k, w in enumerate(windowed) if w]}, seconds a "
          f"sweep {[float(t) for t in secs]}: windowed mean "
          f"{statistics.mean(win):.4f} s, exhaustive mean (after the first) "
          f"{statistics.mean(full[1:]):.4f} s, init error {err0}, step errors "
          f"{errors}, launches {launches}; card '{smi}'", flush=True)
    return launches


# The JAX package's XLA-path runs on the CPU and the port's CPU runs of the
# bench's configs (tests/test_torch_bench.py writes them).
BENCH_FINALS = "tests/data/bench_finals_jax.json"
EXPLORE_FREE_TOL = 1e-3  # the card's explore-free steps 1-2 vs the JAX CPU's
FAST_FINAL_TOL = 1e-4  # the C-9 tie threshold


def phase_bench(img, smi, balanced: dict, fast: dict) -> dict:
    """The port's bench and BASELINE runner (`snesimage_torch.bench`,
    `snesimage_torch.benchmarks`), each path driven with the counts set to
    0 just before it and read just after. `bench.measure` once of the
    balanced recipe, whose step errors must equal phase 4's run to the
    bit, and once of `fast`, which must stop after phase 33's steps within
    FAST_FINAL_TOL of its final; the balanced init hash; the bench's JSON
    line from these runs. Then balanced at seeds 1 and 2 beside the frozen
    JAX CPU and port CPU finals (a report: the port draws its own explore
    candidates), and balanced without explore, which draws nothing: its
    first two steps within EXPLORE_FREE_TOL of the JAX CPU's. Last
    `benchmarks.main` at one step and a batch of 16: a line of the card,
    then one for each of c1-c5 with a finite final error."""
    import contextlib
    import io
    from pathlib import Path

    from snesimage_torch import bench, benchmarks
    from snesimage_torch.config import QuantConfig

    a, b, c, _, _, f, g = WRAPPERS
    frozen = json.loads((Path(__file__).parent / BENCH_FINALS).read_text())
    jax, port_cpu = frozen["jax_cpu"], frozen["port_cpu"]
    runs = {}

    def measured(label, params):
        wrappers = _zero_counts()
        out = bench.measure(img, QuantConfig(**params), repeats=1)
        runs[label] = _read_counts(wrappers, label, (a, b, c))
        check(all(np.isfinite(out["step_errors"])),
              f"{label}: non-finite step error")
        return out

    run = measured("bench_balanced", bench.BALANCED)
    check(run["step_errors"] == balanced["errors"],
          f"bench balanced {run['step_errors']} != phase 4's "
          f"{balanced['errors']}")
    fast_run = measured("bench_fast", bench.FAST)
    check(len(fast_run["step_errors"]) == len(fast["errors"])
          and abs(fast_run["final_error"] - fast["errors"][-1])
          <= FAST_FINAL_TOL,
          f"bench fast {fast_run['step_errors']} against phase 33's "
          f"{fast['errors']}")
    hash_ok = (bench.init_hash_of(img, QuantConfig(**bench.BALANCED))
               == INIT_HASH)
    check(hash_ok, "the bench's balanced init hash")
    line = bench.result_line(run, fast_run, smi, hash_ok)

    seeds = {0: run["final_error"]}
    for s in (1, 2):
        seeds[s] = measured(f"bench_seed{s}",
                            dict(bench.BALANCED, seed=s))["final_error"]
    free = measured("bench_explore0",
                    dict(bench.BALANCED, channel_explore=0))["step_errors"]
    want = jax["balanced_explore0"]["step_errors"]
    gaps = [abs(x - y) for x, y in zip(free, want)]
    check(len(free) == len(want) == bench.BALANCED["max_steps"],
          f"{len(free)} explore-free steps")
    check(max(gaps[:2]) <= EXPLORE_FREE_TOL,
          f"explore-free steps {free[:2]} vs the JAX CPU's {want[:2]}")
    # The first step at which the card parts from the JAX CPU run.
    parts = next((k for k, gap in enumerate(gaps)
                  if gap > EXPLORE_FREE_TOL), None)
    cpu_gaps = [abs(x - y) for x, y in
                zip(free, port_cpu["balanced_explore0"]["step_errors"])]

    wrappers = _zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = benchmarks.main(["--steps", "1", "--batch", "16", "--chunk",
                              "16"])
    secs = time.perf_counter() - t0
    runs["benchmarks"] = _read_counts(wrappers, "benchmarks", (a, b, f, g))
    check(rc == 0, f"benchmarks.main exited {rc}: {buf.getvalue()}")
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    check(len(lines) == 6 and lines[0] == {"device": smi},
          f"benchmarks printed {lines}")
    for out in lines[1:5]:
        check(np.isfinite(out["final_error"]), f"benchmarks: {out}")
    check(np.isfinite(lines[5]["mean_final_error"])
          and lines[5]["images_per_sec"] > 0, f"benchmarks: {lines[5]}")

    jax_finals = [jax[f"balanced_seed{s}"]["final_error"] for s in range(3)]
    cpu_finals = [port_cpu[f"balanced_seed{s}"]["final_error"]
                  for s in range(3)]
    print(f"phase 43 bench: balanced {run['seconds']:.3f} s, step errors "
          f"equal phase 4's; fast {fast_run['seconds']:.3f} s, "
          f"{len(fast_run['step_errors'])} steps, final "
          f"{fast_run['final_error']} (phase 33: {fast['errors'][-1]}); init "
          f"hash ok; balanced finals at seeds 0-2: card "
          f"{[seeds[s] for s in range(3)]} mean "
          f"{statistics.mean(seeds.values())}, JAX CPU {jax_finals} mean "
          f"{statistics.mean(jax_finals)} spread "
          f"{max(jax_finals) - min(jax_finals)}, port CPU {cpu_finals} mean "
          f"{statistics.mean(cpu_finals)}; without explore: card {free}, JAX "
          f"CPU {want}, largest gap {max(gaps)}, first step above "
          f"{EXPLORE_FREE_TOL}: {parts}; port CPU largest gap "
          f"{max(cpu_gaps)}; launches {runs}; card '{smi}'", flush=True)
    print(f"phase 43 benchmarks ({secs:.3f} s, launches "
          f"{runs['benchmarks']}): " + " | ".join(json.dumps(x)
                                                  for x in lines),
          flush=True)
    print(f"phase 43 bench line: {json.dumps(line)}", flush=True)
    return runs


# Sweeps a path runs in each mode of phase 44: at least three, so that two
# replays of one graph chain.
GRAPH_STEPS = 3
# The balanced run's first and last step errors (phase 4), unchanged since
# the balanced path first ran on the card.
BALANCED_ENDS = (131.4586, 118.0944)


def _digest(state) -> str:
    import hashlib

    return hashlib.sha1(state.palette.cpu().numpy().tobytes()
                        + state.palette_map.cpu().numpy().tobytes()
                        + state.tile_palettes.cpu().numpy().tobytes()
                        ).hexdigest()


def _graph_case(label: str, run, present: tuple, regrow=None) -> dict:
    """One path driven three times through `pipeline.optimize`: eagerly
    (`run(True)`), graphed (which captures where its keys have no graph
    yet), and graphed again, where every sweep must replay; with `regrow`
    a fourth graphed run after `regrow()` has grown kernel B's tile
    scratch. Each run with the counts set to 0 just before it and read just
    after. Every graphed run's step errors, final state, launches, three-
    level launches and `run`'s extra readings (gate tallies, hook dumps)
    must equal the eager run's. Returns the seconds a sweep of each run."""
    from snesimage_torch.core import graphs

    modes = ("eager", "graphed", "replayed") + (("regrown",) if regrow
                                                else ())
    out, secs = {}, {}
    for mode in modes:
        if mode == "regrown":
            regrow()
        replays = sum(g["replays"] for g in graphs.stats())
        wrappers = _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, errs, extra = run(mode == "eager")
        errs = errs.cpu()  # waits for the card
        secs[mode] = time.perf_counter() - t0
        launches = _read_counts(wrappers, f"{label} {mode}", present)
        frames = {n: wrappers[n].frame_launches for n in THREE_LEVEL}
        replayed = sum(g["replays"] for g in graphs.stats()) - replays
        out[mode] = (errs, _digest(state), launches, frames, extra, replayed)
    errs0, digest0, launches0, frames0, extra0, replayed0 = out["eager"]
    sweeps = len(errs0)
    check(sweeps >= GRAPH_STEPS, f"{label}: {sweeps} sweeps")
    check(bool(torch.isfinite(errs0).all()), f"{label}: non-finite error")
    check(replayed0 == 0, f"{label}: the eager run replayed {replayed0}")
    for mode in modes[1:]:
        errs, digest, launches, frames, extra, replayed = out[mode]
        check(torch.equal(errs, errs0),
              f"{label} {mode} step errors {errs.tolist()} != eager "
              f"{errs0.tolist()}")
        check(digest == digest0, f"{label} {mode}: another final state")
        check(launches == launches0 and frames == frames0,
              f"{label} {mode} launches {launches} {frames} != eager "
              f"{launches0} {frames0}")
        check(extra == extra0, f"{label} {mode}: {extra} != eager {extra0}")
    check(out["replayed"][5] == sweeps,
          f"{label}: {out['replayed'][5]} of {sweeps} sweeps replayed")
    return {"sweeps": sweeps, "errors": errs0[:, 0].tolist()
            if errs0.dim() == 2 else errs0.tolist(), "launches": launches0,
            "seconds_a_sweep": {m: secs[m] / sweeps for m in modes}}


def _profiled_replay(run) -> tuple:
    """`run()` (one replayed sweep) under torch.profiler: (its kernel events
    by wrapper, from the wrappers' kernel names in core/graphs.py
    `_KERNEL_NAMES`, less kernel B's second launches; what the run added
    to the wrappers' counters). A reading beside the counts, not a check:
    in a fresh process the two agreed on three paths, in this script's
    process the profiler has seen one of kernel B's 721 launches fewer
    (PERF.md §7)."""
    from torch.profiler import ProfilerActivity, profile

    from snesimage_torch.core import graphs

    b = graphs._wrappers()[1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        before = graphs._counts()
        run()
        torch.cuda.synchronize()
    after = graphs._counts()
    added = {fn.__name__: n - before[fn, name]
             for (fn, name), n in after.items() if name == "launches"}
    events = dict.fromkeys(added, 0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for fn, names in zip(graphs._wrappers(), graphs._KERNEL_NAMES):
            if any(n in e.name for n in names):
                events[fn.__name__] += 1
    events[b.__name__] -= (after[b, "split_launches"]
                           - before[b, "split_launches"])
    return events, added


def phase_graphs(img, smi, balanced: dict) -> None:
    """The compiled sweep (core/graphs.py): every path driven eagerly and
    graphed through `pipeline.optimize` (`_graph_case`), bit for bit: the
    balanced, perceptual, dithered and dithered perceptual recipes, the
    three 256x240 paths, the reference cycle, `nes-compat`, a config 5
    batch of 16, `robust` (K = 2), `fast` (inside `gate_tally`, whose counts
    must agree), host-stepped + resume (an `on_step` hook that digests each
    step's state, then a resumed run), tile reassignment (a replacement
    state from `on_step_state` and `reassign_every` 2), a windowed and a
    three-level run. Between two replays of the balanced graph kernel B's
    tile scratch grows by a larger call (ROADMAP C-12). The graphs are
    dropped before each path and captured at a key's second sweep
    (`graphs.CAPTURE_LEFT` 1 for the phase). Prints each path's seconds a
    sweep eager and graphed, and each graph's capture, node count and
    instantiation seconds, nodes and kernel nodes."""
    from snesimage_torch.cli import OPT_PROFILES
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import graphs, pipeline, refine
    from snesimage_torch.core.state import shared_states
    from snesimage_torch.models.presets import preset_fields
    from snesimage_torch.ops import cuda_metric
    from snesimage_torch.ops.ssimulacra2 import (
        NUM_SCALES,
        fused_scale_feature_block,
        shared_pyramid,
    )
    from snesimage_torch.parallel import batch as pb
    from snesimage_torch.testing import bench_image

    a, b, c, d, e, f, g = WRAPPERS
    img240 = np.ascontiguousarray(img[:240])
    check([round(balanced["errors"][k], 4) for k in (0, -1)]
          == list(BALANCED_ENDS),
          f"phase 4's step errors {balanced['errors']}")

    def optimize_run(state, config, refp, steps=GRAPH_STEPS, **kw):
        def run(eager):
            st, errs = pipeline.optimize(state, config, refp=refp,
                                         max_steps=steps, eager=eager, **kw)
            return st, errs, None
        return run

    def single(image, params, steps=GRAPH_STEPS, **kw):
        state, config = prepared_state(image, params)
        return optimize_run(state, config,
                            refine.make_reference_pyramid(state), steps, **kw)

    def tallied(run):
        def go(eager):
            with refine.gate_tally() as tally:
                st, errs, _ = run(eager)
            return st, errs, (tally["visits"], _gate_share(tally))
        return go

    def host_stepped(eager):
        state, config = prepared_state(img, BALANCED)
        refp = refine.make_reference_pyramid(state)
        dumps = []
        st, errs1 = pipeline.optimize(
            state, config, refp=refp, max_steps=GRAPH_STEPS, eager=eager,
            on_step=lambda step, s, _: dumps.append((step, _digest(s))))
        st, errs2 = pipeline.optimize(st, config, refp=refp,
                                      start_step=GRAPH_STEPS,
                                      max_steps=GRAPH_STEPS, eager=eager)
        return st, torch.cat([errs1, errs2]), dumps

    def reassigned(eager):
        state, config = prepared_state(img, BALANCED)

        def click(step, st, _):
            if step == 0:
                return pipeline.apply_tile_reassignments(
                    st, config, [(0, 0), (5, 5, 1), (31, 31)])
            return None

        return optimize_run(state, config,
                            refine.make_reference_pyramid(state), 4,
                            reassign_every=2, on_step_state=click)(eager)

    def regrow():
        """Kernel B on more frames than its tile scratch holds: the
        scratch grows, and the buffer the balanced graph captured must
        stay alive."""
        dev = torch.device("cuda", torch.cuda.current_device())
        old = cuda_metric._TILE_SCRATCH[dev]
        frames = old[0].numel() // (80 * 18) + 8  # 80 tiles a 256x256 frame
        state, _ = prepared_state(img, BALANCED)
        fused_scale_feature_block(
            refine.make_reference_pyramid(state),
            torch.rand((frames, 3, 256, 256), device=dev), 0, NUM_SCALES)
        new = cuda_metric._TILE_SCRATCH[dev]
        check(new[0].numel() > old[0].numel()
              and any(kept[0] is old[0] for kept in cuda_metric._OUTGROWN),
              "kernel B's tile scratch did not grow, or dropped its buffer")

    nes = dict(preset_fields("nes-compat"), converge_tol=0.0, seed=0)
    nes_config = QuantConfig(**nes)
    images = np.stack([bench_image(int(s)) for s in _batch_seeds()[:16]])
    states = pb.bcluster(pb.binit(pb.make_batched_states(
        images, nes_config, "cuda"), nes_config), nes_config)
    robust = dict(OPT_PROFILES["robust"][1], subpalette_count=8,
                  subpalette_size=15, seed=0)
    seed_state, robust_config = prepared_state(img, robust)
    cases = (
        ("balanced", single(img, BALANCED), (a, b, c), regrow),
        ("perceptual", single(img, PERCEPTUAL), (a, b, d), None),
        ("dithered", single(img, DITHER), (a, b, g), None),
        ("dithered perceptual", single(img, DITHER_PERCEPTUAL), (a, b, g),
         None),
        ("256x240", single(img240, GEOMETRY), (a, b, e), None),
        ("256x240 perceptual", single(img240, GEOMETRY_PERCEPTUAL),
         (a, b, f), None),
        ("256x240 dithered", single(img240, GEOMETRY_DITHER), (a, b, g),
         None),
        ("reference cycle", single(img, REFERENCE, 5), (a, b), None),
        ("nes-compat", single(img, nes), (a, b), None),
        ("config 5 batch of 16", optimize_run(
            states, nes_config, pb.brefp(states, nes_config), gate=False),
         (a, b), None),
        ("robust K=2", optimize_run(
            shared_states(seed_state, 2), robust_config,
            shared_pyramid(refine.make_reference_pyramid(seed_state), 2),
            gate=False), (a, b, c), None),
        ("fast", tallied(single(img, fast_params(), 5)), (a, b, c), None),
        ("host-stepped + resume", host_stepped, (a, b, c), None),
        ("reassigned tiles", reassigned, (a, b, c), None),
        ("windowed", single(img, dict(BALANCED, channel_window=WINDOW), 4),
         (a, b, c), None),
        ("three-level", single(img, dict(BALANCED,
                                         prescreen_pre=PRESCREEN_PRE)),
         (a, b, c), None),
    )
    results = {}
    capture_left = graphs.CAPTURE_LEFT
    graphs.CAPTURE_LEFT = 1
    try:
        for label, run, present, regrow_fn in cases:
            graphs.clear()
            results[label] = _graph_case(label, run, present, regrow_fn)
            per = results[label]["seconds_a_sweep"]
            print(f"phase 44 graphs: {label}, {results[label]['sweeps']} "
                  f"sweeps each way, bits equal eager; seconds a sweep "
                  + ", ".join(f"{m} {t:.4f}" for m, t in per.items())
                  + f", step errors {results[label]['errors']}, launches "
                  f"{results[label]['launches']}; graphs: " + "; ".join(
                      f"{gr['label']} capture {gr['capture_s']:.3f} s "
                      f"count {gr['count_s']:.3f} s instantiate "
                      f"{gr['instantiate_s']:.3f} s, {gr['nodes']} nodes, "
                      f"{gr['kernel_nodes']} kernels, replays "
                      f"{gr['replays']}" for gr in graphs.stats())
                  + f"; card '{smi}'", flush=True)
        # One replayed balanced sweep under the profiler, beside the
        # launches it counted (`_profiled_replay`).
        state, config = prepared_state(img, BALANCED)
        refp = refine.make_reference_pyramid(state)
        pipeline.optimize(state, config, refp=refp, max_steps=2)
        events, added = _profiled_replay(lambda: pipeline.optimize(
            state, config, refp=refp, max_steps=1))
        print(f"phase 44 profiled replay: one balanced sweep (its initial "
              f"error eagerly), kernel events {events}, launches counted "
              f"{added}; card '{smi}'", flush=True)
    finally:
        graphs.CAPTURE_LEFT = capture_left
    # Whether the graphs kept alive slow the eager sweeps: the balanced
    # run eagerly with them, then with none.
    eager = single(img, BALANCED)
    kept = len(graphs.stats())
    seconds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager(True)[1].cpu()
        seconds.append((time.perf_counter() - t0) / GRAPH_STEPS)
        graphs.clear()
    print(f"phase 44 eager balanced sweep with {kept} graphs kept "
          f"{seconds[0]:.4f} s, with none {seconds[1]:.4f} s; card '{smi}'",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from snesimage_torch.testing import bench_image

    t_start = time.perf_counter()
    img = bench_image(0)
    smi, name = phase_device()
    records = phase_kernels(img)
    a, b, c, d, e, f, g = WRAPPERS
    runs, balanced, dithered = {}, {}, {}
    init_state = phase_init_hash(img, BALANCED, INIT_HASH, "phase 3")
    runs["balanced"] = phase_main_path(
        img, init_state, smi, BALANCED, "phase 4", "balanced", (a, b, c), 1,
        record=balanced)
    records.append(phase_kernel_d(img, records[0]))
    init_state = phase_init_hash(img, PERCEPTUAL, INIT_HASH_PERCEPTUAL,
                                 "phase 6")
    runs["perceptual"] = phase_main_path(
        img, init_state, smi, PERCEPTUAL, "phase 7", "perceptual", (a, b, d),
        0)
    by_name = {r["name"]: r for r in records}
    records.append(phase_kernel_g(img, by_name["select_colors"],
                                  by_name["multiscale_feature_sums"]))
    init_state = phase_init_hash(img, DITHER, INIT_HASH_DITHER, "phase 10")
    runs["dither"] = phase_main_path(
        img, init_state, smi, DITHER, "phase 11", "dithered", (a, b, g), 0,
        record=dithered)
    init_state = phase_init_hash(img, DITHER_PERCEPTUAL,
                                 INIT_HASH_DITHER_PERCEPTUAL, "phase 12")
    runs["dither_perceptual"] = phase_main_path(
        img, init_state, smi, DITHER_PERCEPTUAL, "phase 13",
        "dithered perceptual", (a, b, g), 0)

    img240 = np.ascontiguousarray(img[:240])
    records[-1:-1] = phase_kernels_ef(  # A, B, C, D, E, F, G
        img240, by_name["select_colors"])
    phase_kernel_b_geometry(img240, by_name["multiscale_feature_sums"])
    init_state = phase_init_hash(img240, GEOMETRY, INIT_HASH_240, "phase 16")
    runs["geometry"] = phase_main_path(
        img240, init_state, smi, GEOMETRY, "phase 17", "balanced", (a, b, e),
        0)
    init_state = phase_init_hash(img240, GEOMETRY_PERCEPTUAL,
                                 INIT_HASH_240_PERCEPTUAL, "phase 18")
    runs["geometry_perceptual"] = phase_main_path(
        img240, init_state, smi, GEOMETRY_PERCEPTUAL, "phase 19",
        "perceptual", (a, b, f), 0)
    init_state = phase_init_hash(img, REFERENCE, INIT_HASH, "phase 20")
    runs["reference"] = phase_main_path(
        img, init_state, smi, REFERENCE, "phase 21", "reference schedule",
        (a, b), 0)
    from snesimage_torch.models.presets import preset_fields

    nes = dict(preset_fields("nes-compat"), max_steps=NES_STEPS,
               converge_tol=0.0, seed=0)
    init_state = phase_init_hash(img, nes, INIT_HASH_NES, "phase 22")
    phase_prologue_nes(init_state, nes, by_name["select_colors"])
    runs["nes"] = phase_main_path(
        img, init_state, smi, nes, "phase 23", "nes-compat", (a, b), 0,
        always_replaces=True)
    init_state = phase_init_hash(img240, GEOMETRY_DITHER,
                                 INIT_HASH_240_DITHER, "phase 24")
    runs["geometry_dither"] = phase_main_path(
        img240, init_state, smi, GEOMETRY_DITHER, "phase 25", "dithered",
        (a, b, g), 0)
    phase_kernel_b_unprescreened(img, by_name["multiscale_feature_sums"])
    phase_kernels_geometry_dither(
        img240, by_name["select_colors"], by_name["multiscale_feature_sums"],
        records[-1])
    runs["batch"] = phase_batch(smi, nes)
    runs["robust"] = phase_robust(img, smi, balanced)
    runs["dither_portfolio"] = phase_dither_portfolio(img, smi)
    phase_image_axis(records)
    phase_kernel_b_gate(img, by_name["multiscale_feature_sums"])
    fast = {}
    runs["fast"], runs["fast_240"] = phase_fast(img, smi, balanced, fast)
    runs["host_stepped"] = phase_host_stepped(img, smi, balanced)
    runs["interactive"] = phase_interactive(img, smi)
    runs["hybrid"] = phase_hybrid(img, smi)
    phase_profile_dir(img, smi)
    three_records = phase_three_level_kernels(img, by_name[b])
    three_runs, frames = phase_three_level_runs(img, smi, balanced)
    runs.update(three_runs)
    runs["gate_coarse"] = phase_gate_coarse(img, smi, balanced)
    runs.update(phase_dither_proxy(img, smi, dithered))
    runs["windows"] = phase_windows(img, smi)
    runs.update(phase_bench(img, smi, balanced, fast))
    phase_graphs(img, smi, balanced)
    path_of = {d: "perceptual", g: "dither", e: "geometry",
               f: "geometry_perceptual"}
    for r in records:
        r["launches_by_path"] = {path: n[r["name"]] for path, n in runs.items()}
        r["launches"] = runs[path_of.get(r["name"], "balanced")][r["name"]]
    for r, path in zip(three_records,
                       ("three_level", "three_level_perceptual")):
        wrapper = r["name"].removesuffix("_three_level")
        r["launches_by_path"] = {k: n[wrapper] for k, n in frames.items()}
        r["launches"] = frames[path][wrapper]
    records += three_records
    records.sort(key=lambda r: (WRAPPERS.index(r["name"].removesuffix(
        "_three_level")), r["name"]))
    print(f"all phases: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
