"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from snesimage_torch/csrc, holds each
against its plain PyTorch twin on the card at the main paths' shapes, pins
the init hashes to the JAX package's CPU values, and drives four paths once
each through `run_fused` and `state_to_json`: the balanced profile
(256x256, 8x15 palettes, 8 channel sweeps with 16 explore candidates), the
same recipe with perceptual (CIEDE2000) palettes, the same recipe with
Floyd-Steinberg dithering, and one sweep of the dithered perceptual recipe.
Each phase prints one line. Then come, each on its own line, the kernels'
JSON record and the card's name and power limit; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it.

Each kernel's record holds its wrapper's wall time and its twin's at the
main paths' shapes (`median_ms`), its launches in the run of the path that
uses it (A and B: the balanced run; G: the dithered run;
`launches_by_path` has all four), and its bound: the larger of the bytes
it must move over the card's memory rate and the arithmetic it does over
the card's peak rate for that arithmetic (`bound`, from this run's
tensors).
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# sha256 of (tile_palettes, palette, palette_map) as int32 bytes after
# initialize + cluster on bench._test_image(0) with the balanced config and
# with the perceptual one: the JAX package's CPU values
# (tests/test_torch_color_init.py and tests/test_torch_perceptual.py keep
# them honest against both packages).
INIT_HASH = "db244f60c99d56558e113293b47e919710bcbb9d3a3929b5f83b1ba82ad4c6d9"
INIT_HASH_PERCEPTUAL = (
    "80f887a8fcf9a066bc4a0917f65e84c987d136dcaf1d19466cb8d5413e73a7f9"
)
# The same after initialize + cluster with dithering, red-mean and
# perceptual (tests/test_torch_dither.py pins them against both packages).
INIT_HASH_DITHER = (
    "7982a1753127d7659979b0cdd0dd7a4b66999a6b1f4dad01a62815cddd6da854"
)
INIT_HASH_DITHER_PERCEPTUAL = (
    "2f36a75bc43c5ab1daf98713d4461cf8b2cc31066d817954a1e87a16b655628c"
)
FEATURE_TOL = 2e-4  # kernel vs twin, finalised features (rtol and atol)
# Kernel D's distance planes vs its twin (atol and rtol). The kernel takes
# the twin's steps, but its fmaf rounds once where the twin's float64
# product-and-sum may round twice, and its libm is CUDA's.
DISTANCE_TOL = 1e-4
ERROR_TOL = 1e-3  # kernel vs twin, full-frame error
# Least share of equal pixels between kernel G's perceptual maps and its
# twin's. Bit-equal is the aim; the card's double pow or trigonometry may
# land across a float32 rounding boundary from the twin's.
DITHER_MAP_SHARE = 0.99
BALANCED = dict(
    subpalette_count=8, subpalette_size=15, max_steps=8, converge_tol=0.0,
    seed=0, schedule="channel", prescreen=8, prescreen_full=2,
    channel_explore=16, accept_margin=0.005,
)
# The balanced recipe with CIEDE2000 palettes; QuantConfig raises
# prescreen_full to 4 for perceptual runs, so it is given here.
PERCEPTUAL = dict(BALANCED, prescreen_full=4, perceptual_palettes=True)
# BASELINE config 3 at the balanced recipe, and config 4 with dithering at
# one sweep (kernel G's CIEDE2000 mode takes about 30 times its red-mean
# mode's time).
DITHER = dict(BALANCED, dither=True)
DITHER_PERCEPTUAL = dict(PERCEPTUAL, dither=True, max_steps=1)
WRAPPERS = ("select_colors", "multiscale_feature_sums",
            "coarse_feature_sums_redmean", "coarse_feature_sums_ciede",
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


def init_hash(state) -> str:
    h = hashlib.sha256()
    for t in (state.tile_palettes, state.palette, state.palette_map):
        h.update(t.to(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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


def _visit(img, params: dict):
    """What the main path's first visit, slot (0, 0) channel 0, gives the
    kernels: the state's pyramid and slot context, and its 32 channel
    values plus 16 explore draws (B = 48) in 8-bit and linear RGB."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops.color import expand_5bit_to_8bit, srgb_u8_to_linear

    state, config = prepared_state(img, params)
    refp = refine.make_reference_pyramid(state)
    ctx = refine.slot_context(state, config, 0, 0,
                              refine.compute_d_all(state, config))
    cand8 = expand_5bit_to_8bit(visit_candidates(state))
    return state, refp, ctx, cand8, srgb_u8_to_linear(cand8)


def visit_candidates(state):
    """The 5-bit candidates of the main path's first visit: the 32 values
    of channel 0 of slot (0, 0) and 16 explore draws (B = 48)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cand5 = state.palette[0, 0][None].repeat(32, 1)
    cand5[:, 0] = torch.arange(32, dtype=torch.int32, device="cuda")
    return torch.cat([cand5, torch.randint(
        0, 32, (16, 3), generator=gen, device="cuda", dtype=torch.int32)])


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
        f"kernel {r['ms']:.4f} ms twin {r['plain_ms']:.4f} ms "
        f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
        for r in records), flush=True)


def _b_case(label: str, refp, frames, start: int, n: int, pre_ds: int):
    """Kernel B against its twin on `frames` for scales start..start+n-1
    after `pre_ds` 2x2 means."""
    from snesimage_torch.ops import cuda_metric
    from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums

    refs = tuple(tuple(a.permute(2, 0, 1) for a in refp[start + s])
                 for s in range(n))
    sizes = [(256 >> (start + s)) ** 2 for s in range(n)]
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
    return dict(
        shape=label, max_abs_err=max_err(got, want, FEATURE_TOL),
        ms=median_ms(kernel), plain_ms=median_ms(plain),
        **bound(nbytes(frames, *(a for t in refs for a in t), raw),
                metric_ops(b, sizes) + pre_ds * b * frames[0].numel()),
    )


def _sum_cases(record: dict, cases) -> dict:
    """`record` with the times and bounds of a kernel's call shapes summed."""
    lib = [c.get("library_ms") for c in cases]
    record.update(
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=sum(c["ms"] for c in cases),
        plain_ms=sum(c["plain_ms"] for c in cases),
        library_ms=None if None in lib else sum(lib),
        bound_ms=sum(c["bound_ms"] for c in cases),
        bound_by=max(cases, key=lambda c: c["bound_ms"])["bound_by"],
        cases=list(cases),
    )
    return record


def _a_case(label: str, key, table):
    """Kernel A against its twin, exact, on one key plane and table or on
    a stack of them. Its library call is one gather from the table with
    the transparent sentinel's zero column appended."""
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
        shape=label, max_abs_err=float((got - want).abs().max()),
        ms=median_ms(lambda: cuda_prescreen.select_colors(key, table)),
        plain_ms=median_ms(
            lambda: cuda_prescreen._select_colors_plain(key, table)),
        library_ms=median_ms(library),
        **bound(nbytes(key, table, want)),
    )


def _a_record(cases) -> dict:
    return _sum_cases(dict(
        name="select_colors", source="snesimage_torch/csrc/select_colors.cu",
        replaces="snesimage_tpu/ops/pallas_prescreen.py:384"), cases)


def _b_record(cases) -> dict:
    return _sum_cases(dict(
        name="multiscale_feature_sums",
        source="snesimage_torch/csrc/multiscale.cu",
        replaces="snesimage_tpu/ops/pallas_metric.py:194"), cases)


def phase_kernels(img):
    """Kernels A, C and B against their twins on the bench image's own
    balanced state, at the shapes one main-path visit gives them."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_metric
    from snesimage_torch.ops.remap import render_linear
    from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums

    state, refp, ctx, cand8, cand_lin = _visit(img, BALANCED)
    records = []

    # A: the no-candidate frame of an undithered visit.
    records.append(_a_record([
        _a_case("256x256, one table", ctx.key_nc, ctx.table)]))

    # C: 32 channel values plus 16 explore draws, B = 48.
    args = refine.coarse_inputs(ctx, cand8, cand_lin, refp)
    sizes = [(256 >> s) ** 2 for s in range(2, 6)]
    raw = cuda_metric.coarse_feature_sums_redmean(*args)
    got = finalize_feature_sums(raw, sizes, 2)
    want = finalize_feature_sums(cuda_metric._coarse_plain(*args), sizes, 2)
    records.append(dict(
        name="coarse_feature_sums_redmean",
        source="snesimage_torch/csrc/coarse_redmean.cu",
        replaces="snesimage_tpu/ops/pallas_metric.py:522",
        max_abs_err=max_err(got, want, FEATURE_TOL),
        ms=median_ms(lambda: cuda_metric.coarse_feature_sums_redmean(*args)),
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
    return records


def phase_kernel_d(img):
    """Kernel D against its twin on the bench image's perceptual state, at
    the shapes of the perceptual path's first visit (B = 48)."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_metric
    from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums

    _, refp, ctx, cand8, cand_lin = _visit(img, PERCEPTUAL)
    args = refine.coarse_inputs(ctx, cand8, cand_lin, refp)
    sizes = [(256 >> s) ** 2 for s in range(2, 6)]
    sums, dcand = cuda_metric.coarse_feature_sums_ciede(*args)
    want_sums, want_d = cuda_metric._coarse_ciede_plain(*args)
    feat_err = max_err(finalize_feature_sums(sums, sizes, 2),
                       finalize_feature_sums(want_sums, sizes, 2),
                       FEATURE_TOL)
    d_err = max_err(dcand, want_d, DISTANCE_TOL)
    record = dict(
        name="coarse_feature_sums_ciede", route="cuda",
        source="snesimage_torch/csrc/coarse_ciede.cu",
        replaces="snesimage_tpu/ops/pallas_metric.py:594",
        max_abs_err=max(feat_err, d_err), feature_max_abs_err=feat_err,
        distance_max_abs_err=d_err,
        distance_exact_share=float((dcand == want_d).float().mean()),
        ms=median_ms(lambda: cuda_metric.coarse_feature_sums_ciede(*args)),
        plain_ms=median_ms(lambda: cuda_metric._coarse_ciede_plain(*args)),
        library_ms=None,
        shape="B=48, 256x256 -> scales 2-5 and distance planes",
        **_coarse_bound(args, nbytes(sums, dcand), CIEDE_OPS_PER_PX),
    )
    _print_records("phase 5", [record])
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
    """Kernel G against its twin for candidates `cand5` of slot (p, i).
    Red-mean maps must be bit-equal. Perceptual maps may differ on at most
    1 - DITHER_MAP_SHARE of the pixels; the case then names the first
    differing pixel of the wavefront and both choices' distances there."""
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
    case = dict(shape=label, equal_share=share,
                max_abs_err=float((got - want).abs().max()))
    if share < 1.0:
        check(perceptual, f"red-mean maps differ from the twin's ({label}: "
              f"{share} equal)")
        check(share >= DITHER_MAP_SHARE,
              f"perceptual maps differ from the twin's ({label}: {share} "
              "equal)")
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
        case["first_difference"] = dict(
            candidate=b, y=y, x=x, kernel_entry=picks[0], twin_entry=picks[1],
            kernel_entry_distance=dists[0], twin_entry_distance=dists[1])
    case["ms"] = median_ms(
        lambda: cuda_dither.dither_remap_candidates(*args), runs=10)
    case["plain_ms"] = twin_ms  # one run: W + 2H - 2 steps of torch ops
    case["ms_per_step"] = case["ms"] / (got.shape[2] + 2 * got.shape[1] - 2)
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
    from snesimage_torch.ops import cuda_dither
    from snesimage_torch.testing import with_transparency

    cases, render_case, frames_case = [], None, None
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
            key, tables = refine.dithered_render_operands(
                state, config, 0, 0, cand5, maps)
            render_case = _a_case("B=48, 256x256, one table per candidate",
                                  key, tables)
            frames = refine.candidate_frames_dithered(state, config, 0, 0,
                                                      cand5, maps)
            frames_case = _b_case(
                "B=48, pre_ds=2, n=4", refine.make_reference_pyramid(state),
                frames, 2, 4, 2)
    a_record.update(_a_record(a_record["cases"] + [render_case]))
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
        shape=main["shape"], ms_per_step=main["ms_per_step"], cases=cases,
    )
    print("phase 8 kernel G vs twin: " + "; ".join(
        f"{c['shape']}: equal share {c['equal_share']}, kernel "
        f"{c['ms']:.4f} ms ({c['ms_per_step'] * 1e3:.3f} us a step), twin "
        f"{c['plain_ms']:.1f} ms, bound {c['bound_ms']:.5f} ms "
        f"({c['bound_by']})" + (f", first difference {c['first_difference']}"
                                if "first_difference" in c else "")
        for c in cases), flush=True)
    print("phase 9 kernels A and B at the dithered shapes: " + "; ".join(
        f"{k} {c['shape']} max_abs_err {c['max_abs_err']:.3g} kernel "
        f"{c['ms']:.4f} ms twin {c['plain_ms']:.4f} ms bound "
        f"{c['bound_ms']:.5f} ms ({c['bound_by']})"
        for k, c in (("A", render_case), ("B", frames_case))), flush=True)
    return record


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
           cuda_dither.dither_remap_candidates)
    return dict(zip(WRAPPERS, fns))


def phase_main_path(img, init_state, smi, params: dict, phase: str,
                    label: str, absent: tuple, timed_runs: int):
    """One run of a path through `run_fused`, checked; then its warm time
    as the best of `timed_runs` runs. Returns each wrapper's launches in
    the checked run; every wrapper but those in `absent` must have
    launched, and kernel G once per visit and twice in the init where the
    path dithers."""
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
        if name in absent:
            check(n == 0, f"the {label} path launched {name}")
        else:
            check(n > 0, f"the {label} path never launched {name}")
    if config.dither:
        visits = (config.max_steps * config.subpalette_count
                  * config.subpalette_size * 3)
        check(launches["dither_remap_candidates"] >= visits + 2,
              f"kernel G launched {launches['dither_remap_candidates']} "
              f"times in {visits} visits")

    refp = refine.make_reference_pyramid(init_state)
    err0 = float(refine.frame_error_fused(init_state, config, refp))
    check(len(errors) == config.max_steps, f"{len(errors)} steps ran")
    check(all(np.isfinite(errors)), "non-finite step error")
    check(all(b <= a for a, b in zip([err0] + errors, errors)),
          "step errors increase")
    check(errors[-1] < err0, "the run did not improve on the init error")

    out = json.loads(state_to_json(state, config))
    check(len(out["palette"]) == config.subpalette_count * 16, "palette")
    check(len(out["tile_palettes"]) == 1024, "tile_palettes")
    check(len(out["tiles"]) == 1024 and all(len(t) == 64 for t in out["tiles"]),
          "tiles")

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
    print(f"{phase} main path: {label} 256x256 8x15, {len(errors)} step(s), "
          f"warm best of {timed_runs} {min(runs):.3f} s (runs {runs}), init "
          f"error {err0}, final error {info['final_error']}, step errors "
          f"{errors}, frame error kernel {kernel_err} twin {twin_err}, "
          f"launches {launches}, card '{smi}'", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from snesimage_torch.testing import bench_image

    t_start = time.perf_counter()
    img = bench_image(0)
    smi, name = phase_device()
    records = phase_kernels(img)
    c, d, g = ("coarse_feature_sums_redmean", "coarse_feature_sums_ciede",
               "dither_remap_candidates")
    runs = {}
    init_state = phase_init_hash(img, BALANCED, INIT_HASH, "phase 3")
    runs["balanced"] = phase_main_path(
        img, init_state, smi, BALANCED, "phase 4", "balanced", (d, g), 3)
    records.append(phase_kernel_d(img))
    init_state = phase_init_hash(img, PERCEPTUAL, INIT_HASH_PERCEPTUAL,
                                 "phase 6")
    runs["perceptual"] = phase_main_path(
        img, init_state, smi, PERCEPTUAL, "phase 7", "perceptual", (c, g), 2)
    by_name = {r["name"]: r for r in records}
    records.append(phase_kernel_g(img, by_name["select_colors"],
                                  by_name["multiscale_feature_sums"]))
    init_state = phase_init_hash(img, DITHER, INIT_HASH_DITHER, "phase 10")
    runs["dither"] = phase_main_path(
        img, init_state, smi, DITHER, "phase 11", "dithered", (c, d), 1)
    init_state = phase_init_hash(img, DITHER_PERCEPTUAL,
                                 INIT_HASH_DITHER_PERCEPTUAL, "phase 12")
    runs["dither_perceptual"] = phase_main_path(
        img, init_state, smi, DITHER_PERCEPTUAL, "phase 13",
        "dithered perceptual", (c, d), 1)
    path_of = {d: "perceptual", g: "dither"}
    for r in records:
        r["launches_by_path"] = {path: n[r["name"]] for path, n in runs.items()}
        r["launches"] = runs[path_of.get(r["name"], "balanced")][r["name"]]
    print(f"all phases: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
