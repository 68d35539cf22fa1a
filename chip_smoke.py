"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from snesimage_torch/csrc, holds each
against its plain PyTorch twin on the card at the main paths' shapes, pins
the init hashes to the JAX package's CPU values, and drives two paths once
each through `run_fused` and `state_to_json`: the balanced profile
(256x256, 8x15 palettes, 8 channel sweeps with 16 explore candidates) and
the same recipe with perceptual (CIEDE2000) palettes. Each phase prints one
line. Then come, each on its own line, the kernels' JSON record and the
card's name and power limit; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it.

Each kernel's record holds its wrapper's wall time and its twin's at the
main paths' shapes (`median_ms`), its launches in the run of the path that
uses it (A and B: the balanced run; `launches_by_path` has both), and its
bound: the larger of the bytes it must move over the card's memory rate
and the arithmetic it does over the card's peak rate for that arithmetic
(`bound`, from this run's tensors).
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
FEATURE_TOL = 2e-4  # kernel vs twin, finalised features (rtol and atol)
# Kernel D's distance planes vs its twin (atol and rtol). The kernel takes
# the twin's steps, but its fmaf rounds once where the twin's float64
# product-and-sum may round twice, and its libm is CUDA's.
DISTANCE_TOL = 1e-4
ERROR_TOL = 1e-3  # kernel vs twin, full-frame error
BALANCED = dict(
    subpalette_count=8, subpalette_size=15, max_steps=8, converge_tol=0.0,
    seed=0, schedule="channel", prescreen=8, prescreen_full=2,
    channel_explore=16, accept_margin=0.005,
)
# The balanced recipe with CIEDE2000 palettes; QuantConfig raises
# prescreen_full to 4 for perceptual runs, so it is given here.
PERCEPTUAL = dict(BALANCED, prescreen_full=4, perceptual_palettes=True)

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


def _init_state(img, params: dict):
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

    state, config = _init_state(img, params)
    refp = refine.make_reference_pyramid(state)
    ctx = refine.slot_context(state, config, 0, 0,
                              refine.compute_d_all(state, config))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cand5 = state.palette[0, 0][None].repeat(32, 1)
    cand5[:, 0] = torch.arange(32, dtype=torch.int32, device="cuda")
    cand5 = torch.cat([cand5, torch.randint(
        0, 32, (16, 3), generator=gen, device="cuda", dtype=torch.int32)])
    cand8 = expand_5bit_to_8bit(cand5)
    return state, refp, ctx, cand8, srgb_u8_to_linear(cand8)


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


def phase_kernels(img):
    """Kernels A, C and B against their twins on the bench image's own
    balanced state, at the shapes one main-path visit gives them."""
    from snesimage_torch.core import refine
    from snesimage_torch.ops import cuda_metric, cuda_prescreen
    from snesimage_torch.ops.remap import render_linear
    from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums

    state, refp, ctx, cand8, cand_lin = _visit(img, BALANCED)
    records = []

    # A: the no-candidate frame, exact. Its library call is one gather from
    # the table with the transparent sentinel's zero column appended.
    got = cuda_prescreen.select_colors(ctx.key_nc, ctx.table)
    want = cuda_prescreen._select_colors_plain(ctx.key_nc, ctx.table)
    check(torch.equal(got, want), "select_colors is not bit-exact")
    padded = torch.cat([ctx.table, torch.zeros_like(ctx.table[:, :1])], dim=1)
    key = ctx.key_nc.long()
    check(torch.equal(padded[:, key], want), "the gather differs from A")
    records.append(dict(
        name="select_colors", source="snesimage_torch/csrc/select_colors.cu",
        replaces="snesimage_tpu/ops/pallas_prescreen.py:384",
        max_abs_err=float((got - want).abs().max()),
        ms=median_ms(lambda: cuda_prescreen.select_colors(ctx.key_nc,
                                                          ctx.table)),
        plain_ms=median_ms(lambda: cuda_prescreen._select_colors_plain(
            ctx.key_nc, ctx.table)),
        library_ms=median_ms(lambda: padded[:, key]),
        **bound(nbytes(ctx.key_nc, ctx.table, want)),
    ))

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
    cases = [("B=1, n=6", frame, 0, 6, 0), ("B=8, pre_ds=1, n=1", finals, 1,
             1, 1), ("B=2, n=1", finals[:2].contiguous(), 0, 1, 0)]
    b_cases = []
    for label, frames, start, n, pre_ds in cases:
        refs = tuple(tuple(a.permute(2, 0, 1) for a in refp[start + s])
                     for s in range(n))
        sizes = [(256 >> (start + s)) ** 2 for s in range(n)]

        def kernel(frames=frames, refs=refs, pre_ds=pre_ds):
            return cuda_metric.multiscale_feature_sums(refs, frames,
                                                       pre_ds=pre_ds)

        def plain(frames=frames, refs=refs, pre_ds=pre_ds):
            return cuda_metric._multiscale_feature_sums_plain(refs, frames,
                                                              pre_ds)

        raw = kernel()
        got = finalize_feature_sums(raw.reshape(len(frames), -1, 6),
                                    sizes, start)
        want = finalize_feature_sums(plain().reshape(len(frames), -1, 6),
                                     sizes, start)
        b = len(frames)
        b_cases.append(dict(
            shape=label, max_abs_err=max_err(got, want, FEATURE_TOL),
            ms=median_ms(kernel), plain_ms=median_ms(plain),
            **bound(nbytes(frames, *(a for t in refs for a in t), raw),
                    metric_ops(b, sizes) + pre_ds * b * frames[0].numel()),
        ))
    records.append(dict(
        name="multiscale_feature_sums",
        source="snesimage_torch/csrc/multiscale.cu",
        replaces="snesimage_tpu/ops/pallas_metric.py:194",
        max_abs_err=max(c["max_abs_err"] for c in b_cases),
        ms=sum(c["ms"] for c in b_cases),
        plain_ms=sum(c["plain_ms"] for c in b_cases),
        library_ms=None,
        bound_ms=sum(c["bound_ms"] for c in b_cases),
        bound_by=max(b_cases, key=lambda c: c["bound_ms"])["bound_by"],
        cases=b_cases,
    ))
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


def phase_init_hash(img, params: dict, want: str, phase: str):
    state, _ = _init_state(img, params)
    got = init_hash(state)
    check(got == want, f"init hash {got} != {want}")
    print(f"{phase} init hash: {got} (equals the JAX CPU value)", flush=True)
    return state


def phase_main_path(img, init_state, smi, params: dict, phase: str,
                    label: str, absent: str | None, timed_runs: int):
    """One run of a path through `run_fused`, checked; then its warm time
    as the best of `timed_runs` runs. Returns each wrapper's launches in
    the checked run; every wrapper but `absent` must have launched."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine
    from snesimage_torch.io.json_out import state_to_json
    from snesimage_torch.ops import cuda_metric, cuda_prescreen
    from snesimage_torch.ops.remap import render_linear
    from snesimage_torch.ops.ssimulacra2 import (
        score_from_features,
        scale_features,
    )

    config = QuantConfig(**params)
    wrappers = {
        "select_colors": cuda_prescreen.select_colors,
        "multiscale_feature_sums": cuda_metric.multiscale_feature_sums,
        "coarse_feature_sums_redmean": cuda_metric.coarse_feature_sums_redmean,
        "coarse_feature_sums_ciede": cuda_metric.coarse_feature_sums_ciede,
    }
    for fn in wrappers.values():
        fn.launches = 0
    state, errors, info = pipeline.run_fused(img, config, device="cuda")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for name, n in launches.items():
        if name == absent:
            check(n == 0, f"the {label} path launched {name}")
        else:
            check(n > 0, f"the {label} path never launched {name}")

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
    print(f"{phase} main path: {label} 256x256 8x15, {len(errors)} steps, "
          f"warm best of {timed_runs} {min(runs):.3f} s (runs {runs}), init "
          f"error {err0}, final error {info['final_error']}, step errors "
          f"{errors}, frame error kernel {kernel_err} twin {twin_err}, "
          f"launches {launches}, card '{smi}'", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from bench import _test_image

    img = _test_image(0)
    smi, name = phase_device()
    records = phase_kernels(img)
    init_state = phase_init_hash(img, BALANCED, INIT_HASH, "phase 3")
    balanced = phase_main_path(img, init_state, smi, BALANCED, "phase 4",
                               "balanced", "coarse_feature_sums_ciede", 3)
    records.append(phase_kernel_d(img))
    init_state = phase_init_hash(img, PERCEPTUAL, INIT_HASH_PERCEPTUAL,
                                 "phase 6")
    perceptual = phase_main_path(img, init_state, smi, PERCEPTUAL, "phase 7",
                                 "perceptual", "coarse_feature_sums_redmean",
                                 2)
    for r in records:
        by_path = {"balanced": balanced[r["name"]],
                   "perceptual": perceptual[r["name"]]}
        r["launches_by_path"] = by_path
        r["launches"] = by_path["perceptual" if r["name"]
                                == "coarse_feature_sums_ciede" else "balanced"]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
