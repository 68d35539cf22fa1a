"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from snesimage_torch/csrc, holds each
against its plain PyTorch twin on the card at the main path's shapes, pins
the init hash to the JAX package's CPU value, and drives the balanced
profile (256x256, 8x15 palettes, 8 channel sweeps with 16 explore
candidates) once through `run_fused` and `state_to_json`. Each phase prints
one line. Then come, each on its own line, the kernels' JSON record and the
card's name and power limit; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
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
# initialize + cluster on bench._test_image(0) with the balanced config:
# the JAX package's CPU value (tests/test_torch_color_init.py keeps it
# honest against both packages).
INIT_HASH = "db244f60c99d56558e113293b47e919710bcbb9d3a3929b5f83b1ba82ad4c6d9"
FEATURE_TOL = 2e-4  # kernel vs twin, finalised features (rtol and atol)
ERROR_TOL = 1e-3  # kernel vs twin, full-frame error
BALANCED = dict(
    subpalette_count=8, subpalette_size=15, max_steps=8, converge_tol=0.0,
    seed=0, schedule="channel", prescreen=8, prescreen_full=2,
    channel_explore=16, accept_margin=0.005,
)


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


def phase_kernels(img):
    """Each kernel against its twin on the bench image's own state, at the
    shapes one main-path visit gives it."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine
    from snesimage_torch.core.state import new_state
    from snesimage_torch.ops import cuda_metric, cuda_prescreen
    from snesimage_torch.ops.color import expand_5bit_to_8bit, srgb_u8_to_linear
    from snesimage_torch.ops.remap import render_linear
    from snesimage_torch.ops.ssimulacra2 import finalize_feature_sums

    config = QuantConfig(**BALANCED)
    state = new_state(img, config, "cuda")
    state = pipeline.cluster(pipeline.initialize(state, config), config)
    refp = refine.make_reference_pyramid(state)
    d_all = refine.compute_d_all(state, config)
    ctx = refine.slot_context(state, config, 0, 0, d_all)
    records = []

    # A: the no-candidate frame, exact.
    got = cuda_prescreen.select_colors(ctx.key_nc, ctx.table)
    want = cuda_prescreen._select_colors_plain(ctx.key_nc, ctx.table)
    check(torch.equal(got, want), "select_colors is not bit-exact")
    records.append(dict(
        name="select_colors", source="snesimage_torch/csrc/select_colors.cu",
        replaces="snesimage_tpu/ops/pallas_prescreen.py:384",
        max_abs_err=float((got - want).abs().max()),
        ms=median_ms(lambda: cuda_prescreen.select_colors(ctx.key_nc,
                                                          ctx.table)),
        plain_ms=median_ms(lambda: cuda_prescreen._select_colors_plain(
            ctx.key_nc, ctx.table)),
    ))

    # C: 32 channel values plus 16 explore draws, B = 48.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cand5 = state.palette[0, 0][None].repeat(32, 1)
    cand5[:, 0] = torch.arange(32, dtype=torch.int32, device="cuda")
    cand5 = torch.cat([cand5, torch.randint(
        0, 32, (16, 3), generator=gen, device="cuda", dtype=torch.int32)])
    cand8 = expand_5bit_to_8bit(cand5)
    cand_lin = srgb_u8_to_linear(cand8)
    args = refine.coarse_inputs(ctx, cand8, cand_lin, refp)
    sizes = [(256 >> s) ** 2 for s in range(2, 6)]
    got = finalize_feature_sums(
        cuda_metric.coarse_feature_sums_redmean(*args), sizes, 2)
    want = finalize_feature_sums(cuda_metric._coarse_plain(*args), sizes, 2)
    records.append(dict(
        name="coarse_feature_sums_redmean",
        source="snesimage_torch/csrc/coarse_redmean.cu",
        replaces="snesimage_tpu/ops/pallas_metric.py:522",
        max_abs_err=max_err(got, want, FEATURE_TOL),
        ms=median_ms(lambda: cuda_metric.coarse_feature_sums_redmean(*args)),
        plain_ms=median_ms(lambda: cuda_metric._coarse_plain(*args)),
        shape="B=48, 256x256 -> scales 2-5",
    ))

    # B: the frame error (B=1, six scales), the scale-1 rank (B=8,
    # pre_ds=1) and the scale-0 finalists (B=2).
    frame = render_linear(state.palette_map, state.alpha,
                          state.tile_palettes, state.palette)
    frame = frame.permute(2, 0, 1)[None].contiguous()
    finals = refine.candidate_frames(ctx, cand8[:8], cand_lin[:8])
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

        got = finalize_feature_sums(kernel().reshape(len(frames), -1, 6),
                                    sizes, start)
        want = finalize_feature_sums(plain().reshape(len(frames), -1, 6),
                                     sizes, start)
        b_cases.append(dict(shape=label,
                            max_abs_err=max_err(got, want, FEATURE_TOL),
                            ms=median_ms(kernel), plain_ms=median_ms(plain)))
    records.append(dict(
        name="multiscale_feature_sums",
        source="snesimage_torch/csrc/multiscale.cu",
        replaces="snesimage_tpu/ops/pallas_metric.py:194",
        max_abs_err=max(c["max_abs_err"] for c in b_cases),
        ms=sum(c["ms"] for c in b_cases),
        plain_ms=sum(c["plain_ms"] for c in b_cases),
        cases=b_cases,
    ))
    for r in records:
        r["route"] = "cuda"
    print("phase 2 kernels vs twins: " + "; ".join(
        f"{r['name']} max_abs_err {r['max_abs_err']:.3g} "
        f"kernel {r['ms']:.4f} ms twin {r['plain_ms']:.4f} ms"
        for r in records), flush=True)
    return records


def phase_init_hash(img):
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline
    from snesimage_torch.core.state import new_state

    config = QuantConfig(**BALANCED)
    state = new_state(img, config, "cuda")
    state = pipeline.cluster(pipeline.initialize(state, config), config)
    got = init_hash(state)
    check(got == INIT_HASH, f"init hash {got} != {INIT_HASH}")
    print(f"phase 3 init hash: {got} (equals the JAX CPU value)", flush=True)
    return state


def phase_main_path(img, init_state, smi):
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import pipeline, refine
    from snesimage_torch.io.json_out import state_to_json
    from snesimage_torch.ops import cuda_metric, cuda_prescreen
    from snesimage_torch.ops.remap import render_linear
    from snesimage_torch.ops.ssimulacra2 import (
        score_from_features,
        scale_features,
    )

    config = QuantConfig(**BALANCED)
    wrappers = {
        "select_colors": cuda_prescreen.select_colors,
        "multiscale_feature_sums": cuda_metric.multiscale_feature_sums,
        "coarse_feature_sums_redmean": cuda_metric.coarse_feature_sums_redmean,
    }
    for fn in wrappers.values():
        fn.launches = 0
    state, errors, info = pipeline.run_fused(img, config, device="cuda")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")

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
    for _ in range(3):
        t0 = time.perf_counter()
        pipeline.run_fused(img, config, device="cuda")
        runs.append(time.perf_counter() - t0)
    print(f"phase 4 main path: balanced 256x256 8x15, {len(errors)} steps, "
          f"warm best of 3 {min(runs):.3f} s (runs {runs}), init error "
          f"{err0}, final error {info['final_error']}, step errors {errors}, "
          f"frame error kernel {kernel_err} twin {twin_err}, launches "
          f"{launches}, card '{smi}'", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from bench import _test_image

    img = _test_image(0)
    smi, name = phase_device()
    records = phase_kernels(img)
    init_state = phase_init_hash(img)
    launches = phase_main_path(img, init_state, smi)
    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
