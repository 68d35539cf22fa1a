"""Run every BASELINE.json config end to end on the card.

    python -m snesimage_torch.benchmarks [--steps N] [--batch N] [--chunk N]
        [--only c1,c2,...]

Counterpart of the JAX package's benchmarks.py. Prints a line with the
card's name and power limit, then one JSON line per config (bench.py stays
the single-line headline benchmark): configs 1-4 on the bench image, one
image each (`run_single`), and config 5, the NES preset's 4x3 palettes on
a batch of images, in chunks (`run_batched`). Without a card it prints one
JSON line with `"value": null` and an `error`, and exits 1.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback

import numpy as np
import torch

from snesimage_torch import testing
from snesimage_torch.bench import failure
from snesimage_torch.config import QuantConfig
from snesimage_torch.core import pipeline
from snesimage_torch.core.refine import error_of, make_reference_pyramid
from snesimage_torch.core.state import new_state
from snesimage_torch.parallel import batch as pb

# BASELINE.json configs 1-4 (one image each) and 5 (NES 4x3, a batch of
# images): tag -> (name, QuantConfig fields).
CONFIGS = (
    ("c1", ("1x15 RGB no-dither", dict(subpalette_count=1,
                                       subpalette_size=15))),
    ("c2", ("8x15 SNES BG", dict(subpalette_count=8, subpalette_size=15))),
    ("c3", ("8x15 dither", dict(subpalette_count=8, subpalette_size=15,
                                dither=True))),
    ("c4", ("8x15 perceptual", dict(subpalette_count=8, subpalette_size=15,
                                    perceptual_palettes=True))),
    ("c5", ("4x3 NES batched", dict(subpalette_count=4, subpalette_size=3,
                                    nes=True))),
)


def _fence(device) -> None:
    """Wait for the device: the timed chain ends when its work has."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _chain(img, config: QuantConfig, max_steps: int, device):
    state = new_state(img, config, device)
    state = pipeline.initialize(state, config)
    state = pipeline.cluster(state, config)
    refp = make_reference_pyramid(state)
    state, errors = pipeline.optimize(state, config, refp=refp,
                                      max_steps=max_steps)
    return state, refp, errors


def run_single(name: str, config: QuantConfig, img: np.ndarray,
               max_steps: int, *, device: torch.device | str = "cuda"
               ) -> dict:
    """One image: a warm-up chain with one `optimize` step, then the timed
    chain `new_state`, `initialize`, `cluster`, the reference pyramid and
    `max_steps` steps, fenced. The clock starts before `new_state`, as
    benchmarks.py's does, so these seconds include the upload of the image
    that `run_fused`'s `total_seconds` leave out (ROADMAP C-10). The final
    error is `error_of` of the state the chain ends in."""
    _chain(img, config, 1, device)
    _fence(device)
    t0 = time.perf_counter()
    state, refp, errors = _chain(img, config, max_steps, device)
    _fence(device)
    elapsed = time.perf_counter() - t0
    return {
        "config": name,
        "seconds": elapsed,
        "images_per_sec": 1.0 / elapsed,
        "final_error": float(error_of(state, config, refp)),
        "step_errors": errors.tolist(),
    }


def run_batched(name: str, config: QuantConfig, imgs: np.ndarray,
                max_steps: int, chunk: int, *,
                device: torch.device | str = "cuda") -> dict:
    """A batch of images through `batched_run`, `chunk` at a time, after a
    warm-up on the first chunk. The mean final error is the mean over the
    chunks of each chunk's last mean step error."""
    pb.batched_run(imgs[:chunk], config, max_steps=max_steps, device=device)
    t0 = time.perf_counter()
    errors = []
    for lo in range(0, len(imgs), chunk):
        _, errs = pb.batched_run(imgs[lo:lo + chunk], config,
                                 max_steps=max_steps, device=device)
        _fence(device)
        errors.append(errs[-1])
    elapsed = time.perf_counter() - t0
    return {
        "config": name,
        "seconds": elapsed,
        "images": len(imgs),
        "images_per_sec": len(imgs) / elapsed,
        "mean_final_error": float(np.mean(errors)),
    }


def _run(args) -> None:
    img = testing.bench_image(0)
    only = set(args.only.split(",")) if args.only else None
    for tag, (name, params) in CONFIGS:
        if only is not None and tag not in only:
            continue
        config = QuantConfig(**params)
        if tag != "c5":
            out = run_single(name, config, img, args.steps)
        else:
            rng = np.random.default_rng(1)
            imgs = np.stack([testing.bench_image(int(s))
                             for s in rng.integers(0, 1 << 31, args.batch)])
            out = run_batched(f"{name} x{args.batch}", config, imgs,
                              args.steps, args.chunk)
        print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m snesimage_torch.benchmarks")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument(
        "--only", help="comma-separated subset: c1,c2,c3,c4,c5 (default all)"
    )
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(json.dumps(failure("no CUDA device is available")))
        return 1
    try:
        print(json.dumps({"device": testing.card_line()}), flush=True)
        _run(args)
    except Exception as e:  # the failing config's line reports it
        traceback.print_exc()
        print(json.dumps(failure(f"{type(e).__name__}: {e}")))
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
