"""Batched multi-image CLI of the port.

Counterpart of snesimage_tpu/batch_cli.py (BASELINE config 5, "batched
256-image run"): a directory of images is optimized as one batch on one
card, every image advancing through the scheduler in lockstep
(parallel/batch.py `batched_run`), and each image's result is written as
reference-format JSON, <stem>.json. The parser and `shard_paths` are
copies of the JAX package's (tests/test_torch_cli.py pins them); several
hosts split a directory by file (`--num-hosts`, `--host-id`). The rank-1
gate is inert here, as it is in the JAX package's batch mode: batched
sweeps always score exactly.

    python -m snesimage_torch.batch_cli INDIR OUTDIR --preset nes-compat --steps 2
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import pathlib
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="snesimage-torch-batch",
        description="Optimize a directory of images as one batch.",
    )
    p.add_argument("input_dir", help="Directory of source images")
    p.add_argument("output_dir", help="Directory for JSON outputs")
    # None sentinels: explicit flags always override presets (see cli.py).
    p.add_argument("-c", "--subpalette-count", type=int, default=None)
    p.add_argument("-s", "--subpalette-size", type=int, default=None)
    p.add_argument("-d", "--dither", action="store_true", default=None)
    p.add_argument("--perceptual-palettes", action="store_true", default=None)
    p.add_argument("--nes", action="store_true", default=None)
    # Optimizer knobs: None sentinels so explicit flags override
    # --opt-profile fields (same layering as the single-image CLI).
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--schedule", choices=["reference", "channel"], default=None)
    p.add_argument("--prescreen", type=int, default=None, metavar="K")
    p.add_argument("--prescreen-full", type=int, default=None, metavar="M")
    p.add_argument(
        "--prescreen-pre", type=int, default=None, metavar="P",
        help="Three-level coarse cascade: 1/8-res pre-rank keeping the "
        "top P before the quarter-res coarse stage (see the "
        "single-image CLI)",
    )
    p.add_argument(
        "--dither-proxy", type=int, default=None, metavar="K",
        help="Dithered runs: wavefront-dither only the top K candidates "
        "per visit, ranked by the exact undithered coarse score (see "
        "the single-image CLI)",
    )
    p.add_argument(
        "--tol", type=float, default=None,
        help="Stop when a full sweep improves the batch-mean error by "
        "less than this (default 0 = fixed step budget)",
    )
    p.add_argument(
        "--channel-explore", type=int, default=None, metavar="E",
        help="Add E random full-RGB candidates per channel visit "
        "(per-image keys; see the single-image CLI)",
    )
    p.add_argument(
        "--channel-window", type=int, default=0, metavar="W",
        help="Windowed channel descent (see the single-image CLI)",
    )
    p.add_argument(
        "--gate-margin", type=float, default=None, metavar="G",
        help="Accepted for profile/recipe parity but INERT in batch mode: "
        "under vmap the gate's skip lowers to a select that computes both "
        "branches, so batched sweeps always score exactly",
    )
    p.add_argument(
        "--accept-margin", type=float, default=None, metavar="T",
        help="Accept a candidate only if it improves the exact error by "
        "more than T (see the single-image CLI)",
    )
    from snesimage_torch.cli import OPT_PROFILES
    from snesimage_torch.models.presets import PRESETS

    p.add_argument(
        "--opt-profile", choices=sorted(OPT_PROFILES),
        help="Optimizer profile (see the single-image CLI for the "
        "measured recipes: "
        + ", ".join(sorted(OPT_PROFILES))
        + "; hybrid and robust are single-image dispatch shapes and are "
        "rejected here). Note the rank1 gate in 'fast' is inert in "
        "batch mode (batched sweeps always score exactly)",
    )
    p.add_argument("--preset", choices=sorted(PRESETS))
    p.add_argument("--trials", type=int, default=64)
    p.add_argument("--limit", type=int, help="Only process the first N images")
    p.add_argument(
        "--num-hosts", type=int, default=1,
        help="Multi-host scale-out: total number of hosts processing this "
        "directory (see docs/adr/0001-multihost.md)",
    )
    p.add_argument(
        "--host-id", type=int, default=0,
        help="This host's 0-based shard index in [0, num-hosts)",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def shard_paths(paths: list, num_hosts: int, host_id: int) -> list:
    """Round-robin shard of the sorted file list for one host.

    Multi-host scale-out for this workload is per-host FILE sharding, not
    a jax.distributed global mesh: images are embarrassingly parallel with
    zero cross-image communication (SURVEY.md §2.5), so each host runs an
    independent local-mesh batched program over its own shard and nothing
    ever crosses DCN. Round-robin keeps shard sizes within one of each
    other. Rationale: docs/adr/0001-multihost.md.
    """
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    return list(paths)[host_id::num_hosts]


def main(argv: list[str] | None = None, *, device: str = "cuda") -> int:
    """Run the batch CLI on `device`: the card unless a caller (the tests)
    asks for the CPU. Returns the exit code (0 ok, 1 error, 2 argparse)."""
    args = build_parser().parse_args(argv)
    from snesimage_torch.cli import setup_logger

    setup_logger(logging.DEBUG if args.verbose else logging.INFO)
    log = logging.getLogger("snesimage_torch")

    import numpy as np

    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core.state import image_of
    from snesimage_torch.io.image import check_size, load_rgba
    from snesimage_torch.io.json_out import write_json
    from snesimage_torch.parallel import batch as pb

    try:
        from snesimage_torch.cli import merge_geometry, merge_opt_fields

        if args.opt_profile == "hybrid":
            raise ValueError(
                "--opt-profile hybrid is a two-phase single-image recipe; "
                "batch mode runs one config per batch — use balanced or "
                "quality"
            )
        if args.opt_profile == "robust":
            raise ValueError(
                "--opt-profile robust is balanced + a seed portfolio, a "
                "single-image dispatch shape; batch mode batches IMAGES "
                "on the same axis — use balanced here and run seed "
                "portfolios per image with the single-image CLI"
            )
        config = QuantConfig(
            **merge_opt_fields(args),
            **merge_geometry(args),
            seed=args.seed,
            random_trials=args.trials,
            channel_window=args.channel_window,
        )
        if config.gate_margin > 0:
            log.info(
                "gate_margin=%g is inert in batch mode: batched sweeps "
                "always score exactly", config.gate_margin,
            )
            config = dataclasses.replace(config, gate_margin=0.0)
        indir = pathlib.Path(args.input_dir)
        outdir = pathlib.Path(args.output_dir)
        outdir.mkdir(parents=True, exist_ok=True)

        if args.limit is not None and args.limit < 1:
            raise ValueError(f"--limit must be >= 1, got {args.limit}")
        if args.num_hosts == 1 and args.host_id != 0:
            raise ValueError(
                "--host-id requires --num-hosts > 1 (a lone --host-id "
                "would silently process the WHOLE directory)"
            )
        exts = {".png", ".bmp", ".gif", ".jpg", ".jpeg", ".webp"}
        paths = sorted(p for p in indir.iterdir() if p.suffix.lower() in exts)
        if args.limit is not None:
            paths = paths[: args.limit]
        if args.num_hosts > 1:
            paths = shard_paths(paths, args.num_hosts, args.host_id)
            log.info(
                "host %d/%d: processing %d-image shard",
                args.host_id, args.num_hosts, len(paths),
            )
            if not paths:
                log.info("host %d: empty shard, nothing to do", args.host_id)
                return 0
        if not paths:
            raise ValueError(f"No images found in {indir}")
        # Outputs are written as <stem>.json: inputs differing only by
        # extension would silently overwrite each other's results.
        stems = [p.stem for p in paths]
        dupes = sorted({s for s in stems if stems.count(s) > 1})
        if dupes:
            raise ValueError(
                "output filename collision: multiple inputs share "
                f"stem(s) {dupes} (outputs are <stem>.json) — rename "
                "the inputs"
            )

        images = []
        for p in paths:
            img = load_rgba(str(p))
            try:
                check_size(img, config.width, config.height)
            except ValueError as err:
                raise ValueError(f"{p}: {err}") from None
            images.append(img)
        log.info("Optimizing %d images as one batch", len(paths))
        t0 = time.perf_counter()
        states, errors = pb.batched_run(np.stack(images), config,
                                        device=device)
        elapsed = time.perf_counter() - t0
        log.info(
            "Batch done in %.2fs (%.3f images/sec); mean error per step: %s",
            elapsed, len(paths) / elapsed, [round(e, 4) for e in errors],
        )
        for b, p in enumerate(paths):
            write_json(str(outdir / (p.stem + ".json")), image_of(states, b),
                       config)
        log.info("Wrote %d JSON files to %s", len(paths), outdir)
        return 0
    except Exception as err:
        log.error("Error running application: %s", err)
        if args.verbose:
            raise
        return 1


if __name__ == "__main__":
    sys.exit(main())
