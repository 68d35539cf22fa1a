"""Runs one benchmark cell once on the card and prints its result line.

    python3 perfbench/run.py --workload mode1.balanced-256 --seed 7 \
        --seconds 40 --trace 0

From the root of a checkout. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device` (with `--trace
1` also `busy_s` and `window_s`), `breakdown` with `--trace 1`, and last
`checks`: each number the check compared, with its limit. The checks are
also the last lines of standard error. Without a card, with fewer cards
than the cell asks for, or when a module of JAX or of the JAX package has
been loaded, it prints no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Kernel caches at fixed paths inside the checkout; the program's own
# nvcc build lives in snesimage_torch/build/, also inside it.
CACHE = ROOT / ".perfbench-cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(line: dict) -> None:
    """The checks as the last lines of standard error, then the line on
    standard output."""
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from perfbench import harness

    spec = harness.cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec.chips:
        print(f"perfbench: {spec.name} needs {spec.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    try:
        line = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    except harness.ForbiddenModules as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
