"""Readings that set the limits of the check: the program's sound runs, the
control, and planted faults, on several seeds in one process.

    python3 perfbench/control.py --workload mode1.balanced-256 \
        --seconds 10 --seeds 11 12 13 [--fault stall|answer]

For each seed: the cell's window at its own size and load (the set-up is
paid once; later seeds find every graph captured), then the check of the
program's answers, and the control's: the plain reference put in the
program's place and computed in bfloat16, one step below the float32 (and
exact integer) arithmetic the configurations state. The control keeps the
program's palettes (its decisions) and works out in bfloat16 everything
the program derives from them: the tile assignment (the initialisation),
the palette map (remap or Floyd-Steinberg), the carried error
(SSIMULACRA2) and, in the GUI, each frame's error and the first frame.

`--fault` plants a fault in the program instead, and reads the program's
answers: `stall`, every sweep returns its state unchanged; `answer`, the
JSON of every output is written from a map with one pixel's entry moved.
The benchmark's own runs never run this script. One JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness, judge  # noqa: E402
from perfbench.reference import json_format, remap  # noqa: E402
from perfbench.reference.init import initial_state  # noqa: E402
from perfbench.reference.ssimulacra2 import Scorer  # noqa: E402

LOW = torch.bfloat16


def control_answer(img: np.ndarray, text: str, spec, deep: bool,
                   scorer: Scorer) -> dict:
    """The control's answer for the image whose program output is `text`,
    judged as the program's are."""
    cfg = spec.config
    c, s, dithered = (cfg["subpalette_count"], cfg["subpalette_size"],
                      cfg["dither"])
    alpha = img[..., 3]
    palette5 = json_format.decode(text, c, s, alpha)[0]
    tiles = initial_state(img, c, s, dithered, LOW)[0]
    pmap = remap.palette_map(img[..., :3], alpha, tiles, palette5, dithered,
                             LOW)
    carried = Scorer(img[..., :3], LOW).error(
        remap.render(palette5, tiles, pmap, alpha))
    return judge.judge_answer(img, json_format.encode(palette5, tiles, pmap,
                                                      alpha),
                              carried, cfg, deep, scorer)


def control_answers(spec, run_, out, seed: int) -> list[dict]:
    """The control's answers to the window's outputs, as the cell's loop
    (perfbench/loops/<loop>.py) makes them."""
    return harness.loop(spec.traffic["loop"]).control(spec, run_, out, seed)


def plant(fault: str) -> None:
    """Breaks the program underneath the harness."""
    from snesimage_torch.core import graphs
    from snesimage_torch.io import json_out

    if fault == "stall":
        def sweep(self, method, state, config, refp, err, generator, draws,
                  *, left, **sweep_kw):
            return state, err.clone()

        graphs.SweepRunner.sweep = sweep
    elif fault == "answer":
        encode = json_out.state_to_json

        def state_to_json(state, config):
            pm = state.palette_map.clone()
            pm[0, 0] = (pm[0, 0] + 1) % config.subpalette_size
            return encode(state.replace(palette_map=pm), config)

        json_out.state_to_json = state_to_json
    else:
        raise ValueError(f"unknown fault {fault!r}")


def readings(spec, answers) -> dict:
    values = {n: judge.reading(answers, n) for n in spec.limits}
    return {"correct": judge.verdict(values, spec.limits)[0], **values}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("stall", "answer"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device is available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    spec = harness.cell_spec(args.workload)
    if args.fault:
        plant(args.fault)
    device = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        run_, out, _ = harness.window(spec, seed, args.seconds, False, device,
                                      t0)
        line = {"workload": spec.name, "seed": seed, "fault": args.fault,
                "answers": run_.attempted,
                "program": readings(spec, harness.check(spec, run_, out,
                                                        seed))}
        if not args.fault:
            line["control"] = readings(spec, control_answers(spec, run_, out,
                                                             seed))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
