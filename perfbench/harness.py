"""One run of one benchmark cell: set-up, the measured window, the check of
the window's outputs against the plain reference, and the result line.

Everything about a cell is data that the harness finds by name:
`BENCHMARK.json` names the cell's configuration and traffic mix, and its
metrics; `perfbench/configs/<config>.json` holds the deployment's fields
of the program's `QuantConfig`; `perfbench/traffic/<mix>.json` the loop,
the recipe and the images; `perfbench/metrics/<metric>.py` the reader of
each metric; `perfbench/limits/<cell>.json` the limit of each number the
check compares.

The program (the `snesimage_torch` package) is imported only inside
`run`: it supplies the system under test, its stage clocks and graph
counters, and its kernels' names in the trace. The harness imports
nothing of the JAX package, and `forbidden_modules` tells whether anything
else did.

A mix's "loop" names the code that drives its window,
`perfbench/loops/<loop>.py`, found by name as the metric readers are; the
mix names the program's entry functions that the loop calls ("entry",
and where a loop takes them, "traced_entry" and "hook"), as dotted paths
inside the program. A loop file has `window` (the set-up after the
imports, and the measured window: it sets `Run.setup_s` when the window
opens and returns the window's outputs), `check` (the judged answers of
those outputs) and `control` (the control's answers to the same inputs,
read by perfbench/control.py). A new mix that drives another entry adds
a data file, and a loop file only where no loop drives it yet.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import judge
from perfbench.trace import SPAN, TRACED, Trace

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"
# Top-level module names that may never be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "snesimage_tpu")
# The program under test: entry functions are named inside it.
PROGRAM = "snesimage_torch"
# Fields of the program's QuantConfig that a configuration file may set.
CONFIG_KEYS = ("subpalette_count", "subpalette_size", "dither",
               "perceptual_palettes", "nes", "width", "height")


def load_json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is forbidden, compared as
    whole names (`snesimage_torch` is not `snesimage_tpu`)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _for_cell(entries: list, cell: str) -> list:
    return [e for e in entries if cell in e.get("workloads", [cell])]


def cell_spec(name: str, manifest: dict | None = None) -> SimpleNamespace:
    """Everything the data says of cell `name`."""
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    unknown = set(config["quant_config"]) - set(CONFIG_KEYS)
    if unknown:
        raise ValueError(f"config {cell['config']}: unknown keys {unknown}")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return SimpleNamespace(
        name=name, chips=cell["chips"], config=config["quant_config"],
        traffic=traffic, limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=_for_cell(manifest["end_to_end"], name),
        per_layer=_for_cell(manifest["per_layer"], name),
    )


def _load(kind: str, name: str):
    """perfbench/<kind>/<name>.py as a module."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The `read(run)` function of perfbench/metrics/<metric>.py."""
    return _load("metrics", metric).read


def loop(name: str):
    """The loop module perfbench/loops/<name>.py."""
    return _load("loops", name)


def program_function(dotted: str):
    """The program's function at `dotted` ("core.pipeline.run_fused" is
    snesimage_torch.core.pipeline.run_fused), looked up when it is called
    for, so that a fault planted in the program beforehand is the one
    driven."""
    module, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(f"{PROGRAM}.{module}"), name)


def span(name: str):
    """A harness span, seen in the trace (and naming idle gaps)."""
    return torch.profiler.record_function(SPAN + name)


@dataclasses.dataclass
class Run:
    """What a metric reader reads of a run."""

    config: dict  # the QuantConfig fields of the cell and its recipe
    setup_s: float = 0.0
    window_s: float = 0.0
    images: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)
    sweeps: int = 0  # sweeps run in the window
    replays: int = 0  # of those, replayed from a captured graph
    trace: Trace | None = None
    traced_images: list = dataclasses.field(default_factory=list)
    attempted: int = 0  # answers due in the window: images, or GUI steps


def _program():
    """What every loop takes of the program: its configuration, its graph
    counters, its stages and its JSON writer."""
    from snesimage_torch.config import QuantConfig
    from snesimage_torch.core import graphs, pipeline, refine
    from snesimage_torch.core.state import new_state
    from snesimage_torch.io.json_out import state_to_json

    return SimpleNamespace(QuantConfig=QuantConfig, graphs=graphs,
                           pipeline=pipeline, refine=refine,
                           new_state=new_state, state_to_json=state_to_json)


def replays(prog) -> int:
    return sum(g["replays"] for g in prog.graphs.stats())


class Profiler:
    """torch.profiler over the traced part of the window, bracketed by the
    TRACED span."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.span = None
        self.done = False
        self.device = device

    def start(self):
        self.prof.start()
        self.span = torch.profiler.record_function(TRACED)
        self.span.__enter__()

    def stop(self) -> None:
        """Ends the traced part; the trace is read after the window."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.span = None
        self.done = True

    def trace(self) -> Trace | None:
        return Trace(self.prof) if self.done else None


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample(rng: np.random.Generator, n: int, k: int) -> list[int]:
    return sorted(rng.choice(n, size=min(n, k), replace=False).tolist())


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def window(spec, seed: int, seconds: float, trace: bool, device,
           t_start: float):
    """Set-up and the measured window: (Run, the window's outputs, the
    device's peak memory). The program's graphs and cached memory are
    released before it returns."""
    prog = _program()
    run_ = Run(config=dict(spec.config, **spec.traffic["recipe"]))
    out = loop(spec.traffic["loop"]).window(prog, spec, run_, seed, seconds,
                                            trace, device, t_start)
    sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    prog.graphs.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run_, out, peak


def check(spec, run_: Run, out, seed: int) -> list[dict]:
    """The judged answers of a window's outputs."""
    return loop(spec.traffic["loop"]).check(spec, run_, out, seed)


def run(spec, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    """One run of the cell; returns the result line (a dict), its "checks"
    last."""
    device = torch.device(device)
    run_, out, peak = window(spec, seed, seconds, trace, device, t_start)
    answers = check(spec, run_, out, seed)
    del out
    readings = {n: judge.reading(answers, n) for n in spec.limits}
    correct, checks = judge.verdict(readings, spec.limits)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = reader(m["name"])(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {
        "correct": correct,
        "attempted": run_.attempted,
        "failed": judge.failed_answers(answers, spec.limits),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": spec.chips,
            "memory_peak_bytes": peak,
        },
        "card": card_line() if device.type == "cuda" else "cpu",
    }
    if trace and run_.trace is not None:
        line["device"]["busy_s"] = run_.trace.busy_s
        line["device"]["window_s"] = run_.trace.window_s
        line["breakdown"] = {"device_ops": run_.trace.top_ops(),
                             "idle_gaps": run_.trace.idle_gaps()}
    line["detail"] = {
        "images": [{k: v for k, v in r.items() if k != "traced"}
                   for r in run_.images],
        "answers": answers,
        "sweeps": run_.sweeps, "replays": run_.replays,
        "window_s": run_.window_s, "setup_s": run_.setup_s,
    }
    line["checks"] = checks
    return line


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__("forbidden modules loaded: " + ", ".join(found))
        self.found = found
