"""The port's bench and BASELINE config runner on the CPU
(`snesimage_torch/bench.py`, `snesimage_torch/benchmarks.py`), against the
JAX package's bench.py and benchmarks.py, which they port.

The configs must be those files' `QuantConfig(...)` literals, read with
`ast` (the scripts import JAX, so they are parsed, not imported), and the
bench's JSON line must carry bench.py's keys plus `init_hash_ok`. The
measurements run at 64x64 with 2x3 palettes on the CPU; on the card the
same functions run at full size (`python -m snesimage_torch.bench`,
`chip_smoke.py` phase 43).

tests/data/bench_finals_jax.json freezes full-size runs on the bench image
that take minutes each on the CPU: the JAX package's XLA path (balanced at
seeds 0, 1 and 2, balanced without explore, `fast`) and the port on the
CPU (balanced at seeds 0, 1 and 2, and without explore), each with its
config, step errors and final error. The card's values are set beside
them in PERF.md. It is written by

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bench.py --freeze

which runs the nine runs in four worker processes (about half an hour on
8 cores); neither package changes what it computes for them."""

import ast
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from snesimage_torch import bench, benchmarks
from snesimage_torch.config import QuantConfig
from snesimage_torch.core import pipeline, refine
from snesimage_torch.core.state import new_state
from snesimage_torch.testing import bench_image, single_torch_thread

ROOT = Path(__file__).resolve().parents[1]
FROZEN = Path(__file__).with_name("data") / "bench_finals_jax.json"

# The frozen runs: name -> config (each a variant of bench.py's two).
RUNS = {
    "balanced_seed0": bench.BALANCED,
    "balanced_seed1": dict(bench.BALANCED, seed=1),
    "balanced_seed2": dict(bench.BALANCED, seed=2),
    "balanced_explore0": dict(bench.BALANCED, channel_explore=0),
    "fast": bench.FAST,
}
# What each package runs of them: the JAX package all five; the port the
# four that are not `fast`, whose card run phase 33 and the bench hold.
PACKAGE_RUNS = {
    "jax_cpu": tuple(RUNS),
    "port_cpu": ("balanced_seed0", "balanced_seed1", "balanced_seed2",
                 "balanced_explore0"),
}
# The small size of the CPU tests: 64x64 (two rows of 32x32 blocks, so
# the visit ranks through kernel C's twin) with 2x3 palettes.
SMALL = dict(subpalette_count=2, subpalette_size=3, width=64, height=64)
# A small channel recipe with no explore draws for the BASELINE runner.
CHANNEL = dict(SMALL, schedule="channel", prescreen=8, prescreen_full=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores,
    and thread pools that ask for more than there are wait on each
    other."""
    with single_torch_thread():
        yield


def _crop(seed: int = 0) -> np.ndarray:
    return np.ascontiguousarray(bench_image(seed)[:64, :64])


def _quant_config_literals(path: Path) -> list[dict]:
    """The keyword literals of every `QuantConfig(...)` call in a file, in
    the order of the source."""
    calls = [n for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.Call) and getattr(n.func, "id", None)
             == "QuantConfig"]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [{k.arg: ast.literal_eval(k.value) for k in n.keywords}
            for n in calls]


def _bench_py_keys() -> tuple[set, set]:
    """The keys of bench.py's result line and of its `fast_config`."""
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if isinstance(node, ast.Dict):
            keys = {ast.literal_eval(k) for k in node.keys}
            if "fast_config" in keys:
                inner = node.values[[ast.literal_eval(k) for k in
                                     node.keys].index("fast_config")]
                return keys, {ast.literal_eval(k) for k in inner.keys}
    raise AssertionError("bench.py has no result line")


def _asdicts_agree(params: dict) -> None:
    from snesimage_tpu.config import QuantConfig as JaxQuantConfig

    assert (dataclasses.asdict(QuantConfig(**params))
            == dataclasses.asdict(JaxQuantConfig(**params)))


@pytest.mark.parametrize("name", ["BALANCED", "FAST"])
def test_bench_configs_are_bench_pys(name):
    """bench.py's `config` and `config_fast` literals, in that order, and
    both packages' QuantConfig build the same fields from them."""
    literals = _quant_config_literals(ROOT / "bench.py")
    assert len(literals) == 2
    params = getattr(bench, name)
    assert params == literals[["BALANCED", "FAST"].index(name)]
    _asdicts_agree(params)


@pytest.mark.parametrize("tag", ["c1", "c2", "c3", "c4", "c5"])
def test_benchmark_configs_are_benchmarks_pys(tag):
    """benchmarks.py's five literals, c1 to c5 in the order of the
    source, with their names (c5's followed by the batch size)."""
    literals = _quant_config_literals(ROOT / "benchmarks.py")
    configs = dict(benchmarks.CONFIGS)
    assert list(configs) == ["c1", "c2", "c3", "c4", "c5"]
    name, params = configs[tag]
    assert params == literals[list(configs).index(tag)]
    _asdicts_agree(params)
    assert f'"{name}' in (ROOT / "benchmarks.py").read_text()


def test_bench_line_and_measure_on_cpu():
    """`bench.bench` at the small size on the CPU: bench.py's keys plus
    `init_hash_ok` (false here: the hash pins the full-size init), and the
    balanced run's step errors and final equal `run_fused`'s to the bit."""
    balanced = dict(bench.BALANCED, **SMALL, max_steps=1)
    fast = dict(bench.FAST, **SMALL, max_steps=1)
    img = _crop()
    line = bench.bench(img, "cpu", balanced=balanced, fast=fast, repeats=1,
                       device="cpu")
    keys, fast_keys = _bench_py_keys()
    assert set(line) == keys | {"init_hash_ok"}
    assert set(line["fast_config"]) == fast_keys
    assert line["device"] == "cpu" and line["init_hash_ok"] is False
    _, errors, info = pipeline.run_fused(img, QuantConfig(**balanced),
                                         device="cpu")
    assert line["step_errors"] == errors and len(errors) == 1
    assert line["final_error"] == info["final_error"] == errors[-1]
    assert line["in_band"] == (errors[-1] <= 115.8)
    assert line["value"] == 1.0 / line["elapsed_seconds"]
    assert line["all_runs_seconds"] == [line["elapsed_seconds"]]
    assert math.isfinite(line["fast_config"]["final_error"])
    json.dumps(line)


@pytest.mark.parametrize("module", [bench, benchmarks])
def test_main_without_a_card_prints_one_error_line(module, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.main([]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] is None and "no CUDA device" in line["error"]


def test_run_single_on_cpu():
    """`run_single`'s fields, its final the `error_of` of the state its
    timed chain ends in (the same chain, run again: the CPU's bits do not
    change between runs)."""
    config = QuantConfig(**CHANNEL)
    img = _crop()
    out = benchmarks.run_single("small", config, img, 1, device="cpu")
    assert set(out) == {"config", "seconds", "images_per_sec", "final_error",
                        "step_errors"}
    state = new_state(img, config, "cpu")
    state = pipeline.cluster(pipeline.initialize(state, config), config)
    refp = refine.make_reference_pyramid(state)
    state, errors = pipeline.optimize(state, config, refp=refp, max_steps=1)
    assert out["step_errors"] == errors.tolist()
    assert out["final_error"] == float(refine.error_of(state, config, refp))
    assert out["images_per_sec"] == 1.0 / out["seconds"]


def test_run_batched_on_cpu():
    """`run_batched` on three small images in chunks of two."""
    imgs = np.stack([_crop(s) for s in (3, 4, 5)])
    out = benchmarks.run_batched("small", QuantConfig(**CHANNEL), imgs, 1, 2,
                                 device="cpu")
    assert set(out) == {"config", "seconds", "images", "images_per_sec",
                        "mean_final_error"}
    assert out["images"] == 3 and out["images_per_sec"] > 0
    assert math.isfinite(out["mean_final_error"])


@pytest.mark.parametrize("package", list(PACKAGE_RUNS))
def test_frozen_finals_hold_the_bench_configs(package):
    """Each frozen run carries its config (bench.BALANCED and its
    variants, bench.FAST), its step errors and its final."""
    frozen = json.loads(FROZEN.read_text())[package]
    assert tuple(frozen) == PACKAGE_RUNS[package]
    for name, run in frozen.items():
        assert run["config"] == RUNS[name], name
        want_steps = 8 if name.startswith("balanced") else None
        assert want_steps is None or len(run["step_errors"]) == want_steps
        assert run["final_error"] == run["step_errors"][-1]
        assert all(b <= a for a, b in zip(run["step_errors"],
                                          run["step_errors"][1:]))


def _frozen_run(job):
    """One run of the freeze, in a worker process: (package, name, its
    record)."""
    package, name = job
    img = bench_image(0)
    params = RUNS[name]
    if package == "jax_cpu":
        from snesimage_tpu.config import QuantConfig as JaxQuantConfig
        from snesimage_tpu.core import pipeline as jax_pipeline

        _, errors, info = jax_pipeline.run_fused(img, JaxQuantConfig(**params))
    else:
        _, errors, info = pipeline.run_fused(img, QuantConfig(**params),
                                             device="cpu")
    return package, name, dict(config=params,
                               step_errors=[float(e) for e in errors],
                               final_error=float(info["final_error"]))


def _share_cores(workers: int) -> None:
    """Torch's thread pool at the worker's share of the cores: pools that
    together ask for more threads than there are cores wait on each
    other."""
    import os

    torch.set_num_threads(max(1, os.cpu_count() // workers))


def freeze(workers: int = 4) -> None:
    """Runs every package's runs in `workers` processes and rewrites FROZEN
    as each run ends, so that an interrupted freeze keeps what it ran. The
    JAX package's runs (about 4 minutes each) come first, then the port's
    (about 10 minutes each on all cores)."""
    import multiprocessing

    jobs = [(p, n) for p in PACKAGE_RUNS for n in PACKAGE_RUNS[p]]
    done = {p: {} for p in PACKAGE_RUNS}
    with multiprocessing.get_context("spawn").Pool(
            workers, _share_cores, (workers,)) as pool:
        for package, name, record in pool.imap_unordered(_frozen_run, jobs):
            done[package][name] = record
            print(package, name, record["step_errors"], flush=True)
            out = {p: {n: done[p][n] for n in PACKAGE_RUNS[p]
                       if n in done[p]} for p in PACKAGE_RUNS}
            FROZEN.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--freeze"]:
        sys.exit("usage: python tests/test_torch_bench.py --freeze")
    freeze()
