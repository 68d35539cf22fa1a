"""Rehearsals of each cell's loop on the CPU through the harness's own
code, at a size a test run holds, and the check seeing the control and
planted faults as not correct. The command itself refuses to run without
a card; `cuda` marks the run on the card."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2 ** 31 + 12345


def small(cell: str):
    """The cell at 64x64 (32x32 dithered: the Floyd-Steinberg twin is a
    Python loop), 2 subpalettes of 3 colours, at most 2 sweeps an image."""
    spec = harness.cell_spec(cell)
    side = 32 if spec.config["dither"] else 64
    spec.config = dict(spec.config, width=side, height=side,
                       subpalette_count=2, subpalette_size=3)
    mix = dict(spec.traffic, warmup_images=1, warmup_steps=1, trace_images=1,
               trace_steps=2)
    if mix["loop"] == "images":
        mix["recipe"] = dict(mix["recipe"],
                             max_steps=min(2, mix["recipe"]["max_steps"]))
    spec.traffic = mix
    return spec


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1], ids=["timed", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(cell, trace):
    spec = small(cell)
    line = harness.run(spec, SEED, 0.2, bool(trace), "cpu",
                       time.perf_counter())
    assert json.loads(json.dumps(line)) == line
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["kind"] == "cpu"
    wanted = spec.per_layer if trace else spec.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    else:
        assert line["device"]["window_s"] > 0
        assert len(line["breakdown"]["idle_gaps"]) <= 10
        if spec.traffic["loop"] == "images":
            # Untraced images follow the traced ones for the stage clocks.
            assert {"init_share.run", "sweep_ms.run"} <= set(line["metrics"])
    for check in line["checks"].values():
        assert check["value"] <= check["limit"]


def _run_small(cell, seed=SEED):
    spec = small(cell)
    run_, out, _ = harness.window(spec, seed, 0.2, False,
                                  torch.device("cpu"), time.perf_counter())
    return spec, run_, out


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    spec, run_, out = _run_small(cell)
    assert control.readings(spec, harness.check(spec, run_, out, SEED))[
        "correct"]
    low = control.readings(spec, control.control_answers(spec, run_, out,
                                                         SEED))
    assert low["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_stalled_sweeps_are_not_correct(cell, monkeypatch):
    from snesimage_torch.core import graphs

    def sweep(self, method, state, config, refp, err, generator, draws, *,
              left, **kw):
        return state, err.clone()

    monkeypatch.setattr(graphs.SweepRunner, "sweep", sweep)
    spec, run_, out = _run_small(cell)
    got = control.readings(spec, harness.check(spec, run_, out, SEED))
    assert got["correct"] is False and got["stall"] > spec.limits["stall"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    from snesimage_torch.io import json_out

    encode = json_out.state_to_json

    def altered(state, config):
        pm = state.palette_map.clone()
        pm[0, 0] = (pm[0, 0] + 1) % config.subpalette_size
        return encode(state.replace(palette_map=pm), config)

    monkeypatch.setattr(json_out, "state_to_json", altered)
    spec, run_, out = _run_small(cell)
    got = control.readings(spec, harness.check(spec, run_, out, SEED))
    assert got["correct"] is False and got["remap_off"] >= 1


IMAGE_CELLS = [c for c in CELLS
               if harness.cell_spec(c).traffic["loop"] == "images"]


@pytest.mark.parametrize("cell", IMAGE_CELLS)
def test_dropped_step_is_not_correct(cell, monkeypatch):
    from snesimage_torch.core import pipeline

    entry = pipeline.run_fused

    def dropped(*args, **kw):
        state, errors, info = entry(*args, **kw)
        return state, errors[:-1], info

    monkeypatch.setattr(pipeline, "run_fused", dropped)
    spec, run_, out = _run_small(cell)
    got = control.readings(spec, harness.check(spec, run_, out, SEED))
    assert got["correct"] is False and got["steps_bad"] >= 1


def test_steps_bad_counts_each_fault():
    loop = harness.loop("images")
    fixed = {"max_steps": 3, "converge_tol": 0.0}
    early = {"max_steps": 3, "converge_tol": 0.5}
    assert loop.steps_bad([3.0, 2.0, 1.0], 1.0, fixed) == 0
    assert loop.steps_bad([3.0, 2.0], 2.0, early) == 0
    assert loop.steps_bad([3.0, 2.0], 2.0, fixed) == 1
    assert loop.steps_bad([3.0, 2.0, 1.0], 1.5, fixed) == 1
    assert loop.steps_bad([3.0, float("nan"), 1.0], 1.0, fixed) == 1
    assert loop.steps_bad([], 1.0, early) == 1
    assert loop.steps_bad([4.0, 3.0, 2.0, 1.0], 1.0, early) == 1


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "snesimage_tpu_like", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_command_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
