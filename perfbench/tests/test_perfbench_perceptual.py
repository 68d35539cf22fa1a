"""The perceptual cell (`mode1-perceptual.balanced-256`) on the CPU: a
rehearsal through the harness at 64x64 with at most two sweeps an image,
the planted faults reading over its limits, the import guard over its
reference, kernel D's least time against a count worked out by hand, and
the reader of `built_frame_calls.run`."""

import ast
import time
from pathlib import Path

import pytest
import torch

from perfbench import control, harness
from perfbench.harness import Run
from perfbench.roofline import D_coarse_ciede
from snesimage_torch.utils import profiling
from snesimage_torch.utils.profiling import RunRecord

HERE = Path(__file__).resolve().parents[1]
CELL = "mode1-perceptual.balanced-256"
SEED = 2 ** 31 + 54321
BANNED = {"jax", "jaxlib", "flax", "snesimage_tpu", "snesimage_torch"}


def small():
    """The cell at 64x64, 2 subpalettes of 3 colours, 2 sweeps an image."""
    spec = harness.cell_spec(CELL)
    spec.config = dict(spec.config, width=64, height=64, subpalette_count=2,
                       subpalette_size=3)
    spec.traffic = dict(spec.traffic, warmup_images=1, trace_images=1,
                        recipe=dict(spec.traffic["recipe"], max_steps=2))
    return spec


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1], ids=["timed", "traced"])
def test_rehearsal(trace):
    spec = small()
    line = harness.run(spec, SEED, 0.2, bool(trace), "cpu",
                       time.perf_counter())
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == {"json_bad", "remap_off", "tiles_off",
                                   "steps_bad", "error_gap", "stall"}
    wanted = {m["name"] for m in (spec.per_layer if trace
                                  else spec.end_to_end)}
    assert set(line["metrics"]) <= wanted
    if trace:
        # Two finalist calls a visit, 18 visits a sweep, and an image's
        # initial carried error, one call over its two sweeps.
        got = line["metrics"]["built_frame_calls.run"]["value"]
        assert got == pytest.approx(2 * 18 + 1 / 2)
    else:
        assert {"images_per_s", "final_error", "setup_s"} <= set(
            line["metrics"])


def _window():
    spec = small()
    run_, out, _ = harness.window(spec, SEED, 0.2, False,
                                  torch.device("cpu"), time.perf_counter())
    return spec, run_, out


def test_control_reads_over_the_limits():
    spec, run_, out = _window()
    assert control.readings(spec, harness.check(spec, run_, out, SEED))[
        "correct"]
    low = control.readings(spec, control.control_answers(spec, run_, out,
                                                         SEED))
    assert low["correct"] is False


@pytest.mark.parametrize("fault,number", [("stall", "stall"),
                                          ("answer", "remap_off")])
def test_faults_read_over_the_limits(monkeypatch, fault, number):
    from snesimage_torch.core import graphs
    from snesimage_torch.io import json_out

    # `plant` replaces these two; the test puts them back afterwards.
    monkeypatch.setattr(graphs.SweepRunner, "sweep", graphs.SweepRunner.sweep)
    monkeypatch.setattr(json_out, "state_to_json", json_out.state_to_json)
    control.plant(fault)
    spec, run_, out = _window()
    got = control.readings(spec, harness.check(spec, run_, out, SEED))
    assert got["correct"] is False and got[number] > spec.limits[number]


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("name", ["lab.py", "perceptual.py"])
def test_reference_imports_nothing_of_the_program(name):
    got = _imports(HERE / "reference" / name)
    assert not {n.split(".")[0] for n in got} & BANNED
    assert all(n.startswith("perfbench.reference") or n in (
        "__future__", "numpy", "torch") for n in got), got


def test_d_by_hand():
    """64x64, 2 subpalettes of 3 colours, explore 4: 36 candidates a
    visit, 18 visits a sweep."""
    cfg = dict(subpalette_count=2, subpalette_size=3, width=64, height=64,
               schedule="channel", prescreen=8, prescreen_full=4,
               channel_explore=4, perceptual_palettes=True)
    b = 36
    n_bytes = (3 * 4096 * 4 + 2 * 4096 * 4 + 3 * 4096 * 4 + 3 * 256 * 4
               + b * 3 * 2 * 4 + 9 * (256 + 64 + 16 + 4) * 4
               + b * 4 * 18 * 4 + b * 4096 * 4)
    ops = b * (150 * 4096 + 668 * 256 + 680 * (64 + 16 + 4))
    visit = max(n_bytes / 3.35e12, ops / 67e12)
    assert visit == ops / 67e12  # bound by its operations
    assert D_coarse_ciede.least_seconds_visit(cfg) == pytest.approx(visit)
    assert D_coarse_ciede.least_seconds(cfg, [2, 1]) == pytest.approx(
        3 * 18 * visit)
    for other in (dict(perceptual_palettes=False), dict(dither=True),
                  dict(prescreen_pre=16)):
        with pytest.raises(ValueError):
            D_coarse_ciede.least_seconds_visit(dict(cfg, **other))


def _record(counts: dict) -> RunRecord:
    return RunRecord(profiled=False, cuda=False, counts=counts)


def test_built_frame_calls_reader(monkeypatch):
    """`b.frame_calls` over the untraced images' records, a sweep; nothing
    where a record lacks the counter, as a program that keeps none."""
    run = Run(config={})
    run.images = [{"traced": True, "steps": 8}] + [
        {"traced": False, "steps": 8}] * 2
    recs = [_record({("b.frame_calls", "optimize"): 1,
                     ("b.frame_calls", "sweep.replay"): n})
            for n in (100, 720 * 8, 720 * 8)]
    monkeypatch.setattr(profiling, "runs", lambda: recs)
    read = harness.reader("built_frame_calls.run")
    assert read(run) == pytest.approx((2 + 2 * 720 * 8) / 16)
    recs[-1] = _record({("b.source_calls", "optimize"): 5})
    assert read(run) is None
    monkeypatch.delattr(profiling, "runs")
    assert read(run) is None
