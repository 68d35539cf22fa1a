"""The program's spans and counters (snesimage_torch/utils/profiling.py) on
the CPU: off they cost a flag check and record nothing; `pipeline.run`
records one run of named, nested spans and its host waits; under a
running profiler the spans are annotations; the gate counts reach the
counters; `diverted` keeps counts from the open run. The CUDA events of
device spans need the card: the benchmark's traced runs (perfbench/) read
them there."""

import collections

import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core import init, pipeline
from snesimage_torch.testing import bench_image, single_torch_thread
from snesimage_torch.utils import profiling

# 32x32, 2x2 palettes, three gated channel sweeps: the rank-1 gate at a
# margin where some gates close.
GATED = dict(subpalette_count=2, subpalette_size=2, width=32, height=32,
             max_steps=3, converge_tol=0.0, schedule="channel", prescreen=8,
             prescreen_full=2, gate_margin=0.01)
STAGES = ("init", "cluster", "pyramid", "optimize", "final")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with single_torch_thread():
        yield


@pytest.fixture(autouse=True)
def fresh_runs(monkeypatch):
    monkeypatch.setattr(profiling, "_runs",
                        collections.deque(maxlen=profiling.MAX_RUNS))


@pytest.fixture(scope="module")
def image():
    return np.ascontiguousarray(bench_image(0)[112:144, 112:144])


def test_off_enters_no_annotation_and_records_nothing(image, monkeypatch):
    """Without `recording()` and without a profiler a span is one shared
    no-op, a count does nothing, and `run_fused` leaves no record."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b", device=True)
    profiling.count("host_waits")
    config = QuantConfig(**dict(GATED, max_steps=1))
    pipeline.run_fused(image, config, device="cpu")
    assert profiling.runs() == []


def test_run_records_its_stages(image, monkeypatch):
    """`pipeline.run` equals `run_fused` bit for bit and leaves one record:
    the five stages at the top, every sweep inside `optimize`, one sweep
    span a step, a host wait at least for every k-means iteration, the
    gate counts of `run_fused` recorded alike, and no device times on the
    CPU."""
    config = QuantConfig(**GATED)
    with profiling.recording() as fused:
        want, want_errors, _ = pipeline.run_fused(image, config,
                                                  device="cpu")
    iterations = []
    kmeans = init.lloyd_kmeans

    def counted(*args, **kw):
        km = kmeans(*args, **kw)
        iterations.append(int(km.iterations.max()))
        return km

    monkeypatch.setattr(init, "lloyd_kmeans", counted)
    got, errors, info = pipeline.run(image, config, device="cpu")
    assert errors == want_errors
    for f in ("tile_palettes", "palette", "palette_map"):
        assert torch.equal(getattr(got, f), getattr(want, f))
    (_, record) = profiling.runs()
    assert not record.profiled
    top = [s.name for s in record.spans if s.parent is None]
    assert top == list(STAGES)
    optimize = [s.name for s in record.spans].index("optimize")
    sweeps = [s for s in record.spans if s.name.startswith("sweep.")]
    assert len(sweeps) == len(errors) == config.max_steps
    assert all(s.parent == optimize for s in sweeps)
    assert all(s.end_ns >= s.start_ns for s in record.spans)
    assert all(s.device_ms is None for s in record.spans)
    assert len(iterations) == 2
    assert record.total("host_waits") >= sum(iterations)
    assert record.counts[("host_waits", "final")] == 1
    assert record.total("gate.visits") == fused.total("gate.visits") == 36
    assert record.total("gate.closed") == fused.total("gate.closed") > 0
    assert record.total("gate.closed_coarse") == 0


def test_spans_are_annotations_under_a_profiler(image):
    """Under a CPU profiler the spans of `run_fused` appear as `snes.*`
    annotations, each sweep inside `optimize`; a run recorded under the
    profiler is marked `profiled`."""
    config = QuantConfig(subpalette_count=2, subpalette_size=2, width=16,
                         height=16, max_steps=1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipeline.run_fused(np.ascontiguousarray(image[:16, :16]), config,
                           device="cpu")
        with profiling.recording():
            pass
    spans = {}
    for e in prof.events():
        if e.name.startswith(profiling.PREFIX):
            spans.setdefault(e.name, []).append(e.time_range)
    assert set(spans) >= {"snes." + s for s in STAGES} | {"snes.sweep.eager"}
    (outer,) = spans["snes.optimize"]
    (inner,) = spans["snes.sweep.eager"]
    assert outer.start <= inner.start and inner.end <= outer.end
    assert [r.profiled for r in profiling.runs()] == [True]


def test_runs_keeps_the_last_records():
    """`runs()` keeps the last MAX_RUNS (256) records, oldest first; a
    recording inside another joins it; counts are keyed by the innermost
    span."""
    for k in range(profiling.MAX_RUNS + 44):
        with profiling.recording() as record:
            with profiling.recording() as inner:
                assert inner is record
                profiling.count("n", k)
                with profiling.span("stage"):
                    profiling.count("n")
    runs = profiling.runs()
    assert len(runs) == profiling.MAX_RUNS == 256
    assert [r.counts[("n", "")] for r in (runs[0], runs[-1])] == [44, 299]
    assert runs[-1].counts[("n", "stage")] == 1
    assert runs[-1].total("n") == 300


KERNEL_CALLS = ("b.source_calls", "b.frame_calls", "d.calls", "f.calls")


@pytest.mark.parametrize("change,per_visit", [
    (dict(perceptual_palettes=True, prescreen_full=4), (0, 2, 1, 0)),
    (dict(perceptual_palettes=True, prescreen_full=4, width=40, height=24),
     (0, 3, 0, 1)),
    ({}, (2, 0, 0, 0))], ids=["perceptual", "perceptual-40x24", "red-mean"])
def test_visits_count_kernel_calls(change, per_visit):
    """One eager channel sweep (2x2 palettes, 12 visits): a perceptual
    visit at 32x32 calls kernel D once and kernel B twice on the
    finalists' frames built in torch; at 40x24, where D cannot run, kernel
    F once and B three times (its quarter frames, then the finalists); a
    red-mean visit calls B twice in source mode, and neither D nor F. The
    run's initial carried error is one more call of B on a frame, outside
    the sweep."""
    config = QuantConfig(**dict(GATED, gate_margin=0.0, max_steps=1,
                                **change))
    img = np.ascontiguousarray(
        bench_image(0)[100:100 + config.height, 100:100 + config.width])
    pipeline.run(img, config, device="cpu")
    (record,) = profiling.runs()
    visits = 12
    assert tuple(record.counts.get((c, "sweep.eager"), 0)
                 for c in KERNEL_CALLS) == tuple(n * visits for n in per_visit)
    assert record.counts[("b.frame_calls", "optimize")] == 1


def test_diverted_counts_apart():
    """Counts inside `diverted` go to its dict, with or without an open
    run, and none reaches the run; an inner block takes its own counts,
    and the run's counting resumes after the block."""
    with profiling.diverted() as alone:
        profiling.count("a", 2)
    assert alone == {"a": 2} and profiling.runs() == []
    with profiling.recording() as record:
        profiling.count("a")
        with profiling.diverted() as outer:
            profiling.count("a", 3)
            with profiling.diverted() as inner:
                profiling.count("b")
            with profiling.recording() as joined:
                profiling.count("a")
        profiling.count("b", 4)
    assert joined is record
    assert outer == {"a": 4} and inner == {"b": 1}
    assert record.counts == {("a", ""): 1, ("b", ""): 4}
