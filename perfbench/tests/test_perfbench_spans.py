"""The readers of the program's own spans and counters
(perfbench/spans.py and the metrics that use it) on synthetic records:
they read the last records made without the profiler, as many as the
window's untraced images, and report nothing where there are none."""

import pytest

from perfbench import harness
from perfbench.harness import Run
from snesimage_torch.utils import profiling
from snesimage_torch.utils.profiling import RunRecord, SpanRecord

NEW = ("init_device_ms.run", "replay_device_ms.run", "sweep_idle_share.run",
       "bind_host_ms.run", "host_waits.run", "gate_closed_share.run")


def record(profiled=False, scale=1.0, device=True, gates=(36, 9, 3)):
    """A run of two replayed sweeps: init 1 + cluster 2 + pyramid 1 device
    ms, sweeps 10 and 14 ms inside an `optimize` of 30 ms, binds of 0.5
    and 1.5 host ms, 12 host waits and the gate counts (visits, closed,
    closed coarse), all times `scale`."""
    spans = []

    def add(name, parent, host_ms, device_ms=None):
        spans.append(SpanRecord(name, parent, 0, int(host_ms * 1e6),
                                device_ms * scale if device and device_ms
                                is not None else None))

    add("init", None, 5, 1.0)
    add("cluster", None, 9, 2.0)
    add("pyramid", None, 1, 1.0)
    add("optimize", None, 40, 30.0)
    add("sweep.bind", 3, 0.5 * scale)
    add("sweep.replay", 3, 0.1, 10.0)
    add("sweep.bind", 3, 1.5 * scale)
    add("sweep.replay", 3, 0.1, 14.0)
    add("final", None, 2)
    visits, closed, coarse = gates
    counts = {("host_waits", "cluster"): 10, ("host_waits", "final"): 1,
              ("host_waits", ""): int(scale),
              ("gate.visits", "optimize"): visits,
              ("gate.closed", "optimize"): closed,
              ("gate.closed_coarse", "optimize"): coarse}
    return RunRecord(profiled=profiled, cuda=device, spans=spans,
                     counts=counts)


def window(traced: int, untraced: int) -> Run:
    run = Run(config={})
    run.images = ([{"traced": True}] * traced
                  + [{"traced": False}] * untraced)
    return run


def read(name, run):
    return harness.reader(name)(run)


@pytest.fixture
def records(monkeypatch):
    """Warm-up runs, four profiled ones, then two untraced ones (scale 1
    and 3); the readers must take the last two."""
    recs = ([record(scale=100.0)] + [record(True, 50.0)] * 4
            + [record(), record(scale=3.0)])
    monkeypatch.setattr(profiling, "runs", lambda: list(recs))
    return recs


def test_readers_take_the_last_untraced_records(records):
    run = window(4, 2)
    assert read("init_device_ms.run", run) == pytest.approx((4 + 12) / 2)
    assert read("replay_device_ms.run", run) == pytest.approx(
        (10 + 14 + 30 + 42) / 4)
    assert read("sweep_idle_share.run", run) == pytest.approx(
        100 * (1 - (24 + 72) / (30 + 90)))
    assert read("bind_host_ms.run", run) == pytest.approx(
        (0.5 + 1.5 + 1.5 + 4.5) / 4)
    assert read("host_waits.run", run) == pytest.approx((12 + 14) / 2)
    assert read("gate_closed_share.run", run) == pytest.approx(
        100 * 12 / 36)
    # One untraced image: the last record alone.
    assert read("host_waits.run", window(4, 1)) == 14


@pytest.mark.parametrize("name", NEW)
def test_readers_report_nothing_without_records(name, monkeypatch):
    monkeypatch.setattr(profiling, "runs", lambda: [record(True)] * 3)
    assert read(name, window(3, 2)) is None
    monkeypatch.setattr(profiling, "runs", lambda: [record()] * 3)
    assert read(name, window(3, 0)) is None
    # A program that keeps no records, as before it kept any.
    monkeypatch.delattr(profiling, "runs")
    assert read(name, window(3, 2)) is None


def test_device_readers_need_device_times(monkeypatch):
    """On the CPU the spans carry no device times: the device readers
    report nothing, the host ones still read."""
    monkeypatch.setattr(profiling, "runs", lambda: [record(device=False)])
    run = window(0, 1)
    for name in ("init_device_ms.run", "replay_device_ms.run",
                 "sweep_idle_share.run"):
        assert read(name, run) is None
    assert read("bind_host_ms.run", run) == pytest.approx(1.0)
    assert read("host_waits.run", run) == 12


def test_gate_share_needs_read_counts(monkeypatch):
    """No gated visit, or a device count never read, gives nothing."""
    monkeypatch.setattr(profiling, "runs",
                        lambda: [record(gates=(0, 0, 0))])
    assert read("gate_closed_share.run", window(0, 1)) is None
    unread = record()
    unread._device_counts[("gate.closed", "optimize")] = object()
    monkeypatch.setattr(profiling, "runs", lambda: [unread])
    assert read("gate_closed_share.run", window(0, 1)) is None
