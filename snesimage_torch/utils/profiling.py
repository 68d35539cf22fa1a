"""Spans, counters and trace capture: what the program measures of itself.

Counterpart of snesimage_tpu/utils/profiling.py. The reference's only
observability is throttled error logging (src/lib.rs:910-915). Here:

- `span(name)` marks a stage of the program. With nothing listening (no
  `recording()` block open, no `torch.profiler` running) it returns one
  shared no-op context after a flag check. Under a running profiler it
  enters `record_function("snes.<name>")`, so the stage appears in the
  trace on the clock of the device operations. Inside `recording()` it
  keeps its host start and end and its parent span; a device span
  (`device=True`) on the card also records a pair of timing CUDA events on
  the current stream, never on a stream that is being captured.
- `count(name, n)` adds n to the open run's count of `name`, keyed by the
  innermost open span. n is an int, or a device tensor that is never read
  before the run's own last wait for the device (the gate's closed counts).
  It is the program's one counter of kernel launches ("launch.<kernel>",
  ops/_kernels.py `launch`), kernel calls ("b.frame_calls", ...) and gates
  ("gate.*", core/refine.py `GateCount`). Inside `diverted()` the counts
  go to the block's own dict instead, and the open run gets none of them:
  a CUDA graph's capture (core/graphs.py) collects what its body counted,
  where nothing ran, and each replay adds that tally.
- `recording(device)` opens the record of one run (a block nested in
  another joins the outer run). Its events and device counts are read as
  the block closes, after the run's last wait for the device: events only
  where `Event.query` says they completed, device counts through copies
  that `queue_reads` puts on the stream before that wait. So the layer
  never waits on the device itself. `runs()` keeps the last `MAX_RUNS`
  records.
- `trace(dir)` captures a `torch.profiler` trace of the block (CPU
  activity, and CUDA activity where a card is present) as a
  Chrome/Perfetto JSON file, records the block, and logs each span's and
  counter's totals at its end (`log_summary`).

The state is one process's and one thread's: the program runs one entry
at a time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

log = logging.getLogger("snesimage_torch")

TRACE_FILE = "trace.json"
# Annotations in a profiler trace start with this prefix.
PREFIX = "snes."
# Records that `runs()` keeps, the newest last.
MAX_RUNS = 256

_NULL = contextlib.nullcontext()
_run = None  # the open RunRecord, or None
# Where `count` adds: the open RunRecord, the innermost `diverted` tally,
# or None.
_sink = None
_runs: collections.deque = collections.deque(maxlen=MAX_RUNS)


@dataclasses.dataclass
class SpanRecord:
    """One span of a run: its name, the index of its parent in the run's
    spans (None at the top), host start and end (`perf_counter_ns`), and
    its device milliseconds between its two events (None for a host span,
    on the CPU, or where the events had not completed)."""

    name: str
    parent: int | None
    start_ns: int
    end_ns: int | None = None
    device_ms: float | None = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclasses.dataclass
class RunRecord:
    """What one `recording()` block recorded: whether a torch profiler was
    running when it began, its spans in the order they began, and its
    counts keyed (counter, innermost span's name or "")."""

    profiled: bool
    cuda: bool
    spans: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)
    _stack: list = dataclasses.field(default_factory=list)
    _events: dict = dataclasses.field(default_factory=dict)
    _device_counts: dict = dataclasses.field(default_factory=dict)
    _reads: list = dataclasses.field(default_factory=list)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def total(self, name: str) -> int | None:
        """The count of `name` over every span; None where a device count
        of it was never read."""
        if any(k[0] == name for k in self._device_counts):
            return None
        return sum(n for (k, _), n in self.counts.items() if k == name)

    def _open(self, name: str, device: bool) -> int:
        index = len(self.spans)
        parent = self._stack[-1] if self._stack else None
        self.spans.append(SpanRecord(name, parent, time.perf_counter_ns()))
        self._stack.append(index)
        if device and self.cuda:
            self._events[index] = _event_pair()
        return index

    def _close(self, index: int) -> None:
        self.spans[index].end_ns = time.perf_counter_ns()
        if self._stack and self._stack[-1] == index:
            self._stack.pop()
        pair = self._events.get(index)
        if pair is not None and pair[0] is not None:
            if torch.cuda.is_current_stream_capturing():
                pair[0] = None
            else:
                pair[1].record()

    def _count(self, name: str, n) -> None:
        key = (name, self.spans[self._stack[-1]].name if self._stack else "")
        if isinstance(n, torch.Tensor):
            if n.device.type != "cuda":
                n = int(n)
            elif key in self._device_counts:
                self._device_counts[key].add_(n)
                return
            else:
                self._device_counts[key] = n.detach().to(torch.int64,
                                                         copy=True)
                return
        self.counts[key] = self.counts.get(key, 0) + n

    def _queue_reads(self) -> None:
        for key, value in self._device_counts.items():
            host = torch.empty(value.shape, dtype=value.dtype,
                               pin_memory=True)
            host.copy_(value, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._reads.append((key, host, done))

    def _resolve(self) -> None:
        """Reads what has completed on the device, without waiting: of
        each count, the read queued last, and nothing where that read has
        not completed (`total` then gives None)."""
        last = {key: (host, done) for key, host, done in self._reads}
        for key, (host, done) in last.items():
            if done.query():
                del self._device_counts[key]
                self.counts[key] = self.counts.get(key, 0) + int(host)
        self._reads.clear()
        for index, (start, end) in self._events.items():
            if start is not None and end.query():
                self.spans[index].device_ms = start.elapsed_time(end)
        self._events.clear()
        self._stack.clear()


def _event_pair() -> list:
    """[start, end] timing events, the start recorded now on the current
    stream; [None, None] while the stream is being captured."""
    if torch.cuda.is_current_stream_capturing():
        return [None, None]
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return [start, torch.cuda.Event(enable_timing=True)]


class _Span:
    __slots__ = ("name", "device", "annotation", "run", "index")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self.annotation = self.run = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(PREFIX
                                                             + self.name)
            self.annotation.__enter__()
        if _run is not None:
            self.run = _run
            self.index = _run._open(self.name, self.device)
        return self

    def __exit__(self, *exc):
        if self.run is not None:
            self.run._close(self.index)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, device: bool = False):
    """A context marking the stage `name` (module docstring); `device`
    times it on the card's clock too."""
    if _run is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, device)


def count(name: str, n=1) -> None:
    """Adds n to the open run's count of `name` (or to the innermost
    `diverted` tally); nothing outside `recording()`."""
    if _sink is not None:
        _sink._count(name, n)


class _Tally(dict):
    """What a `diverted` block counted: {counter: total}."""

    def _count(self, name: str, n) -> None:
        self[name] = self.get(name, 0) + n


@contextlib.contextmanager
def diverted():
    """Collects the counts made in the block into the dict it yields,
    with or without a `recording()` open, and adds none of them to the
    open run."""
    global _sink
    outer, tally = _sink, _Tally()
    _sink = tally
    try:
        yield tally
    finally:
        _sink = outer


def queue_reads() -> None:
    """Queues on the current stream the copies to the host of the open
    run's device counts: call it just before a wait for the device that
    the program makes anyway, which completes them."""
    if _run is not None and _run._device_counts:
        _run._queue_reads()


@contextlib.contextmanager
def recording(device=None):
    """Records the block as one run (module docstring); with `device` on
    the card, device spans are timed by CUDA events. Yields the
    RunRecord; a block inside another yields the outer one."""
    global _run, _sink
    if _run is not None:
        yield _run
        return
    cuda = device is not None and torch.device(device).type == "cuda"
    record = RunRecord(profiled=bool(_autograd_profiler._is_profiler_enabled),
                       cuda=cuda)
    outer = _sink
    _run = record
    if outer is None:
        _sink = record
    try:
        yield record
    finally:
        _run, _sink = None, outer
        record._resolve()
        _runs.append(record)


def runs() -> list:
    """The last `MAX_RUNS` runs' records, oldest first."""
    return list(_runs)


def summary(record: RunRecord) -> list[str]:
    """One line a span name (total host seconds, calls, host ms a call,
    and device seconds where every call was timed on the card), then one
    a counter (its total, and by innermost span)."""
    lines = []
    by_name: dict = {}
    for s in record.spans:
        by_name.setdefault(s.name, []).append(s)
    for name, spans in sorted(by_name.items(),
                              key=lambda kv: -sum(s.host_ms for s in kv[1])):
        total = sum(s.host_ms for s in spans) / 1e3
        line = (f"{name}: {total:.3f}s total, {len(spans)} calls, "
                f"{total / len(spans) * 1e3:.2f}ms/call")
        device = [s.device_ms for s in spans]
        if all(d is not None for d in device):
            line += f", device {sum(device) / 1e3:.3f}s"
        lines.append(line)
    names = sorted({k for k, _ in record.counts})
    for name in names:
        parts = ", ".join(f"{where or '-'} {n}" for (k, where), n
                          in sorted(record.counts.items()) if k == name)
        lines.append(f"{name}: {record.total(name)} ({parts})")
    return lines


def log_summary(record: RunRecord) -> None:
    for line in summary(record):
        log.info("timing | %s", line)


@contextlib.contextmanager
def trace(trace_dir: str | None, device=None):
    """Capture a `torch.profiler` trace of the block into
    `trace_dir`/trace.json (CPU activity, and CUDA activity where a card is
    present), record the block's spans and counters (`recording(device)`)
    and log their totals; does nothing when no directory is given."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with recording(device) as record:
            yield
    log_summary(record)
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
