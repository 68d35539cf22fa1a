"""Step timers and trace capture.

Counterpart of snesimage_tpu/utils/profiling.py. The reference's only
observability is throttled error logging (src/lib.rs:910-915). Here:
`StepTimer` accumulates wall-clock time by phase, and `trace` captures a
`torch.profiler` trace of the CPU and, on the card, of CUDA activity, as a
Chrome/Perfetto JSON file (the port's counterpart of a `jax.profiler`
trace; open it in ui.perfetto.dev or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field

import torch

log = logging.getLogger("snesimage_torch")

TRACE_FILE = "trace.json"


@dataclass
class StepTimer:
    """Accumulates per-phase wall-clock time; report with `summary()`."""

    times: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def time(self, name: str, *, block_on=None):
        """Times the block under `name`; with `block_on` (a tensor) the
        clock stops once its device has finished the work queued so far."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.is_cuda:
                torch.cuda.synchronize(block_on.device)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.times.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {n} calls, "
                         f"{total / n * 1e3:.2f}ms/call")
        return "\n".join(lines)

    def log_summary(self) -> None:
        for line in self.summary().splitlines():
            log.info("timing | %s", line)


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """Capture a `torch.profiler` trace of the block into
    `trace_dir`/trace.json (CPU activity, and CUDA activity where a card is
    present); does nothing when no directory is given."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
