"""What a run's `torch.profiler` trace says: device busy time, time by
kernel, the longest device operations and the longest idle gaps.

The traced window is the harness's own span `TRACED` (a
`record_function` annotation around the part of the window the profiler
covers). Device intervals are clipped to it. A gap is named by the
harness span and the innermost host operation that were running when the
device fell idle.

Kernel names map to the port's kernels A-G as `profile_torch.py`
`KERNEL_OF` maps them (a copy, so that the benchmark keeps its own):
every other device operation is glue.
"""

from __future__ import annotations

import bisect

import torch

TRACED = "perfbench.traced_window"
# The harness's own spans start with this prefix.
SPAN = "perfbench."

KERNEL_OF = {
    "select_colors_kernel": "A",
    "prologue_kernel": "A",
    "render_kernel": "A",
    "multiscale_kernel": "B",
    "coarse_redmean_kernel": "C",
    "coarse_ciede_kernel": "D",
    "pooled_wins_redmean_kernel": "E",
    "pooled_wins_ciede_kernel": "F",
    "dither_remap_kernel": "G",
}


def kernel_of(name: str) -> str | None:
    for part, kernel in KERNEL_OF.items():
        if part in name:
            return kernel
    return None


def _union(intervals) -> float:
    busy, end = 0, None
    for a, b in sorted(intervals):
        if end is None or b > end:
            busy += b - (a if end is None else max(a, end))
            end = b
    return busy


class Trace:
    """The events of one profiler run, in nanoseconds."""

    def __init__(self, prof):
        device, host = [], []
        window = None
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            item = (start, start + e.duration_ns(), e.name())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # A host annotation is mirrored on the device's timeline:
                # it is no device operation.
                if not (e.is_user_annotation() or item[2].startswith(SPAN)):
                    device.append(item)
            else:
                host.append(item)
                if item[2] == TRACED:
                    window = item[:2]
        if window is None:
            raise RuntimeError("the trace holds no traced-window span")
        self.start, self.end = window
        self.device = sorted((max(a, self.start), min(b, self.end), n)
                             for a, b, n in device
                             if b > self.start and a < self.end)
        self.host = sorted(host)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        return _union((a, b) for a, b, _ in self.device) / 1e9

    def seconds_by_kernel(self) -> dict:
        """Device seconds of each kernel A-G and of the glue."""
        out: dict = {}
        for a, b, n in self.device:
            k = kernel_of(n) or "glue"
            out[k] = out.get(k, 0.0) + (b - a) / 1e9
        return out

    def top_ops(self, n: int = 10) -> list:
        """The n device operations, by name, that took the most time."""
        by_name: dict = {}
        for a, b, name in self.device:
            by_name[name] = by_name.get(name, 0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest stretches of the window with nothing on the
        device, each named "<harness span>/<host operation>" by what was
        running on the host when the gap began."""
        gaps, end = [], self.start
        for a, b, _ in self.device:
            if a > end:
                gaps.append((a - end, end))
            end = max(end, b)
        if self.end > end:
            gaps.append((self.end - end, end))
        gaps = sorted(gaps, reverse=True)[:n]
        starts = [h[0] for h in self.host]
        out = []
        for length, at in gaps:
            span, op = "", ""
            span_len = op_len = None
            for a, b, name in self.host[:bisect.bisect_right(starts, at)]:
                if b <= at or name == TRACED:
                    continue
                if name.startswith(SPAN):
                    if span_len is None or b - a < span_len:
                        span, span_len = name[len(SPAN):], b - a
                elif op_len is None or b - a < op_len:
                    op, op_len = name, b - a
            out.append([f"{span or 'window'}/{op or 'none'}"[:120],
                        length / 1e9])
        return out
