"""Kernel B (`multiscale_kernel`, the SSIMULACRA2 feature sums of frames).

Per image: the carried error of the initial state (one frame, six
scales). Per visit of a two-level prescreen (`prescreen` K finalists,
`prescreen_full` M of them at scale 0, no gate): the K finalists' frames
at full resolution scored at scale 1, then the M best at scale 0. A
dithered visit first scores every candidate's full-resolution frame at
scales 2-5 (the coarse rank, which the undithered visit takes from kernel
C). A gated recipe is not counted: there the work depends on which gates
close.
"""

from __future__ import annotations

from perfbench.roofline import (
    NUM_SCALES, candidates, metric_call, visits_per_sweep)

KERNEL = "B"


def least_seconds(config: dict, steps: list[int]) -> float:
    if config.get("gate_margin") or config.get("prescreen_pre"):
        raise ValueError("kernel B's roofline counts ungated two-level visits")
    k, m = config["prescreen"], config["prescreen_full"]
    if not 0 < m < k:
        raise ValueError("kernel B's roofline needs 0 < prescreen_full < prescreen")
    visit = (metric_call(config, k, 1, 1, 1) + metric_call(config, m, 0, 1, 0))
    if config.get("dither"):
        visit += metric_call(config, candidates(config), 2, NUM_SCALES - 2, 2)
    per_image = metric_call(config, 1, 0, NUM_SCALES, 0)
    return sum(per_image + n * visits_per_sweep(config) * visit for n in steps)
