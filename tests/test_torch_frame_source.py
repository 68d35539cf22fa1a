"""Kernel B's source mode (ops/cuda_metric.py `FrameSource`) on the CPU.

An undithered red-mean visit hands kernel B its finalists as a
`FrameSource` (the candidates, their rows and the win rule), which the card
builds into frames in its loads and the twin through `FrameSource.frames`,
the visit's own `candidate_frames`.
Here the visit's finalists stages give exactly what the old glue gave,
frames from `candidate_frames` on the distance planes of
`SlotContext.cand_dist`; the profiling counter "b.source_calls" counts two
such calls a visit on that path and none on the dithered and perceptual
ones. The card's kernel against the frames mode: tests/test_torch_cuda.py.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core import pipeline, refine
from snesimage_torch.core.state import new_state, stack_states
from snesimage_torch.ops import cuda_metric
from snesimage_torch.ops.color import expand_5bit_to_8bit, srgb_u8_to_linear
from snesimage_torch.ops.ssimulacra2 import reference_pyramid
from snesimage_torch.testing import bench_image, single_torch_thread
from snesimage_torch.utils import profiling

# 64x64, 2x4 palettes, a two-level prescreen: 8 finalists at scale 1, 2 at
# scale 0.
FINALISTS = dict(subpalette_count=2, subpalette_size=4, width=64, height=64,
                 schedule="channel", prescreen=8, prescreen_full=2,
                 channel_explore=0, accept_margin=0.005)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with single_torch_thread():
        yield


@lru_cache(maxsize=None)
def _state(corner: int, coarse: bool):
    config = QuantConfig(**FINALISTS, gate_margin=0.01, gate_coarse=coarse)
    img = np.ascontiguousarray(
        bench_image(0)[corner:corner + 64, corner:corner + 64])
    state = pipeline.cluster(pipeline.initialize(
        new_state(img, config, "cpu"), config), config)
    return state, config


# A visit's gate: none, or the carry with the carried error moved by the
# offset (+10: every gate opens, -10: every gate closes), and whether it
# may close (False: scored exactly, the confirmation sweep's visits), and
# whether the coarse gate decides first.
GATES = {"ungated": None, "open": (10.0, True, False),
         "closed": (-10.0, True, False), "exact": (-10.0, False, False),
         "coarse-closed": (-10.0, True, True)}


def _visit(n_img: int, gate_kind: str):
    """(config, pyramid, slot context, candidates, gate) of a visit of
    slot (1, 2) of one image or a batch of two, with 48 numpy-made
    candidates an image, and the gate of GATES[gate_kind]."""
    kind = GATES[gate_kind]
    coarse = kind is not None and kind[2]
    states = [_state(corner, coarse) for corner in (96, 40)[:n_img]]
    config = states[0][1]
    state = (states[0][0] if n_img == 1
             else stack_states([s for s, _ in states]))
    refp = refine.make_reference_pyramid(state)
    ctx = refine.slot_context(state, config, 1, 2,
                              refine.compute_d_all(state, config))
    lead = () if n_img == 1 else (n_img,)
    cand5 = torch.from_numpy(np.random.default_rng(n_img).integers(
        0, 32, (*lead, 48, 3)).astype(np.int32))
    gate = None
    if kind is not None:
        offset, enable, _ = kind
        gate = (refine.gate_base_fused(state, config, refp),
                refine.frame_error_fused(state, config, refp) + offset,
                enable, None)
    return config, refp, ctx, cand5, gate


def _old_frames(ctx):
    """A stand-in for `FrameSource` that builds the frames as the visit
    did before kernel B took them in its loads."""

    def build(target, cand8, cand_lin, ix, bva, lnc, frames):
        return refine.candidate_frames(
            ctx, ctx.cand_dist(refine._take(cand8, ix)),
            refine._take(cand_lin, ix))

    return build


@pytest.mark.parametrize("n_img", [1, 2])
@pytest.mark.parametrize("gate_kind", list(GATES))
def test_source_gives_the_old_frames_features(monkeypatch, n_img,
                                              gate_kind):
    """`_score_finalists` (ungated) and `_gated_finalists` (gates that
    open, close, score exactly, or close at the coarse gate) give the same
    bits with the finalists as a FrameSource as with the old glue's
    frames, for one image and a batch of two; each visit makes two source
    calls."""
    config, refp, ctx, cand5, gate = _visit(n_img, gate_kind)
    with profiling.recording() as record:
        got = refine.candidate_errors(ctx, config, refp, cand5, gate=gate)
    assert record.total("b.source_calls") == 2
    monkeypatch.setattr(refine, "FrameSource", _old_frames(ctx))
    want = refine.candidate_errors(ctx, config, refp, cand5, gate=gate)
    assert len(got) == len(want) == (2 if gate is None else 3)
    assert torch.equal(got[0], want[0])
    closed = gate_kind in ("closed", "coarse-closed")
    assert bool(torch.isfinite(got[0]).any()) != closed
    if gate is not None:
        assert torch.equal(got[2], want[2])


def test_frames_of_a_source_scores_as_its_frames():
    """Kernel B's twin scores a FrameSource as the frames its builder
    gives, with and without an image axis and a gate flag."""
    _, refp, ctx, cand5, _ = _visit(2, "ungated")
    b = cuda_metric.multiscale_feature_sums
    cand8 = expand_5bit_to_8bit(cand5)
    cand_lin = srgb_u8_to_linear(cand8)
    ix = torch.tensor([[3, 7], [40, 0]])
    frames = refine.candidate_frames(
        ctx, ctx.cand_dist(refine._take(cand8, ix)),
        refine._take(cand_lin, ix))
    src = cuda_metric.FrameSource(ctx.target, cand8, cand_lin, ix,
                                  ctx.rule[0], ctx.lnc, lambda: frames)
    assert tuple(frames.shape) == src.shape == (2, 2, 3, 64, 64)
    refs = (tuple(a.movedim(-1, -3) for a in refp[0]),)
    for gate in (None, torch.tensor([1, 0], dtype=torch.int32)):
        assert torch.equal(b(refs, src, gate=gate),
                           b(refs, frames, gate=gate))
    one = dataclasses.replace(src, target=ctx.target[1], cand8=cand8[1],
                              cand_lin=cand_lin[1], ix=ix[1],
                              bva=ctx.rule[0][1], lnc=ctx.lnc[1],
                              frames=lambda: frames[1])
    assert one.shape == (2, 3, 64, 64)
    refs = (tuple(a[1] for a in refs[0]),)
    assert torch.equal(b(refs, one), b(refs, frames[1]))


@pytest.mark.parametrize("change,per_visit", [
    ({}, 2), (dict(gate_margin=0.01), 2), (dict(dither=True), 0),
    (dict(perceptual_palettes=True, prescreen_full=4), 0)],
    ids=["red-mean", "gated", "dithered", "perceptual"])
def test_source_calls_count_two_a_visit(monkeypatch, change, per_visit):
    """One channel sweep at 32x32 (2x2 palettes, 12 visits): the counter
    "b.source_calls" reads two a visit on the undithered red-mean visits,
    gated or not, and none on the dithered and perceptual ones."""
    monkeypatch.setattr(profiling, "_runs", type(profiling._runs)(
        maxlen=profiling.MAX_RUNS))
    config = QuantConfig(**dict(FINALISTS, subpalette_size=2, width=32,
                                height=32, max_steps=1, converge_tol=0.0,
                                **change))
    img = np.ascontiguousarray(bench_image(0)[112:144, 112:144])
    pipeline.run(img, config, device="cpu")
    (record,) = profiling.runs()
    assert record.total("b.source_calls") == per_visit * 12


def test_cuda_wrapper_lays_out_a_source_call(monkeypatch):
    """The card's wrapper, with a stand-in for the library: a source call
    hands kernel B the source's operands (frames null, its ix, 48
    candidates an image) in one launch, where the frames of the same call
    would launch their tiles and resident clusters apart (24 frames at
    128x128, scales 0-1): three launches of B's kernel counted."""
    from snesimage_torch.ops import _kernels

    launched = []

    def entry(name):
        def launch(call, refs, params, stream):
            c = _kernels.MultiscaleCall.from_address(call)
            launched.append((c.frames is None, c.source.ix is not None,
                             c.source.n_cand, c.n_frames,
                             c.n_resident_items, c.tiles_total))
            return 0
        return launch

    monkeypatch.setattr(_kernels, "entry", entry)
    monkeypatch.setattr(_kernels, "stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    rng = np.random.default_rng(0)
    cand8 = torch.from_numpy(rng.integers(0, 256, (48, 3), dtype=np.int32))
    # The stand-in launches nothing, so the frames' values do not matter.
    src = cuda_metric.FrameSource(
        torch.from_numpy(rng.integers(0, 256, (3, 128, 128), dtype=np.int32)),
        cand8, srgb_u8_to_linear(cand8), torch.arange(24),
        torch.from_numpy(rng.integers(0, 1 << 26, (128, 128),
                                      dtype=np.int32)),
        torch.from_numpy(rng.random((3, 128, 128), dtype=np.float32)),
        lambda: torch.zeros((24, 3, 128, 128)))
    refp = reference_pyramid(torch.from_numpy(
        rng.integers(0, 256, (128, 128, 3), dtype=np.int32)))
    refs = tuple(tuple(a.movedim(-1, -3).contiguous() for a in refp[s])
                 for s in (0, 1))
    with profiling.recording() as record:
        for frames in (src, src.frames()):
            out = cuda_metric._multiscale_feature_sums_cuda(refs, frames, 0)
            assert tuple(out.shape) == (24, 2, 3, 6)
    assert launched == [(True, True, 48, 24, 24, 16),
                        (False, False, 0, 24, 0, 16),
                        (False, False, 0, 24, 24, 0)]
    assert record.total(_kernels.LAUNCH + "multiscale_kernel") == 3
