"""SSIMULACRA2 feature kernels B, C and D and their plain twins.

Counterparts of snesimage_tpu/ops/pallas_metric.py:

- `multiscale_feature_sums` (kernel B, csrc/multiscale.cu): raw feature
  sums of several consecutive pyramid scales for a batch of linear-RGB
  frames, after `pre_ds` 2x2 means, in one launch: tile clusters for the
  scales larger than 64x64, the cluster pass of kernels C and D for the
  rest, every 2x2 mean taken in the loads. Twin: the maps of
  ops/ssimulacra2.py `scale_features`, summed instead of averaged.
- `coarse_feature_sums_redmean` (kernel C, csrc/coarse_redmean.cu): the
  fused coarse prescreen of one slot visit: per candidate the int32
  red-mean win mask, its 4x4 pooled sums, the exact quarter-resolution
  frame and the raw sums of its scales, one thread-block cluster of four
  blocks a candidate (csrc/coarse_cluster.cuh). Twin: the JAX package's
  XLA chain (pallas_prescreen.py `_pooled_wins_redmean_xla`, the coarse
  frame of core/refine.py, then kernel B's twin).
- `coarse_feature_sums_ciede` (kernel D, csrc/coarse_ciede.cu): kernel C
  for perceptual mode. The win mask compares each pixel's CIEDE2000
  distance to the candidate (csrc/ciede2000.cuh, the standard formula of
  ops/color.py) with the float tie rule, and the distance planes are
  returned too. Twin: ops/color.py `ciede2000`, the same pooling and
  kernel B's twin.

C and D also have the three-level mode of the JAX kernels (`pre_ds=1,
emit_frames=True`): the cluster pass starts at scale 3 from the 2x2 means
of the quarter-resolution frame, and the quarter frames are returned too,
so that the visit scores scale 2 only for the candidates the scale-3..5
rank keeps. Such calls count in the profiling counters
"c.three_level_calls" and "d.three_level_calls".

Kernel B also takes its frames as a `FrameSource`, the undithered red-mean
visit's finalists described by the candidates and the win rule: on the
card it builds each frame pixel in its loads (source mode, one launch of
its kernel<., true>), bit-equal to the frames that `FrameSource.frames`
builds in torch, which its twin scores on the CPU. Such calls count in
the profiling counter "b.source_calls"; its calls handed frames built in
torch in "b.frame_calls", and kernel D's calls in "d.calls".

All return raw sums of [d, art, det, d^4, art^4, det^4]; the division by
the pixel count and the fourth root stay in `finalize_feature_sums`. On a
CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor it
runs the twin. Each launch counts in the profiling counter
"launch.<kernel>" (ops/_kernels.py `launch`): a call of B that splits
(`_launches`) counts two. A call counter counts where the call's work
runs: on the card after its launches, on the CPU beside the twin, so a
card's count is one of calls its kernel took.

Each also takes a leading image axis N (the counterpart of the JAX
package's `custom_vmap` image fold): N images' operands in one launch, each
image's results bit-equal to its own launch with one image. A reference
pyramid with no image axis is shared by every image (a seed portfolio of
one image); the kernels then read it with an image stride of 0. The twins
run the images one after another.
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections.abc import Callable

import torch

from snesimage_torch.ops import _kernels
from snesimage_torch.ops.cuda_prescreen import (
    _batched,
    ciede_wins,
    coarse_frames,
    pooled_sums,
    redmean_wins,
)
from snesimage_torch.ops.ssimulacra2 import (
    downsample2,
    feature_maps,
    linear_rgb_to_positive_xyb,
    pyramid_size,
)
from snesimage_torch.utils import profiling

# Planes up to this many pixels run resident in shared memory, on the
# cluster pass (kResidentMaxPixels in csrc/metric_common.cuh); kernel B
# tiles larger ones.
RESIDENT_MAX_PIXELS = 64 * 64
_TILE = 32  # kTile in csrc/multiscale.cu
# From this many frames, a call with both tiled and resident scales launches
# its tile clusters (three blocks, up to four an SM) and its resident
# clusters apart: in one grid every block takes the resident clusters'
# shared memory, two an SM, and at 32 frames or more the tiles then run
# slower than in two launches (PERF.md).
SPLIT_FRAMES = 16
# Blocks per candidate of kernels C and D: a thread-block cluster of four
# (kClusterBlocks in csrc/coarse_cluster.cuh).
CLUSTER_BLOCKS = 4


@dataclasses.dataclass(frozen=True)
class FrameSource:
    """Kernel B's frames given by what builds them: frame j is candidate
    ix[j]'s full-resolution linear frame under the red-mean win rule of
    kernels C and E, cand_lin[ix[j], c] at the pixels where the exact int32
    scaled red-mean distance of the target to cand8[ix[j]] is below bva,
    lnc[c] elsewhere. `frames()` builds the same frames in torch (the
    visit's `candidate_frames`, core/refine.py), which the twin scores.

    With a leading image axis N on every field, ix (N, k) picks rows of
    image n's (N, B, 3) candidates, and the frames are (N, k, 3, H, W)."""

    target: torch.Tensor  # (3, H, W) int32 8-bit target
    cand8: torch.Tensor  # (B, 3) int32 8-bit candidates
    cand_lin: torch.Tensor  # (B, 3) float32 their linear colours
    ix: torch.Tensor  # (k,) int64 candidate rows, one a frame
    bva: torch.Tensor  # (H, W) int32 win threshold
    lnc: torch.Tensor  # (3, H, W) float32 no-candidate frame
    frames: Callable[[], torch.Tensor]  # the (k, 3, H, W) frames in torch

    @property
    def shape(self) -> tuple:
        """The shape of the frames: (k, 3, H, W), or (N, k, 3, H, W)."""
        return (*self.ix.shape, 3, *self.bva.shape[-2:])

    @property
    def device(self) -> torch.device:
        return self.ix.device

    @property
    def is_cuda(self) -> bool:
        return self.ix.is_cuda


def _raw_sums(img1, mu1, s11, img2) -> torch.Tensor:
    """(..., 3, 6) raw sums of the three maps and their fourth powers."""
    maps = feature_maps(img1, mu1, s11, img2)
    ones = [m.sum(dim=(-3, -2)) for m in maps]
    fours = [((m * m) * (m * m)).sum(dim=(-3, -2)) for m in maps]
    return torch.stack(ones + fours, dim=-1)


def _refs_of(refs, n: int):
    """Image n's reference planes, in tuples nested as `refs` are: (N, 3,
    h, w) planes indexed, shared (3, h, w) planes as they are."""
    if isinstance(refs, tuple):
        return tuple(_refs_of(a, n) for a in refs)
    return refs[n] if refs.dim() == 4 else refs


def _multiscale_feature_sums_plain(ref_scales, frames, pre_ds=0, gate=None):
    if gate is not None:
        # Zero sums for the images of a closed gate, the others scored.
        frames5 = frames if frames.dim() == 5 else frames[None]
        out = torch.zeros((*frames5.shape[:2], len(ref_scales), 3, 6),
                          dtype=torch.float32, device=frames.device)
        for n, open_ in enumerate(gate.reshape(-1).tolist()):
            if open_:
                out[n] = _multiscale_feature_sums_plain(
                    _refs_of(ref_scales, n) if frames.dim() == 5
                    else ref_scales, frames5[n], pre_ds)
        return out if frames.dim() == 5 else out[0]
    if frames.dim() == 5:
        return torch.stack([
            _multiscale_feature_sums_plain(_refs_of(ref_scales, n), frames[n],
                                           pre_ds)
            for n in range(frames.shape[0])
        ])
    lin = frames.movedim(1, -1)  # (B, h, w, 3)
    for _ in range(pre_ds):
        lin = downsample2(lin)
    out = []
    for si, triple in enumerate(ref_scales):
        if si:
            lin = downsample2(lin)
        img1, mu1, s11 = (a.movedim(0, -1) for a in triple)
        out.append(_raw_sums(img1, mu1, s11, linear_rgb_to_positive_xyb(lin)))
    return torch.stack(out, dim=1)  # (B, n, 3, 6)


def _ref_pyramid(triples, device, n_img: int = 1) -> _kernels.RefPyramid:
    """The kernels' description of reference triples for n_img images:
    (N, 3, h, w) planes, one pyramid an image, or (3, h, w) planes that
    every image shares (image stride 0)."""
    refs = _kernels.RefPyramid()
    for si, triple in enumerate(triples):
        hs, ws = triple[0].shape[-2:]
        ptrs, strides = zip(*(
            _kernels.require_images(a, f"ref plane {si}.{j}", torch.float32,
                                    (3, hs, ws), n_img, device)
            for j, a in enumerate(triple)
        ))
        if len(set(strides)) != 1:
            raise ValueError(f"ref planes of scale {si} mix shared and "
                             "per-image planes")
        refs.img1[si], refs.mu1[si], refs.s11[si] = ptrs
        refs.h[si], refs.w[si] = hs, ws
        refs.img_stride[si] = strides[0]
    return refs


# Tile sums and tickets of kernel B's tiled scales, per device: grown when
# a call needs more, never shrunk. The kernel leaves every ticket at 0. A
# CUDA graph (core/graphs.py) replays the addresses it captured, so every
# buffer outgrown stays alive (`_OUTGROWN`), and none grows in a capture,
# where it would be taken from the graph's own memory (ROADMAP C-12).
_TILE_SCRATCH: dict = {}
_OUTGROWN: list = []


def _tile_scratch(dev, n_sums: int, n_tickets: int):
    have = _TILE_SCRATCH.get(dev)
    if have is None or have[0].numel() < n_sums or have[1].numel() < n_tickets:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("kernel B's tile scratch would grow inside a "
                               "CUDA graph capture")
        n_sums = max(n_sums, have[0].numel() if have else 0)
        n_tickets = max(n_tickets, have[1].numel() if have else 0)
        if have is not None:
            _OUTGROWN.append(have)
        have = (torch.empty(n_sums, dtype=torch.float32, device=dev),
                torch.zeros(n_tickets, dtype=torch.int32, device=dev))
        _TILE_SCRATCH[dev] = have
    return have


def _multiscale_call(frames, sizes, pre_ds: int) -> _kernels.MultiscaleCall:
    """Kernel B's launch description for `frames` (B, 3, H, W), or
    (N, B, 3, H, W) for N images, and scales of `sizes`, after `pre_ds` 2x2
    means: the leading scales larger than RESIDENT_MAX_PIXELS take tile
    clusters, the rest one resident cluster a frame. Leaves `out`,
    `partial` and `tickets` to the caller."""
    per_image, _, h, w = frames.shape[-4:]
    b = per_image * (frames.shape[0] if len(frames.shape) == 5 else 1)
    n = len(sizes)
    n_tiled = sum(hs * ws > RESIDENT_MAX_PIXELS for hs, ws in sizes)
    resident = n_tiled < n
    if pre_ds + n > _kernels.MAX_LEVELS:
        raise ValueError(f"kernel B takes at most {_kernels.MAX_LEVELS} "
                         f"pyramid levels, not pre_ds={pre_ds} + {n} scales")
    call = _kernels.MultiscaleCall()
    call.n_frames, call.pre_ds, call.n_scales = b, pre_ds, n
    call.frames_per_image = per_image
    call.n_tiled, call.n_resident_items = n_tiled, b if resident else 0
    for lv in range(pre_ds + n):
        call.lv.h[lv], call.lv.w[lv] = pyramid_size(h, w, lv)
    total = 0
    for si, (hs, ws) in enumerate(sizes[:n_tiled]):
        call.tiles_x[si] = -(-ws // _TILE)
        call.tile_start[si] = total
        total += call.tiles_x[si] * -(-hs // _TILE)
    call.tile_start[n_tiled] = total
    call.tiles_total = total
    return call


def _launches(call) -> list:
    """The launches of one call: `call` itself, or from SPLIT_FRAMES frames
    on, where it has tiled and resident scales, its tile clusters and its
    resident clusters apart. A call in source mode launches once: it
    scores a visit's few finalists."""
    if not (call.tiles_total and call.n_resident_items
            and call.n_frames >= SPLIT_FRAMES) or call.source.ix:
        return [call]
    tiles = _kernels.MultiscaleCall.from_buffer_copy(call)
    tiles.n_resident_items = 0
    resident = _kernels.MultiscaleCall.from_buffer_copy(call)
    resident.tiles_total = 0
    return [tiles, resident]


def _multiscale_feature_sums_cuda(ref_scales, frames, pre_ds, gate=None):
    dev = frames.device
    lead = frames.shape[:-3]  # (B,) or (N, B)
    h, w = frames.shape[-2:]
    n = len(ref_scales)
    call = _multiscale_call(frames, _check_scales(ref_scales, h, w, pre_ds),
                            pre_ds)
    b = call.n_frames
    n_img = lead[0] if len(lead) == 2 else 1
    if isinstance(frames, FrameSource):
        call.source = _source_operands(frames, lead, h, w, dev)
    else:
        call.frames = _kernels.require(frames, "frames", torch.float32,
                                       (*lead, 3, h, w), dev)
    if len(lead) == 1 and any(a.dim() != 3 for t in ref_scales for a in t):
        raise ValueError("frames without an image axis take one pyramid")
    refs = _ref_pyramid(ref_scales, dev, n_img)
    if gate is not None:
        call.gate = _kernels.require(gate.reshape(-1), "gate", torch.int32,
                                     (n_img,), dev)
    out = torch.empty((*lead, n, 3, 6), dtype=torch.float32, device=dev)
    call.out = out.data_ptr()
    if call.tiles_total:
        sums, tickets = _tile_scratch(dev, b * call.tiles_total * 18,
                                      b * call.n_tiled)
        call.partial, call.tickets = sums.data_ptr(), tickets.data_ptr()
    for c in _launches(call):
        _kernels.launch("snes_multiscale", ctypes.addressof(c),
                        ctypes.addressof(refs),
                        ctypes.addressof(_kernels.metric_params()),
                        _kernels.stream(dev))
    profiling.count(_b_counter(frames))
    return out


def _b_counter(frames) -> str:
    return ("b.source_calls" if isinstance(frames, FrameSource)
            else "b.frame_calls")


def _source_operands(src: FrameSource, lead: tuple, h: int, w: int,
                     dev) -> _kernels.FrameSource:
    """Kernel B's description of `src`, whose frames are `lead` (k,) or
    (N, k) frames of h x w: its operands checked, with an image axis where
    the frames have one."""
    img = lead[:-1]
    ix = src.ix.contiguous()
    n_cand = src.cand8.shape[-2]
    out = _kernels.FrameSource()
    out.target = _kernels.require(src.target, "target", torch.int32,
                                  (*img, 3, h, w), dev)
    out.bva = _kernels.require(src.bva, "bva", torch.int32, (*img, h, w), dev)
    out.lnc = _kernels.require(src.lnc, "lnc", torch.float32, (*img, 3, h, w),
                               dev)
    out.cand8 = _kernels.require(src.cand8, "cand8", torch.int32,
                                 (*img, n_cand, 3), dev)
    out.cand_lin = _kernels.require(src.cand_lin, "cand_lin", torch.float32,
                                    (*img, n_cand, 3), dev)
    out.ix = _kernels.require(ix, "ix", torch.int64, lead, dev)
    out.n_cand = n_cand
    return out


def _check_scales(ref_scales, h: int, w: int, pre_ds: int) -> list:
    """The (h_s, w_s) of each scale; raises unless they are the pyramid's
    from h x w frames after `pre_ds` 2x2 means."""
    sizes = [tuple(t[0].shape[-2:]) for t in ref_scales]
    for si, size in enumerate(sizes):
        if size != pyramid_size(h, w, pre_ds + si):
            raise ValueError(
                f"scale {si} is {size[0]}x{size[1]}, not the "
                f"{pre_ds + si}-fold 2x2 downsample of the {h}x{w} frames"
            )
    return sizes


def multiscale_launches(ref_scales, frames, pre_ds: int = 0) -> list:
    """For each launch of kernel B's call on these operands, how many
    clusters of it the card holds at once: the occupancy calculator's
    answer. One launch a call, two from SPLIT_FRAMES frames on where the
    call has both tiled and resident scales."""
    h, w = frames.shape[-2:]
    call = _multiscale_call(frames, _check_scales(ref_scales, h, w, pre_ds),
                            pre_ds)
    held = []
    for c in _launches(call):
        n = _kernels.entry("snes_multiscale_active_clusters")(
            ctypes.addressof(c))
        _kernels.check(max(-n, 0), "snes_multiscale_active_clusters")
        held.append(n)
    return held


def multiscale_feature_sums(ref_scales, frames, *, pre_ds: int = 0,
                            gate=None):
    """Raw feature sums of consecutive pyramid scales.

    ref_scales: tuple over scales of channel-major (img1, mu1, s11)
        triples, each (3, h_s, w_s) float32 in positive XYB; scale 0 is
        the frames' size after `pre_ds` 2x2 means, each later scale the
        next 2x2 mean (`pyramid_size`: an odd side's last row or column
        is replicated first, as `downsample2` does).
    frames: (B, 3, H, W) float32 linear-RGB frames, or a `FrameSource`
        of B frames (on the card kernel B builds them in its loads; the
        twin scores `frames.frames()`).
    Returns (B, n_scales, 3, 6) raw sums.

    With frames (N, B, 3, H, W) of N images, the planes are (N, 3, h_s,
    w_s), one pyramid an image, or (3, h_s, w_s), one pyramid for all, and
    the sums (N, B, n_scales, 3, 6).

    gate: None, or an int32 flag an image ((N,), or (1,) without an image
    axis) on the frames' device: an image whose flag is 0 gets zero sums,
    and on the card its blocks return before they load anything (the
    rank-1 gate of core/refine.py, decided on the device, so no visit waits
    for it); an open flag gives the sums of a call without one.
    """
    if frames.is_cuda:
        return _multiscale_feature_sums_cuda(ref_scales, frames, pre_ds, gate)
    profiling.count(_b_counter(frames))
    if isinstance(frames, FrameSource):
        frames = frames.frames()
    return _multiscale_feature_sums_plain(ref_scales, frames, pre_ds, gate)


def _coarse_frames_plain(tg, cand8, cand_lin, bva, ml, ds4_l):
    pooled = pooled_sums(redmean_wins(tg, cand8, bva), ml)
    return coarse_frames(pooled, cand_lin, ds4_l)


def _triples(flat_refs):
    return tuple(
        tuple(flat_refs[3 * si : 3 * si + 3]) for si in range(len(flat_refs) // 3)
    )


def _per_image(fn, n_img: int, *operands, flat_refs):
    """A twin over N images, one image at a time: fn on image n's
    operands and reference planes, the results stacked."""
    outs = [fn(*(a[n] for a in operands), _refs_of(flat_refs, n))
            for n in range(n_img)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _coarse_sums_plain(frames, flat_refs, pre_ds: int, emit_frames: bool):
    """The twins' last step: kernel B's twin on the quarter frames after
    `pre_ds` 2x2 means; the frames too with `emit_frames`."""
    sums = _multiscale_feature_sums_plain(_triples(flat_refs), frames, pre_ds)
    sums = sums.reshape(frames.shape[0], -1, 6)
    return (sums, frames) if emit_frames else sums


def _coarse_plain(tg, cand8, cand_lin, bva, ml, ds4_l, flat_refs, pre_ds=0,
                  emit_frames=False):
    if tg.dim() == 4:
        return _per_image(
            lambda *a: _coarse_plain(*a, pre_ds, emit_frames), tg.shape[0],
            tg, cand8, cand_lin, bva, ml, ds4_l, flat_refs=flat_refs)
    frames = _coarse_frames_plain(tg, cand8, cand_lin, bva, ml, ds4_l)
    return _coarse_sums_plain(frames, flat_refs, pre_ds, emit_frames)


def fused_coarse_ok(h: int, w: int) -> bool:
    """Whether the fused coarse kernels C and D take h x w frames: sides
    that are multiples of 32 (the JAX package's `fused_ok`) and a
    quarter-resolution frame that fits in shared memory. The visit takes
    kernels E or F and kernel B for every other geometry."""
    return (h % 32 == 0 and w % 32 == 0
            and (h // 4) * (w // 4) <= RESIDENT_MAX_PIXELS)


def _check_mode(pre_ds: int, emit_frames: bool) -> None:
    """Kernels C and D have two modes: the default, and the three-level
    one (pre_ds=1 with emit_frames)."""
    if (pre_ds, bool(emit_frames)) not in ((0, False), (1, True)):
        raise ValueError("kernels C and D take pre_ds=0 or pre_ds=1 with "
                         f"emit_frames, not pre_ds={pre_ds}, emit_frames="
                         f"{emit_frames}")


def _coarse_geometry(name, h, w, flat_refs, other, pre_ds):
    """Checks the frame size one of the coarse kernels takes; returns the
    reference triples of its scales, from scale 2 + pre_ds."""
    if not fused_coarse_ok(h, w):
        raise ValueError(
            f"kernel {name} takes frames with sides that are multiples of "
            f"32, up to 256x256, not {h}x{w}: {other} and kernel B score "
            "other geometries"
        )
    triples = _triples(flat_refs)
    first = 2 + pre_ds
    for si, t in enumerate(triples):
        if tuple(t[0].shape[-2:]) != pyramid_size(h, w, first + si):
            raise ValueError(f"coarse scale {first + si} has the wrong size")
    return triples


def active_clusters(perceptual: bool, h: int, w: int, pre_ds: int = 0) -> int:
    """How many clusters of kernel D (perceptual) or C the card holds at
    once for h x w frames (with pre_ds 1: in the three-level mode): the
    occupancy calculator's answer."""
    name = ("snes_coarse_ciede_active_clusters" if perceptual
            else "snes_coarse_redmean_active_clusters")
    n = _kernels.entry(name)(h, w, pre_ds)
    _kernels.check(max(-n, 0), name)
    return n


def _frames_out(three: bool, n_img: int, b: int, h: int, w: int, dev):
    """The three-level mode's quarter frames, or None."""
    if not three:
        return None
    return torch.empty((n_img, b, 3, h // 4, w // 4), dtype=torch.float32,
                       device=dev)


def _coarse_cuda(tg, cand8, cand_lin, bva, ml, ds4_l, flat_refs, pre_ds=0,
                 emit_frames=False):
    three = bool(pre_ds)  # the wrapper checked the mode
    dev = tg.device
    n_img, b = cand8.shape[:2]
    h, w = bva.shape[-2:]
    triples = _coarse_geometry(
        "C", h, w, flat_refs, "pooled_wins_redmean", pre_ds)
    n = len(triples)
    ptrs = [
        _kernels.require(tg, "tg", torch.int32, (n_img, 3, h, w), dev),
        _kernels.require(cand8, "cand8", torch.int32, (n_img, b, 3), dev),
        _kernels.require(cand_lin, "cand_lin", torch.float32, (n_img, b, 3),
                         dev),
        _kernels.require(bva, "bva", torch.int32, (n_img, h, w), dev),
        _kernels.require(ml, "ml", torch.float32, (n_img, 3, h, w), dev),
        _kernels.require(ds4_l, "ds4_l", torch.float32,
                         (n_img, 3, h // 4, w // 4), dev),
    ]
    if any(p % 16 for p in (ptrs[0], ptrs[3], ptrs[4])):
        raise ValueError("kernel C reads tg, bva and ml as 16-byte vectors")
    refs = _ref_pyramid(triples, dev, n_img)
    out = torch.empty((n_img, b, n, 3, 6), dtype=torch.float32, device=dev)
    frames = _frames_out(three, n_img, b, h, w, dev)
    _kernels.launch(
        "snes_coarse_redmean", *ptrs, ctypes.addressof(refs), 0, n, n_img, b,
        h, w, ctypes.addressof(_kernels.metric_params()), out.data_ptr(),
        frames.data_ptr() if three else None, _kernels.stream(dev),
    )
    if three:
        profiling.count("c.three_level_calls")
    sums = out.reshape(n_img, b, 3 * n, 6)
    return (sums, frames) if three else sums


def coarse_feature_sums_redmean(tg, cand8, cand_lin, bva, ml, ds4_l, flat_refs,
                                *, pre_ds=0, emit_frames=False):
    """Fused coarse prescreen, red-mean path.

    tg: (3, H, W) int32 target; cand8: (B, 3) int32 8-bit candidates;
    cand_lin: (B, 3) float32 their linear colours; bva: (H, W) int32 win
    threshold (a candidate wins a pixel where its scaled red-mean distance
    is below it; the caller folds the tie rule and the candidate mask in);
    ml: (3, H, W) float32 masked no-candidate frame; ds4_l: (3, H/4, W/4)
    float32 4x4 means of the no-candidate frame; flat_refs: channel-major
    (img1, mu1, s11) of the coarse scales, from scale 2.
    Returns (B, 3 * n_scales, 6) raw sums.

    With `pre_ds=1, emit_frames=True` (the three-level mode) flat_refs
    start at scale 3, the sums are those of scales 3.. from the 2x2 means
    of the quarter-resolution frames, and the (B, 3, H/4, W/4) float32
    quarter frames are returned after them.

    With a leading image axis N on every operand but the reference planes
    (which are (N, 3, h, w), or (3, h, w) shared by every image), the sums
    are (N, B, 3 * n_scales, 6) and the frames (N, B, 3, H/4, W/4).
    """
    _check_mode(pre_ds, emit_frames)
    if pre_ds and not tg.is_cuda:  # `_coarse_cuda` counts at its launch
        profiling.count("c.three_level_calls")
    fn = _coarse_cuda if tg.is_cuda else _coarse_plain
    return _batched(lambda *a: fn(*a, flat_refs, pre_ds, emit_frames), tg,
                    cand8, cand_lin, bva, ml, ds4_l)


def _coarse_ciede_plain(tlab, cand_lab, cand_lin, bvalm, adj, ml, ds4_l,
                        flat_refs, pre_ds=0, emit_frames=False):
    if tlab.dim() == 4:
        return _per_image(
            lambda *a: _coarse_ciede_plain(*a, pre_ds, emit_frames),
            tlab.shape[0], tlab, cand_lab, cand_lin, bvalm, adj, ml, ds4_l,
            flat_refs=flat_refs)
    wins, dcand = ciede_wins(tlab, cand_lab, bvalm, adj)
    frames = coarse_frames(pooled_sums(wins, ml), cand_lin, ds4_l)
    sums = _coarse_sums_plain(frames, flat_refs, pre_ds, False)
    return (sums, dcand, frames) if emit_frames else (sums, dcand)


def _coarse_ciede_cuda(tlab, cand_lab, cand_lin, bvalm, adj, ml, ds4_l,
                       flat_refs, pre_ds=0, emit_frames=False):
    three = bool(pre_ds)  # the wrapper checked the mode
    dev = tlab.device
    n_img, b = cand_lab.shape[:2]
    h, w = bvalm.shape[-2:]
    triples = _coarse_geometry(
        "D", h, w, flat_refs, "pooled_wins_ciede", pre_ds)
    n = len(triples)
    ptrs = [
        _kernels.require(tlab, "tlab", torch.float32, (n_img, 3, h, w), dev),
        _kernels.require(cand_lab, "cand_lab", torch.float32, (n_img, b, 3),
                         dev),
        _kernels.require(cand_lin, "cand_lin", torch.float32, (n_img, b, 3),
                         dev),
        _kernels.require(bvalm, "bvalm", torch.float32, (n_img, h, w), dev),
        _kernels.require(adj, "adj", torch.int32, (n_img, h, w), dev),
        _kernels.require(ml, "ml", torch.float32, (n_img, 3, h, w), dev),
        _kernels.require(ds4_l, "ds4_l", torch.float32,
                         (n_img, 3, h // 4, w // 4), dev),
    ]
    if any(p % 16 for p in (ptrs[0], ptrs[3], ptrs[4], ptrs[5])):
        raise ValueError(
            "kernel D reads tlab, bvalm, adj and ml as 16-byte vectors")
    refs = _ref_pyramid(triples, dev, n_img)
    out = torch.empty((n_img, b, n, 3, 6), dtype=torch.float32, device=dev)
    dcand = torch.empty((n_img, b, h, w), dtype=torch.float32, device=dev)
    frames = _frames_out(three, n_img, b, h, w, dev)
    _kernels.launch(
        "snes_coarse_ciede", *ptrs, ctypes.addressof(refs), 0, n, n_img, b,
        h, w, ctypes.addressof(_kernels.metric_params()), out.data_ptr(),
        dcand.data_ptr(), frames.data_ptr() if three else None,
        _kernels.stream(dev),
    )
    _count_d(three)
    sums = out.reshape(n_img, b, 3 * n, 6)
    return (sums, dcand, frames) if three else (sums, dcand)


def _count_d(three: bool) -> None:
    profiling.count("d.calls")
    if three:
        profiling.count("d.three_level_calls")


def coarse_feature_sums_ciede(tlab, cand_lab, cand_lin, bvalm, adj, ml, ds4_l,
                              flat_refs, *, pre_ds=0, emit_frames=False):
    """Fused coarse prescreen, CIEDE2000 path.

    tlab: (3, H, W) float32 target CIELAB planes; cand_lab: (B, 3) float32
    candidate CIELAB; cand_lin: (B, 3) float32 their linear colours;
    bvalm: (H, W) float32 best distance without the candidate's slot,
    -3e38 where the candidate may not win; adj: (H, W) int32, non-zero
    where the candidate wins ties. A candidate wins a pixel where
    d < bvalm, or d == bvalm and adj != 0, with d = ciede2000(target Lab,
    candidate Lab). ml, ds4_l and flat_refs as for
    `coarse_feature_sums_redmean`.
    Returns ((B, 3 * n_scales, 6) raw sums, (B, H, W) float32 distances);
    with `pre_ds=1, emit_frames=True` the sums of scales 3.. and the
    quarter frames after the distances, as for
    `coarse_feature_sums_redmean`; with a leading image axis N, as for
    `coarse_feature_sums_redmean`, all gain it.
    """
    _check_mode(pre_ds, emit_frames)
    if not tlab.is_cuda:  # `_coarse_ciede_cuda` counts at its launch
        _count_d(bool(pre_ds))
    fn = _coarse_ciede_cuda if tlab.is_cuda else _coarse_ciede_plain
    return _batched(lambda *a: fn(*a, flat_refs, pre_ds, emit_frames), tlab,
                    cand_lab, cand_lin, bvalm, adj, ml, ds4_l)
