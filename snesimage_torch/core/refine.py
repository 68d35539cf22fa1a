"""Palette refinement: slot visits and the sweeps over them.

Counterpart of snesimage_tpu/core/refine.py. A visit of slot (p, i) scores
a batch of candidate colours for that palette entry and keeps one:

- a channel visit scores the 32 values of one channel plus
  `channel_explore` random full-RGB candidates, a random visit
  `random_trials` random candidates; both keep the best only if it beats
  the current exact error by more than `accept_margin`;
- a NES visit scores the 56 NES colours and always takes the best, even
  when it is worse than the current colour (src/lib.rs:242-284).

The sweeps carry the exact error of the current state from visit to visit
(`carried_base`). The per-slot functions `refine_slot_*` score the current
colour inside the batch instead, as row 0, which every ranking keeps.

With `prescreen` K > 0 a visit scores its candidates in stages:
  1. every candidate is ranked by the exact scale-2..5 score of its
     quarter-resolution frame, built from pooled win masks: one launch of
     kernel C (red-mean) or D (perceptual) where the image's sides are
     multiples of 32, else kernel E or F for the pooled sums, the frame
     assembly in torch and kernel B on the frames. D and F also return each
     candidate's CIEDE2000 distance plane;
  2. the top K get full-resolution frames. With `prescreen_full` M in
     (0, K) they are ranked at scale 1 by kernel B (one in-kernel 2x2 mean
     first) and the top M scored at scale 0; otherwise all K are scored at
     scales 0 and 1 in one call. On an undithered red-mean visit kernel B
     builds these frames in its loads from the candidates and the win
     rule (a `FrameSource`); the other visits hand it frames.
With `prescreen_pre` Q (the three-level prescreen, `_three_level`) the
first stage splits in two where the sides are multiples of 8 and the batch
is larger than Q: every candidate is ranked by the exact scale-3..5 score
of its frame's 2x2 means (kernel C or D in their three-level mode, which
also return the quarter-resolution frames; or kernel E or F and kernel B
with one 2x2 mean in the loads), and only the top Q are scored at scale 2,
by kernel B on their quarter frames; the scale-2..5 rank of stage 2 then
takes those Q, the rest +inf.
Unscored candidates report +inf. Without a prescreen (K = 0, a batch no
larger than K, or a NES visit, where a misranked candidate would be taken
even if worse) every candidate's frame goes through kernel B at all six
scales in one call. Ties in every ranking go to the lower candidate index
(`_smallest`), as `jax.lax.top_k` orders them. In perceptual mode the
finalists' win masks come from kernel D's or F's distance planes, as in the
JAX package, and so do the accepted colour's palette map and cache plane,
which the JAX package recomputes.

The undithered remap is incremental, as in the JAX package: the (S, H, W)
distance cache `d_all` (int32 red-mean, or float32 CIEDE2000 with the
target's Lab carried beside it) is carried across the visits of a sweep,
and an accepted colour replaces one plane of it; ties between entries go
to the lowest index (src/lib.rs:780-792).

What a visit shares across its candidates (each pixel's best entry with
and without slot i, the frame and palette map with slot i never winning,
and the operands of the candidates' win rule) comes from one launch of
kernel A's visit prologue (ops/cuda_prescreen.py `visit_prologue`).

With `config.dither` the remap is the Floyd-Steinberg wavefront (kernel
G, ops/cuda_dither.py) and there is no distance cache: a visit remaps the
whole image once per candidate in one launch, renders every map to a
full-resolution frame (kernel A's render entry, over the candidate axis)
and scores the frames in the same stages, kernel B taking them down for
the coarse rank (two in-kernel 2x2 means). The accepted colour's map is
its row of kernel G's output, which equals the full remap with the new
palette, so no second wavefront runs.

Everything stays on the device: accept, reject and the carried error are
`torch.where`s, and a sweep never waits for the device.

The rank-1 gate (`gate_margin`, `_gating_active`): a gated sweep carries
the current state's weighted |feature| sums at scales 0 and 1
(`gate_base_fused`) beside its exact error. A visit ranks its finalists at
scale 1 by the full error they predict with the carried scale-0 term, and
runs the scale-0 stage only where the best prediction beats the carried
error by more than the margin, or where an explore candidate reached the
scale-0 finalists. That decision stays on the device: it is kernel B's gate
flag, whose closed blocks return before they load anything, and the glue
of a closed visit runs and is masked by `torch.where` (+inf errors, so the
visit rejects). The carry takes the accepted candidate's two sums. A sweep
with `use_gate=False` scores every visit exactly and keeps the gated
ranking (the stop rule's confirmation sweep, core/pipeline.py); `gate=False`
turns the machinery off (the batched paths, as in the JAX package).
With `gate_coarse` a second gate comes first: the best coarse candidate's
full error is predicted from its scale-2..5 sum and the carried terms of
scales 0 and 1, and where that beats the carried error by no more than the
margin (and no explore candidate is among the coarse finalists) the visit
closes before its finalists are scored: kernel B's flag closes both the
scale-1 and the scale-0 call. A gated sweep counts the two closures apart
on the device (`GateCount`), for the profiling counters.

With `dither_proxy` K a dithered visit first ranks its candidates by
their exact undithered coarse score (`candidate_errors` with
`coarse_only`, from the slot context of the palette's own undithered
remap, computed for the visit as the JAX package does), and only the top K
(and the current colour, where it is scored inside the batch) go through
kernel G, A's render and kernel B; the rest report +inf.

With `window` (the pipeline's windowed channel steps, `channel_window`
W) a channel visit scores the 2W values of the channel nearest the current
one, clamped to [0, 31], instead of all 32.

Every function here also takes a batched state (core/state.py: a leading
image axis N on every field, and a reference pyramid an image, or one
that a seed portfolio's K seeds share): all images visit the same slots
in the same order, each with its own candidates, its own accept decision
and its own carried error, and each kernel launch serves all N images. The
single-image functions are the same code without the leading axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import NamedTuple

import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core.state import (
    QuantState,
    image_of,
    is_batched,
    shares_image,
)
from snesimage_torch.ops.color import (
    expand_5bit_to_8bit,
    nes_palette_5bit,
    red_mean_sq_scaled,
    srgb_u8_to_lab,
    srgb_u8_to_linear,
)
from snesimage_torch.ops.cuda_dither import dither_remap_candidates
from snesimage_torch.ops.cuda_metric import (
    FrameSource,
    coarse_feature_sums_ciede,
    coarse_feature_sums_redmean,
    fused_coarse_ok,
)
from snesimage_torch.ops.cuda_prescreen import (
    coarse_frames,
    pooled_wins_ciede,
    pooled_wins_redmean,
    render_palette_maps,
    visit_prologue,
)
from snesimage_torch.ops.remap import (
    entry_distances,
    remap_undithered,
    render_linear,
)
from snesimage_torch.ops.ssimulacra2 import (
    NUM_SCALES,
    finalize_feature_sums,
    fused_scale_feature_block,
    reference_pyramid,
    score_from_features,
    score_from_ssim_sum,
    ssim_weighted_sum,
    ssimulacra2_from_ref_linear,
    stack_pyramids,
)
from snesimage_torch.utils import profiling


def make_reference_pyramid(state: QuantState):
    """Candidate-independent half of the metric for this image, from its
    8-bit values (the exact sRGB-decode table applies). A batched state
    gets one pyramid an image, stacked (`stack_pyramids`)."""
    if is_batched(state):
        return stack_pyramids([reference_pyramid(state.rgb[n])
                               for n in range(state.rgb.shape[0])])
    return reference_pyramid(state.rgb)


def _per_image(state: QuantState, fn) -> torch.Tensor:
    """fn(image) for one state, or stacked over a batched state's images."""
    if is_batched(state):
        return torch.stack([fn(image_of(state, n))
                            for n in range(state.original.shape[0])])
    return fn(state)


def _image_operands(state: QuantState):
    """(rgb, alpha, tile map) for kernel G: one image that every row remaps
    where the state's images are one (a seed portfolio), else the state's
    own, with its image axis if it has one."""
    if shares_image(state):
        original = state.original[0]
        return (original[..., :3].to(torch.int32),
                original[..., 3].to(torch.int32), state.tile_palettes[0])
    return state.rgb, state.alpha, state.tile_palettes


def full_remap(state: QuantState, config: QuantConfig) -> QuantState:
    """palette_map from the current palette (reference `optimize`,
    src/lib.rs:425-501). Dithered: kernel G with one candidate and no
    slot overridden (p = -1), all images of a batched state in one
    launch."""
    if config.dither:
        palette = state.palette
        pm = dither_remap_candidates(
            *_image_operands(state), palette, -1, 0,
            palette[..., 0, 0, :].unsqueeze(-2), config.perceptual_palettes,
        )[..., 0, :, :]
    else:
        pm = _per_image(state, lambda st: remap_undithered(
            st.rgb, st.alpha, st.tile_palettes, st.palette,
            config.perceptual_palettes))
    return state.replace(palette_map=pm)


def frame_error_fused(
    state: QuantState, config: QuantConfig, refp
) -> torch.Tensor:
    """Exact full-frame error, 100 - SSIMULACRA2, through kernel B (one
    frame, six scales). A 0-dim float32 tensor on the state's device, or
    one error an image, (N,), for a batched state (one launch)."""
    rendered = _per_image(state, lambda st: render_linear(
        st.palette_map, st.alpha, st.tile_palettes, st.palette))
    frames = rendered.movedim(-1, -3).unsqueeze(-4).contiguous()
    feats = fused_scale_feature_block(refp, frames, 0, NUM_SCALES)
    return (100.0 - score_from_features(feats))[..., 0]


def error_of(state: QuantState, config: QuantConfig, refp) -> torch.Tensor:
    """Reference `error()`, 100 - SSIMULACRA2 of the state's rendered frame
    (src/lib.rs:503-548), through `ssimulacra2_from_ref_linear`: the value
    of `frame_error_fused`, a 0-dim tensor, or (N,) for a batched state."""
    rendered = _per_image(state, lambda st: render_linear(
        st.palette_map, st.alpha, st.tile_palettes, st.palette))
    return 100.0 - ssimulacra2_from_ref_linear(refp, rendered)


def _gating_active(config: QuantConfig) -> bool:
    """Whether the rank-1 gate (`gate_margin`) applies: only undithered
    visits with a two-level prescreen (0 < prescreen_full < prescreen: a
    separate scale-0 stage to skip) gate, never NES sweeps, and the
    prescreen needs sides that are multiples of 4."""
    return (
        config.gate_margin > 0
        and config.prescreen > 0
        and 0 < config.prescreen_full < config.prescreen
        and not config.dither
        and not config.nes
        and config.height % 4 == 0
        and config.width % 4 == 0
    )


def _scale_sums(feats: torch.Tensor) -> torch.Tensor:
    """(..., 2) weighted |feature| sums of scale 0 and of scale 1 of
    features (..., NUM_SCALES, 3, 6): the score's weighted sum decomposes
    over scales, so the gate carries the current state's two terms."""
    scale = torch.arange(NUM_SCALES, device=feats.device)[:, None, None]
    return torch.stack([ssim_weighted_sum(feats * (scale == s))
                        for s in (0, 1)], dim=-1)


def gate_base_fused(state: QuantState, config: QuantConfig,
                    refp) -> torch.Tensor:
    """The gate's carry for the current state: (2,) weighted |feature| sums
    [scale 0, scale 1] of its frame, from one call of kernel B at scales 0
    and 1; (N, 2) for a batched state."""
    rendered = _per_image(state, lambda st: render_linear(
        st.palette_map, st.alpha, st.tile_palettes, st.palette))
    frames = rendered.movedim(-1, -3).unsqueeze(-4).contiguous()
    feats = fused_scale_feature_block(refp, frames, 0, 2)
    return _scale_sums(feats)[..., 0, :]


# The GateCounts of the gated sweeps running, the innermost last.
_GATE_COUNTS: list = []


class GateCount:
    """The gates of one gated sweep, or of one gated visit outside a
    sweep: `visits` (one an image and visit), and once `finish`ed,
    `closed`, a (2,) int32 device tensor the sweep owns: the visits whose
    rank-1 gate closed, then those whose coarse gate closed (`coarse`
    tells whether it is a count at all), or None where no gate could
    close. A visit adds one device operation a gate flag, which counts
    the open gates of every image; the host never reads them."""

    def __init__(self):
        self.visits = 0
        self.scored = 0  # visits whose gates could close
        self.coarse = False
        self.closed = None
        self._opens = None  # (2, images) int32 open gates

    def add(self, n: int, flag=None, flag_c=None) -> None:
        """n more gated visits, their rank-1 (or final) and coarse int32
        gate flags, one an image, where the gates could close."""
        self.visits += n
        if flag is None:
            return
        self.scored += n
        if self._opens is None:
            self._opens = torch.zeros((2, flag.numel()), dtype=torch.int32,
                                      device=flag.device)
        self._opens[0].add_(flag)
        if flag_c is not None:
            self.coarse = True
            self._opens[1].add_(flag_c)

    def finish(self) -> "GateCount":
        if self._opens is not None:
            self.closed = self.scored - self._opens.sum(-1,
                                                        dtype=torch.int32)
            if self.coarse:
                # A final gate closes where either gate did: the rank-1
                # closures are the coarse gates that opened, less the
                # final gates that opened.
                self.closed[0].sub_(self.closed[1])
        return self

    def publish(self) -> None:
        """Adds the counts to the profiling counters "gate.visits",
        "gate.closed" and "gate.closed_coarse" (device tensors, which an
        open run reads at its last wait: utils/profiling.py)."""
        profiling.count("gate.visits", self.visits)
        if self.closed is None:
            return
        keys = ("closed", "closed_coarse")[:1 + self.coarse]
        for key, shut in zip(keys, self.closed):
            profiling.count("gate." + key, shut)


@contextlib.contextmanager
def _sweep_gates(gated: bool, gates: list | None):
    """The GateCount of a sweep, where it gates, that its visits add to;
    at the end it goes to `gates` where the caller passed a list (a
    captured sweep's, which each replay publishes), else it is
    published."""
    if not gated:
        yield
        return
    count = GateCount()
    _GATE_COUNTS.append(count)
    try:
        yield
    finally:
        _GATE_COUNTS.pop()
    count.finish()
    if gates is None:
        count.publish()
    else:
        gates.append(count)


def _count_gates(n: int, flag=None, flag_c=None) -> None:
    """Adds n gated visits and their gate flags to the running sweep's
    GateCount; a visit outside a sweep publishes its own."""
    if _GATE_COUNTS:
        _GATE_COUNTS[-1].add(n, flag, flag_c)
        return
    count = GateCount()
    count.add(n, flag, flag_c)
    count.finish().publish()


def compute_d_all(state: QuantState, config: QuantConfig) -> torch.Tensor:
    """(S, H, W) distances of every pixel to each entry of its own
    subpalette (entry-major): int32 scaled red-mean, or float32 CIEDE2000
    in perceptual mode; (N, S, H, W) for a batched state."""
    return _per_image(state, lambda st: entry_distances(
        st.rgb, st.tile_palettes, st.palette, config.perceptual_palettes,
    ).permute(2, 0, 1).contiguous())


def target_lab(state: QuantState, config: QuantConfig):
    """The target's Lab image in perceptual mode (carried across a sweep
    beside `d_all`), else None."""
    return srgb_u8_to_lab(state.rgb) if config.perceptual_palettes else None


def _smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest values along the last axis, ties to the
    lower index: the order of jax.lax.top_k(-x, k). torch.topk promises no
    tie order."""
    return torch.sort(x, stable=True).indices[..., :k]


@functools.lru_cache(maxsize=None)
def _image_rows(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device)[:, None]


def _take(x: torch.Tensor, ix: torch.Tensor | None) -> torch.Tensor:
    """Rows `ix` of x on its candidate axis: x[ix] for (k,) indices of
    (B, ...) rows, and image n's rows ix[n] for (N, k) indices of
    (N, B, ...) rows; all rows for None. Plain indexing, which launches
    one kernel (`take_along_dim` launches several)."""
    if ix is None:
        return x
    if ix.dim() == 1:
        return x[ix]
    return x[_image_rows(ix.shape[0], ix.device), ix]


@dataclasses.dataclass
class SlotContext:
    """What a visit of slot (p, i) shares across its candidates: the best
    entry of every pixel with and without slot i, and the frame (`lnc`,
    channel-major linear RGB) and palette map with slot i never winning,
    all from kernel A's visit prologue, with the operands of the
    candidates' win rule (`rule`, `ml`: see `VisitPrologue`). In a batched
    visit every tensor has a leading image axis N."""

    p: int
    i: int
    target_u8: torch.Tensor  # (H, W, 3) int32
    target_lab: torch.Tensor | None  # (H, W, 3) float32 (perceptual)
    # (3, H, W) the target planes kernels C to F take: int32 8-bit RGB, or
    # float32 Lab in perceptual mode
    target: torch.Tensor
    alpha: torch.Tensor  # (H, W) int32
    tile_palettes: torch.Tensor  # (H/8, W/8) int32
    best_val: torch.Tensor  # (H, W) int32 or float32, best without slot i
    best_idx: torch.Tensor  # (H, W) int32, its entry
    base_idx: torch.Tensor  # (H, W) int32, best entry with slot i
    affected: torch.Tensor  # (H, W) bool, pixels of subpalette p
    map_nc: torch.Tensor  # (H, W) int32 palette map, slot i never winning
    lnc: torch.Tensor  # (3, H, W) float32
    rule: tuple  # (bva,) red-mean, (bvalm, adj) perceptual
    ml: torch.Tensor  # (3, H, W) float32, lnc where the candidate may win

    @property
    def perceptual(self) -> bool:
        return self.target_lab is not None

    @property
    def opaque(self) -> torch.Tensor:
        return self.alpha > 0

    def cand_dist(self, cand8: torch.Tensor) -> torch.Tensor:
        """(..., H, W) scaled red-mean distances of every pixel to (..., 3)
        8-bit candidates. In perceptual mode kernel D writes the CIEDE2000
        planes instead (`candidate_errors`)."""
        target = self.target_u8
        if cand8.dim() > target.dim() - 2:  # a candidate axis
            target = target.unsqueeze(-4)
        return red_mean_sq_scaled(target, cand8[..., None, None, :])

    def wins(self, d_c: torch.Tensor) -> torch.Tensor:
        """Strict less-than over entry index: the candidate (index i) wins
        on d_c < best_val, or on ties when i precedes best_idx."""
        return (d_c < self.best_val) | (
            (d_c == self.best_val) & (self.i < self.best_idx)
        )

    def win_mask(self, d_c: torch.Tensor) -> torch.Tensor:
        """Where candidates with (..., n, H, W) distance planes `d_c` take
        the pixel: `wins` on the opaque pixels of subpalette p, nowhere
        else. The rule of kernels C to F on the prologue's operands."""
        if self.perceptual:
            bvalm, adj = (r.unsqueeze(-3) for r in self.rule)
            return (d_c < bvalm) | ((d_c == bvalm) & (adj != 0))
        return d_c < self.rule[0].unsqueeze(-3)


def slot_context(state: QuantState, config: QuantConfig, p: int, i: int,
                 d_all: torch.Tensor, t_lab=None) -> SlotContext:
    """Everything a visit of slot (p, i) shares; `t_lab` is the target's
    Lab image (perceptual mode; computed here when not given)."""
    if config.perceptual_palettes and t_lab is None:
        t_lab = target_lab(state, config)
    rgb, alpha = state.rgb, state.alpha
    tiles = state.tile_palettes.contiguous()
    target = (t_lab if config.perceptual_palettes else rgb).movedim(-1, -3)
    pro = visit_prologue(d_all, tiles, alpha, state.palette, p, i)
    return SlotContext(
        p=p, i=i, target_u8=rgb, target_lab=t_lab,
        target=target.contiguous(), alpha=alpha, tile_palettes=tiles,
        best_val=pro.best_val, best_idx=pro.best_idx, base_idx=pro.base_idx,
        affected=pro.affected, map_nc=pro.map_nc, lnc=pro.lnc, rule=pro.rule,
        ml=pro.ml,
    )


def pooled_inputs(ctx: SlotContext, cand8: torch.Tensor):
    """The arguments of kernel E (red-mean) or kernel F (perceptual) for
    8-bit candidates `cand8`: the target, the candidates, the win rule,
    the masked no-candidate frame, and the tile map and subpalette p, so
    that the kernel computes only the tiles of p (all the visit reads)."""
    cand = srgb_u8_to_lab(cand8) if ctx.perceptual else cand8
    return (ctx.target, cand, *ctx.rule, ctx.ml, ctx.tile_palettes, ctx.p)


def ds4_no_candidate(ctx: SlotContext) -> torch.Tensor:
    """(3, H/4, W/4) exact 4x4 means of the no-candidate frame."""
    h, w = ctx.best_val.shape[-2:]
    means = ctx.lnc.reshape(-1, h // 4, 4, w // 4, 4).mean(dim=(2, 4))
    return means.reshape(*ctx.lnc.shape[:-2], h // 4, w // 4)


def coarse_inputs(ctx: SlotContext, cand8: torch.Tensor,
                  cand_lin: torch.Tensor, refp, start: int = 2):
    """The arguments of kernel C (red-mean) or kernel D (perceptual) for
    candidates (cand8, cand_lin): those of kernel E or F, the candidates'
    linear colours, the 4x4 means of the no-candidate frame and the
    reference planes of scales `start`..5 (3.. in the three-level mode)."""
    target, cand, *rule, ml, _, _ = pooled_inputs(ctx, cand8)
    flat_refs = tuple(
        a.movedim(-1, -3) for sc in range(start, NUM_SCALES)
        for a in refp[sc]
    )
    return (target, cand, cand_lin, *rule, ml, ds4_no_candidate(ctx),
            flat_refs)


def candidate_frames(ctx: SlotContext, dist: torch.Tensor,
                     cand_lin: torch.Tensor) -> torch.Tensor:
    """(n, 3, H, W) full-resolution linear frames of n candidates from
    their (n, H, W) distance planes, by the win rule of kernels C to F
    (each with the context's leading image axis, if it has one)."""
    return torch.where(ctx.win_mask(dist).unsqueeze(-3),
                       cand_lin[..., None, None], ctx.lnc.unsqueeze(-4))


def _put(x: torch.Tensor, ix: torch.Tensor, rows: torch.Tensor):
    """x with its rows `ix` on the candidate axis set to `rows`, indexed
    as `_take` indexes (a copy; x is left as it is)."""
    out = x.clone()
    if ix.dim() == 1:
        out[ix] = rows
    else:
        out[_image_rows(ix.shape[0], ix.device), ix] = rows
    return out


def _keep(rank: torch.Tensor, k: int, base_rows: int) -> torch.Tensor:
    """Indices of the k rows of `rank` (..., B) with the lowest values
    (`_smallest`). With an in-batch baseline (`base_rows` = 1) row 0 is
    kept besides, and comes first."""
    if not base_rows:
        return _smallest(rank, k)
    first = torch.zeros(rank.shape[:-1] + (1,), dtype=torch.long,
                        device=rank.device)
    return torch.cat([first, _smallest(rank[..., 1:], k) + 1], dim=-1)


def _gated_finalists(refp, feats_c: torch.Tensor, sel: torch.Tensor, build,
                     config: QuantConfig, gate):
    """The finalists' stage of a gated visit (the JAX package's `_stage12`
    and `_scale0`): the k finalists `sel` ranked at scale 1 by the full
    error they predict with the carried scale-0 term, then the top m scored
    at scale 0 where the gate opens. Returns ((..., B) errors, +inf where
    the gate closed, and (..., B, 2) per-scale weighted sums, zero where it
    closed); `gate` is (carried sums, carried error, whether the gate may
    close, the rows before the explore draws or None).

    With `gate_coarse` the coarse gate decides first, from the best coarse
    candidate's scale-2..5 sum and both carried terms (`sel[..., 0]`: the
    prediction falls with the coarse sum). Where it closes, kernel B's flag
    closes the scale-1 call too, and the visit is closed whatever the
    rank-1 gate says."""
    gb, base_full, enable, n_gated = gate
    b = feats_c.shape[-4]
    explore = n_gated is not None and n_gated < b
    open_c = flag_c = None
    if enable and config.gate_coarse:
        wsum = ssim_weighted_sum(_take(feats_c, sel[..., :1]))[..., 0]
        pred = 100.0 - score_from_ssim_sum(gb[..., 0] + gb[..., 1] + wsum)
        open_c = pred - base_full < -config.gate_margin
        if explore:
            # An explore row among the coarse finalists opens it.
            open_c = open_c | (sel >= n_gated).any(-1)
        flag_c = open_c.to(torch.int32).reshape(-1)
    feats_1 = fused_scale_feature_block(refp, build(sel), 1, 1, pre_ds=1,
                                        gate=flag_c)
    s15 = ssim_weighted_sum(feats_1 + _take(feats_c, sel))
    rank1 = 100.0 - score_from_ssim_sum(gb[..., 0:1] + s15)
    sel2 = _smallest(rank1, config.prescreen_full)
    sel_f = _take(sel, sel2)
    gate_open = flag = None
    if enable:
        gate_open = (rank1.min(-1).values - base_full
                     < -config.gate_margin)
        if explore:
            # Explore rows are exempt: their gains are often scale-0 ones
            # the prediction cannot see.
            gate_open = gate_open | (sel_f >= n_gated).any(-1)
        if open_c is not None:
            gate_open = gate_open & open_c
        flag = gate_open.to(torch.int32).reshape(-1)
    _count_gates(gb[..., 0].numel(), flag, flag_c)
    feats_0 = fused_scale_feature_block(refp, build(sel_f), 0, 1, gate=flag)
    full = 100.0 - score_from_features(
        feats_0 + _take(feats_1, sel2) + _take(feats_c, sel_f))
    errs = torch.full(feats_c.shape[:-3], float("inf"), device=full.device)
    errs = errs.scatter(-1, sel_f, full)
    zeros = torch.zeros_like(errs)
    sums = torch.stack([zeros.scatter(-1, sel_f, ssim_weighted_sum(feats_0)),
                        zeros.scatter(-1, sel, ssim_weighted_sum(feats_1))],
                       dim=-1)
    if gate_open is None:
        return errs, sums
    return (torch.where(gate_open[..., None], errs, float("inf")),
            torch.where(gate_open[..., None, None], sums, 0.0))


def _score_finalists(refp, feats_c: torch.Tensor, coarse: torch.Tensor, build,
                     config: QuantConfig, base_rows: int, gate=None):
    """(..., B) exact errors of the candidates that the prescreen keeps,
    +inf for the rest, from all candidates' scale-2..5 features `feats_c`
    and their coarse rank `coarse` (+inf where an earlier stage dropped
    them); `build(ix)` gives the full-resolution frames of candidates `ix`
    (frames, or a `FrameSource` of them). With a `gate` (carried errors
    only), the gated stage `_gated_finalists`, which also returns the
    per-scale sums."""
    k, m = config.prescreen, config.prescreen_full
    sel = _keep(coarse, k, base_rows)
    if gate is not None:
        return _gated_finalists(refp, feats_c, sel, build, config, gate)
    if 0 < m < k:
        feats_1 = fused_scale_feature_block(refp, build(sel), 1, 1, pre_ds=1)
        rank1 = 100.0 - score_from_features(feats_1 + _take(feats_c, sel))
        sel2 = _keep(rank1, m, base_rows)
        sel, feats_1 = _take(sel, sel2), _take(feats_1, sel2)
        fine = fused_scale_feature_block(refp, build(sel), 0, 1) + feats_1
    else:
        fine = fused_scale_feature_block(refp, build(sel), 0, 2)
    full = 100.0 - score_from_features(fine + _take(feats_c, sel))
    errs = torch.full(feats_c.shape[:-3], float("inf"), device=full.device)
    return errs.scatter(-1, sel, full)


def _prescreens(config: QuantConfig, b: int, allow_prescreen: bool,
                base_rows: int) -> bool:
    return bool(config.prescreen and allow_prescreen
                and b > config.prescreen + base_rows)


def _three_level(config: QuantConfig, b: int, base_rows: int, h: int,
                 w: int) -> bool:
    """Whether a prescreened visit of b candidates splits its coarse stage
    in three levels (`prescreen_pre` Q; the JAX package's conditions): more
    candidates than Q, Q at least the K finalists, sides that are
    multiples of 8."""
    q = config.prescreen_pre
    return bool(q and b > q + base_rows and q >= config.prescreen + base_rows
                and h % 8 == 0 and w % 8 == 0)


def _pre_ranked(refp, feats_pre: torch.Tensor, frames_q: torch.Tensor,
                q: int, base_rows: int):
    """The three-level cascade's first two levels: every candidate ranked
    by its exact scale-3..5 score (`feats_pre`), the top q (with row 0 in
    the legacy mode) scored at scale 2 by kernel B on their quarter frames.
    Returns (scale-2..5 features, zero for the others; the coarse rank,
    +inf for the others)."""
    sel = _keep(100.0 - score_from_features(feats_pre), q, base_rows)
    feats_sel = (fused_scale_feature_block(refp, _take(frames_q, sel), 2, 1)
                 + _take(feats_pre, sel))
    rank = torch.full(feats_pre.shape[:-3], float("inf"),
                      device=feats_pre.device)
    return (_put(torch.zeros_like(feats_pre), sel, feats_sel),
            rank.scatter(-1, sel, 100.0 - score_from_features(feats_sel)))


def candidate_errors(ctx: SlotContext, config: QuantConfig, refp,
                     cand5: torch.Tensor, allow_prescreen: bool = True,
                     carried_base: bool = True, gate=None,
                     coarse_only: bool = False):
    """(B,) float32 exact errors of the candidates `cand5` (B, 3), +inf for
    those a prescreen dropped; and `dists`, which gives the (n, H, W)
    distance planes of candidates `ix` (n,) (kernel D's or F's rows in
    perceptual mode; F's are +inf off the tiles of subpalette p, where
    nothing reads them). Without `carried_base` row 0 is the current colour
    and survives every ranking. In a batched visit every tensor has the
    leading image axis N: (N, B, 3) candidates give (N, B) errors, and
    `dists` takes (N, n) indices. With a `gate` (see `_gated_finalists`)
    a third value: the (..., B, 2) weighted sums of scales 0 and 1 that
    the gate's carry takes from the accepted candidate.

    `coarse_only` (the dither proxy's rank): every candidate's exact
    scale-2..5 score where the visit prescreens (never in three levels),
    else its full error; all finite."""
    b = cand5.shape[-2]
    base_rows = 0 if carried_base else 1
    h, w = ctx.best_val.shape[-2:]
    prescreened = _prescreens(config, b, allow_prescreen, base_rows)
    three = (prescreened and not coarse_only
             and _three_level(config, b, base_rows, h, w))
    start = 3 if three else 2  # the first scale of the coarse rank
    fused = prescreened and fused_coarse_ok(h, w)
    cand8 = expand_5bit_to_8bit(cand5)  # (B, 3)
    cand_lin = srgb_u8_to_linear(cand8)
    sums = pooled = dcand = frames_q = None
    if fused:
        args = coarse_inputs(ctx, cand8, cand_lin, refp, start)
        mode = dict(pre_ds=1, emit_frames=True) if three else {}
        if ctx.perceptual:
            out = coarse_feature_sums_ciede(*args, **mode)
            sums, dcand = out[:2]
        else:
            out = coarse_feature_sums_redmean(*args, **mode)
            sums = out[0] if three else out
        if three:
            frames_q = out[-1]
    elif ctx.perceptual:
        # Also without a prescreen: the frames below need every
        # candidate's distance plane on the tiles of p, and kernel F
        # writes them.
        pooled, dcand = pooled_wins_ciede(*pooled_inputs(ctx, cand8))
    elif prescreened:
        pooled = pooled_wins_redmean(*pooled_inputs(ctx, cand8))

    def dists(ix):
        if ctx.perceptual:
            return _take(dcand, ix)
        return ctx.cand_dist(_take(cand8, ix))

    def build(ix):
        def frames():
            return candidate_frames(ctx, dists(ix), _take(cand_lin, ix))

        if ix is None or ctx.perceptual:
            return frames()
        # The finalists: kernel B builds their frames in its loads.
        return FrameSource(ctx.target, cand8, cand_lin, ix, ctx.rule[0],
                           ctx.lnc, frames)

    if not prescreened:
        feats = fused_scale_feature_block(refp, build(None), 0, NUM_SCALES)
        errs = 100.0 - score_from_features(feats)
        if gate is None:
            return errs, dists
        # A batch too small to prescreen has no stage to skip; the carry
        # takes the sums from the full features.
        _count_gates(gate[0][..., 0].numel())
        return errs, dists, _scale_sums(feats)
    if fused:
        sizes = [refp[sc][0].shape[-3] * refp[sc][0].shape[-2]
                 for sc in range(start, NUM_SCALES)]
        feats_c = finalize_feature_sums(sums, sizes, start)
    else:
        # Kernel B takes the quarter frames down once for scale 3.
        frames_q = coarse_frames(pooled, cand_lin, ds4_no_candidate(ctx))
        feats_c = fused_scale_feature_block(refp, frames_q, start,
                                            NUM_SCALES - start,
                                            pre_ds=start - 2)
    if three:
        feats_c, coarse = _pre_ranked(refp, feats_c, frames_q,
                                      config.prescreen_pre, base_rows)
    else:
        coarse = 100.0 - score_from_features(feats_c)
    if coarse_only:
        return coarse, dists
    out = _score_finalists(refp, feats_c, coarse, build, config, base_rows,
                           gate)
    if gate is None:
        return out, dists
    return out[0], dists, out[1]


def _undithered_machinery(
    state: QuantState, config: QuantConfig, p: int, i: int, d_all=None,
    t_lab=None,
):
    """The visit of slot (p, i) as three closures, like the JAX package's,
    except that the last two take the chosen colour's (H, W) distance
    plane (from `dists`) where the JAX package's take the colour:

      errors(refp, cand5, allow_prescreen=True, carried_base=True,
             gate=None, coarse_only=False) ->
        ((B,) float32 errors, +inf for candidates a prescreen dropped;
        `dists`, as returned by `candidate_errors`; with a gate, the
        per-scale sums);
      final_map(dist) -> (H, W) palette_map with slot i set to the colour;
      new_d_all(dist) -> the distance cache with slot i set to the colour.

    `t_lab` is the target's Lab image in perceptual mode (computed here
    when not given). A batched state gives the batched forms.
    """
    if d_all is None:
        d_all = compute_d_all(state, config)
    ctx = slot_context(state, config, p, i, d_all, t_lab)

    def errors(refp, cand5, allow_prescreen=True, carried_base=True,
               gate=None, coarse_only=False):
        return candidate_errors(ctx, config, refp, cand5, allow_prescreen,
                                carried_base, gate, coarse_only)

    def final_map(dist):
        return torch.where(ctx.win_mask(dist.unsqueeze(-3)).squeeze(-3), i,
                           ctx.map_nc)

    def new_d_all(dist):
        out = d_all.clone()
        out[..., i, :, :] = torch.where(ctx.affected, dist,
                                        d_all[..., i, :, :])
        return out

    return errors, final_map, new_d_all


def _candidate_errors_dithered(state: QuantState, config: QuantConfig, refp,
                               p: int, i: int, cand5: torch.Tensor,
                               allow_prescreen: bool = True,
                               carried_base: bool = True):
    """(B,) float32 exact errors of the dithered candidates `cand5`, +inf
    for those a prescreen dropped, and all candidates' (B, H, W) palette
    maps. Without `carried_base` row 0 is the current colour and survives
    every ranking. A batched state gives (N, B) errors and (N, B, H, W)
    maps, all images' candidates in one launch of kernel G.

    With `dither_proxy` K (and more than K candidates besides row 0) only
    the K with the best undithered coarse score (`candidate_errors` with
    `coarse_only`, from the slot context of the palette's undithered remap:
    `compute_d_all` and kernel A's prologue, which read the palette and
    never the dithered map) go through kernel G and the scoring, with row 0
    where it is the current colour; the others get +inf and zero maps,
    which nothing reads."""
    base_rows = 0 if carried_base else 1
    b = cand5.shape[-2]
    if config.dither_proxy and allow_prescreen and (
            b - base_rows > config.dither_proxy):
        und_errors = _undithered_machinery(state, config, p, i)[0]
        # Every row ranked as a candidate; _keep keeps row 0 besides.
        proxy, _ = und_errors(refp, cand5, carried_base=True,
                              coarse_only=True)
        sel = _keep(proxy, config.dither_proxy, base_rows)
        # Its batch is dither_proxy + base_rows rows: no second proxy.
        errs_k, maps_k = _candidate_errors_dithered(
            state, config, refp, p, i, _take(cand5, sel), allow_prescreen,
            carried_base)
        errs = torch.full(cand5.shape[:-1], float("inf"),
                          device=errs_k.device)
        maps = maps_k.new_zeros((*cand5.shape[:-1], *maps_k.shape[-2:]))
        return errs.scatter(-1, sel, errs_k), _put(maps, sel, maps_k)
    alpha, tiles = state.alpha, state.tile_palettes.contiguous()
    maps = dither_remap_candidates(
        *_image_operands(state), state.palette, p, i, cand5,
        config.perceptual_palettes,
    )
    # Map b rendered with candidate b in slot (p, i); the JAX package's
    # one-hot contraction over S computes the same frames.
    frames = render_palette_maps(maps, tiles, alpha, state.palette, cand5, p,
                                 i)
    if not _prescreens(config, cand5.shape[-2], allow_prescreen, base_rows):
        feats = fused_scale_feature_block(refp, frames, 0, NUM_SCALES)
        return 100.0 - score_from_features(feats), maps
    # The coarse rank takes the full-resolution frames down inside kernel B.
    feats_c = fused_scale_feature_block(refp, frames, 2, NUM_SCALES - 2,
                                        pre_ds=2)
    errs = _score_finalists(refp, feats_c, 100.0 - score_from_features(
        feats_c), lambda ix: _take(frames, ix), config, base_rows)
    return errs, maps


def _dithered_machinery(state: QuantState, config: QuantConfig, p: int,
                        i: int):
    """The dithered visit of slot (p, i) in the form of
    `_undithered_machinery`: `errors` also returns a function giving the
    candidates' palette maps (kernel G's rows), `final_map` takes such a
    row as it is, and there is no distance cache (None)."""

    def errors(refp, cand5, allow_prescreen=True, carried_base=True):
        errs, maps = _candidate_errors_dithered(
            state, config, refp, p, i, cand5, allow_prescreen, carried_base)
        return errs, lambda ix: _take(maps, ix)

    return errors, lambda pm: pm, None


def _slot_machinery(state, config, p, i, d_all, t_lab):
    if config.dither:
        return _dithered_machinery(state, config, p, i)
    return _undithered_machinery(state, config, p, i, d_all, t_lab)


def _apply(state, d_all, p, i, color, changed, dist, final_map, new_d_all):
    """(state, d_all) with slot (p, i) set to `color` where the bool
    `changed` holds (one an image), else as they came. `dist` is the
    colour's distance plane, or its palette map on the dithered path,
    which carries no cache (`d_all` and `new_d_all` are None there)."""
    palette = state.palette.clone()
    palette[..., p, i, :] = color
    planes = changed[..., None, None]
    state_out = state.replace(
        palette=torch.where(planes[..., None], palette, state.palette),
        palette_map=torch.where(planes, final_map(dist), state.palette_map),
    )
    if d_all is None:
        return state_out, None
    return state_out, torch.where(planes[..., None], new_d_all(dist), d_all)


def _pick(errors, final_map, new_d_all, state, d_all, refp, cand5, current,
          base_err, p, i, accept_margin, gate_base=None, gate_enable=True,
          n_gated=None):
    """Accept the best candidate only if it beats the current exact error
    by more than accept_margin; returns (state, error, d_all). A rejected
    visit returns the incoming state and cache. With `base_err` the
    current error is the carried one; with None the current colour is
    scored inside the batch, as row 0, by the code that scores the
    candidates. Each image of a batched visit decides on its own.

    With `gate_base` (a carried error only: the gate's carry, see
    `gate_base_fused`) the visit is gated (`gate_enable` False scores it
    exactly, `n_gated` rows come before the explore draws), and a fourth
    value is returned: the carry, the accepted candidate's per-scale sums
    where the entry changed."""
    base_rows = 1 if base_err is None else 0
    if base_rows:
        batch = torch.cat([current.unsqueeze(-2), cand5], dim=-2)
    else:
        batch = cand5
    if gate_base is None:
        errs, dists = errors(refp, batch, carried_base=not base_rows)
    else:
        errs, dists, sums = errors(
            refp, batch, carried_base=True,
            gate=(gate_base, base_err, gate_enable, n_gated))
    base = errs[..., 0] if base_rows else base_err
    cand_errs = errs[..., base_rows:]
    bidx = torch.argmin(cand_errs, dim=-1, keepdim=True)  # first minimum
    bmin = _take(cand_errs, bidx)[..., 0]
    accept = bmin < base - accept_margin
    color = torch.where(accept[..., None], _take(cand5, bidx)[..., 0, :],
                        current)
    changed = accept & torch.any(color != current, dim=-1)
    err_out = torch.where(changed, torch.minimum(bmin, base), base)
    # Where changed, the colour is candidate bidx of cand5.
    state_out, d_out = _apply(state, d_all, p, i, color, changed,
                              dists(bidx + base_rows)[..., 0, :, :],
                              final_map, new_d_all)
    if gate_base is None:
        return state_out, err_out, d_out
    carry = torch.where(changed[..., None], _take(sums, bidx)[..., 0, :],
                        gate_base)
    return state_out, err_out, d_out, carry


def _draws(generator, lead: tuple, n: int, device) -> torch.Tensor:
    """(*lead, n, 3) uniform 5-bit colours from `generator`: row j of the
    leading axis belongs to image (or seed) j, and one image draws what an
    unbatched visit draws."""
    return torch.randint(0, 32, (*lead, n, 3), generator=generator,
                         device=device, dtype=torch.int32)


def _slot_random(state, config, refp, p, i, d_all=None, base_err=None,
                 generator=None, t_lab=None, cand5=None, gate_base=None,
                 gate_enable=True):
    """One random visit of slot (p, i): `random_trials` uniform 5-bit
    candidates drawn from `generator` (or the given `cand5`); the best is
    kept only if it beats the current error (src/lib.rs:191-240). With
    `gate_base`, gated (`_pick`)."""
    current = state.palette[..., p, i, :]
    if cand5 is None:
        cand5 = _draws(generator, current.shape[:-1], config.random_trials,
                       current.device)
    errors, final_map, new_d_all = _slot_machinery(state, config, p, i, d_all,
                                                   t_lab)
    return _pick(
        errors, final_map, new_d_all, state, d_all, refp, cand5, current,
        base_err, p, i, config.accept_margin, gate_base, gate_enable,
    )


def _channel_values(current: torch.Tensor, channel: int, window: int):
    """(..., n) values of `channel` a channel visit scores: all 32, or
    with `window` W the 2W nearest the current one (current - W ..
    current - 1, current + 1 .. current + W) clamped to [0, 31], which
    may repeat an end value (the first copy wins the argmin)."""
    dev = current.device
    if not window:
        return torch.arange(32, dtype=torch.int32, device=dev).expand(
            *current.shape[:-1], 32)
    offsets = torch.cat([torch.arange(-window, 0, device=dev),
                         torch.arange(1, window + 1, device=dev)])
    return (current[..., channel:channel + 1] + offsets).clamp(0, 31).to(
        torch.int32)


def _slot_channel(state, config, refp, p, i, channel, d_all, base_err,
                  generator=None, t_lab=None, gate_base=None,
                  gate_enable=True, window=False, rand5=None):
    """One visit: the 32 values of `channel` for slot (p, i) (with
    `window`, the 2 * channel_window nearest the current one,
    `_channel_values`), plus `channel_explore` uniform random full-RGB
    candidates drawn from `generator` when one is given (or the given
    `rand5`). With `gate_base`, gated (`_pick`); the explore draws are
    exempt from the gate."""
    current = state.palette[..., p, i, :]
    lead = current.shape[:-1]
    values = _channel_values(current, channel,
                             config.channel_window if window else 0)
    sweep5 = current.unsqueeze(-2).repeat(*(1,) * len(lead),
                                          values.shape[-1], 1)
    sweep5[..., channel] = values
    n_gated = None
    if rand5 is None and generator is not None and config.channel_explore > 0:
        rand5 = _draws(generator, lead, config.channel_explore,
                       current.device)
    if rand5 is not None:
        n_gated = sweep5.shape[-2]
        sweep5 = torch.cat([sweep5, rand5], dim=-2)
    errors, final_map, new_d_all = _slot_machinery(state, config, p, i, d_all,
                                                   t_lab)
    return _pick(
        errors, final_map, new_d_all, state, d_all, refp, sweep5, current,
        base_err, p, i, config.accept_margin, gate_base, gate_enable, n_gated,
    )


def _slot_nes(state, config, refp, p, i, d_all=None, t_lab=None):
    """One NES visit: all 56 NES colours scored exactly, and the best
    always replaces the entry, even if it is worse than the current colour
    (src/lib.rs:242-284). No prescreen: a misranked candidate would be
    taken, not merely missed. Returns (state, the best colour's error,
    d_all)."""
    current = state.palette[..., p, i, :]
    nes = nes_palette_5bit(current.device)
    cand5 = nes.expand(*current.shape[:-1], *nes.shape)
    errors, final_map, new_d_all = _slot_machinery(state, config, p, i, d_all,
                                                   t_lab)
    errs, dists = errors(refp, cand5, allow_prescreen=False)
    bidx = torch.argmin(errs, dim=-1, keepdim=True)  # first minimum
    color = _take(cand5, bidx)[..., 0, :]
    state_out, d_out = _apply(
        state, d_all, p, i, color, torch.any(color != current, dim=-1),
        dists(bidx)[..., 0, :, :], final_map, new_d_all)
    return state_out, _take(errs, bidx)[..., 0], d_out


class SlotResult(NamedTuple):
    """What a per-slot visit returns, as in the JAX package."""

    state: QuantState
    error: torch.Tensor  # 0-dim float32: the error after the visit
    changed: torch.Tensor  # 0-dim bool: whether the entry changed


def _slot_result(before: QuantState, visit) -> SlotResult:
    state, err, _ = visit
    changed = (state.palette != before.palette).flatten(-3).any(-1)
    return SlotResult(state, err, changed)


def refine_slot_random(state, config, refp, generator, p, i) -> SlotResult:
    """One random visit with the current colour scored inside the batch."""
    return _slot_result(state, _slot_random(state, config, refp, p, i,
                                            generator=generator))


def refine_slot_channel(state, config, refp, p, i, channel,
                        generator=None, window=False) -> SlotResult:
    """One channel visit with the current colour scored inside the batch;
    `window` as for `_slot_channel`."""
    return _slot_result(state, _slot_channel(state, config, refp, p, i,
                                             channel, None, None, generator,
                                             window=window))


def refine_slot_nes(state, config, refp, p, i) -> SlotResult:
    """One NES visit."""
    return _slot_result(state, _slot_nes(state, config, refp, p, i))


def _sweep_caches(state, config):
    """What a sweep carries across its visits beside the state: the
    distance cache and the target's Lab image; the dithered path has
    neither."""
    if config.dither:
        return None, None
    return compute_d_all(state, config), target_lab(state, config)


def _gate_carry(state, config, refp, gate: bool):
    """A sweep's initial gate carry: `gate_base_fused` where the sweep
    gates, else None."""
    if gate and _gating_active(config):
        return gate_base_fused(state, config, refp)
    return None


def _visit(slot, carry: tuple, gate_base, *args, **kwargs):
    """Runs a slot visit (`_slot_random` or `_slot_channel`) with the
    sweep's carry (state, error, d_all) and gate carry; returns both."""
    out = slot(carry[0], *args, d_all=carry[2], base_err=carry[1],
               gate_base=gate_base, **kwargs)
    if gate_base is None:
        return out, None
    return out[:3], out[3]


def sweep_random(state: QuantState, config: QuantConfig, refp, generator,
                 base_err=None, use_gate: bool = True, gate: bool = True,
                 *, draws=None, gates: list | None = None):
    """One random step: every slot visited once (src/lib.rs:888-932, steps
    with step % 5 < 4), C * S visits with their candidates drawn from
    `generator`. Returns (state, error), the exact error carried through
    the visits (one an image for a batched state). Where the config gates
    (`_gating_active`) and `gate` holds, the visits are gated;
    `use_gate=False` scores each exactly (the stop rule's confirmation).
    `draws`, a (visits, *lead, n, 3) int32 tensor, gives visit k its
    candidates `draws[k]` in place of drawing them (a captured sweep reads
    its graph's static draws, core/graphs.py). A gated sweep counts its
    gates in a `GateCount` and publishes it, or appends it to `gates`
    where given."""
    s = config.subpalette_size
    err = base_err
    if err is None:
        err = frame_error_fused(state, config, refp)
    d_all, t_lab = _sweep_caches(state, config)
    gb = _gate_carry(state, config, refp, gate)
    carry = (state, err, d_all)
    with _sweep_gates(gb is not None, gates):
        for k in range(config.subpalette_count * s):
            carry, gb = _visit(_slot_random, carry, gb, config, refp, k // s,
                               k % s, generator=generator, t_lab=t_lab,
                               gate_enable=use_gate,
                               cand5=None if draws is None else draws[k])
    return carry[0], carry[1]


def sweep_channel(state: QuantState, config: QuantConfig, refp,
                  base_err=None, generator=None, use_gate: bool = True,
                  gate: bool = True, window: bool = False, *, draws=None,
                  gates: list | None = None):
    """One channel step: every slot visited for channels 0, 1, 2 in turn
    (src/lib.rs:917-923), C * S * 3 visits. Returns (state, error): the
    exact error of the resulting state, carried through the visits (one an
    image for a batched state). `use_gate`, `gate`, `draws` (the explore
    candidates) and `gates` as for `sweep_random`; `window` makes every
    visit windowed (`_slot_channel`)."""
    s = config.subpalette_size
    err = base_err
    if err is None:
        err = frame_error_fused(state, config, refp)
    d_all, t_lab = _sweep_caches(state, config)
    gb = _gate_carry(state, config, refp, gate)
    carry = (state, err, d_all)
    with _sweep_gates(gb is not None, gates):
        for k in range(config.subpalette_count * s * 3):
            carry, gb = _visit(_slot_channel, carry, gb, config, refp,
                               k // (s * 3), (k // 3) % s, k % 3,
                               generator=generator, t_lab=t_lab,
                               gate_enable=use_gate, window=window,
                               rand5=None if draws is None else draws[k])
    return carry[0], carry[1]


def sweep_nes(state: QuantState, config: QuantConfig, refp, base_err=None):
    """One NES step: every slot NES-swept once. Returns (state, error), the
    error of the last visit's colour, which is the resulting state's.
    `base_err` is taken for the schedule's sake and not used: a NES visit
    never compares with the current error."""
    s = config.subpalette_size
    d_all, t_lab = _sweep_caches(state, config)
    err = None
    for k in range(config.subpalette_count * s):
        state, err, d_all = _slot_nes(state, config, refp, k // s, k % s,
                                      d_all, t_lab)
    return state, err
