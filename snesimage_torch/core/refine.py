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
     scales 0 and 1 in one call.
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

Not ported yet, and raising NotImplementedError (`check_slice`): the dither
proxy, the rank-1 gate, windowed visits and the three-level prescreen.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core.state import QuantState
from snesimage_torch.ops.color import (
    expand_5bit_to_8bit,
    nes_palette_5bit,
    red_mean_sq_scaled,
    srgb_u8_to_lab,
    srgb_u8_to_linear,
)
from snesimage_torch.ops.cuda_dither import dither_remap_candidates
from snesimage_torch.ops.cuda_metric import (
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
)


def check_slice(config: QuantConfig) -> None:
    """Raises NotImplementedError, naming its ROADMAP item, for every
    option outside the ported main path."""
    missing = [
        (config.gate_margin > 0 or config.gate_coarse,
         "the rank-1 gate (ROADMAP queue A item 11)"),
        (config.channel_window > 0,
         "windowed visits (ROADMAP queue A item 17)"),
        (config.prescreen_pre > 0,
         "the three-level prescreen (ROADMAP queue A item 17)"),
        (config.dither_proxy > 0,
         "the dither proxy (ROADMAP queue A item 17)"),
    ]
    for off_slice, what in missing:
        if off_slice:
            raise NotImplementedError(f"{what} is not ported yet")


def make_reference_pyramid(state: QuantState):
    """Candidate-independent half of the metric for this image, from its
    8-bit values (the exact sRGB-decode table applies)."""
    return reference_pyramid(state.rgb)


def full_remap(state: QuantState, config: QuantConfig) -> QuantState:
    """palette_map from the current palette (reference `optimize`,
    src/lib.rs:425-501). Dithered: kernel G with one candidate and no
    slot overridden (p = -1)."""
    check_slice(config)
    if config.dither:
        pm = dither_remap_candidates(
            state.rgb, state.alpha, state.tile_palettes, state.palette,
            -1, 0, state.palette[0, 0][None], config.perceptual_palettes,
        )[0]
    else:
        pm = remap_undithered(
            state.rgb, state.alpha, state.tile_palettes, state.palette,
            config.perceptual_palettes,
        )
    return state.replace(palette_map=pm)


def frame_error_fused(
    state: QuantState, config: QuantConfig, refp
) -> torch.Tensor:
    """Exact full-frame error, 100 - SSIMULACRA2, through kernel B (one
    frame, six scales). A 0-dim float32 tensor on the state's device."""
    rendered = render_linear(
        state.palette_map, state.alpha, state.tile_palettes, state.palette
    )
    frames = rendered.permute(2, 0, 1).unsqueeze(0).contiguous()
    feats = fused_scale_feature_block(refp, frames, 0, NUM_SCALES)
    return (100.0 - score_from_features(feats))[0]


def compute_d_all(state: QuantState, config: QuantConfig) -> torch.Tensor:
    """(S, H, W) distances of every pixel to each entry of its own
    subpalette (entry-major): int32 scaled red-mean, or float32 CIEDE2000
    in perceptual mode."""
    d = entry_distances(state.rgb, state.tile_palettes, state.palette,
                        config.perceptual_palettes)
    return d.permute(2, 0, 1).contiguous()


def target_lab(state: QuantState, config: QuantConfig):
    """The target's Lab image in perceptual mode (carried across a sweep
    beside `d_all`), else None."""
    return srgb_u8_to_lab(state.rgb) if config.perceptual_palettes else None


def _smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest values, ties to the lower index: the
    order of jax.lax.top_k(-x, k). torch.topk promises no tie order."""
    return torch.sort(x, stable=True).indices[:k]


@dataclasses.dataclass
class SlotContext:
    """What a visit of slot (p, i) shares across its candidates: the best
    entry of every pixel with and without slot i, and the frame (`lnc`,
    channel-major linear RGB) and palette map with slot i never winning,
    all from kernel A's visit prologue, with the operands of the
    candidates' win rule (`rule`, `ml`: see `VisitPrologue`)."""

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
        return red_mean_sq_scaled(self.target_u8, cand8[..., None, None, :])

    def wins(self, d_c: torch.Tensor) -> torch.Tensor:
        """Strict less-than over entry index: the candidate (index i) wins
        on d_c < best_val, or on ties when i precedes best_idx."""
        return (d_c < self.best_val) | (
            (d_c == self.best_val) & (self.i < self.best_idx)
        )

    def win_mask(self, d_c: torch.Tensor) -> torch.Tensor:
        """Where a candidate with distance planes `d_c` takes the pixel:
        `wins` on the opaque pixels of subpalette p, nowhere else. The rule
        of kernels C to F on the prologue's operands."""
        if self.perceptual:
            bvalm, adj = self.rule
            return (d_c < bvalm) | ((d_c == bvalm) & (adj != 0))
        return d_c < self.rule[0]


def slot_context(state: QuantState, config: QuantConfig, p: int, i: int,
                 d_all: torch.Tensor, t_lab=None) -> SlotContext:
    """Everything a visit of slot (p, i) shares; `t_lab` is the target's
    Lab image (perceptual mode; computed here when not given)."""
    if config.perceptual_palettes and t_lab is None:
        t_lab = target_lab(state, config)
    rgb, alpha = state.rgb, state.alpha
    target = (t_lab if config.perceptual_palettes else rgb).permute(2, 0, 1)
    pro = visit_prologue(d_all, state.tile_palettes, alpha, state.palette, p,
                         i)
    return SlotContext(
        p=p, i=i, target_u8=rgb, target_lab=t_lab,
        target=target.contiguous(), alpha=alpha,
        tile_palettes=state.tile_palettes, best_val=pro.best_val,
        best_idx=pro.best_idx, base_idx=pro.base_idx, affected=pro.affected,
        map_nc=pro.map_nc, lnc=pro.lnc, rule=pro.rule, ml=pro.ml,
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
    h, w = ctx.best_val.shape
    return ctx.lnc.reshape(3, h // 4, 4, w // 4, 4).mean(dim=(2, 4))


def coarse_inputs(ctx: SlotContext, cand8: torch.Tensor,
                  cand_lin: torch.Tensor, refp):
    """The arguments of kernel C (red-mean) or kernel D (perceptual) for
    candidates (cand8, cand_lin): those of kernel E or F, the candidates'
    linear colours, the 4x4 means of the no-candidate frame and the
    reference planes of scales 2..5."""
    target, cand, *rule, ml, _, _ = pooled_inputs(ctx, cand8)
    flat_refs = tuple(
        a.permute(2, 0, 1) for sc in range(2, NUM_SCALES) for a in refp[sc]
    )
    return (target, cand, cand_lin, *rule, ml, ds4_no_candidate(ctx),
            flat_refs)


def candidate_frames(ctx: SlotContext, dist: torch.Tensor,
                     cand_lin: torch.Tensor) -> torch.Tensor:
    """(n, 3, H, W) full-resolution linear frames of n candidates from
    their (n, H, W) distance planes, by the win rule of kernels C to F."""
    return torch.where(ctx.win_mask(dist)[:, None],
                       cand_lin[:, :, None, None], ctx.lnc[None])


def _keep(rank: torch.Tensor, k: int, base_rows: int) -> torch.Tensor:
    """Indices of the k rows of `rank` with the lowest values (`_smallest`).
    With an in-batch baseline (`base_rows` = 1) row 0 is kept besides, and
    comes first."""
    if not base_rows:
        return _smallest(rank, k)
    first = torch.zeros(1, dtype=torch.long, device=rank.device)
    return torch.cat([first, _smallest(rank[1:], k) + 1])


def _score_finalists(refp, feats_c: torch.Tensor, build, config: QuantConfig,
                     base_rows: int) -> torch.Tensor:
    """(B,) exact errors of the candidates that the prescreen keeps, +inf
    for the rest, from all candidates' scale-2..5 features `feats_c`;
    `build(ix)` gives the full-resolution frames of candidates `ix`."""
    k, m = config.prescreen, config.prescreen_full
    sel = _keep(100.0 - score_from_features(feats_c), k, base_rows)
    if 0 < m < k:
        feats_1 = fused_scale_feature_block(refp, build(sel), 1, 1, pre_ds=1)
        rank1 = 100.0 - score_from_features(feats_1 + feats_c[sel])
        sel2 = _keep(rank1, m, base_rows)
        sel, feats_1 = sel[sel2], feats_1[sel2]
        fine = fused_scale_feature_block(refp, build(sel), 0, 1) + feats_1
    else:
        fine = fused_scale_feature_block(refp, build(sel), 0, 2)
    full = 100.0 - score_from_features(fine + feats_c[sel])
    errs = torch.full((feats_c.shape[0],), float("inf"), device=full.device)
    return errs.scatter(0, sel, full)


def _prescreens(config: QuantConfig, b: int, allow_prescreen: bool,
                base_rows: int) -> bool:
    return bool(config.prescreen and allow_prescreen
                and b > config.prescreen + base_rows)


def candidate_errors(ctx: SlotContext, config: QuantConfig, refp,
                     cand5: torch.Tensor, allow_prescreen: bool = True,
                     carried_base: bool = True):
    """(B,) float32 exact errors of the candidates `cand5`, +inf for those
    a prescreen dropped; and `dists`, which gives the (n, H, W) distance
    planes of candidates `ix` (kernel D's or F's rows in perceptual mode;
    F's are +inf off the tiles of subpalette p, where nothing reads them).
    Without `carried_base` row 0 is the current colour and survives every
    ranking."""
    b = cand5.shape[0]
    base_rows = 0 if carried_base else 1
    h, w = ctx.best_val.shape
    prescreened = _prescreens(config, b, allow_prescreen, base_rows)
    fused = prescreened and fused_coarse_ok(h, w)
    cand8 = expand_5bit_to_8bit(cand5)  # (B, 3)
    cand_lin = srgb_u8_to_linear(cand8)
    sums = pooled = dcand = None
    if fused and ctx.perceptual:
        sums, dcand = coarse_feature_sums_ciede(
            *coarse_inputs(ctx, cand8, cand_lin, refp))
    elif fused:
        sums = coarse_feature_sums_redmean(
            *coarse_inputs(ctx, cand8, cand_lin, refp))
    elif ctx.perceptual:
        # Also without a prescreen: the frames below need every
        # candidate's distance plane on the tiles of p, and kernel F
        # writes them.
        pooled, dcand = pooled_wins_ciede(*pooled_inputs(ctx, cand8))
    elif prescreened:
        pooled = pooled_wins_redmean(*pooled_inputs(ctx, cand8))

    def dists(ix):
        return dcand[ix] if ctx.perceptual else ctx.cand_dist(cand8[ix])

    def build(ix):
        return candidate_frames(ctx, dists(ix), cand_lin[ix])

    if not prescreened:
        feats = fused_scale_feature_block(refp, build(slice(None)), 0,
                                          NUM_SCALES)
        return 100.0 - score_from_features(feats), dists
    if fused:
        sizes = [refp[sc][0].shape[0] * refp[sc][0].shape[1]
                 for sc in range(2, NUM_SCALES)]
        feats_c = finalize_feature_sums(sums, sizes, 2)
    else:
        frames_q = coarse_frames(pooled, cand_lin, ds4_no_candidate(ctx))
        feats_c = fused_scale_feature_block(refp, frames_q, 2,
                                            NUM_SCALES - 2)
    return _score_finalists(refp, feats_c, build, config, base_rows), dists


def _undithered_machinery(
    state: QuantState, config: QuantConfig, p: int, i: int, d_all=None,
    t_lab=None,
):
    """The visit of slot (p, i) as three closures, like the JAX package's,
    except that the last two take the chosen colour's (H, W) distance
    plane (from `dists`) where the JAX package's take the colour:

      errors(refp, cand5, allow_prescreen=True, carried_base=True) ->
        ((B,) float32 errors, +inf for candidates a prescreen dropped;
        `dists`, as returned by `candidate_errors`);
      final_map(dist) -> (H, W) palette_map with slot i set to the colour;
      new_d_all(dist) -> the distance cache with slot i set to the colour.

    `t_lab` is the target's Lab image in perceptual mode (computed here
    when not given).
    """
    if d_all is None:
        d_all = compute_d_all(state, config)
    ctx = slot_context(state, config, p, i, d_all, t_lab)

    def errors(refp, cand5, allow_prescreen=True, carried_base=True):
        return candidate_errors(ctx, config, refp, cand5, allow_prescreen,
                                carried_base)

    def final_map(dist):
        return torch.where(ctx.win_mask(dist), i, ctx.map_nc)

    def new_d_all(dist):
        out = d_all.clone()
        out[i] = torch.where(ctx.affected, dist, d_all[i])
        return out

    return errors, final_map, new_d_all


def _candidate_errors_dithered(state: QuantState, config: QuantConfig, refp,
                               p: int, i: int, cand5: torch.Tensor,
                               allow_prescreen: bool = True,
                               carried_base: bool = True):
    """(B,) float32 exact errors of the dithered candidates `cand5`, +inf
    for those a prescreen dropped, and all candidates' (B, H, W) palette
    maps. Without `carried_base` row 0 is the current colour and survives
    every ranking."""
    base_rows = 0 if carried_base else 1
    alpha = state.alpha
    maps = dither_remap_candidates(
        state.rgb, alpha, state.tile_palettes, state.palette, p, i, cand5,
        config.perceptual_palettes,
    )
    # Map b rendered with candidate b in slot (p, i); the JAX package's
    # one-hot contraction over S computes the same frames.
    frames = render_palette_maps(maps, state.tile_palettes, alpha,
                                 state.palette, cand5, p, i)
    if not _prescreens(config, cand5.shape[0], allow_prescreen, base_rows):
        feats = fused_scale_feature_block(refp, frames, 0, NUM_SCALES)
        return 100.0 - score_from_features(feats), maps
    # The coarse rank takes the full-resolution frames down inside kernel B.
    feats_c = fused_scale_feature_block(refp, frames, 2, NUM_SCALES - 2,
                                        pre_ds=2)
    errs = _score_finalists(refp, feats_c, lambda ix: frames[ix], config,
                            base_rows)
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
        return errs, lambda ix: maps[ix]

    return errors, lambda pm: pm, None


def _slot_machinery(state, config, p, i, d_all, t_lab):
    if config.dither:
        return _dithered_machinery(state, config, p, i)
    return _undithered_machinery(state, config, p, i, d_all, t_lab)


def _apply(state, d_all, p, i, color, changed, dist, final_map, new_d_all):
    """(state, d_all) with slot (p, i) set to `color` where the 0-dim bool
    `changed` holds, else as they came. `dist` is the colour's distance
    plane, or its palette map on the dithered path, which carries no
    cache (`d_all` and `new_d_all` are None there)."""
    palette = state.palette.clone()
    palette[p, i] = color
    state_out = state.replace(
        palette=torch.where(changed, palette, state.palette),
        palette_map=torch.where(changed, final_map(dist), state.palette_map),
    )
    if d_all is None:
        return state_out, None
    return state_out, torch.where(changed, new_d_all(dist), d_all)


def _pick(errors, final_map, new_d_all, state, d_all, refp, cand5, current,
          base_err, p, i, accept_margin):
    """Accept the best candidate only if it beats the current exact error
    by more than accept_margin; returns (state, error, d_all). A rejected
    visit returns the incoming state and cache. With `base_err` the
    current error is the carried one; with None the current colour is
    scored inside the batch, as row 0, by the code that scores the
    candidates."""
    base_rows = 1 if base_err is None else 0
    batch = torch.cat([current[None], cand5]) if base_rows else cand5
    errs, dists = errors(refp, batch, carried_base=not base_rows)
    base = errs[0] if base_rows else base_err
    cand_errs = errs[base_rows:]
    bidx = torch.argmin(cand_errs).view(1)  # first minimum
    bmin = cand_errs[bidx][0]
    accept = bmin < base - accept_margin
    color = torch.where(accept, cand5[bidx][0], current)
    changed = accept & torch.any(color != current)
    err_out = torch.where(changed, torch.minimum(bmin, base), base)
    # Where changed, the colour is candidate bidx of cand5.
    state_out, d_out = _apply(state, d_all, p, i, color, changed,
                              dists(bidx + base_rows)[0], final_map,
                              new_d_all)
    return state_out, err_out, d_out


def _slot_random(state, config, refp, p, i, d_all=None, base_err=None,
                 generator=None, t_lab=None, cand5=None):
    """One random visit of slot (p, i): `random_trials` uniform 5-bit
    candidates drawn from `generator` (or the given `cand5`); the best is
    kept only if it beats the current error (src/lib.rs:191-240)."""
    current = state.palette[p, i]
    if cand5 is None:
        cand5 = torch.randint(
            0, 32, (config.random_trials, 3), generator=generator,
            device=current.device, dtype=torch.int32,
        )
    errors, final_map, new_d_all = _slot_machinery(state, config, p, i, d_all,
                                                   t_lab)
    return _pick(
        errors, final_map, new_d_all, state, d_all, refp, cand5, current,
        base_err, p, i, config.accept_margin,
    )


def _slot_channel(state, config, refp, p, i, channel, d_all, base_err,
                  generator=None, t_lab=None):
    """One visit: the 32 values of `channel` for slot (p, i), plus
    `channel_explore` uniform random full-RGB candidates drawn from
    `generator` when one is given."""
    current = state.palette[p, i]
    sweep5 = current[None, :].repeat(32, 1)
    sweep5[:, channel] = torch.arange(32, dtype=torch.int32,
                                      device=current.device)
    if generator is not None and config.channel_explore > 0:
        rand5 = torch.randint(
            0, 32, (config.channel_explore, 3), generator=generator,
            device=current.device, dtype=torch.int32,
        )
        sweep5 = torch.cat([sweep5, rand5], dim=0)
    errors, final_map, new_d_all = _slot_machinery(state, config, p, i, d_all,
                                                   t_lab)
    return _pick(
        errors, final_map, new_d_all, state, d_all, refp, sweep5, current,
        base_err, p, i, config.accept_margin,
    )


def _slot_nes(state, config, refp, p, i, d_all=None, t_lab=None):
    """One NES visit: all 56 NES colours scored exactly, and the best
    always replaces the entry, even if it is worse than the current colour
    (src/lib.rs:242-284). No prescreen: a misranked candidate would be
    taken, not merely missed. Returns (state, the best colour's error,
    d_all)."""
    current = state.palette[p, i]
    cand5 = nes_palette_5bit(current.device)
    errors, final_map, new_d_all = _slot_machinery(state, config, p, i, d_all,
                                                   t_lab)
    errs, dists = errors(refp, cand5, allow_prescreen=False)
    bidx = torch.argmin(errs).view(1)  # first minimum
    color = cand5[bidx][0]
    state_out, d_out = _apply(
        state, d_all, p, i, color, torch.any(color != current),
        dists(bidx)[0], final_map, new_d_all)
    return state_out, errs[bidx][0], d_out


class SlotResult(NamedTuple):
    """What a per-slot visit returns, as in the JAX package."""

    state: QuantState
    error: torch.Tensor  # 0-dim float32: the error after the visit
    changed: torch.Tensor  # 0-dim bool: whether the entry changed


def _slot_result(before: QuantState, visit) -> SlotResult:
    state, err, _ = visit
    return SlotResult(state, err, torch.any(state.palette != before.palette))


def refine_slot_random(state, config, refp, generator, p, i) -> SlotResult:
    """One random visit with the current colour scored inside the batch."""
    check_slice(config)
    return _slot_result(state, _slot_random(state, config, refp, p, i,
                                            generator=generator))


def refine_slot_channel(state, config, refp, p, i, channel,
                        generator=None) -> SlotResult:
    """One channel visit with the current colour scored inside the batch."""
    check_slice(config)
    return _slot_result(state, _slot_channel(state, config, refp, p, i,
                                             channel, None, None, generator))


def refine_slot_nes(state, config, refp, p, i) -> SlotResult:
    """One NES visit."""
    check_slice(config)
    return _slot_result(state, _slot_nes(state, config, refp, p, i))


def _sweep_caches(state, config):
    """What a sweep carries across its visits beside the state: the
    distance cache and the target's Lab image; the dithered path has
    neither."""
    if config.dither:
        return None, None
    return compute_d_all(state, config), target_lab(state, config)


def sweep_random(state: QuantState, config: QuantConfig, refp, generator,
                 base_err=None):
    """One random step: every slot visited once (src/lib.rs:888-932, steps
    with step % 5 < 4), C * S visits with their candidates drawn from
    `generator`. Returns (state, error), the exact error carried through
    the visits."""
    check_slice(config)
    s = config.subpalette_size
    err = base_err
    if err is None:
        err = frame_error_fused(state, config, refp)
    d_all, t_lab = _sweep_caches(state, config)
    for k in range(config.subpalette_count * s):
        state, err, d_all = _slot_random(
            state, config, refp, k // s, k % s, d_all, err, generator, t_lab)
    return state, err


def sweep_channel(state: QuantState, config: QuantConfig, refp,
                  base_err=None, generator=None):
    """One channel step: every slot visited for channels 0, 1, 2 in turn
    (src/lib.rs:917-923), C * S * 3 visits. Returns (state, error): the
    exact error of the resulting state, carried through the visits."""
    check_slice(config)
    s = config.subpalette_size
    err = base_err
    if err is None:
        err = frame_error_fused(state, config, refp)
    d_all, t_lab = _sweep_caches(state, config)
    for k in range(config.subpalette_count * s * 3):
        state, err, d_all = _slot_channel(
            state, config, refp, k // (s * 3), (k // 3) % s, k % 3, d_all,
            err, generator, t_lab,
        )
    return state, err


def sweep_nes(state: QuantState, config: QuantConfig, refp, base_err=None):
    """One NES step: every slot NES-swept once. Returns (state, error), the
    error of the last visit's colour, which is the resulting state's.
    `base_err` is taken for the schedule's sake and not used: a NES visit
    never compares with the current error."""
    check_slice(config)
    s = config.subpalette_size
    d_all, t_lab = _sweep_caches(state, config)
    err = None
    for k in range(config.subpalette_count * s):
        state, err, d_all = _slot_nes(state, config, refp, k // s, k % s,
                                      d_all, t_lab)
    return state, err
