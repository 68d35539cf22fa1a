"""Palette refinement: the balanced profile's channel sweeps.

Counterpart of the main-path slice of snesimage_tpu/core/refine.py. A
channel sweep visits every (subpalette, entry, channel) slot once; a visit
scores the 32 values of that channel plus `channel_explore` random
full-RGB candidates and keeps the best only if it beats the carried exact
error by more than `accept_margin`.

A visit scores candidates in three stages (the two-level prescreen):
  1. kernel C (red-mean) or kernel D (perceptual) ranks every candidate by
     the exact scale-2..5 score of its quarter-resolution frame, built from
     pooled win masks; kernel D also returns each candidate's CIEDE2000
     distance plane;
  2. the top `prescreen` get full-resolution frames, scored at scale 1
     by kernel B (one in-kernel 2x2 mean first);
  3. the top `prescreen_full` of those are scored at scale 0 by kernel B.
Unscored candidates report +inf. Ties in both rankings go to the lower
candidate index (`_smallest`), as `jax.lax.top_k` orders them. In
perceptual mode the finalists' win masks come from kernel D's distance
planes, as in the JAX package, and so do the accepted colour's palette map
and cache plane, which the JAX package recomputes.

The undithered remap is incremental, as in the JAX package: the (S, H, W)
distance cache `d_all` (int32 red-mean, or float32 CIEDE2000 with the
target's Lab carried beside it) is carried across the visits of a sweep,
and an accepted colour replaces one plane of it; ties between entries go
to the lowest index (src/lib.rs:780-792).

With `config.dither` the remap is the Floyd-Steinberg wavefront (kernel
G, ops/cuda_dither.py) and there is no distance cache: a visit remaps the
whole image once per candidate in one launch, renders every map to a
full-resolution frame (kernel A, batched over candidates), scores all
frames at scales 2..5 (kernel B after two in-kernel 2x2 means), the top
`prescreen` at scale 1 and the top `prescreen_full` at scale 0. The
accepted colour's map is its row of kernel G's output, which equals the
full remap with the new palette, so no second wavefront runs.

Everything stays on the device: accept, reject and the carried error are
`torch.where`s, and a sweep never waits for the device.

Not ported yet, and raising NotImplementedError (`check_slice`): the dither
proxy, NES palettes, the reference random schedule, the rank-1 gate, windowed
visits and the three-level prescreen.
"""

from __future__ import annotations

import dataclasses

import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core.state import QuantState
from snesimage_torch.ops.color import (
    expand_5bit_to_8bit,
    red_mean_sq_scaled,
    srgb_u8_to_lab,
    srgb_u8_to_linear,
)
from snesimage_torch.ops.cuda_dither import dither_remap_candidates
from snesimage_torch.ops.cuda_metric import (
    coarse_feature_sums_ciede,
    coarse_feature_sums_redmean,
)
from snesimage_torch.ops.cuda_prescreen import select_colors
from snesimage_torch.ops.remap import (
    entry_distances,
    remap_undithered,
    render_linear,
    tile_pixel_map,
)
from snesimage_torch.ops.ssimulacra2 import (
    NUM_SCALES,
    finalize_feature_sums,
    fused_scale_feature_block,
    reference_pyramid,
    score_from_features,
    score_from_ssim_sum,
    ssim_weighted_sum,
)

INT32_MAX = torch.iinfo(torch.int32).max
INT32_MIN = torch.iinfo(torch.int32).min
_BIG = 3.0e38  # the float cache's exclusion value (JAX package: _BIG)


def check_slice(config: QuantConfig) -> None:
    """Raises NotImplementedError, naming its ROADMAP item, for every
    option outside the ported main path."""
    missing = [
        (config.nes, "NES palettes (ROADMAP queue A item 12)"),
        (config.schedule != "channel",
         "the reference random schedule (queue A item 10)"),
        (config.gate_margin > 0 or config.gate_coarse,
         "the rank-1 gate (queue A item 11)"),
        (config.channel_window > 0, "windowed visits (queue A item 17)"),
        (config.prescreen_pre > 0,
         "the three-level prescreen (queue A item 17)"),
        (config.dither_proxy > 0, "the dither proxy (queue A item 17)"),
        (not 0 < config.prescreen_full < config.prescreen,
         "scoring without the two-level prescreen (queue A item 10)"),
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
    entry of every pixel with and without slot i, and the frame with slot
    i never winning (`lnc`, channel-major linear RGB, built by kernel A
    from `key_nc` and `table`)."""

    p: int
    i: int
    target_u8: torch.Tensor  # (H, W, 3) int32
    target_lab: torch.Tensor | None  # (H, W, 3) float32 (perceptual)
    best_val: torch.Tensor  # (H, W) int32 or float32, best without slot i
    best_idx: torch.Tensor  # (H, W) int32, its entry
    base_idx: torch.Tensor  # (H, W) int32, best entry with slot i
    affected: torch.Tensor  # (H, W) bool, pixels of subpalette p
    opaque: torch.Tensor  # (H, W) bool
    key_nc: torch.Tensor  # (H, W) int32 in [0, C*S]
    table: torch.Tensor  # (3, C*S) float32 linear entry colours
    lnc: torch.Tensor  # (3, H, W) float32

    @property
    def perceptual(self) -> bool:
        return self.target_lab is not None

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


def slot_context(state: QuantState, config: QuantConfig, p: int, i: int,
                 d_all: torch.Tensor, t_lab=None) -> SlotContext:
    """Everything a visit of slot (p, i) shares; `t_lab` is the target's
    Lab image (perceptual mode; computed here when not given)."""
    s = config.subpalette_size
    if config.perceptual_palettes and t_lab is None:
        t_lab = target_lab(state, config)
    entries8 = expand_5bit_to_8bit(state.palette)  # (C, S, 3)
    tp_pix = tile_pixel_map(state.tile_palettes)
    excl = (torch.arange(s, device=d_all.device) == i)[:, None, None]
    big = INT32_MAX if d_all.dtype == torch.int32 else _BIG
    best_val, best_idx = torch.min(torch.where(excl, big, d_all), dim=0)
    best_idx = best_idx.to(torch.int32)
    base_idx = torch.argmin(d_all, dim=0).to(torch.int32)
    affected = tp_pix == p
    opaque = state.alpha > 0
    # Affected pixels take their best other entry, the rest their best
    # entry, transparent pixels the sentinel (colour 0).
    table = srgb_u8_to_linear(entries8).reshape(-1, 3).T.contiguous()
    idx_nc = torch.where(affected, best_idx, base_idx)
    key_nc = torch.where(opaque, tp_pix * s + idx_nc, table.shape[1]).to(
        torch.int32
    )
    return SlotContext(
        p=p, i=i, target_u8=state.rgb, target_lab=t_lab, best_val=best_val,
        best_idx=best_idx, base_idx=base_idx, affected=affected,
        opaque=opaque, key_nc=key_nc, table=table,
        lnc=select_colors(key_nc, table),
    )


def coarse_inputs(ctx: SlotContext, cand8: torch.Tensor,
                  cand_lin: torch.Tensor, refp):
    """The arguments of kernel C (red-mean) or kernel D (perceptual) for
    candidates (cand8, cand_lin)."""
    h, w = ctx.best_val.shape
    mask = ctx.affected & ctx.opaque
    adj = (ctx.i < ctx.best_idx).to(torch.int32)
    ml = torch.where(mask[None], ctx.lnc, 0.0)
    ds4_l = ctx.lnc.reshape(3, h // 4, 4, w // 4, 4).mean(dim=(2, 4))
    flat_refs = tuple(
        a.permute(2, 0, 1) for sc in range(2, NUM_SCALES) for a in refp[sc]
    )
    if ctx.perceptual:
        # Float win rule (d < bvalm) | (d == bvalm & adj): the tie rule
        # cannot fold into the threshold; masked pixels never win.
        bvalm = torch.where(mask, ctx.best_val, -_BIG)
        return (ctx.target_lab.permute(2, 0, 1).contiguous(),
                srgb_u8_to_lab(cand8), cand_lin, bvalm, adj, ml, ds4_l,
                flat_refs)
    # Integer win threshold with the tie rule and the mask folded in: a
    # candidate wins a pixel where its distance is below bva.
    bva = torch.where(
        mask,
        torch.where(ctx.best_val == INT32_MAX, ctx.best_val,
                    ctx.best_val + adj),
        INT32_MIN,
    )
    return (ctx.target_u8.permute(2, 0, 1).contiguous(), cand8, cand_lin,
            bva, ml, ds4_l, flat_refs)


def candidate_frames(ctx: SlotContext, dist: torch.Tensor,
                     cand_lin: torch.Tensor) -> torch.Tensor:
    """(n, 3, H, W) full-resolution linear frames of n candidates from
    their (n, H, W) distance planes. In perceptual mode this is kernel D's
    win rule: (d < bvalm) | (d == bvalm & adj), bvalm = -3e38 off the
    mask."""
    wins = ctx.affected & ctx.opaque & ctx.wins(dist)
    return torch.where(wins[:, None], cand_lin[:, :, None, None],
                       ctx.lnc[None])


def candidate_errors(ctx: SlotContext, config: QuantConfig, refp,
                     cand5: torch.Tensor):
    """(B,) float32 exact errors of the candidates the two-level prescreen
    keeps, +inf for the rest; and `dists`, which gives the (n, H, W)
    distance planes of candidates `ix` (kernel D's rows in perceptual
    mode)."""
    k, m = config.prescreen, config.prescreen_full
    b = cand5.shape[0]
    if not 0 < m < k < b:
        raise NotImplementedError(
            "only the two-level prescreen with more candidates than "
            "prescreen is ported"
        )
    cand8 = expand_5bit_to_8bit(cand5)  # (B, 3)
    cand_lin = srgb_u8_to_linear(cand8)
    sizes = [refp[sc][0].shape[0] * refp[sc][0].shape[1]
             for sc in range(2, NUM_SCALES)]
    args = coarse_inputs(ctx, cand8, cand_lin, refp)
    if ctx.perceptual:
        sums, dcand = coarse_feature_sums_ciede(*args)

        def dists(ix):
            return dcand[ix]
    else:
        sums = coarse_feature_sums_redmean(*args)

        def dists(ix):
            return ctx.cand_dist(cand8[ix])

    def build(ix):
        return candidate_frames(ctx, dists(ix), cand_lin[ix])

    feats_c = finalize_feature_sums(sums, sizes, 2)
    sel = _smallest(100.0 - score_from_features(feats_c), k)

    feats_1 = fused_scale_feature_block(refp, build(sel), 1, 1, pre_ds=1)
    rank1 = 100.0 - score_from_ssim_sum(
        ssim_weighted_sum(feats_1 + feats_c[sel])
    )
    sel2 = _smallest(rank1, m)
    sel_f = sel[sel2]
    feats_0 = fused_scale_feature_block(refp, build(sel_f), 0, 1)
    full = 100.0 - score_from_features(feats_0 + feats_1[sel2] + feats_c[sel_f])
    errs = torch.full((b,), float("inf"), device=full.device)
    return errs.scatter(0, sel_f, full), dists


def _undithered_machinery(
    state: QuantState, config: QuantConfig, p: int, i: int, d_all=None,
    t_lab=None,
):
    """The visit of slot (p, i) as three closures, like the JAX package's,
    except that the last two take the chosen colour's (H, W) distance
    plane (from `dists`) where the JAX package's take the colour:

      errors(refp, cand5, carried_base=True) -> ((B,) float32 errors, +inf
        for candidates the prescreen dropped; `dists`, as returned by
        `candidate_errors`);
      final_map(dist) -> (H, W) palette_map with slot i set to the colour;
      new_d_all(dist) -> the distance cache with slot i set to the colour.

    `t_lab` is the target's Lab image in perceptual mode (computed here
    when not given).
    """
    if d_all is None:
        d_all = compute_d_all(state, config)
    ctx = slot_context(state, config, p, i, d_all, t_lab)

    def errors(refp, cand5, carried_base=True):
        if not carried_base:
            raise NotImplementedError(
                "in-batch baselines are not ported yet (ROADMAP queue A "
                "item 10)"
            )
        return candidate_errors(ctx, config, refp, cand5)

    def final_map(dist):
        idx = torch.where(
            ctx.affected,
            torch.where(ctx.wins(dist), i, ctx.best_idx),
            ctx.base_idx,
        )
        return torch.where(ctx.opaque, idx, 0).to(torch.int32)

    def new_d_all(dist):
        out = d_all.clone()
        out[i] = torch.where(ctx.affected, dist, d_all[i])
        return out

    return errors, final_map, new_d_all


def dithered_render_operands(state: QuantState, config: QuantConfig, p: int,
                             i: int, cand5: torch.Tensor, maps: torch.Tensor):
    """What kernel A renders the (B, H, W) palette maps `maps` from: the
    (B, H, W) int32 keys `subpalette * S + entry`, with the sentinel key for
    transparent pixels, and one (3, C*S) linear colour table per candidate,
    candidate b's colour in slot (p, i) of table b."""
    s = config.subpalette_size
    entries_lin = srgb_u8_to_linear(expand_5bit_to_8bit(state.palette))
    tables = entries_lin.reshape(-1, 3).T[None].repeat(cand5.shape[0], 1, 1)
    tables[:, :, p * s + i] = srgb_u8_to_linear(expand_5bit_to_8bit(cand5))
    tp_pix = tile_pixel_map(state.tile_palettes)
    key = torch.where(state.alpha > 0, tp_pix * s + maps, tables.shape[2])
    return key.to(torch.int32), tables.contiguous()


def candidate_frames_dithered(state: QuantState, config: QuantConfig, p: int,
                              i: int, cand5: torch.Tensor,
                              maps: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) linear frames of the (B, H, W) palette maps `maps`,
    map b rendered with candidate b in slot (p, i): kernel A over the
    candidate axis. The JAX package's one-hot contraction over S computes
    the same frames."""
    return select_colors(
        *dithered_render_operands(state, config, p, i, cand5, maps))


def _candidate_errors_dithered(state: QuantState, config: QuantConfig, refp,
                               p: int, i: int, cand5: torch.Tensor):
    """(B,) float32 exact errors of the dithered candidates the two-level
    prescreen keeps, +inf for the rest, and all candidates' (B, H, W)
    palette maps."""
    k, m = config.prescreen, config.prescreen_full
    b = cand5.shape[0]
    if not 0 < m < k < b:
        raise NotImplementedError(
            "only the two-level prescreen with more candidates than "
            "prescreen is ported"
        )
    maps = dither_remap_candidates(
        state.rgb, state.alpha, state.tile_palettes, state.palette, p, i,
        cand5, config.perceptual_palettes,
    )
    frames = candidate_frames_dithered(state, config, p, i, cand5, maps)
    # The coarse rank takes the full-resolution frames down inside kernel B.
    feats_c = fused_scale_feature_block(refp, frames, 2, NUM_SCALES - 2,
                                        pre_ds=2)
    sel = _smallest(100.0 - score_from_features(feats_c), k)
    feats_1 = fused_scale_feature_block(refp, frames[sel], 1, 1, pre_ds=1)
    rank1 = 100.0 - score_from_features(feats_1 + feats_c[sel])
    sel2 = _smallest(rank1, m)
    sel_f = sel[sel2]
    feats_0 = fused_scale_feature_block(refp, frames[sel_f], 0, 1)
    full = 100.0 - score_from_features(feats_0 + feats_1[sel2] + feats_c[sel_f])
    errs = torch.full((b,), float("inf"), device=full.device)
    return errs.scatter(0, sel_f, full), maps


def _dithered_machinery(state: QuantState, config: QuantConfig, p: int,
                        i: int):
    """The dithered visit of slot (p, i) in the form of
    `_undithered_machinery`: `errors` also returns a function giving the
    candidates' palette maps (kernel G's rows), `final_map` takes such a
    row as it is, and there is no distance cache (None)."""

    def errors(refp, cand5, carried_base=True):
        if not carried_base:
            raise NotImplementedError(
                "in-batch baselines are not ported yet (ROADMAP queue A "
                "item 10)"
            )
        errs, maps = _candidate_errors_dithered(state, config, refp, p, i,
                                                cand5)
        return errs, lambda ix: maps[ix]

    return errors, lambda pm: pm, None


def _pick(errors, final_map, new_d_all, state, d_all, refp, cand5, current,
          base_err, p, i, accept_margin):
    """Accept the best candidate only if it beats the carried exact error
    by more than accept_margin; returns (state, error, d_all). A rejected
    visit returns the incoming state and cache. `d_all` and `new_d_all`
    are None on the dithered path, which carries no cache."""
    cand_errs, dists = errors(refp, cand5, carried_base=True)
    bidx = torch.argmin(cand_errs).view(1)  # first minimum
    bmin = cand_errs[bidx][0]
    accept = bmin < base_err - accept_margin
    color = torch.where(accept, cand5[bidx][0], current)
    changed = accept & torch.any(color != current)
    err_out = torch.where(changed, torch.minimum(bmin, base_err), base_err)

    # Where changed, the colour is candidate bidx; `dist` is its distance
    # plane, or its palette map on the dithered path.
    dist = dists(bidx)[0]
    palette = state.palette.clone()
    palette[p, i] = color
    state_out = state.replace(
        palette=torch.where(changed, palette, state.palette),
        palette_map=torch.where(changed, final_map(dist), state.palette_map),
    )
    d_out = None
    if d_all is not None:
        d_out = torch.where(changed, new_d_all(dist), d_all)
    return state_out, err_out, d_out


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
    if config.dither:
        errors, final_map, new_d_all = _dithered_machinery(state, config, p, i)
    else:
        errors, final_map, new_d_all = _undithered_machinery(
            state, config, p, i, d_all, t_lab
        )
    return _pick(
        errors, final_map, new_d_all, state, d_all, refp, sweep5, current,
        base_err, p, i, config.accept_margin,
    )


def sweep_channel(state: QuantState, config: QuantConfig, refp,
                  base_err=None, generator=None):
    """One channel step: every slot visited for channels 0, 1, 2 in turn
    (src/lib.rs:917-923), C * S * 3 visits. Returns (state, error): the
    exact error of the resulting state, carried through the visits."""
    check_slice(config)
    s = config.subpalette_size
    if base_err is None:
        base_err = frame_error_fused(state, config, refp)
    # carried across the visits; the dithered path has no distance cache
    d_all = None if config.dither else compute_d_all(state, config)
    t_lab = None if config.dither else target_lab(state, config)
    err = base_err
    for k in range(config.subpalette_count * s * 3):
        state, err, d_all = _slot_channel(
            state, config, refp, k // (s * 3), (k // 3) % s, k % 3, d_all,
            err, generator, t_lab,
        )
    return state, err
