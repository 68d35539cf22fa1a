"""The reference's own mode: one loaded image optimised indefinitely, its
frame redrawn after every step.

The window initialises the image (`new_state`, `initialize`, `cluster`,
`make_reference_pyramid`), draws the first frame, then runs the mix's
"entry" (as `pipeline.optimize`) with an `on_step` hook that redraws the
GUI's composite with the mix's "hook" (as `preview.render_preview`) after
every step and ends the loop once `seconds` have passed; then the last
state's JSON. The image is member `seed` mod the set's size, and its run
seed is drawn from the seed: each seed is one user's session. The
profiler covers steps 1 to "trace_steps".

The check judges the last state's JSON and error, the first frame
against the reference initialisation's render, and "judge_steps" steps'
frames, drawn from the seed, against their steps' errors.
"""

import time

import numpy as np

from perfbench import harness, images, judge
from perfbench.harness import span


class WindowClosed(Exception):
    """Raised by the hook to end the entry when the window closes."""


def window(prog, spec, run, seed, seconds, trace, device, t_start):
    mix, quant = spec.traffic, spec.config
    h, w = quant["height"], quant["width"]
    stream = images.Stream(seed, mix["kinds"], mix["per_kind"], h, w)
    member = seed % len(stream.members)
    img = stream.members[member]
    stream.member(0)
    config = prog.QuantConfig(**dict(quant, **mix["recipe"]),
                              seed=stream.drawn_seed())
    pipeline = prog.pipeline
    optimize = harness.program_function(mix["entry"])
    redraw = harness.program_function(mix["hook"])

    def start(img):
        state = prog.new_state(img, config, device)
        state = pipeline.cluster(pipeline.initialize(state, config), config)
        return state, prog.refine.make_reference_pyramid(state)

    warm = images.Stream(seed, mix["kinds"], mix["per_kind"], h, w,
                         images.WARMUP)
    state, refp = start(warm.members[member])
    redraw(state, config)
    optimize(state, config, refp=refp, max_steps=mix["warmup_steps"],
             on_step=lambda s, st, e: redraw(st, config))
    del state, refp
    harness.sync(device)
    prof = harness.Profiler(device) if trace else None
    replays0 = harness.replays(prog)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    with span("init"):
        state, refp = start(img)
    with span("hook"):
        first = redraw(state, config)[:, w:2 * w]
    frames, errors, times = [], [], [time.perf_counter()]
    last = [state]

    def hook(step, st, errs):
        th = time.perf_counter()
        with span("hook"):
            frame = redraw(st, config)
        now = time.perf_counter()
        frames.append(frame[:, w:2 * w].copy())
        errors.append(errs[-1])
        run.steps.append(dict(interval_s=now - times[-1], hook_s=now - th,
                              traced=bool(prof and prof.span)))
        times.append(now)
        last[0] = st
        if prof and step == 0:
            prof.start()
        elif prof and prof.span and step == mix["trace_steps"]:
            prof.stop()
        if now - t0 >= seconds:
            raise WindowClosed

    try:
        optimize(state, config, refp=refp, on_step=hook)
    except WindowClosed:
        pass
    if prof and prof.span:
        prof.stop()
    with span("json"):
        text = prog.state_to_json(last[0], config)
    run.window_s = time.perf_counter() - t0
    run.trace = prof.trace() if prof else None
    run.sweeps = len(run.steps)
    run.replays = harness.replays(prog) - replays0
    run.attempted = len(run.steps)
    return img, first, frames, errors, text


def _picks(spec, frames, seed):
    return harness.sample(np.random.default_rng([seed % 2 ** 64, 2]),
                          len(frames), spec.traffic["judge_steps"])


def check(spec, run, out, seed):
    img, first, frames, errors, text = out
    scorer = judge.Scorer(img[..., :3])
    answer = judge.judge_answer(img, text, errors[-1] if errors else
                                judge.UNREADABLE, spec.config, True, scorer)
    picks = _picks(spec, frames, seed)
    answer["error_gap"] = max(answer["error_gap"], judge.judge_frames(
        img, [frames[i] for i in picks], [errors[i] for i in picks], scorer))
    answer["init_px_off"] = judge.judge_init_frame(img, first, spec.config)
    return [answer]


def control(spec, run, out, seed):
    """The control's answer: the last state's, each judged step's frame
    scored in the lower precision, and the first frame drawn from the
    control's own initialisation."""
    from perfbench.control import LOW, control_answer
    from perfbench.reference import remap
    from perfbench.reference.init import initial_state

    img, first, frames, errors, text = out
    scorer = judge.Scorer(img[..., :3])
    answer = control_answer(img, text, spec, True, scorer)
    low = judge.Scorer(img[..., :3], LOW)
    answer["error_gap"] = max([answer["error_gap"]] + [
        abs(low.error(frames[i]) - scorer.error(frames[i]))
        for i in _picks(spec, frames, seed)])
    cfg = spec.config
    tiles, palette5, pmap = initial_state(img, cfg["subpalette_count"],
                                          cfg["subpalette_size"],
                                          cfg["dither"], LOW)
    answer["init_px_off"] = judge.judge_init_frame(
        img, remap.render(palette5, tiles, pmap, img[..., 3]), cfg)
    return [answer]
