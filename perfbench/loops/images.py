"""A user converting one image after another (a closed loop, one client).

Each image goes through the mix's "entry" (as `pipeline.run_fused`: the
RGBA array and a `QuantConfig` in, (state, per-step errors, info with
"final_error") out), or in a traced run through its "traced_entry" (as
`pipeline.run`: the same work, with the stage clocks "init_seconds" and
"optimize_seconds" in its info), then through the program's JSON writer.
The window closes at the end of the image that is running once `seconds`
have passed. The profiler covers the window's first "trace_images"
images; its stop takes tens of seconds of its own, so in a traced run
the untraced images, which the stage clocks' readers read, get `seconds`
from the stop.

The check judges every image's JSON and carried error, and the step
errors the entry returned (`steps_bad`); the initialisation on a sample
of "judge_sample" images drawn from the seed.
"""

import math
import time

import numpy as np

from perfbench import harness, images, judge
from perfbench.harness import span


def window(prog, spec, run, seed, seconds, trace, device, t_start):
    mix, quant = spec.traffic, spec.config
    h, w = quant["height"], quant["width"]
    recipe = dict(quant, **mix["recipe"])
    entry = harness.program_function(mix["traced_entry"] if trace
                                     else mix["entry"])

    def convert(img, run_seed):
        config = prog.QuantConfig(**recipe, seed=run_seed)
        with span("entry"):
            state, errors, info = entry(img, config, device=device)
        with span("json"):
            text = prog.state_to_json(state, config)
        return errors, info, text

    warm = images.Stream(seed, mix["kinds"], mix["per_kind"], h, w,
                         images.WARMUP)
    for k in range(mix["warmup_images"]):
        _, _, run_seed, img = warm.image(k)
        convert(img, run_seed)
    stream = images.Stream(seed, mix["kinds"], mix["per_kind"], h, w)
    harness.sync(device)
    prof = harness.Profiler(device) if trace else None
    replays0 = harness.replays(prog)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    deadline = t0 + seconds
    outputs = []
    k = 0
    while True:
        if prof and k == 0:
            prof.start()
        member, kind, run_seed, img = stream.image(k)
        t1 = time.perf_counter()
        errors, info, text = convert(img, run_seed)
        t2 = time.perf_counter()
        record = dict(member=member, kind=kind, steps=len(errors),
                      seconds=t2 - t1, traced=bool(prof and prof.span))
        for key in ("init_seconds", "optimize_seconds"):
            if key in info:
                record[key] = info[key]
        run.images.append(record)
        outputs.append((img, text, info["final_error"], list(errors)))
        k += 1
        if prof and prof.span and k == mix["trace_images"]:
            prof.stop()
            deadline = time.perf_counter() + seconds
        if t2 >= deadline:
            break
    if prof and prof.span:
        prof.stop()
    run.window_s = time.perf_counter() - t0
    run.trace = prof.trace() if prof else None
    run.sweeps = sum(r["steps"] for r in run.images)
    run.replays = harness.replays(prog) - replays0
    run.traced_images = [r for r in run.images if r["traced"]]
    run.attempted = len(run.images)
    return outputs


def steps_bad(errors: list, carried: float, recipe: dict) -> int:
    """Faults of an image's step errors: each one that is not finite, one
    where the last is not the carried final error (or there is none), and
    one where the run took more steps than the recipe allows, or another
    number than it fixes where it never stops early."""
    bad = sum(not math.isfinite(e) for e in errors)
    bad += int(not errors or errors[-1] != carried)
    n, limit = len(errors), recipe["max_steps"]
    bad += int(n > limit or (recipe["converge_tol"] == 0 and n != limit))
    return bad


def check(spec, run, outputs, seed):
    """Judges every image's answer; the initialisation on a sample."""
    deep = set(harness.sample(np.random.default_rng([seed % 2 ** 64, 2]),
                              len(outputs), spec.traffic["judge_sample"]))
    answers = []
    for k, (img, text, carried, errors) in enumerate(outputs):
        with span("reference_check"):
            a = judge.judge_answer(img, text, carried, spec.config, k in deep)
        a["steps_bad"] = steps_bad(errors, carried, spec.traffic["recipe"])
        run.images[k]["reference_final"] = a["final"]
        answers.append(a)
    return answers


def control(spec, run, outputs, seed):
    """The control's answer to every image, judged as the program's are."""
    from perfbench.control import control_answer
    from perfbench.reference.ssimulacra2 import Scorer

    deep = set(harness.sample(np.random.default_rng([seed % 2 ** 64, 2]),
                              len(outputs), spec.traffic["judge_sample"]))
    answers = []
    for k, (img, text, carried, errors) in enumerate(outputs):
        a = control_answer(img, text, spec, k in deep, Scorer(img[..., :3]))
        # The control takes the program's steps as it takes its palettes.
        a["steps_bad"] = steps_bad(errors, carried, spec.traffic["recipe"])
        answers.append(a)
    return answers
