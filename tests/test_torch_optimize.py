"""The port's host-stepped driver (core/pipeline.py `optimize`), its random
stream keyed by step, `run`, `run_fused_hybrid`, the schedule and
utils/profiling.py on the CPU.

In the port `run_fused` and the host-stepped loop are one code path, so a
hook that only reads (`on_step`) leaves the run's bits as they were. The
plateau-window tests mirror the JAX package's tests/test_reassign.py, and
the faults its second review found (NEXT.md:45-54) each have a test here or
in tests/test_torch_cli.py / tests/test_torch_reassign.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core import refine as tref
from snesimage_torch.core.state import new_state
from snesimage_torch.testing import single_torch_thread
from snesimage_torch.utils.profiling import StepTimer, trace
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core.state import new_state as j_new_state

# Explore draws enter, so the generator's stream is exercised.
EXPLORE = dict(
    subpalette_count=2, subpalette_size=3, width=64, height=64, max_steps=3,
    converge_tol=0.0, schedule="channel", prescreen=8, prescreen_full=2,
    channel_explore=4, accept_margin=0.005,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    with single_torch_thread():
        yield


def _clustered(img, config):
    state = new_state(img, config, "cpu")
    return tpipe.cluster(tpipe.initialize(state, config), config)


@pytest.fixture(scope="module")
def image():
    """A 64x64 crop of the bench image, made with numpy."""
    from snesimage_torch.testing import bench_image

    return np.ascontiguousarray(bench_image(0)[96:160, 96:160])


def test_on_step_hook_changes_no_bit(image):
    """`optimize` with an `on_step` hook equals `run_fused` bit for bit,
    and the hook sees each step, the state and the errors so far."""
    config = TConfig(**EXPLORE)
    want, errors, _ = tpipe.run_fused(image, config, device="cpu")
    seen = []
    state, errs = tpipe.optimize(
        _clustered(image, config), config,
        on_step=lambda step, st, es: seen.append((step, list(es))))
    assert errs.tolist() == errors
    assert [s[0] for s in seen] == [0, 1, 2]
    assert [s[1] for s in seen] == [errors[:1], errors[:2], errors]
    assert torch.equal(state.palette, want.palette)
    assert torch.equal(state.palette_map, want.palette_map)


def _record_draws(monkeypatch):
    """Every draw the run makes from its generator, in order."""
    draws = []
    real = tref._draws

    def draw(*args):
        out = real(*args)
        draws.append(out.clone())
        return out

    monkeypatch.setattr(tref, "_draws", draw)
    return draws


def test_resume_draws_what_an_uninterrupted_run_draws(image, monkeypatch):
    """ROADMAP C-11: a run of 4 steps and a second run resumed from its
    state at step 4 for 4 more draw what one 8-step run draws (the resumed
    generator replays the first 4 steps' draws, then draws steps 4-7), and
    end in its state with its step errors."""
    config = TConfig(**dict(EXPLORE, max_steps=8))
    start = _clustered(image, config)
    draws = _record_draws(monkeypatch)
    full, full_errs = tpipe.optimize(start, config)
    whole = list(draws)
    per_step = len(whole) // 8
    assert per_step == 2 * 3 * 3  # one draw a channel visit
    draws.clear()
    half, errs1 = tpipe.optimize(start, config, max_steps=4)
    resumed, errs2 = tpipe.optimize(half, config, max_steps=4, start_step=4)
    replay = whole[:4 * per_step]
    assert len(draws) == len(replay) * 2 + 4 * per_step
    for got, want in zip(draws, replay + replay + whole[4 * per_step:]):
        assert torch.equal(got, want)
    assert torch.equal(resumed.palette, full.palette)
    assert torch.equal(resumed.palette_map, full.palette_map)
    # The resumed run starts from its state's error scored afresh, not the
    # carried one; after its first accepted move the errors are the
    # uninterrupted run's to the bit.
    assert torch.equal(torch.cat([errs1, errs2]), full_errs)


def test_run_fused_start_step_continues_the_stream(image):
    """`run_fused(start_step=k)` draws at step k what a run from 0 draws
    there: its first step equals step k of `optimize` resumed from the
    same state."""
    config = TConfig(**EXPLORE)
    _, errors, _ = tpipe.run_fused(image, config, max_steps=1, start_step=2,
                                   device="cpu")
    _, errs = tpipe.optimize(_clustered(image, config), config, max_steps=1,
                             start_step=2)
    assert errors == errs.tolist()
    _, zero, _ = tpipe.run_fused(image, config, max_steps=1, device="cpu")
    assert zero != errors


def test_midrun_replacement_resets_plateau_stop(image):
    """The twin of tests/test_reassign.py's: with a huge tol the bare run
    stops after cycle + 1 = 2 steps; a replacement at step 1 restarts the
    window and buys one more step."""
    config = TConfig(**dict(EXPLORE, max_steps=6, converge_tol=1e9))
    start = _clustered(image, config)
    _, base = tpipe.optimize(start, config)
    assert len(base) == 2

    def replace_at_1(step, state, errs):
        return state if step == 1 else None  # identity = external edit

    _, errs = tpipe.optimize(start, config, on_step_state=replace_at_1)
    assert len(errs) == 3


def test_on_step_state_edit_survives(image):
    """The twin of tests/test_reassign.py `test_optimize_on_step_state_
    midrun`: a reassignment injected after step 0 survives to the final
    state (nothing else changes tile_palettes)."""
    config = TConfig(**EXPLORE)
    start = _clustered(image, config)
    target = int(1 - start.tile_palettes[0, 0])
    applied = []

    def on_step_state(step, state, errs):
        if step != 0:
            return None
        applied.append(step)
        return tpipe.apply_tile_reassignments(state, config,
                                              [(0, 0, target)])

    state, errs = tpipe.optimize(start, config, on_step_state=on_step_state)
    assert applied == [0]
    assert len(errs) == 3 and torch.isfinite(errs).all()
    assert int(state.tile_palettes[0, 0]) == target


def test_reassign_every_resets_the_window(image):
    """`reassign_every=1` re-fits the tiles after every step and restarts
    the plateau window each time, so a huge tol never stops the run; the
    state's tiles are the re-fit's, its map the remap of them."""
    from snesimage_torch.core.reassign import auto_reassign_tiles

    config = TConfig(**dict(EXPLORE, max_steps=3, converge_tol=1e9))
    state, errs = tpipe.optimize(_clustered(image, config), config,
                                 reassign_every=1)
    assert len(errs) == 3 and torch.isfinite(errs).all()
    refit = auto_reassign_tiles(state, config)
    assert torch.equal(refit.tile_palettes, state.tile_palettes)
    assert torch.equal(tref.full_remap(state, config).palette_map,
                       state.palette_map)


def test_tol_zero_reads_no_error_on_the_host(image, monkeypatch):
    """With tol 0 and no hook the loop never reads an error on the host:
    no dead exact evaluation and sync per step (NEXT.md:45-54)."""
    config = TConfig(**dict(EXPLORE, max_steps=2))
    start = _clustered(image, config)
    reads = []
    real = torch.Tensor.__float__
    monkeypatch.setattr(torch.Tensor, "__float__",
                        lambda t: reads.append(1) or real(t))
    tpipe.optimize(start, config)
    assert not reads


def test_on_slot_visits_every_slot_like_the_jax_package(image):
    """`on_slot` runs each step visit by visit (the current colour scored
    in each visit's batch, never gated) and reports every visit; without
    random draws the JAX package's host-stepped loop ends in the same
    palette and map with each visit's error within 1e-3."""
    kw = dict(EXPLORE, channel_explore=0, max_steps=1, gate_margin=0.01,
              converge_tol=0.5)
    tc, jc = TConfig(**kw), JConfig(**kw)
    seen, jseen = [], []
    state, errs = tpipe.optimize(
        _clustered(image, tc), tc,
        on_slot=lambda v, e: seen.append((v.palette, v.index, v.channel, e)))
    js = jpipe.cluster(jpipe.initialize(j_new_state(image, jc), jc), jc)
    jstate, jerrs = jpipe.optimize(
        js, jc,
        on_slot=lambda v, e: jseen.append((v.palette, v.index, v.channel, e)))
    assert [s[:3] for s in seen] == [s[:3] for s in jseen]
    assert len(seen) == 2 * 3 * 3
    np.testing.assert_allclose([s[3] for s in seen], [s[3] for s in jseen],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(state.palette.numpy(),
                                  np.asarray(jstate.palette))
    np.testing.assert_array_equal(state.palette_map.numpy(),
                                  np.asarray(jstate.palette_map))
    assert float(errs[-1]) == seen[-1][3]


@pytest.mark.parametrize("kw", [
    dict(schedule="channel"), dict(schedule="reference"),
    dict(nes=True), dict(schedule="channel", subpalette_count=3),
])
def test_schedule_is_the_jax_packages(kw):
    kw = {**dict(subpalette_count=2, subpalette_size=2, width=64,
                 height=64), **kw}
    mine = [tuple(vars(v).values())
            for v in tpipe.schedule(TConfig(**kw), 6)]
    theirs = [(v.step, v.palette, v.index, v.method, v.channel)
              for v in jpipe.schedule(JConfig(**kw), 6)]
    assert mine == theirs


def test_run_times_its_stages(image):
    """`run` returns the init's and the optimisation's seconds and the
    final error, with `run_fused`'s step errors."""
    config = TConfig(**dict(EXPLORE, max_steps=1))
    state, errors, info = tpipe.run(image, config, device="cpu")
    _, want, winfo = tpipe.run_fused(image, config, device="cpu")
    assert errors == want and info["final_error"] == winfo["final_error"]
    assert set(info) == {"init_seconds", "optimize_seconds", "final_error"}
    assert info["init_seconds"] > 0 and info["optimize_seconds"] > 0


def test_run_fused_hybrid_reports_its_phases(image, monkeypatch):
    """Phase 1 (the gated fast recipe, no draws) runs to its plateau;
    phase 2 (explore polish) starts at phase 1's step count in the stream
    and draws what an uninterrupted phase-2 run draws there."""
    from snesimage_torch.cli import OPT_PROFILES

    geometry = dict(subpalette_count=2, subpalette_size=3, width=64,
                    height=64)
    fast = TConfig(**dict(OPT_PROFILES["fast"][1], **geometry))
    quality = TConfig(**dict(OPT_PROFILES["hybrid"][1], **geometry,
                             max_steps=2))
    draws = _record_draws(monkeypatch)
    state, errors, info = tpipe.run_fused_hybrid(image, fast, quality,
                                                 device="cpu")
    k1, k2 = info["phase_steps"]
    assert k1 >= 2 and k2 == 2 and len(errors) == k1 + k2
    assert info["final_error"] == errors[-1]
    per_step = 2 * 3 * 3
    run_draws = draws[k1 * per_step:]  # after phase 2's replay
    assert len(draws) == (k1 + 2) * per_step
    draws.clear()
    tpipe.optimize(_clustered(image, quality), quality, max_steps=k1 + 2)
    for got, want in zip(run_draws, draws[k1 * per_step:]):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="disagree on subpalette_size"):
        tpipe.run_fused_hybrid(
            image, fast, TConfig(**dict(geometry, subpalette_size=4)),
            device="cpu")


def test_trace_writes_a_trace(tmp_path):
    """`trace(dir)` writes a Chrome/Perfetto trace of the block; with no
    directory it does nothing."""
    with trace(str(tmp_path / "t")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert events["traceEvents"]
    with trace(None):
        pass
    assert os.listdir(tmp_path) == ["t"]


def test_step_timer_accumulates():
    timer = StepTimer()
    for _ in range(2):
        with timer.time("sweep", block_on=torch.ones(2)):
            pass
    assert timer.counts == {"sweep": 2}
    assert "sweep:" in timer.summary() and "2 calls" in timer.summary()
