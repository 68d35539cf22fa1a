"""Successive random visits and a whole reference cycle of the port against
the JAX package on the CPU, on the JAX generator's own draws.

A random visit's candidates come from the package's generator. The JAX
package's key stream is reproduced here (`sweep_random` splits its key once
a visit, `_optimize_fused` once a random step), and `torch.randint` is made
to hand the port those draws, so the two packages walk the same visits:
what is compared is the error, the distance cache and the target's Lab
image carried from visit to visit, and the cycle's hand-over from the
random sweeps to the channel sweep. tests/test_torch_schedules.py holds the
single visit and says why errors are compared within 1e-5 of their value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import pipeline as tpipe
from snesimage_torch.core import refine as tref
from snesimage_torch.io.json_out import state_to_json as t_json
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core import refine as jref
from snesimage_tpu.io.json_out import state_to_json as j_json
from test_torch_schedules import (
    SMALL,
    TRIALS,
    VISIT_ERR_RTOL,
    _assert_same_state,
    _both,
)


def _jax_sweep_draws(key, visits: int, trials: int):
    """The candidates that the JAX package's `sweep_random` draws from
    `key`, visit by visit, and each visit's key."""
    keys, draws = [], []
    for _ in range(visits):
        key, sub = jax.random.split(key)
        keys.append(sub)
        draws.append(np.array(jax.random.randint(sub, (trials, 3), 0, 32,
                                                 dtype=jnp.int32)))
    return keys, draws


def _feed_randint(monkeypatch, draws):
    """Makes `torch.randint` hand out `draws` in turn, so that the port's
    sweeps see the JAX generator's candidates."""
    feed = iter(draws)

    def randint(low, high, size, *, generator=None, device=None, dtype=None):
        draw = next(feed)
        assert (low, high, tuple(size)) == (0, 32, draw.shape)
        return torch.from_numpy(draw).to(device=device, dtype=dtype)

    monkeypatch.setattr(torch, "randint", randint)
    return feed


@pytest.mark.parametrize(
    "prescreen,prescreen_full,perceptual,width,height",
    [(0, 0, False, 32, 32), (8, 2, False, 32, 32), (0, 0, True, 40, 24)],
)
def test_sweep_random_visit_by_visit_with_the_jax_draws(
        small_image, monkeypatch, prescreen, prescreen_full, perceptual,
        width, height):
    """Two successive random sweeps, every visit on the JAX generator's
    draws, with the error, the distance cache and the target's Lab image
    carried from visit to visit on both sides: after each visit the same
    palette and map and the carried error within 1e-5 of its value. Then
    the port's `sweep_random` on the same draws gives the walk's states,
    and they are the JAX package's `sweep_random`'s."""
    kw = dict(SMALL, width=width, height=height, prescreen=prescreen,
              prescreen_full=prescreen_full, perceptual_palettes=perceptual,
              random_trials=TRIALS)
    (js, jc, jrefp), (ts, tc, trefp) = _both(small_image, **kw)
    s, visits = tc.subpalette_size, tc.subpalette_count * tc.subpalette_size
    sweep_keys = [jax.random.key(21), jax.random.key(22)]

    @jax.jit
    def j_visit(state, cache, err, key, p, i):
        res, cache, _ = jref._slot_random(state, jc, jrefp, key, p, i, cache,
                                          err, skip=True)
        return res.state, cache, res.error

    j_err = jref.frame_error_fused(js, jc, jrefp)
    t_err = tref.frame_error_fused(ts, tc, trefp)
    assert abs(float(t_err) - float(j_err)) <= VISIT_ERR_RTOL * float(j_err)
    accepted, all_draws, walked = 0, [], []
    for sweep_key in sweep_keys:
        keys, draws = _jax_sweep_draws(sweep_key, visits, TRIALS)
        all_draws += draws
        j_cache = jref._init_cache(js, jc)
        d_all, t_lab = tref._sweep_caches(ts, tc)
        for k in range(visits):
            before = ts.palette
            js, j_cache, j_err = j_visit(js, j_cache, j_err, keys[k], k // s,
                                         k % s)
            ts, t_err, d_all = tref._slot_random(
                ts, tc, trefp, k // s, k % s, d_all, t_err, t_lab=t_lab,
                cand5=torch.from_numpy(draws[k]))
            _assert_same_state(ts, js)
            assert abs(float(t_err) - float(j_err)) <= (
                VISIT_ERR_RTOL * float(j_err)), k
            accepted += int(not torch.equal(before, ts.palette))
        # The carried cache is the state's own.
        assert torch.equal(d_all, tref.compute_d_all(ts, tc)) or perceptual
        walked.append((ts, float(t_err), js))
    assert accepted >= 2  # the carried error and caches were put to use

    # The sweeps themselves, from the same start and on the same draws.
    (js0, _, _), (ts0, _, _) = _both(small_image, **kw)
    feed = _feed_randint(monkeypatch, all_draws)
    state, err, jstate, jerr = ts0, None, js0, None
    for sweep_key, (want_state, want_err, want_j) in zip(sweep_keys, walked):
        state, err = tref.sweep_random(state, tc, trefp, None, err)
        assert torch.equal(state.palette, want_state.palette)
        assert torch.equal(state.palette_map, want_state.palette_map)
        assert float(err) == want_err
        jstate, jerr, _ = jref.sweep_random(jstate, jc, jrefp, sweep_key, jerr)
        _assert_same_state(state, jstate)
        _assert_same_state(want_state, want_j)
        assert abs(float(err) - float(jerr)) <= VISIT_ERR_RTOL * float(jerr)
    assert next(feed, None) is None


def test_reference_cycle_with_the_jax_draws(small_image, monkeypatch):
    """One whole cycle of the reference schedule through `run_fused` on
    both packages (four random sweeps handing over to a channel sweep, no
    prescreen), the port's random visits fed the draws of the JAX package's
    key stream: the same palette, map and JSON bytes, and each step's error
    within 1e-5 of its value."""
    img = np.ascontiguousarray(small_image[:32, :32])
    kw = dict(SMALL, width=32, height=32, max_steps=5, random_trials=16,
              converge_tol=0.0, seed=3)
    tc, jc = TConfig(**kw), JConfig(**kw)
    assert tc.schedule == "reference" and tc.prescreen == 0
    visits = tc.subpalette_count * tc.subpalette_size
    key = jax.random.fold_in(jax.random.key(jc.seed), 0)
    draws = []
    for step in range(tc.max_steps):
        if tpipe.step_method(tc, step) == "random":
            key, sub = jax.random.split(key)
            draws += _jax_sweep_draws(sub, visits, tc.random_trials)[1]
    jstate, jerrors, _ = jpipe.run_fused(img, jc)
    feed = _feed_randint(monkeypatch, draws)
    state, errors, _ = tpipe.run_fused(img, tc, device="cpu")
    assert next(feed, None) is None
    _assert_same_state(state, jstate)
    assert t_json(state, tc) == j_json(jstate, jc)
    np.testing.assert_allclose(errors, jerrors, rtol=VISIT_ERR_RTOL, atol=0)
    assert errors[4] < errors[3] < errors[0]  # both kinds of sweep accepted
