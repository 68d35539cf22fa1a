"""The compiled sweep (snesimage_torch/core/graphs.py) on the CPU.

A CUDA graph needs the card, so these tests give `graphs.SweepRunner` a
stand-in, `EmulatedGraph`: its capture runs the sweep once and keeps the
outputs, and each replay runs the sweep again on the graph's static inputs
and writes the results into those same outputs, as a replay overwrites a
graph's static outputs. What the runner adds around a graph is then the
code under test: the keys, which steps share a graph, the copies into the
static buffers and out of them, the draws buffer, the counters a replay
adds (its capture's tally, checked against the stand-in's kernel nodes,
none on the CPU unless a test gives some), the gate counts a replay
publishes and the bound on the graphs kept. Every graphed run must equal
the eager run (`eager=True`, the graph's plain twin) bit for bit. On the card the same runs go through
real graphs in `tests/test_torch_cuda.py` and `chip_smoke.py` phase 44.
"""

import dataclasses

import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core import graphs, pipeline, refine
from snesimage_torch.core.state import QuantState, new_state, shared_states
from snesimage_torch.ops import _kernels
from snesimage_torch.ops.ssimulacra2 import shared_pyramid
from snesimage_torch.testing import bench_image, single_torch_thread
from snesimage_torch.utils import profiling

# 32x32, 2x2 palettes: 12 channel visits a sweep, explore draws included.
CHANNEL = dict(
    subpalette_count=2, subpalette_size=2, width=32, height=32, max_steps=6,
    converge_tol=0.0, schedule="channel", prescreen=8, prescreen_full=2,
    channel_explore=4, accept_margin=0.005,
)
# The reference cycle: four random sweeps of 8 draws, then a channel sweep.
REFERENCE = dict(subpalette_count=2, subpalette_size=2, width=32, height=32,
                 max_steps=6, converge_tol=0.0, random_trials=8)
NES = dict(subpalette_count=2, subpalette_size=2, width=32, height=32,
           max_steps=6, converge_tol=0.0, nes=True)
NES_VISITS = 4  # a NES sweep's visits, one a slot
# The rank-1 gate with its exact confirmation sweeps (a tolerance that
# starves), and windowed channel descent (steps 2, 3 and 5 windowed).
GATED = dict(CHANNEL, channel_explore=0, gate_margin=0.01, converge_tol=5.0)
WINDOWED = dict(CHANNEL, channel_window=2)


class EmulatedGraph:
    """A CUDA graph's stand-in on the CPU (module docstring): no kernel
    nodes unless `KERNELS` ({mangled kernel name: nodes}) says so."""

    KERNELS: dict = {}

    def __init__(self, device):
        self.capture_s = self.count_s = self.instantiate_s = 0.0
        self.kernels = dict(self.KERNELS)
        self.nodes = sum(self.kernels.values())

    def capture(self, body):
        self.body = body
        self.out = body()
        return self.out

    def replay(self):
        for kept, new in zip(self.out, self.body()):
            if kept is not None:
                kept.copy_(new)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with single_torch_thread():
        yield


@pytest.fixture(autouse=True)
def emulated(monkeypatch):
    """Graphs on the CPU through `EmulatedGraph`, none kept across
    tests."""
    monkeypatch.setattr(graphs, "backend", lambda device: EmulatedGraph)
    graphs.clear()
    yield
    graphs.clear()


@pytest.fixture(scope="module")
def image():
    return np.ascontiguousarray(bench_image(0)[112:144, 112:144])


def _clustered(image, config):
    state = new_state(image, config, "cpu")
    return pipeline.cluster(pipeline.initialize(state, config), config)


def _same(a: QuantState, b: QuantState) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("original", "tile_palettes", "palette",
                         "palette_map"))


def _replays() -> int:
    return sum(g["replays"] for g in graphs.stats())


@pytest.mark.parametrize("name,params,labels", [
    ("channel", CHANNEL, ["channel 32x32 N=1"]),
    ("reference", REFERENCE, ["random 32x32 N=1", "channel 32x32 N=1"]),
    ("nes", NES, ["nes 32x32 N=1"]),
    ("gated", GATED, ["channel 32x32 N=1 gate=True use_gate=True",
                      "channel 32x32 N=1 gate=True use_gate=False"]),
    ("windowed", WINDOWED, ["channel 32x32 N=1",
                            "channel 32x32 N=1 window=True"]),
])
def test_graphed_runs_equal_eager(image, name, params, labels,
                                  monkeypatch):
    """Two graphed runs of each schedule equal the eager run bit for bit:
    a key's first sweep runs eagerly, later ones replay (here captured
    whatever the steps left), and the second run replays every sweep; the
    steps of one key share one graph."""
    monkeypatch.setattr(graphs, "CAPTURE_LEFT", 1)
    config = QuantConfig(**params)
    state = _clustered(image, config)
    want, want_errs = pipeline.optimize(state, config, eager=True)
    assert graphs.stats() == []  # an eager run captures nothing
    got, errs = pipeline.optimize(state, config)
    assert torch.equal(errs, want_errs) and _same(got, want)
    before = _replays()
    again, errs = pipeline.optimize(state, config)
    assert torch.equal(errs, want_errs) and _same(again, want)
    assert _replays() - before == len(want_errs)
    seen = sorted(g["label"] for g in graphs.stats())
    if name == "gated":
        # The confirmation key runs only where the stop rule asks for it.
        assert labels[0] in seen and set(seen) <= set(labels)
    else:
        assert seen == sorted(labels)


def test_keys():
    """A key holds what changes the captured work and nothing else: runs
    that differ in seed, max_steps or converge_tol, or run inside a
    `profiling.recording`, share graphs."""
    config = QuantConfig(**CHANNEL)
    state = new_state(np.zeros((32, 32, 4), np.uint8), config, "cpu")
    refp = refine.make_reference_pyramid(state)
    err = torch.tensor(1.0)

    def key(method="channel", st=state, cfg=config, rp=refp, kw=None):
        return graphs.sweep_key(method, st, cfg, rp, err, kw or {})

    base = key()
    same = dataclasses.replace(config, seed=5, max_steps=2, converge_tol=1.0)
    assert key(cfg=same) == base
    two = shared_states(state, 2)
    others = [
        key("random"), key("nes"), key(kw=dict(window=True)),
        key(kw=dict(use_gate=False, gate=True)),
        key(cfg=dataclasses.replace(config, accept_margin=0.01)),
        key(st=state.replace(palette_map=state.palette_map.t())),  # strides
        graphs.sweep_key("channel", two, config, shared_pyramid(refp, 2),
                         err.expand(2).contiguous(), {}),
    ]
    with profiling.recording():
        assert key() == base  # counting the gates changes no graph
    assert len({base, *others}) == len(others) + 1


def test_capture_rule(image):
    """A run captures a key's graph with CAPTURE_LEFT steps left, or once
    the key ran in CAPTURE_RUNS earlier runs, never at the key's first
    sweep in the process; a run replays the graphs an earlier run left."""
    left = graphs.CAPTURE_LEFT
    assert graphs.CAPTURE_RUNS == 2
    config = QuantConfig(**dict(CHANNEL, max_steps=left))
    state = _clustered(image, config)

    def replays(**kw):
        pipeline.optimize(state, config, **kw)
        return [g["replays"] for g in graphs.stats()]

    assert replays() == []  # step 0 eager, step 1 has 4 steps left
    assert replays(max_steps=2) == []  # one earlier run, too short
    assert replays(max_steps=2) == [2]  # two earlier runs: captures
    assert replays(max_steps=1) == [3]
    graphs.clear()
    assert replays(max_steps=left + 1) == [left]  # 5 steps left at step 1
    assert replays() == [2 * left]


def test_static_buffers_do_not_leak(image):
    """The state a graphed run returns and each step's error are tensors of
    their own: a later replay changes none of them, and no two steps'
    errors share memory."""
    config = QuantConfig(**CHANNEL)
    state = _clustered(image, config)
    pipeline.optimize(state, config)  # captures
    got, errs = pipeline.optimize(state, config)
    kept = (got.palette.clone(), got.palette_map.clone(), errs.clone())
    graph, = graphs._GRAPHS.values()
    buffers = {t.data_ptr() for t in (*graph.out, graph.err,
                                      graph.state.palette,
                                      graph.state.palette_map)}
    assert not buffers & {got.palette.data_ptr(), got.palette_map.data_ptr()}
    other = _clustered(image, dataclasses.replace(config, seed=3))
    pipeline.optimize(other, dataclasses.replace(config, seed=3))
    assert torch.equal(got.palette, kept[0])
    assert torch.equal(got.palette_map, kept[1]) and torch.equal(errs,
                                                                 kept[2])


def test_step_errors_are_copied_out(image):
    """Each step's error is copied out of the graph's output buffer."""
    config = QuantConfig(**CHANNEL)
    state = _clustered(image, config)
    runner = graphs.SweepRunner(state.device)
    refp = refine.make_reference_pyramid(state)
    err = refine.frame_error_fused(state, config, refp)
    gen = pipeline.step_stream(config, state)
    outs = []
    for step in range(graphs.CAPTURE_LEFT):
        state, err = runner.sweep("channel", state, config, refp, err, gen,
                                  pipeline._draw_sizes(config, step),
                                  left=graphs.CAPTURE_LEFT)
        outs.append(err)
    assert len({e.data_ptr() for e in outs}) == len(outs)
    graph, = graphs._GRAPHS.values()
    assert graph.out[2].data_ptr() not in {e.data_ptr() for e in outs}
    eager_errs = pipeline.optimize(
        _clustered(image, config), config,
        max_steps=graphs.CAPTURE_LEFT, eager=True)[1]
    assert torch.equal(torch.stack(outs), eager_errs)


def test_replacements_reach_the_next_sweep(image):
    """An `on_step_state` replacement and `reassign_every` put a new state
    into the graph's buffers: the graphed run equals the eager one, and
    differs from the run without them."""
    config = QuantConfig(**CHANNEL)
    state = _clustered(image, config)

    def click(step, st, _):
        if step == 1:
            return pipeline.apply_tile_reassignments(st, config,
                                                     [(0, 0), (3, 2, 1)])
        return None

    kw = dict(reassign_every=2, on_step_state=click)
    want, want_errs = pipeline.optimize(state, config, eager=True, **kw)
    plain, plain_errs = pipeline.optimize(state, config, eager=True)
    assert not torch.equal(want_errs, plain_errs)
    pipeline.optimize(state, config)  # captures the sweep's graph
    got, errs = pipeline.optimize(state, config, **kw)
    assert torch.equal(errs, want_errs) and _same(got, want)


def test_on_step_sees_each_state(image):
    """`on_step` reads each step's state as the eager run has it, in
    tensors no later replay changes."""
    config = QuantConfig(**CHANNEL)
    state = _clustered(image, config)
    eager_seen, seen = [], []
    pipeline.optimize(state, config, eager=True,
                      on_step=lambda k, st, _: eager_seen.append(st))
    pipeline.optimize(state, config)
    pipeline.optimize(state, config, on_step=lambda k, st, _: seen.append(st))
    assert len(seen) == len(eager_seen) == config.max_steps
    assert all(_same(a, b) for a, b in zip(seen, eager_seen))


def test_gate_counts_unchanged(image):
    """A gated run counts the same visits and closed gates graphed as
    eagerly."""
    config = QuantConfig(**dict(GATED, converge_tol=0.0))
    state = _clustered(image, config)
    counts = []
    for eager in (True, False, False):
        with profiling.recording() as rec:
            pipeline.optimize(state, config, eager=eager)
        counts.append((rec.total("gate.visits"), rec.total("gate.closed")))
    assert counts[0] == counts[1] == counts[2]
    assert counts[0][0] == config.max_steps * 12


# Kernel B's kernel<false>, kernel C's three-level kernel<true> and kernel
# A's entries, as mangled names.
B_KERNEL = "_ZN4snes17multiscale_kernelILb0ELb0EEEvNS_14MultiscaleCallE"
C_FRAMES = "_ZN4snes21coarse_redmean_kernelILb1EEEvPKiS2_"
B_LAUNCH = _kernels.LAUNCH + "multiscale_kernel"


def _counting_nes(monkeypatch, calls: int, launches: int):
    """sweep_nes as if each sweep called kernel B `calls` more times on
    frames, launching it `launches` times (the calls that split launch
    twice)."""
    real = refine.sweep_nes

    def counted(*args, **kw):
        profiling.count("b.frame_calls", calls)
        profiling.count(B_LAUNCH, launches)
        return real(*args, **kw)

    monkeypatch.setattr(refine, "sweep_nes", counted)


def _totals(rec) -> tuple:
    return tuple(rec.total(k) for k in (B_LAUNCH, "b.frame_calls",
                                        "b.source_calls"))


def test_launch_counters_follow_replays(image, monkeypatch):
    """The counts tick at every replay by the capture's tally, whose
    launches must equal the graph's kernel nodes, and not at the capture,
    where nothing runs: on the CPU a stand-in sweep counts 7 more calls of
    kernel B, 2 of which launch twice, and the stand-in graph holds 9
    nodes of B's kernel. Beside them the twin's calls count, which launch
    nothing: one a NES visit, and one for the start's error."""
    _counting_nes(monkeypatch, 7, 9)
    monkeypatch.setattr(EmulatedGraph, "KERNELS", {B_KERNEL: 9})
    config = QuantConfig(**NES)
    state = _clustered(image, config)
    counts = []
    for eager in (True, False, False):
        with profiling.recording() as rec:
            pipeline.optimize(state, config, eager=eager)
        counts.append(_totals(rec))
    steps = config.max_steps
    calls = 7 + NES_VISITS
    assert counts == [(9 * steps, calls * steps + 1, 0)] * 3
    assert graphs.stats()[0]["kernel_nodes"] == 9


def test_capture_adds_its_tally_at_each_replay(image, monkeypatch):
    """A capture adds nothing to the open run, and each replay adds the
    capture's tally once: the stand-in graph's replays run the sweep into
    a tally of their own, so the run sees each sweep's counts once,
    eager or replayed."""
    _counting_nes(monkeypatch, 7, 9)
    monkeypatch.setattr(EmulatedGraph, "KERNELS", {B_KERNEL: 9})
    config = QuantConfig(**NES)
    state = _clustered(image, config)
    refp = refine.make_reference_pyramid(state)
    err = refine.frame_error_fused(state, config, refp)
    runner = graphs.SweepRunner(state.device)
    seen = []
    with profiling.recording() as rec:
        for step in range(3):  # eager; captured and replayed; replayed
            state, err = runner.sweep("nes", state, config, refp, err, None,
                                      (0, 0), left=graphs.CAPTURE_LEFT)
            seen.append(_totals(rec))
    graph, = graphs._GRAPHS.values()
    assert graph.tally[B_LAUNCH] == 9
    assert graph.tally["b.frame_calls"] == 7 + NES_VISITS
    sweep = tuple(graph.tally.get(k, 0) for k in (B_LAUNCH, "b.frame_calls",
                                                  "b.source_calls"))
    assert seen == [tuple(n * k for n in sweep) for k in (1, 2, 3)]


@pytest.mark.parametrize("nodes", [8, 10])
def test_capture_refuses_nodes_that_disagree(image, monkeypatch, nodes):
    """A captured graph whose kernel nodes are not the launches its capture
    counted raises, and no step runs eagerly in its place."""
    _counting_nes(monkeypatch, 7, 9)
    monkeypatch.setattr(EmulatedGraph, "KERNELS", {B_KERNEL: nodes})
    config = QuantConfig(**NES)
    state = _clustered(image, config)
    with pytest.raises(RuntimeError, match="kernel nodes"):
        pipeline.optimize(state, config)
    assert graphs.stats() == []


def test_nodes_count_toward_their_kernel_by_name():
    """Kernel nodes count toward the listed kernel whose name their
    mangled name holds, across namespaces and template arguments: A's
    three kernels apart, C's kernel<true> and kernel<false> together, B's
    four variants together; torch's kernels toward none."""
    name = "_ZN4snes17multiscale_kernelILb{}ELb{}EEEvNS_14MultiscaleCallE"
    kernels = {"_ZN12_GLOBAL__N_120select_colors_kernelEPKiPKfPfi": 1,
               "_ZN12_GLOBAL__N_115prologue_kernelEv": 2,
               "_Z13render_kernelv": 3, C_FRAMES: 4,
               "_ZN4snes21coarse_redmean_kernelILb0EEEvPKiS2_": 1,
               name.format(0, 0): 3, name.format(1, 0): 1,
               name.format(0, 1): 4, name.format(1, 1): 2,
               "_ZN2at6native29vectorized_elementwise_kernelILi4E": 50,
               "_ZN2at6native13reduce_kernelILi512ELi1E": 7}
    launch = _kernels.LAUNCH
    assert _kernels.node_launches(kernels) == {
        launch + "select_colors_kernel": 1, launch + "prologue_kernel": 2,
        launch + "render_kernel": 3, launch + "multiscale_kernel": 10,
        launch + "coarse_redmean_kernel": 5}
    assert _kernels.node_launches({}) == {}


@pytest.mark.parametrize("change", [-1, 1, "missing", "extra"])
def test_node_check_refuses_a_tally_that_differs(change):
    """A listed kernel with more or fewer nodes than its tally's launches,
    or nodes of a kernel the tally never launched, or launches with no
    node, raise; other counters and torch's nodes are not compared."""
    kernels = {B_KERNEL: 5, C_FRAMES: 4,
               "_ZN2at6native29vectorized_elementwise_kernelILi4E": 50}
    tally = {B_LAUNCH: 5, _kernels.LAUNCH + "coarse_redmean_kernel": 4,
             "b.frame_calls": 3, "c.three_level_calls": 4}
    graphs._check_nodes(kernels, tally, "sweep")
    if change == "missing":
        del tally[B_LAUNCH]
    elif change == "extra":
        tally[_kernels.LAUNCH + "dither_remap_kernel"] = 1
    else:
        tally[B_LAUNCH] += change
    with pytest.raises(RuntimeError, match="kernel nodes"):
        graphs._check_nodes(kernels, tally, "sweep")


def test_graphs_kept_are_bounded(image, monkeypatch):
    """The process keeps the MAX_GRAPHS graphs used last and at most
    MAX_SEEN keys: a run of a new key past the bound drops the graph used
    least recently, and a dropped key captures anew."""
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    monkeypatch.setattr(graphs, "MAX_SEEN", 3)
    monkeypatch.setattr(graphs, "CAPTURE_LEFT", 1)
    base = QuantConfig(**dict(CHANNEL, max_steps=2))
    state = _clustered(image, base)
    margins = (0.001, 0.002, 0.003, 0.004)
    for margin in margins:
        pipeline.optimize(state, dataclasses.replace(base,
                                                     accept_margin=margin))
        assert len(graphs.stats()) <= 2 and len(graphs._SEEN) <= 3
    fields = [f.name for f in dataclasses.fields(QuantConfig)
              if f.name not in graphs._RUN_FIELDS]
    at = fields.index("accept_margin")
    assert {key[2][at] for key in graphs._GRAPHS} == set(margins[-2:])
    # The first margin's graph and key are gone: its next run warms again.
    pipeline.optimize(state, dataclasses.replace(base,
                                                 accept_margin=margins[0]))
    assert [g["replays"] for g in graphs.stats()] == [1, 1]


def test_draw_buffer_draws_what_the_sweep_draws(image):
    """`DrawBuffer.fill` takes from the generator what the eager visits
    take, visit by visit, and leaves it at the same position; a sweep given
    the buffer as its `draws` equals the sweep that draws them."""
    gen_a, gen_b = torch.Generator(), torch.Generator()
    gen_a.manual_seed(11)
    gen_b.manual_seed(11)
    buf = graphs.DrawBuffer(5, (2,), 4, torch.device("cpu"))
    buf.fill(gen_a)
    want = [refine._draws(gen_b, (2,), 4, "cpu") for _ in range(5)]
    assert torch.equal(buf.rows, torch.stack(want))
    assert torch.equal(torch.randint(0, 9, (3,), generator=gen_a),
                       torch.randint(0, 9, (3,), generator=gen_b))
    for method, params in (("random", REFERENCE), ("channel", CHANNEL)):
        config = QuantConfig(**params)
        state = _clustered(image, config)
        refp = refine.make_reference_pyramid(state)
        err = refine.frame_error_fused(state, config, refp)
        visits, n = pipeline._draw_sizes(config, 0 if method == "random"
                                         else 4)
        rows = graphs.DrawBuffer(visits, (), n, torch.device("cpu"))
        rows.fill(pipeline.step_stream(config, state))
        want = graphs.run_sweep(method, state, config, refp, err,
                                pipeline.step_stream(config, state))
        got = graphs.run_sweep(method, state, config, refp, err, None,
                               rows.rows)
        assert torch.equal(got[1], want[1]) and _same(got[0], want[0])


def test_portfolio_keeps_its_stride_zero_image(image):
    """A seed portfolio (stride-0 image and pyramid) replays bit for bit,
    and the state it returns still shares one image."""
    config = QuantConfig(**CHANNEL)
    state = _clustered(image, config)
    seeds = shared_states(state, 2)
    refp = shared_pyramid(refine.make_reference_pyramid(state), 2)
    want, want_errs = pipeline.optimize(seeds, config, refp=refp, gate=False,
                                        eager=True)
    for _ in range(2):
        got, errs = pipeline.optimize(seeds, config, refp=refp, gate=False)
    assert torch.equal(errs, want_errs) and _same(got, want)
    assert got.original.stride(0) == 0


def test_capture_refuses_a_lazy_table(image, monkeypatch):
    """A capture that would build a device table raises, and nothing runs
    the step eagerly in its place."""
    config = QuantConfig(**CHANNEL)
    state = _clustered(image, config)
    pipeline.optimize(state, config, max_steps=1)  # the key's eager sweep
    real = refine.sweep_channel

    def builds(*args, **kw):
        refine._image_rows(97, torch.device("cpu"))
        return real(*args, **kw)

    monkeypatch.setattr(refine, "sweep_channel", builds)
    with pytest.raises(RuntimeError, match="device table"):
        pipeline.optimize(state, config, max_steps=graphs.CAPTURE_LEFT)
