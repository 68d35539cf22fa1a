"""The compiled sweep: each sweep captured once as a CUDA graph, then replayed.

Counterpart of snesimage_tpu/core/refine.py:1145-1215, where `sweep_random`
and `sweep_channel` are jitted `lax.fori_loop`s ("the whole sweep in one
XLA program — the host sees only the final state"), and of
snesimage_tpu/core/pipeline.py:247-385 (`_optimize_fused`, the refinement
loop as one XLA program) and 623-624 (the host-stepped fast path's step as
one jitted fori_loop over all slots). On the card the counterpart of a
jitted loop of fixed shapes is a CUDA graph. The sweeps of core/refine.py
already never wait for the device (accept, reject, the carried error and
the gate are device tensors), so one capture of a sweep replays every
later sweep of the same key. The eager sweeps stay as they are: they are
the graph's plain twin, and `optimize(..., eager=True)` runs them on the
card too.

A graph's key (`sweep_key`) is everything that changes the captured work:
the sweep method, `use_gate`, `gate`, `window`, every field of the
`QuantConfig` but the three that only `optimize` reads (`seed`,
`max_steps`, `converge_tol`: a run's generator, length and stop), the
shape, strides and dtype of every input tensor (the image shape, the image
count N, a seed portfolio's stride-0 image and pyramid), and the device.
Counting the gates changes no graph: a gated sweep, eager or captured,
counts them on the device (`refine.GateCount`). The process keeps the
`MAX_GRAPHS` graphs used last, each with its buffers and memory pool, and
drops the one used least recently for a new one (`clear` drops them all),
so the bench's timed runs and a batch's later chunks replay what an
earlier run of the same key captured, and a process that meets many keys
holds no more.

When a step captures (`SweepRunner.sweep`): a key's first sweep in the
process runs eagerly, as a real step that builds every lazy table and
scratch buffer the capture then finds. A later sweep replays the key's
graph where there is one. Where there is none, it captures the graph and
replays it if at least `CAPTURE_LEFT` steps of its run are left, this one
included, or if the key ran in `CAPTURE_RUNS` earlier runs of the process
(runs that repeat: the bench's timed runs, a batch's chunks); else it runs
eagerly. On the H100 a capture, its node count and its instantiation cost
about two eager sweeps of host time (0.4-3.4 s a channel sweep, PERF.md
§6) and a replay saves up to nine tenths of a sweep on the host-bound
paths, so a run captures only where enough replays follow it: in the same
run, or in the runs that repeat it. A two-step run after its one warm-up
(the `benchmarks` chains) stays eager. A capture or replay that fails
raises; nothing carries on eagerly in its place.

Each graph owns static buffers for what a sweep reads: the state's four
fields, the carried error, the reference pyramid and, for a random or an
explore sweep, the draws. Before a replay every input that is not already
the graph's own buffer is copied in on the device (so a replacement state
from a hook or a tile reassignment reaches the next sweep); after it the
run carries the graph's outputs, and the step's error is copied out, so
that no two steps' errors alias. The host never waits. Hazards of a stale
graph (ROADMAP C-12), each handled here or where it lives:

- the draws: before every replay one `torch.randint(..., out=row)` a
  visit, in the eager sweep's order, fills the graph's (visits, *lead, n,
  3) buffer from the run's generator (`DrawBuffer`), which the captured
  sweep reads through its `draws` keyword; the generator's stream keeps
  its position (ROADMAP C-11);
- lazily built device tables (`ops/color.py`, `ops/ssimulacra2.py`,
  `refine._image_rows`): a capture that would build one raises
  (`_lazy_tables`); the warm-up sweep builds them;
- kernel B's tile scratch (`ops/cuda_metric.py` `_tile_scratch`) keeps
  every buffer it outgrows alive and refuses to grow inside a capture;
- the counters (utils/profiling.py: kernel launches, kernel calls)
  tick only when Python makes the call: the capture's body runs inside
  `profiling.diverted`, so what it counts (nothing ran) becomes the
  graph's tally and not the run's, and every replay adds the tally. The
  captured graph's kernel nodes are counted by kernel name (`kernel_nodes`,
  through libcuda); their launch counters (`_kernels.node_launches`) must
  equal the tally's, or the capture raises. The captured sweep's
  `refine.GateCount` is published after every replay, with no host read;
- every kernel launches on the current stream (`ops/_kernels.py`
  `stream`), the capture's side stream while capturing.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import itertools
import time
from functools import lru_cache

import torch

from snesimage_torch.config import QuantConfig
from snesimage_torch.core import refine
from snesimage_torch.core.state import QuantState
from snesimage_torch.ops import _kernels
from snesimage_torch.utils import profiling
from snesimage_torch.utils.profiling import span

_FIELDS = ("original", "tile_palettes", "palette", "palette_map")
# Steps of a run that must be left, the capturing one included, for it to
# capture a key's graph, or earlier runs of the key (module docstring).
CAPTURE_LEFT = 5
CAPTURE_RUNS = 2
# Graphs the process keeps, the ones used last (module docstring); keys
# seen, for the rule that a key's first sweep runs eagerly.
MAX_GRAPHS = 8
MAX_SEEN = 256
# The config fields that only `optimize` and `step_stream` read, never a
# sweep: runs that differ in them share graphs.
_RUN_FIELDS = ("seed", "max_steps", "converge_tol")


def run_sweep(method: str, state: QuantState, config: QuantConfig, refp,
              err, generator, draws=None, gates=None, **sweep_kw):
    """One eager sweep of `method` ("nes", "random" or "channel") from
    `state` and its carried error `err`; a channel sweep draws explore
    candidates from `generator` only where the config has them, and
    `draws` (a tensor of every visit's draws) stands in for the generator
    where given. A gated sweep appends its `refine.GateCount` to `gates`
    where given, else publishes it. `sweep_kw` are the sweep's keywords
    (`use_gate`, `gate`, `window`)."""
    if draws is not None:
        sweep_kw = dict(sweep_kw, draws=draws)
    if gates is not None:
        sweep_kw = dict(sweep_kw, gates=gates)
    if method == "nes":
        return refine.sweep_nes(state, config, refp, err)
    if method == "random":
        return refine.sweep_random(state, config, refp, generator, err,
                                   **sweep_kw)
    explore = generator if config.channel_explore > 0 else None
    return refine.sweep_channel(state, config, refp, err, explore,
                                **sweep_kw)


def _layout(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype


def _inputs(state: QuantState, err, refp) -> list:
    return ([getattr(state, f) for f in _FIELDS] + [err]
            + [a for scale in refp for a in scale])


def sweep_key(method: str, state: QuantState, config: QuantConfig, refp,
              err, sweep_kw: dict) -> tuple:
    """Everything that changes a sweep's captured work (module docstring)."""
    fields = tuple(getattr(config, f.name)
                   for f in dataclasses.fields(config)
                   if f.name not in _RUN_FIELDS)
    return (method, tuple(sorted(sweep_kw.items())), fields,
            tuple(_layout(t) for t in _inputs(state, err, refp)),
            state.device)


def _buffer(t: torch.Tensor) -> torch.Tensor:
    """A static buffer of t's shape, strides (stride 0 included) and dtype
    on its device, zero-filled."""
    out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                              device=t.device)
    _dense(out).zero_()
    return out


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t without its stride-0 axes (index 0 on each): what a copy writes."""
    return t[tuple(0 if s == 0 and n > 1 else slice(None)
                   for n, s in zip(t.shape, t.stride()))]


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    _dense(dst).copy_(_dense(src))


def _detached(state: QuantState) -> QuantState:
    """A copy of `state` in tensors of its own (stride-0 axes kept), which
    no later replay overwrites."""
    out = {}
    for f in _FIELDS:
        t = getattr(state, f)
        out[f] = _buffer(t)
        _copy(out[f], t)
    return QuantState(**out)


class DrawBuffer:
    """A graph's static draws: row k holds the k-th visit's (*lead, n, 3)
    5-bit colours, which the captured sweep reads as its `draws`. `fill`
    draws every row from the run's generator, one `torch.randint` a visit
    as the eager sweep draws (`refine._draws`)."""

    def __init__(self, visits: int, lead: tuple, n: int, device):
        self.rows = torch.zeros((visits, *lead, n, 3), dtype=torch.int32,
                                device=device)

    def fill(self, generator: torch.Generator) -> None:
        for row in self.rows:
            torch.randint(0, 32, tuple(row.shape), generator=generator,
                          out=row)


def _check_nodes(kernels: dict, tally: dict, label: str) -> None:
    """Raises unless a graph's kernel nodes ({mangled name: nodes}) are the
    launches that its capture's `tally` counted."""
    launched = {k: n for k, n in tally.items()
                if k.startswith(_kernels.LAUNCH)}
    nodes = _kernels.node_launches(kernels)
    if nodes != launched:
        raise RuntimeError(f"{label}: the graph's kernel nodes give the "
                           f"launches {nodes}, the capture counted {launched}")


def _lazy_tables() -> tuple:
    """The `lru_cache`d functions that make the device tables a sweep
    reads."""
    from snesimage_torch.ops import color, ssimulacra2

    return (color._linear_lut, color.nes_palette_5bit,
            ssimulacra2._blur_matrix, ssimulacra2._weights,
            ssimulacra2._pixel_counts, refine._image_rows)


def _table_counts() -> tuple:
    return tuple(fn.cache_info().currsize for fn in _lazy_tables())


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


@lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    """libcuda's graph and name queries (CUDA 12.3 or later)."""
    cu = ctypes.CDLL("libcuda.so.1")
    p, ptr = ctypes.c_void_p, ctypes.POINTER
    for name, args in (
            ("cuGraphGetNodes", (p, p, ptr(ctypes.c_size_t))),
            ("cuGraphNodeGetType", (p, ptr(ctypes.c_int))),
            ("cuGraphKernelNodeGetParams_v2", (p, ptr(_KernelNodeParams))),
            ("cuFuncGetName", (ptr(ctypes.c_char_p), p)),
            ("cuKernelGetName", (ptr(ctypes.c_char_p), p))):
        fn = getattr(cu, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return cu


def _cu(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} failed with CUresult {rc}")


def kernel_nodes(graph: int) -> tuple[int, collections.Counter]:
    """(nodes, {mangled kernel name: nodes}) of the cudaGraph_t `graph`."""
    cu = _libcuda()
    n = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, params = ctypes.c_int(), _KernelNodeParams()
    names, kernels = {}, collections.Counter()
    for node in nodes:
        _cu(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        _cu(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
            "cuGraphKernelNodeGetParams")
        handle = (params.func, params.kern)
        if handle not in names:
            name = ctypes.c_char_p()
            if params.func:
                _cu(cu.cuFuncGetName(ctypes.byref(name), params.func),
                    "cuFuncGetName")
            else:
                _cu(cu.cuKernelGetName(ctypes.byref(name), params.kern),
                    "cuKernelGetName")
            names[handle] = name.value.decode()
        kernels[names[handle]] += 1
    return n.value, kernels


class CudaGraph:
    """One CUDA graph on the card: `capture(body)` records what `body`
    launches on a side stream, counts the graph's nodes (`nodes`, and
    `kernels` by name) and instantiates it (a capture that fails raises);
    `replay()` launches it on the current stream. Keeps the host seconds
    of the capture, the count and the instantiation."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.capture_s = self.count_s = self.instantiate_s = 0.0
        self.nodes, self.kernels = 0, collections.Counter()

    def capture(self, body):
        current = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            t0 = time.perf_counter()
            self.graph.capture_begin()
            try:
                out = body()
            finally:
                self.graph.capture_end()
            t1 = time.perf_counter()
            self.nodes, self.kernels = kernel_nodes(
                self.graph.raw_cuda_graph())
            t2 = time.perf_counter()
            self.graph.instantiate()
        self.capture_s, self.count_s = t1 - t0, t2 - t1
        self.instantiate_s = time.perf_counter() - t2
        current.wait_stream(side)
        return out

    def replay(self) -> None:
        self.graph.replay()


_STREAMS: dict = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def backend(device: torch.device):
    """The graph class for `device`: CUDA graphs on the card; None on the
    CPU, where every sweep runs eagerly."""
    return CudaGraph if device.type == "cuda" else None


@dataclasses.dataclass
class SweepGraph:
    """A captured sweep, its static inputs and outputs, and what a replay
    adds to the counters: its capture's tally and its gates."""

    label: str
    graph: object  # a `backend` instance
    state: QuantState  # static inputs
    err: torch.Tensor
    refp: tuple
    draws: DrawBuffer | None
    out: tuple  # (palette, palette_map, error) static outputs
    tally: dict = dataclasses.field(default_factory=dict)
    gates: refine.GateCount | None = None
    replays: int = 0
    holder: object = None  # the runner whose pyramid `refp` holds


# The graphs kept and the keys seen, each least recently used first; a
# key seen maps to (earlier runs that swept it, the last run that did).
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_SEEN: collections.OrderedDict = collections.OrderedDict()
_RUNS = itertools.count()


def clear() -> None:
    """Drops every graph (and its memory) and forgets which keys ran."""
    _GRAPHS.clear()
    _SEEN.clear()


def _keep(kept: collections.OrderedDict, key, value, cap: int) -> None:
    kept[key] = value
    kept.move_to_end(key)
    while len(kept) > cap:
        kept.popitem(last=False)


def stats() -> list:
    """One dict a graph kept: its label, capture, node count and
    instantiation seconds, nodes, kernel nodes, kernel B's source-mode
    calls a replay (`source_calls`) and replays so far."""
    return [dict(label=g.label, capture_s=g.graph.capture_s,
                 count_s=g.graph.count_s,
                 instantiate_s=g.graph.instantiate_s, nodes=g.graph.nodes,
                 kernel_nodes=sum(g.graph.kernels.values()),
                 source_calls=g.tally.get("b.source_calls", 0),
                 replays=g.replays)
            for g in _GRAPHS.values()]


def _label(method: str, state: QuantState, sweep_kw: dict) -> str:
    h, w = state.palette_map.shape[-2:]
    n = state.palette.shape[0] if state.palette.dim() == 4 else 1
    kw = "".join(f" {k}={v}" for k, v in sorted(sweep_kw.items()))
    return f"{method} {w}x{h} N={n}{kw}"


class SweepRunner:
    """The sweeps of one `optimize` run: eagerly, or through the process's
    graphs on the card (module docstring). Not for two runs at once: a
    graph's buffers hold one run's state at a time."""

    def __init__(self, device: torch.device, eager: bool = False):
        self.backend = None if eager else backend(device)
        self.run = next(_RUNS)
        self.replayed = False

    def sweep(self, method: str, state: QuantState, config: QuantConfig,
              refp, err, generator, draws: tuple, *, left: int, **sweep_kw):
        """One sweep; returns (state, error) as `run_sweep` does. `draws`
        is (visits, n) of the sweep's random draws, (0, 0) for none;
        `left` counts the run's steps left, this one included. Spans:
        `sweep.eager`, or `sweep.capture` or `sweep.bind` (the copies into
        the graph's buffers and the draws), then `sweep.replay` (the
        launch alone)."""
        if self.backend is None:
            return _eager(method, state, config, refp, err, generator,
                          sweep_kw)
        key = sweep_key(method, state, config, refp, err, sweep_kw)
        graph = _GRAPHS.get(key)
        if graph is None:
            runs = self._earlier_runs(key)
            if runs is None or (left < CAPTURE_LEFT and runs < CAPTURE_RUNS):
                return _eager(method, state, config, refp, err, generator,
                              sweep_kw)
            with span("sweep.capture"):
                graph = self._capture(key, method, state, config, refp, err,
                                      generator, draws, sweep_kw)
        else:
            with span("sweep.bind"):
                self._bind(graph, state, err, refp, generator)
        _keep(_GRAPHS, key, graph, MAX_GRAPHS)
        with span("sweep.replay", device=True):
            graph.graph.replay()
        graph.replays += 1
        self.replayed = True
        for name, n in graph.tally.items():
            profiling.count(name, n)
        if graph.gates is not None:
            graph.gates.publish()
        palette, palette_map, err_out = graph.out
        return (graph.state.replace(palette=palette, palette_map=palette_map),
                err_out.clone())

    def _earlier_runs(self, key):
        """The earlier runs of the process that swept `key`, or None at its
        first sweep in the process; notes this run's sweep."""
        seen = _SEEN.get(key)
        runs = None if seen is None else seen[0] + (seen[1] != self.run)
        _keep(_SEEN, key, (runs or 0, self.run), MAX_SEEN)
        return runs

    def release(self, state: QuantState) -> QuantState:
        """The run's final state in tensors of its own, where a replay may
        have left it in a graph's buffers."""
        return _detached(state) if self.replayed else state

    def _bind(self, graph: SweepGraph, state, err, refp, generator) -> None:
        """Copies the run's state, error, pyramid (once a run) and this
        step's draws into the graph's buffers."""
        for f in _FIELDS:
            src, dst = getattr(state, f), getattr(graph.state, f)
            if src is not dst:
                _copy(dst, src)
        if err is not graph.err:
            _copy(graph.err, err)
        if graph.holder is not self:
            for scale, buf in zip(refp, graph.refp):
                for a, b in zip(scale, buf):
                    _copy(b, a)
            graph.holder = self
        if graph.draws is not None:
            graph.draws.fill(generator)

    def _capture(self, key, method, state, config, refp, err, generator,
                 draws, sweep_kw) -> SweepGraph:
        visits, n = draws
        lead = tuple(state.palette.shape[:-3])
        graph = SweepGraph(
            label=_label(method, state, sweep_kw),
            graph=self.backend(state.device),
            state=QuantState(**{f: _buffer(getattr(state, f))
                                for f in _FIELDS}),
            err=_buffer(err),
            refp=tuple(tuple(_buffer(a) for a in scale) for scale in refp),
            draws=(DrawBuffer(visits, lead, n, state.device) if visits
                   else None),
            out=())
        self._bind(graph, state, err, refp, generator)

        def body():
            tables = _table_counts()
            gates = []
            with profiling.diverted() as tally:
                out_state, out_err = run_sweep(
                    method, graph.state, config, graph.refp, graph.err, None,
                    None if graph.draws is None else graph.draws.rows,
                    gates, **sweep_kw)
            if _table_counts() != tables:
                raise RuntimeError(
                    f"a device table was built while capturing {graph.label}:"
                    " it would live in the graph's memory")
            for f in ("original", "tile_palettes"):
                if getattr(out_state, f) is not getattr(graph.state, f):
                    raise RuntimeError(f"{graph.label} replaced {f}")
            graph.tally, graph.gates = tally, gates[0] if gates else None
            return out_state.palette, out_state.palette_map, out_err

        graph.out = graph.graph.capture(body)
        _check_nodes(graph.graph.kernels, graph.tally, graph.label)
        return graph


def _eager(method, state, config, refp, err, generator, sweep_kw):
    """An eager sweep in its span; a gated one publishes its gates."""
    with span("sweep.eager", device=True):
        return run_sweep(method, state, config, refp, err, generator,
                         **sweep_kw)
