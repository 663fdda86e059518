"""Shared serving types (port of ``repro.serve.request``): request and
finished records, the nearest-rank percentile, :class:`StepGraphs`, the
counterpart of the reference's ``counting_jit``: an engine's step callables
built once per static shape, counted and traced, each a captured CUDA graph
on the card, and :func:`make_serve_energy_model`, the hw twin's serving
books."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.obs.trace import NOOP, TID_COMPILE

Tensor = torch.Tensor


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    generated: List[int] = dataclasses.field(default_factory=list)
    energy_pj: float = 0.0        # attributed crossbar read energy
    submit_t: float = dataclasses.field(default_factory=time.monotonic)
    prefilled: int = 0            # prompt tokens already in the cache (the
                                  # chunked-prefill resume cursor)
    skipped: int = 0              # times a younger request was admitted
                                  # first (serve/sched's starvation guard)
    queued_step: int = 0          # scheduler step at submit (age basis)
    first_token_t: float = 0.0    # wall time the first token landed (TTFT)
    last_token_t: float = 0.0     # wall time of the latest token


@dataclasses.dataclass
class Finished:
    uid: int
    tokens: np.ndarray
    energy_pj: float = 0.0        # prefill + attributed decode shares
    pj_per_token: float = 0.0     # energy / (prompt + generated tokens)
    latency_s: float = 0.0        # submit -> finished wall time
    ttft_s: float = 0.0           # submit -> first token wall time


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile; 0.0 for an empty input."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def make_serve_energy_model(cfg, slots: int, track_energy: bool,
                            params=None, census=None):
    """The hw twin's serving books (DESIGN.md §6): only at
    ``quant="timefloats"`` and when asked. With ``params`` the model also
    carries a per-tile wear book (DESIGN.md §13) keyed by the mapper's
    placement, so the reads an engine books land per tile. ``census``
    replaces ``hw.schedule.capture_census`` (an engine's memo over it)."""
    if not (track_energy and cfg.quant == "timefloats"):
        return None
    from repro_torch.hw.schedule import ServeEnergyModel, TileWearBook

    wear = None
    if params is not None:
        from repro_torch.hw.mapper import map_params

        wear = TileWearBook(map_params(params, cfg), cfg)
    return ServeEnergyModel(slots, wear=wear, census=census)


# Step censuses by engine geometry and step shape, shared by every engine
# of one process: a census is a function of shapes only, and a drain that
# builds several engines of one configuration (graphs, eager twin, plain
# versions) traces each of its programs once.
_CENSUS_MEMO: Dict[tuple, list] = {}


def _signature(a):
    if isinstance(a, (np.ndarray, Tensor)):
        return ("array", tuple(a.shape), str(a.dtype))
    return a


def memo_census(geometry: tuple, fn, *args) -> list:
    """``hw.schedule.capture_census(fn, *args)`` memoized on ``geometry``
    (whatever fixes the shapes of the engine's parameters and cache),
    ``fn``'s name and the shapes and values of the step's other
    arguments. ``args`` are (params, cache, step inputs...)."""
    from repro_torch.hw.schedule import capture_census

    key = (geometry, getattr(fn, "__name__", fn),
           tuple(_signature(a) for a in args[2:]))
    if key not in _CENSUS_MEMO:
        _CENSUS_MEMO[key] = capture_census(fn, *args)
    return _CENSUS_MEMO[key]


# ---------------------------------------------------------------------------
# Compile discipline: the counterpart of the reference's ``counting_jit``.
# ---------------------------------------------------------------------------

def launch_counters() -> tuple:
    """The kernel wrappers whose ``launches`` attribute counts their
    launches (K1, K2, K3, K6, K4, K5, and K1 over experts)."""
    from repro_torch.kernels import paged, paged_attn, sampling
    from repro_torch.kernels import timefloats_matmul as tm

    return (tm.timefloats_matmul_quantized,
            tm.timefloats_matmul_transposed_quantized, sampling.sample,
            paged.gather_pages, paged_attn.paged_decode_attention,
            paged_attn.paged_decode_mla, tm.timefloats_matmul_experts)


@contextlib.contextmanager
def launches_set_aside(deltas: List[int]) -> Iterator[None]:
    """Run a capture: afterwards ``deltas`` holds what each of
    :func:`launch_counters` counted inside the block, and the counters are
    back where they were (a capture launches nothing)."""
    counters = launch_counters()
    before = [f.launches for f in counters]
    try:
        yield
    finally:
        deltas[:] = [f.launches - b for f, b in zip(counters, before)]
        for f, b in zip(counters, before):
            f.launches = b


@dataclasses.dataclass
class _Entry:
    inputs: List[Tensor]                     # static input buffers
    outputs: Optional[List[Tensor]] = None   # static output buffers (graph)
    graph: Optional[Any] = None              # its torch.cuda.CUDAGraph
    deltas: List[int] = dataclasses.field(default_factory=list)

    def replay(self) -> tuple:
        """Replay the graph and count the launches it holds."""
        self.graph.replay()
        for f, d in zip(launch_counters(), self.deltas):
            f.launches += d
        return tuple(self.outputs)


class StepGraphs:
    """One engine's step callables by name, each created once and counted
    in ``counts`` as the reference's ``counting_jit`` counts a trace, so
    ``counts`` is the number of distinct step programs a drain built.

    A call names its entry, the step function and the inputs it reads:
    host arrays, or tensors on either side (a training batch on the card,
    a step's host scalars). The inputs land in the entry's static input
    buffers (made at its first call), and the function reads them and the
    caller's persistent tensors (state, cache, parameters) and returns its
    output tensors.

    - ``capture=False`` (the CPU, or a CUDA engine with graphs off): every
      call runs the function eagerly on the static buffers.
    - ``capture=True`` (CUDA): the first call of a name runs the function
      eagerly (its warm-up, whose results are the call's: kernel builds,
      attribute and occupancy queries happen here), then captures it into a
      ``torch.cuda.CUDAGraph`` whose outputs are copied into static output
      buffers; every later call copies its inputs in and replays. All of
      an engine's warm-ups and graphs run on one stream and share one
      memory pool, so temporaries are held once, not once per graph. Each
      replay adds to the kernel wrappers' ``launches`` what the capture
      recorded. A capture that fails raises; nothing falls back to eager.
      ``generators`` (CUDA ``torch.Generator``s the steps draw from) are
      registered with every graph, so each replay advances their Philox
      offsets as an eager call would.

    With a ``tracer`` (obs/trace), each build of an entry emits one
    ``compile[<name>]`` span on the compile track, as the reference's
    ``counting_jit`` does for a trace: on the card it covers the eager
    warm-up and the capture, on the CPU the entry's first call. A replay,
    or a later eager call, emits nothing.
    """

    def __init__(self, device, capture: bool, generators: tuple = (),
                 tracer=None):
        self.device = torch.device(device)
        self.tracer = tracer or NOOP
        if capture and self.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA engine; a CPU engine "
                             "runs its steps eagerly")
        if capture and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.capture = capture
        self.generators = tuple(generators)
        self.counts: Dict[str, int] = {}
        self.warm_s: Dict[str, float] = {}     # each graph's eager warm-up
        self.capture_s: Dict[str, float] = {}  # and its capture
        self._entries: Dict[str, _Entry] = {}
        if capture:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.MemPool()

    def call(self, name: str, fn: Callable[..., tuple], *host) -> tuple:
        entry = self._entries.get(name)
        if not self.capture:
            if entry is not None:
                self._load(entry, host)
                return tuple(fn(*entry.inputs))
            t0 = self.tracer.now()
            entry = self._entries[name] = _Entry(self._buffers(host))
            self.counts[name] = 1
            out = tuple(fn(*entry.inputs))
            self._built(name, t0)
            return out
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            if entry is None:
                t0 = self.tracer.now()
                out = self._create(name, fn, host)
                self._built(name, t0)
            else:
                self._load(entry, host)
                out = entry.replay()
        cur.wait_stream(self._stream)
        return out

    def _built(self, name: str, t0: float) -> None:
        self.tracer.complete(f"compile[{name}]", t0, cat="jit",
                             tid=TID_COMPILE, callable=name)

    def _buffers(self, host) -> List[Tensor]:
        return [torch.empty(a.shape, dtype=a.dtype, device=self.device
                            ).copy_(a) if isinstance(a, Tensor)
                else torch.tensor(np.asarray(a), device=self.device)
                for a in host]

    @staticmethod
    def _load(entry: _Entry, host) -> None:
        for buf, a in zip(entry.inputs, host):
            buf.copy_(a if isinstance(a, Tensor)
                      else torch.from_numpy(np.asarray(a)))

    def _create(self, name: str, fn, host) -> tuple:
        entry = _Entry(self._buffers(host))
        t0 = time.monotonic()
        # Memory the allocator keeps cached for eager work cannot serve the
        # graph pool: hand it back before the warm-up allocates there.
        torch.cuda.empty_cache()
        with torch.cuda.use_mem_pool(self._pool, self.device):
            warm = tuple(fn(*entry.inputs))
        entry.outputs = [t.clone() for t in warm]
        del warm
        torch.cuda.synchronize(self.device)
        self.warm_s[name] = time.monotonic() - t0
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        t0 = time.monotonic()
        with launches_set_aside(entry.deltas), torch.cuda.graph(
                graph, pool=self._pool.id, stream=self._stream):
            for buf, t in zip(entry.outputs, fn(*entry.inputs)):
                buf.copy_(t)
        self.capture_s[name] = time.monotonic() - t0
        entry.graph = graph
        self._entries[name] = entry
        self.counts[name] = 1
        return tuple(entry.outputs)
