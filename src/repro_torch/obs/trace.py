"""Low-overhead span tracer (port of ``repro.obs.trace``, DESIGN.md §11).

Design constraints, in order:

- **Disabled must be ~free.** Instrumented code holds a tracer attribute
  that is either a real `Tracer` or the shared `NOOP` singleton; the hot
  path pays one attribute check (``tracer.enabled``) or one no-op context
  manager — no allocation, no clock read, no branching on config.
- **Bounded.** Finished events land in a ring buffer (``capacity``
  events); overflow drops the OLDEST events and counts them in
  ``dropped`` so exporters can refuse to certify a truncated timeline
  (the pJ-sum validation in `obs.export.validate_trace` requires
  ``dropped == 0``).
- **Deterministic tests.** The clock is injectable (any zero-arg callable
  returning float seconds); production default is ``time.perf_counter``.
- **Host wall-clock only.** A span measures the host-side interval
  between enter and exit. CUDA launches are asynchronous: a span around
  a step's graph replay (or its eager launches) measures the *launch*
  (plus any blocking the call does), not device-side kernel time — the
  documented §11 non-goal. The step's single device->host copy is where
  device time surfaces, as the ``host_transfer`` span.

Events are Chrome trace-event shaped (`phase` "X" complete span, "i"
instant, "C" counter) so `obs.export.write_chrome_trace` is a direct
serialization; span ``args`` may be mutated after close (the engine
attaches the twin's attributed pJ to the decode span only after the
host transfer books it) — export reads whatever the args hold then.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Optional


class Span:
    """One event record. Phase "X" spans are open until ``close`` stamps
    ``t1``; instants/counters are born closed. ``args`` is the Perfetto
    args payload — mutable until export via `set()`."""

    __slots__ = ("name", "cat", "tid", "phase", "t0", "t1", "args", "_tr")

    def __init__(self, name: str, cat: str, tid: int, phase: str,
                 t0: float, args: Dict, tracer: Optional["Tracer"] = None):
        self.name = name
        self.cat = cat
        self.tid = tid
        self.phase = phase
        self.t0 = t0
        self.t1 = t0
        self.args = args
        self._tr = tracer

    def set(self, **kw) -> "Span":
        """Attach/overwrite args (e.g. the attributed pJ booked after the
        span closed)."""
        self.args.update(kw)
        return self

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    # -- context manager: close on ANY exit, including exceptions --------
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tr._close(self)
        return False


class _NoopSpan:
    """Shared do-nothing span: context-manager + `set()` compatible, so
    instrumented code needs no disabled-path branches."""

    __slots__ = ()
    name = cat = ""
    t0 = t1 = dur = 0.0
    args: Dict = {}

    def set(self, **kw) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """Disabled tracer: every method is a constant-time no-op returning
    the shared `NOOP_SPAN`. Instrumented code keeps a single code path;
    ``enabled`` is the one attribute the hot path may check to skip
    building args dicts."""

    enabled = False
    events: deque = deque()
    dropped = 0

    def now(self) -> float:
        return 0.0

    def span(self, name, cat="", tid=0, **args):
        return NOOP_SPAN

    def complete(self, name, t0, cat="", tid=0, **args):
        return NOOP_SPAN

    def instant(self, name, cat="", tid=0, **args):
        return NOOP_SPAN

    def counter(self, name, value, tid=0):
        return NOOP_SPAN


NOOP = NoopTracer()


class Tracer:
    """Span tracer with a bounded ring buffer of finished events.

    ``capacity`` bounds memory (oldest events drop first, counted in
    ``dropped``); ``clock`` is any zero-arg float-seconds callable.
    ``open_spans`` tracks enter/exit balance — it must return to zero
    after any drain, exceptions included (tests pin this).
    """

    enabled = True

    def __init__(self, capacity: int = 1 << 16,
                 clock: Optional[Callable[[], float]] = None):
        assert capacity > 0
        self.capacity = capacity
        self.clock = clock or time.perf_counter
        self.events: deque = deque()
        self.dropped = 0
        self.open_spans = 0
        # tid -> display name for the Perfetto thread tracks.
        self.thread_names: Dict[int, str] = dict(THREADS)

    def now(self) -> float:
        return self.clock()

    # -- event constructors ------------------------------------------------
    def span(self, name: str, cat: str = "", tid: int = 0, **args) -> Span:
        """Open a span; close it with the context-manager protocol (the
        only way — `with tracer.span(...) as sp:` closes on exceptions
        too) or let `complete()` build pre-closed ones."""
        self.open_spans += 1
        return Span(name, cat, tid, "X", self.clock(), args, self)

    def complete(self, name: str, t0: float, cat: str = "", tid: int = 0,
                 **args) -> Span:
        """Record an already-finished span from an explicit start time
        (e.g. a step program's build, detected only after the call
        returned)."""
        sp = Span(name, cat, tid, "X", t0, args, self)
        sp.t1 = self.clock()
        self._push(sp)
        return sp

    def instant(self, name: str, cat: str = "", tid: int = 0, **args) -> Span:
        sp = Span(name, cat, tid, "i", self.clock(), args, self)
        self._push(sp)
        return sp

    def counter(self, name: str, value: float, tid: int = 0) -> Span:
        """One sample of a cumulative counter track (Perfetto renders the
        series — the pJ-over-time view rides this)."""
        sp = Span(name, "", tid, "C", self.clock(), {"value": float(value)},
                  self)
        self._push(sp)
        return sp

    # -- ring buffer -------------------------------------------------------
    def _close(self, sp: Span) -> None:
        sp.t1 = self.clock()
        self.open_spans -= 1
        self._push(sp)

    def _push(self, sp: Span) -> None:
        if len(self.events) >= self.capacity:
            self.events.popleft()
            self.dropped += 1
        self.events.append(sp)


# Default thread-track layout: one Perfetto track per subsystem.
TID_SERVE = 0
TID_TRAIN = 1
TID_COMPILE = 2
TID_HEALTH = 3
THREADS = {TID_SERVE: "serve", TID_TRAIN: "train", TID_COMPILE: "jit",
           TID_HEALTH: "health"}
