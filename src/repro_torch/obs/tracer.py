"""Span-based tracer with two clocks: wall time and the simulated
event-loop clock.

The repo's signals live on two different time axes.  Kernel launches,
plan builds, and protocol phases happen in *wall* time; the edge
scheduler's replays happen on the *simulated* clock of
``runtime.scheduler._replay_events`` (share arrivals, the Phase-2
barrier, response arrivals, decode acceptance).  One ``Tracer`` records
both, tagging every event with its clock, so the exporter
(``repro.obs.export``) can render a replay as a flame chart of
workers x phases on one track while real wall-clock spans land on a
separate track.

Design constraints, in order:

1. **Off by default, near-zero overhead when disabled.**  Every
   recording entry point starts with one ``self.enabled`` check;
   ``span()`` returns a module-level singleton no-op context manager
   when disabled, so the instrumented hot path allocates *nothing* —
   no span objects, no dicts, no ids (regression-tested).
2. **Zero dependencies.**  ``threading`` + ``time`` + ``itertools``.
3. **Deterministic simulated events.**  Sim-clock records carry only
   caller-provided timestamps and attributes, so two byte-identical
   replays produce byte-identical sim-track traces (the wall track is
   inherently machine-dependent and is kept separable).

Record shape (a plain dict per event, see ``Tracer.events``):

``kind``    ``"span"`` | ``"instant"``
``clock``   ``"wall"`` | ``"sim"``
``name``    span/event name (taxonomy in ``docs/observability.md``)
``id``      unique int (> 0) per record
``parent``  enclosing wall-span id (0 at top level; sim records may
            link to anything via attrs instead)
``track``   wall: thread id; sim: a ``(lane, index)`` tuple such as
            ``("worker", 3)`` or ``("replay", 0)``
``t0, t1``  spans: start/end on the record's clock (wall: seconds from
            ``time.perf_counter``; sim: the caller's simulated units)
``t``       instants: the single timestamp
``attrs``   caller attributes (JSON-serializable values expected)

A copy of the JAX package's ``repro.obs.tracer`` (plain Python and numpy),
kept here so that the port imports nothing of that package.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# Hard cap on buffered events: a runaway loop with tracing enabled
# degrades to dropped events (counted) instead of unbounded memory.
MAX_EVENTS_DEFAULT = 1_000_000

SimTrack = Tuple[str, int]


class _DisabledSpan:
    """Singleton no-op returned by ``span()`` while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_DisabledSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_DisabledSpan":
        return self

    @property
    def id(self) -> int:
        return 0


_DISABLED_SPAN = _DisabledSpan()


class Span:
    """A live wall-clock span; use as a context manager.

    The record is appended on ``__exit__`` (so the event list is
    completion-ordered, like Chrome ``"X"`` events).  ``set()`` adds
    attributes mid-flight.
    """

    __slots__ = ("_tracer", "name", "attrs", "id", "parent", "t0", "_track")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.id = tracer._next_id()
        self.parent = 0
        self.t0 = 0.0
        self._track = 0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        self._track = threading.get_ident()
        self.t0 = tr._clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        t1 = tr._clock()
        stack = tr._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        tr._record(
            {
                "kind": "span",
                "clock": "wall",
                "name": self.name,
                "id": self.id,
                "parent": self.parent,
                "track": self._track,
                "t0": self.t0,
                "t1": t1,
                "attrs": self.attrs,
            }
        )
        return False


class Tracer:
    """Thread-safe two-clock event recorder (module docstring)."""

    def __init__(self, max_events: int = MAX_EVENTS_DEFAULT, clock=time.perf_counter):
        self.enabled = False
        self.max_events = int(max_events)
        self._clock = clock
        self._events: List[dict] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    # -- lifecycle -----------------------------------------------------
    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> "Tracer":
        with self._lock:
            self._events = []
            self._dropped = 0
            self._ids = itertools.count(1)
        return self

    @property
    def events(self) -> List[dict]:
        """Snapshot of the recorded events (copy; safe to mutate)."""
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped

    def sim_events(self) -> List[dict]:
        """Only the simulated-clock records — the deterministic track."""
        return [e for e in self.events if e["clock"] == "sim"]

    # -- recording -----------------------------------------------------
    def span(self, name: str, **attrs):
        """Wall-clock span context manager; a shared no-op when disabled."""
        if not self.enabled:
            return _DISABLED_SPAN
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> int:
        """Wall-clock instant; returns the event id (0 when disabled)."""
        if not self.enabled:
            return 0
        stack = self._stack()
        eid = self._next_id()
        self._record(
            {
                "kind": "instant",
                "clock": "wall",
                "name": name,
                "id": eid,
                "parent": stack[-1] if stack else 0,
                "track": threading.get_ident(),
                "t": self._clock(),
                "attrs": attrs,
            }
        )
        return eid

    def sim_span(
        self,
        name: str,
        t0: float,
        t1: float,
        track: SimTrack = ("sim", 0),
        **attrs,
    ) -> int:
        """Record a completed span on the simulated clock.

        ``track`` names the flame-chart lane, e.g. ``("worker", 3)`` or
        ``("replay", 0)``.  Returns the record id (0 when disabled).
        """
        if not self.enabled:
            return 0
        eid = self._next_id()
        self._record(
            {
                "kind": "span",
                "clock": "sim",
                "name": name,
                "id": eid,
                "parent": 0,
                "track": (str(track[0]), int(track[1])),
                "t0": float(t0),
                "t1": float(t1),
                "attrs": attrs,
            }
        )
        return eid

    def sim_event(
        self, name: str, t: float, track: SimTrack = ("sim", 0), **attrs
    ) -> int:
        """Instant on the simulated clock; returns id (0 when disabled)."""
        if not self.enabled:
            return 0
        eid = self._next_id()
        self._record(
            {
                "kind": "instant",
                "clock": "sim",
                "name": name,
                "id": eid,
                "parent": 0,
                "track": (str(track[0]), int(track[1])),
                "t": float(t),
                "attrs": attrs,
            }
        )
        return eid

    # -- internals -----------------------------------------------------
    def _next_id(self) -> int:
        return next(self._ids)

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _record(self, rec: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            self._events.append(rec)


# The process-wide default tracer every instrumented module consults.
TRACER = Tracer()


def get_tracer() -> Tracer:
    return TRACER


def enable() -> Tracer:
    return TRACER.enable()


def disable() -> Tracer:
    return TRACER.disable()
