"""Process-wide metrics registry: counters, gauges, histograms, probes.

Before this module the repo's counters were scattered, each with its
own spelling: ``planner.subset_cache_info()``,
``planner.plan_cache_info()["replans"]``, the (previously uncounted)
``decode_check_matrix`` memo, ad-hoc fields inside benchmark reports.
The registry absorbs them behind one ``snapshot()`` API without
deprecating anything — the legacy functions keep working and the
registry *delegates* to them through probes (callables evaluated at
snapshot time), so there is exactly one source of truth per counter.

Three owned instrument kinds plus probes:

* ``Counter``   — monotonically increasing int (``inc``),
* ``Gauge``     — last-write-wins float (``set``),
* ``Histogram`` — bounded reservoir of observations with
                  count/mean/p50/p95/max summary (the reservoir keeps
                  the most recent ``maxlen`` values),
* probes        — named zero-arg callables merged into the snapshot
                  under ``"probes"``; registration replaces (latest
                  wins) and a raising probe reports its error string
                  instead of breaking the snapshot.

Everything is thread-safe and cheap enough to leave on
unconditionally: an ``inc()`` is a dict lookup plus an int add.  The
module-level :data:`REGISTRY` is what the instrumented modules use;
``snapshot()`` is JSON-serializable by construction.

A copy of the JAX package's ``repro.obs.metrics`` (plain Python and numpy),
kept here so that the port imports nothing of that package.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict

import numpy as np

HISTOGRAM_MAXLEN = 4096


class Counter:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    __slots__ = ("_values", "_count", "_lock")

    def __init__(self, maxlen: int = HISTOGRAM_MAXLEN):
        self._values: deque = deque(maxlen=maxlen)
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._values.append(float(v))
            self._count += 1

    def summary(self) -> dict:
        """count/mean/p50/p95/max over the retained reservoir; an empty
        histogram reports zeros (defined, never a division error)."""
        with self._lock:
            vals = list(self._values)
            count = self._count
        if not vals:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "max": 0.0}
        arr = np.asarray(vals)
        return {
            "count": count,
            "mean": float(arr.mean()),
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "max": float(arr.max()),
        }


class MetricsRegistry:
    """Name -> instrument store with get-or-create accessors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._probes: Dict[str, Callable[[], dict]] = {}

    # -- accessors (get-or-create) -------------------------------------
    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def _get(self, store: dict, name: str, factory):
        inst = store.get(name)
        if inst is None:
            with self._lock:
                inst = store.setdefault(name, factory())
        return inst

    # -- probes --------------------------------------------------------
    def register_probe(self, name: str, fn: Callable[[], dict]) -> None:
        """Delegate a snapshot section to ``fn`` (latest wins)."""
        with self._lock:
            self._probes[name] = fn

    # -- snapshot / reset ----------------------------------------------
    def snapshot(self) -> dict:
        """One JSON-ready view of every instrument and probe."""
        out = {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(self._histograms.items())
            },
            "probes": {},
        }
        for name, fn in sorted(self._probes.items()):
            try:
                out["probes"][name] = fn()
            except Exception as exc:  # a broken probe must not kill the snapshot
                out["probes"][name] = {"error": f"{type(exc).__name__}: {exc}"}
        return out

    def reset(self) -> None:
        """Drop owned instruments (probes — delegated state — stay)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


def snapshot() -> dict:
    return REGISTRY.snapshot()


# ----------------------------------------------------------------------
# default probes: the three legacy cache-stat spellings, delegated.
# Imports are deferred to probe-call time so repro_torch.obs stays importable
# from inside repro_torch.core (the planner imports the tracer).
# ----------------------------------------------------------------------
def _plan_cache_probe() -> dict:
    from ..core.planner import plan_cache_info

    return plan_cache_info()


def _subset_cache_probe() -> dict:
    from ..core.planner import subset_cache_info

    return subset_cache_info()


def _decode_check_cache_probe() -> dict:
    from ..core.planner import decode_check_cache_info

    return decode_check_cache_info()


REGISTRY.register_probe("plan_cache", _plan_cache_probe)
REGISTRY.register_probe("subset_cache", _subset_cache_probe)
REGISTRY.register_probe("decode_check_cache", _decode_check_cache_probe)
