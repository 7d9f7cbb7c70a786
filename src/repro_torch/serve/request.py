"""Request model and load report for the private-inference serving tier.

A copy of ``repro.serve.request`` (numpy only).

A :class:`Request` is one user's secure-matmul demand: activation rows
``x`` against the engine's private weight matrix, stamped with a
simulated arrival time and an optional absolute deadline (its SLO).
The engine moves it through a small lifecycle::

    queued ──admit──> admitted ──decode──> done
       └────shed────> shed            (deadline hopeless / pool unfit)

All timestamps live on the *simulated* clock of the replayed worker
traces — the same clock the runtime's event loop and the tracer's sim
spans use — so deadline accounting is exact and deterministic per
seed.  :class:`EngineReport` aggregates a finished run into the
numbers the serving benchmark publishes: sustained throughput and
latency percentiles, plus the SLO/admission census.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

#: Request lifecycle states.
QUEUED = "queued"
ADMITTED = "admitted"
DONE = "done"
SHED = "shed"


@dataclasses.dataclass
class Request:
    """One secure-matmul request against the engine's weight matrix."""

    rid: int
    x: np.ndarray  # [rows, k] activation rows (source-1 operand)
    arrival: float  # simulated submission time
    deadline: Optional[float]  # absolute SLO deadline, None = best-effort
    state: str = QUEUED
    launch: float = math.nan  # Phase-1 upload start of the serving replay
    completion: float = math.nan  # decode acceptance (absolute)
    replay: int = -1  # session replay index that served it
    shed_reason: Optional[str] = None
    y: Optional[np.ndarray] = None  # [rows, out] decoded activations

    @property
    def latency(self) -> float:
        """Arrival-to-decode latency (nan unless served)."""
        return self.completion - self.arrival

    @property
    def queue_wait(self) -> float:
        """Arrival-to-launch wait (nan unless launched)."""
        return self.launch - self.arrival

    @property
    def met_deadline(self) -> bool:
        """Served and inside its SLO (best-effort requests always
        count as met once served; shed requests never do)."""
        if self.state != DONE:
            return False
        if self.deadline is None:
            return True
        return bool(self.completion <= self.deadline + 1e-9)


@dataclasses.dataclass
class EngineReport:
    """Aggregate outcome of one :meth:`ServingEngine.run`."""

    requests: List[Request]
    replays: int  # protocol replays launched
    makespan: float  # first arrival -> last decode acceptance

    @property
    def served(self) -> List[Request]:
        return [r for r in self.requests if r.state == DONE]

    @property
    def shed(self) -> List[Request]:
        return [r for r in self.requests if r.state == SHED]

    @property
    def deadline_misses(self) -> int:
        """Served requests that blew their SLO (shed counts separately)."""
        return sum(1 for r in self.served if not r.met_deadline)

    @property
    def latencies(self) -> np.ndarray:
        return np.array([r.latency for r in self.served])

    @property
    def throughput(self) -> float:
        """Served requests per unit simulated time over the makespan."""
        if self.makespan <= 0:
            return 0.0
        return len(self.served) / self.makespan

    def percentile(self, q: float) -> float:
        lat = self.latencies
        return float(np.percentile(lat, q)) if lat.size else math.nan

    def summary(self) -> dict:
        """The benchmark-facing scalar view (BENCH_serve.json leaves)."""
        return {
            "requests": len(self.requests),
            "served": len(self.served),
            "shed": len(self.shed),
            "deadline_misses": self.deadline_misses,
            "replays": self.replays,
            "makespan": round(self.makespan, 9),
            "throughput": round(self.throughput, 9),
            "p50_latency": round(self.percentile(50), 9),
            "p95_latency": round(self.percentile(95), 9),
            "p99_latency": round(self.percentile(99), 9),
        }
