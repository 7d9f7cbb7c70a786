"""Private-inference serving tier: request -> batch -> protocol.

The one-off demos ran a secure matmul per call; this package turns the
batched protocol + edge runtime into a *serving engine* for many
concurrent users:

* ``request`` — the :class:`Request` lifecycle (queued -> admitted ->
  done, or shed) on the simulated clock, and the :class:`EngineReport`
  the load benchmark publishes (throughput, latency percentiles, SLO
  census),
* ``engine``  — :class:`ServingEngine`: a request queue feeding a
  continuous batcher that appends replays to an in-flight
  ``runtime.PipelineSession`` (no batch boundaries), with
  ``PoolEstimate``-driven admission control (shed hopeless deadlines,
  defer when pool-health estimates disagree), hybrid Byzantine decode,
  elastic-pool reconfiguration barriers, and live ``AutoPlanner``
  feeding.

Everything downstream of ``submit()`` is deterministic per seed —
arrivals, traces, admission, and every published percentile.

The counterpart of ``repro.serve``, with the same modules and exports;
the replays run on the device (default: the GPU) through the port's
kernels.
"""
from .engine import ServingEngine  # noqa: F401
from .request import (  # noqa: F401
    ADMITTED,
    DONE,
    QUEUED,
    SHED,
    EngineReport,
    Request,
)
