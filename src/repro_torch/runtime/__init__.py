"""Edge worker-pool runtime of the port: straggler-aware protocol execution.

The counterpart of ``repro.runtime``, with the same modules and exports:

* ``pool``      — latency models (deterministic / shifted-exponential /
                   heavy-tail), link models and fault injection,
                   sampled into replayable per-worker traces (copy),
* ``scheduler`` — the event loop: dispatch shares, pick the fastest
                   ``n_workers`` for Phase 2, decode from the fastest
                   responders with verification (``"detect"``) or one
                   Berlekamp-Welch decode (``"correct"``);
                   ``run_over_pool`` per product, ``run_batch_over_pool``
                   for a batch through one trace,
* ``metrics``   — per-run timeline, communication and decode-subset
                   statistics, aggregation and pool estimation (copy),
* ``pipeline``  — ``PipelineSession`` / ``run_pipeline_over_pool``: K
                   batched replays in flight with overlapping traces,
* ``autoplan``  — ``AutoPlanner`` and ``run_adaptive_over_pool``: the
                   construction chosen per replay from observed runs.

The event loop, the decode search and every draw from the ``numpy`` rng
are the reference's, so a given trace and seed give the reference's
timelines, subsets and metrics exactly.  The data plane (shares, worker
multiply, degree reduction) runs on the device, by default the GPU, and
every GF(p) product goes through the kernels.  With ``mesh=`` a batched
replay's Phase 2 is the sharded exchange (``core.distributed``): one
``torch.distributed`` collective over the mesh's ranks.
"""
from .pool import (  # noqa: F401
    AsymmetricLinks,
    ClusteredEdge,
    Deterministic,
    ElasticPool,
    FaultSpec,
    HeavyTail,
    LatencyModel,
    NetworkModel,
    ShiftedExponential,
    TimeVaryingLinks,
    UniformLinks,
    WorkerTrace,
    sample_trace,
)
from .scheduler import (  # noqa: F401
    DEFAULT_SUBSET_TRIES,
    BatchEdgeRun,
    DecodeFailure,
    EdgeRun,
    HybridState,
    run_batch_over_pool,
    run_over_pool,
)
from .metrics import (  # noqa: F401
    ObservedRun,
    PipelineMetrics,
    PoolEstimate,
    RunMetrics,
    estimate_pool,
    fit_order_stats,
    observed_run,
    order_stat_mean,
    summarize,
)
from .pipeline import (  # noqa: F401
    PipelineReplay,
    PipelineRun,
    PipelineSession,
    run_pipeline_over_pool,
)
from .autoplan import (  # noqa: F401
    AdaptiveRun,
    AutoPlanner,
    PlanDecision,
    plan_for_decision,
    run_adaptive_over_pool,
)
