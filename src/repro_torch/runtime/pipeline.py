"""Pipelined batched replays: K protocol executions in flight at once.

``run_batch_over_pool`` amortizes the event loop across a *batch* of
products, but successive batches still run back-to-back: replay k+1's
Phase-1 upload waits for replay k's decode, even though the master's
links and the workers sit idle for most of that span.  This module
overlaps them — the ROADMAP's "pipelining many batched replays with
overlapping traces" item, and its Phase-1/Phase-2 overlap rule is the
"overlapping Phase-1 transfers with Phase-2 compute" item.

Pipeline timing model (two serial resources, everything else overlaps):

* **master -> worker link**: replay k's share to worker ``w`` starts
  the moment replay k-1's share to ``w`` has *arrived* (store-and-
  forward per link; links to different workers are independent), so
  ``arrive[k, w] = sum_{j <= k} share_delay_j(w)``,
* **worker compute**: worker ``w`` starts replay k's H(alpha_n) at
  ``max(arrive[k, w], finish[k-1, w])`` — one multiply at a time;
  dropped workers never compute, so they release the worker
  immediately.  A worker *abandons* replay k's compute the moment
  replay k's Phase-2 set is announced without it: its H(alpha_n) can
  no longer enter the exchange, so queueing it further would only
  starve replay k+1 (without cancellation a straggler's stale compute
  compounds across replays and pipelining can lose to back-to-back
  execution).

Phases 2 and 3 of each replay proceed independently through the shared
event loop (``scheduler._replay_events``) with these absolute times
injected: each in-flight replay fixes its own fastest-``n_workers``
Phase-2 set, runs its own (link-aware) exchange, and decodes from its
own fastest responder subset — the fastest-subset/decode-subset
machinery is reused per replay, per-replay traces may differ (that is
what "overlapping traces" means), and faults are per-(replay, worker).

The upshot: replay k+1's Phase-1 transfers overlap replay k's Phase-2
compute whenever ``share_delay`` < completion span, which is exactly
the edge regime (fast links, slow/heterogeneous compute).  Aggregate
accounting lands in :class:`~repro.runtime.metrics.PipelineMetrics`
(makespan, per-replay spans, pipeline occupancy, Phase-1 overlap, and
the summed communication ``Trace``).

Two entry points share one implementation:

* :class:`PipelineSession` — the stateful core: replays are *appended*
  one at a time against the live link/compute occupancy, so a caller
  (the serving engine) can decide replay k+1's contents *after* seeing
  replay k's outcome, inject request-arrival floors (``not_before``),
  and stop whenever its queue drains.  Nothing about the pipeline is
  fixed up front — not the depth, not the batch sizes, not even the
  construction (per-append planner decisions).
* :func:`run_pipeline_over_pool` — the fixed-K convenience wrapper:
  prepares a ``[K, batch, k, m]`` operand stack and appends each slice
  back-to-back.  Replays byte-identically to the pre-session
  implementation (same rng streams, same timestamps).

The counterpart of ``repro.runtime.pipeline``: the timing model, the
rng lanes and the event loop are the reference's; each replay's shares
and Phase 2 run on the device (default: the GPU) through the batched
engine, with the share key ``gf.fold_in(gf.prng_key(seed), k)`` as the
reference folds its JAX key.  ``mesh=`` (the sharded Phase-2 exchange)
is not ported yet and raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import gf
from ..core import protocol as proto
from ..core.planner import CMPCPlan
from ..obs.metrics import REGISTRY
from .metrics import PipelineMetrics, RunMetrics
from .pool import WorkerTrace
from .scheduler import (
    DEFAULT_SUBSET_TRIES,
    HybridState,
    _batched_compute_closure,
    _build_metrics,
    _check_pool,
    _refuse_mesh,
    _replay_events,
    _resolve_decode_mode,
    _resolve_error_budget,
    _resolve_hybrid,
    _resolve_verify_extras,
    _unfold_batched_y,
)


@dataclasses.dataclass
class PipelineRun:
    """Result of K pipelined batched replays.

    ``y[k]`` is replay k's decoded batch; ``replay_metrics[k]`` its
    :class:`RunMetrics` on the absolute pipeline clock (batch-level
    aggregate accounting, like ``BatchEdgeRun.metrics``); ``metrics``
    the cross-replay :class:`PipelineMetrics`.
    """

    y: np.ndarray  # [K, batch, ma, mb]
    replay_metrics: List[RunMetrics]
    metrics: PipelineMetrics


def _as_stack(x):
    """An operand stack as given: a tensor stays a tensor (on its
    device), anything else becomes a numpy array."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _prep_pipeline_operands(plan, a, b, depth: int):
    """Promote operands to [K, batch, k, m]; validate against the plan
    when one is fixed up front (auto-planned pipelines pick per-replay
    plans whose block splits differ, but the global dims still bind)."""
    a = _as_stack(a)
    b = _as_stack(b)
    if a.ndim == 3:  # [K, k, m] -> batch-1 replays
        a = a[:, None]
    if b.ndim == 3:
        b = b[:, None]
    if a.ndim != 4 or b.ndim != 4:
        raise ValueError(
            f"expected [K, batch, k, m] operand stacks, got {a.shape} {b.shape}"
        )
    if a.shape[0] != depth or b.shape[0] != depth:
        raise ValueError(
            f"{depth} traces but operand stacks of depth {a.shape[0]} / "
            f"{b.shape[0]}"
        )
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"batch mismatch: {a.shape[1]} vs {b.shape[1]}")
    if a.shape[2] != b.shape[2]:
        raise ValueError(f"inner-dim mismatch: {a.shape[2]} vs {b.shape[2]}")
    if plan is not None:
        sh = plan.shapes
        if tuple(a.shape[2:]) != (sh.k, sh.ma) or tuple(b.shape[2:]) != (sh.k, sh.mb):
            raise ValueError(
                f"operands {a.shape[2:]}/{b.shape[2:]} disagree with plan "
                f"shapes ({sh.k}, {sh.ma})/({sh.k}, {sh.mb})"
            )
    return a, b


@dataclasses.dataclass
class PipelineReplay:
    """One appended replay's outcome on the session's absolute clock."""

    index: int  # session replay index (rng lane)
    y: np.ndarray  # [batch, ma, mb], on the host
    metrics: RunMetrics
    start: float  # first Phase-1 send (absolute)
    completion: float  # decode acceptance (absolute)
    batch: int
    decision: Optional[object] = None  # PlanDecision when planner-driven


class PipelineSession:
    """Stateful pipelined replays: append batched replays mid-flight.

    Holds the two serial resources of the pipeline timing model — the
    per-worker master-link occupancy (``upload_free``) and per-worker
    compute occupancy (``worker_free``) — across an *open-ended*
    sequence of :meth:`append` calls.  Each append replays one batch
    through the shared event loop at absolute times derived from the
    live occupancy, exactly as one iteration of the fixed-K pipeline;
    between appends the caller is free to look at results, consult a
    queue, or change the batch size — that is what lets the serving
    engine admit requests into an in-flight pipeline instead of
    waiting for a batch boundary.

    ``not_before`` on an append floors the replay's upload start (a
    request that arrives at t cannot be shared before t); with the
    default 0.0 and ``base_time=0.0`` the session replays
    byte-identically to the historical fixed-K loop — same rng streams
    (``default_rng([seed, k])`` / folded JAX key, ``k`` the session
    replay counter), same timestamps.

    ``base_time`` starts the clock late: a session rebuilt after a pool
    reconfiguration continues on the absolute clock of its predecessor.

    ``decode_mode="hybrid"`` holds one :class:`HybridState` for the
    whole session (pass ``hybrid_state`` to share or pre-escalate it):
    the first rejected responder on any append escalates every later
    append to Berlekamp-Welch correction.

    Pool size is fixed by the first append (the serialized occupancy
    vectors assume a stable worker set); a pool resize needs a new
    session — see the serving engine's reconfiguration barrier.

    Every replay's data plane runs on ``device`` (default: the GPU);
    ``mesh`` raises ``NotImplementedError`` (not ported yet).
    """

    def __init__(
        self,
        plan: Optional[CMPCPlan] = None,
        *,
        seed: int = 0,
        verify_extras="auto",
        master_decode_cost: float = 0.0,
        mesh=None,
        axis: str = "workers",
        mode: str = "all_to_all",
        backend: str = "auto",
        planner=None,
        plan_seed: int = 0,
        compute_scale="auto",
        decode_mode: str = "detect",
        error_budget="auto",
        max_subset_tries: int = DEFAULT_SUBSET_TRIES,
        base_time: float = 0.0,
        hybrid_state: Optional[HybridState] = None,
        device=None,
    ):
        if plan is None and planner is None:
            raise ValueError("need a plan or a planner")
        _refuse_mesh(mesh)
        self.device = proto.resolve_device(device)
        self.plan = plan
        self.planner = planner
        self.seed = seed
        self.base_time = float(base_time)
        self._verify_extras = verify_extras
        self._master_decode_cost = master_decode_cost
        self._backend = backend
        self._plan_seed = plan_seed
        self._compute_scale = compute_scale
        self._decode_mode = decode_mode
        self._error_budget = error_budget
        self._max_subset_tries = max_subset_tries
        if hybrid_state is None and decode_mode == "hybrid":
            hybrid_state = HybridState()
        self.hybrid_state = hybrid_state
        self._key = gf.prng_key(seed)

        self._n: Optional[int] = None  # pool size, fixed at first append
        self._upload_free: Optional[np.ndarray] = None
        self._worker_free: Optional[np.ndarray] = None
        self._replays: List[PipelineReplay] = []
        self._agg_trace = None

    # -- introspection the batcher schedules against --------------------

    @property
    def depth(self) -> int:
        """Replays appended so far."""
        return len(self._replays)

    def next_start(self) -> float:
        """Earliest absolute time the next append's Phase 1 can begin
        (the soonest any master link frees up) — the continuous
        batcher's launch clock."""
        if self._upload_free is None:
            return self.base_time
        return float(self._upload_free.min())

    def busy_until(self) -> float:
        """Latest decode acceptance so far (``base_time`` when empty) —
        the batch-boundary launch clock."""
        if not self._replays:
            return self.base_time
        return max(r.completion for r in self._replays)

    def ready_at(self, pipe_depth: int = 1) -> float:
        """Earliest launch time keeping at most ``pipe_depth`` replays
        in flight (and the master uplink free).

        ``pipe_depth=1`` is the batch-boundary discipline — wait for
        every in-flight replay to decode.  ``pipe_depth>=2`` is
        continuous batching: the next replay's Phase-1 upload launches
        while the tail replay is still in its Phase-2/Phase-3 window,
        so requests overlap the in-flight batch instead of waiting for
        the pool to drain.
        """
        if pipe_depth < 1:
            raise ValueError(f"pipe_depth must be >= 1, got {pipe_depth}")
        t = self.next_start()
        if len(self._replays) >= pipe_depth:
            comps = sorted(r.completion for r in self._replays)
            t = max(t, comps[len(comps) - pipe_depth])
        return t

    # -- the core: one replay against the live occupancy ----------------

    def append(
        self,
        a: np.ndarray,
        b: np.ndarray,
        trace: WorkerTrace,
        *,
        not_before: float = 0.0,
        obs_attrs: Optional[dict] = None,
    ) -> PipelineReplay:
        """Replay one batch (a: [batch, k, ma], b: [batch, k, mb]; 2D
        promotes to batch 1) against ``trace`` at the live occupancy.

        ``not_before`` floors the upload start on every master link —
        the serving engine passes the launch time its admission loop
        chose (>= the admitted requests' arrivals).  Raises
        :class:`~repro.runtime.scheduler.DecodeFailure` exactly like
        the standalone entry points; a failed append leaves the
        occupancy state untouched (the replay never ran).
        """
        k = len(self._replays)
        if self.planner is None:
            decision = None
            plan_k = self.plan
            if trace.n != plan_k.n_total:
                raise ValueError(
                    f"trace {k} covers {trace.n} workers, plan provisions "
                    f"{plan_k.n_total}"
                )
        else:
            # Replay-boundary feedback: decide from everything observed
            # so far, re-fitting spares to the pool (same-construction
            # decisions hit the plan cache; spare refits take the
            # replan fast path).
            from .autoplan import plan_for_decision

            a_dims = _as_stack(a)
            b_dims = _as_stack(b)
            decision = self.planner.decide(trace.n)
            plan_k = plan_for_decision(
                decision,
                int(a_dims.shape[-2]),
                int(a_dims.shape[-1]),
                int(b_dims.shape[-1]),
                seed=self._plan_seed,
            )
        if self._n is None:
            self._n = trace.n
            self._upload_free = np.full(self._n, self.base_time)
            self._worker_free = np.full(self._n, self.base_time)
        elif trace.n != self._n:
            raise ValueError(
                f"pipelined replays need one pool size, got "
                f"{sorted({self._n, trace.n})}"
            )
        alive = _check_pool(plan_k, trace)
        extras_k = _resolve_verify_extras(self._verify_extras, trace)
        budget_k = _resolve_error_budget(self._error_budget, trace, plan_k)
        mode_k, budget_k, _ = _resolve_hybrid(
            self._decode_mode, self.hybrid_state, budget_k, plan_k
        )
        mode_k = _resolve_decode_mode(mode_k, budget_k)
        rng = np.random.default_rng([self.seed, k])
        if self._compute_scale == "auto":
            scale_k = (
                self.planner.work_factor(decision.config)
                if self.planner is not None
                else 1.0
            )
        else:
            scale_k = float(self._compute_scale)

        # -- pipeline timing: serialize the master links and compute --
        upload_base = np.maximum(self._upload_free, float(not_before))
        start = float(upload_base.min())
        arrive = upload_base + trace.share_delay
        comp_start = np.maximum(arrive, self._worker_free)
        finish = np.where(
            trace.dropout, comp_start, comp_start + scale_k * trace.compute_delay
        )
        # upload_free/worker_free commit only after the replay succeeds
        # (a DecodeFailure must not half-advance the occupancy).

        # -- numeric path: same batched engine as run_batch_over_pool --
        a_t, b_t = proto._prep_batched_operands(plan_k, a, b, self.device)
        batch = int(a_t.shape[0])
        fa, fb = proto.share_batched(
            plan_k, a_t, b_t, gf.fold_in(self._key, k),
            backend=self._backend, device=self.device,
        )
        compute_i_all = _batched_compute_closure(
            plan_k, fa, fb, rng, batch, self._backend
        )
        # Trace annotations: lane index + absolute start, plus the
        # deciding PlanDecision when a planner drives the pipeline
        # (decision_id links the replay span to its autoplan.decide
        # event).
        obs_k = {"replay": k, "t_start": start, "batch": batch}
        if decision is not None:
            obs_k["decision_id"] = decision.obs_id
            obs_k["config"] = decision.config.label()
        if obs_attrs:
            obs_k.update(obs_attrs)
        res = _replay_events(
            plan_k,
            trace,
            alive,
            compute_i_all,
            extras_k,
            rng,
            self._master_decode_cost,
            share_arrival=arrive,
            compute_finish=finish,
            decode_mode=mode_k,
            error_budget=budget_k,
            max_subset_tries=self._max_subset_tries,
            obs_attrs=obs_k,
        )
        self._upload_free = arrive.copy()
        # Straggler cancellation: a worker outside replay k's Phase-2
        # set abandons its (now useless) H-compute when the set is
        # announced, freeing it for replay k+1.  Set members finished
        # at or before the announcement, so they are unaffected.
        in_set = np.zeros(self._n, bool)
        in_set[res.phase2_ids] = True
        abandoned = ~in_set & ~trace.dropout
        self._worker_free = np.where(
            abandoned,
            np.minimum(finish, np.maximum(comp_start, res.phase2_set_time)),
            finish,
        )

        y = _unfold_batched_y(plan_k, res.coeffs, batch)
        m = _build_metrics(plan_k, trace, alive, res, batch=batch)
        if self.hybrid_state is not None:
            self.hybrid_state.note(m)
        if self.planner is not None:
            self.planner.observe(decision.config, m, start=start)
        self._agg_trace = (
            m.trace if self._agg_trace is None else self._agg_trace + m.trace
        )
        replay = PipelineReplay(
            index=k, y=y, metrics=m, start=start,
            completion=m.completion_time, batch=batch, decision=decision,
        )
        self._replays.append(replay)
        return replay

    # -- aggregation ----------------------------------------------------

    def result(self) -> PipelineRun:
        """Aggregate everything appended so far into a
        :class:`PipelineRun` (requires at least one replay; ``y`` is
        stacked only when every append used one batch size, else the
        per-replay ``replay_metrics``/session records are the API)."""
        if not self._replays:
            raise ValueError("need at least one trace/replay")
        depth = len(self._replays)
        starts = np.array([r.start for r in self._replays])
        completions = np.array([r.completion for r in self._replays])
        phase1_lasts = np.array(
            [r.metrics.phase1_last_share for r in self._replays]
        )
        batches = [r.batch for r in self._replays]
        makespan = float(completions.max())
        busy = makespan - self.base_time
        spans = completions - starts
        # Phase-1 upload time of replay k that ran while replay k-1 (or
        # any earlier one) was still in flight — the overlap the
        # sequential runtime forgoes entirely.
        prev_busy_until = np.concatenate(
            ([self.base_time], np.maximum.accumulate(completions)[:-1])
        )
        phase1_overlap = float(
            np.maximum(
                0.0, np.minimum(phase1_lasts, prev_busy_until) - starts
            ).sum()
        )
        metrics = PipelineMetrics(
            depth=depth,
            batch=max(batches),
            products=int(sum(batches)),
            makespan=makespan,
            completions=completions,
            starts=starts,
            occupancy=float(spans.sum() / busy) if busy > 0 else 0.0,
            phase1_overlap=phase1_overlap,
            trace=self._agg_trace,
        )
        REGISTRY.counter("pipeline.runs").inc()
        REGISTRY.gauge("pipeline.occupancy").set(metrics.occupancy)
        REGISTRY.gauge("pipeline.makespan").set(metrics.makespan)
        REGISTRY.gauge("pipeline.overlap_ratio").set(metrics.overlap_ratio)
        uniform = len(set(batches)) == 1
        y = (
            np.stack([r.y for r in self._replays])
            if uniform
            else np.concatenate([r.y for r in self._replays])
        )
        return PipelineRun(
            y=y,
            replay_metrics=[r.metrics for r in self._replays],
            metrics=metrics,
        )


def run_pipeline_over_pool(
    plan: Optional[CMPCPlan],
    a: np.ndarray,
    b: np.ndarray,
    traces: Sequence[WorkerTrace],
    seed: int = 0,
    verify_extras="auto",
    master_decode_cost: float = 0.0,
    mesh=None,
    axis: str = "workers",
    mode: str = "all_to_all",
    backend: str = "auto",
    planner=None,
    plan_seed: int = 0,
    compute_scale="auto",
    decode_mode: str = "detect",
    error_budget="auto",
    max_subset_tries: int = DEFAULT_SUBSET_TRIES,
    hybrid_state: Optional[HybridState] = None,
    device=None,
) -> PipelineRun:
    """Run K batched replays through the pool with overlapping traces.

    a: [K, batch, k, ma], b: [K, batch, k, mb] ([K, k, m] promotes to
    batch 1); ``traces`` holds one :class:`WorkerTrace` per replay
    (they may differ — each replay faces its own latency/fault/link
    draw).  Replay k+1's Phase-1 upload to each worker starts as soon
    as that master link is free, so transfers overlap earlier replays'
    Phase-2 compute; each replay then fixes its own Phase-2 subset and
    decode subset through the shared event loop.  Per-replay decode
    failures raise :class:`DecodeFailure` exactly like the standalone
    entry points.

    With ``planner`` (an :class:`~repro.runtime.autoplan.AutoPlanner`)
    the construction is chosen *per replay* at the pipeline's replay
    boundaries: the planner decides from everything observed so far,
    the chosen config is re-fitted to the (fixed-size) pool, and the
    replay's outcome feeds back before the next decision — mid-stream
    scheme/lambda/spare switching inside one pipeline.  ``plan`` may
    then be ``None``; pool size must be constant across traces (the
    pipeline's serialized master links and worker occupancy assume a
    stable worker set — elastic pools go through
    :func:`~repro.runtime.autoplan.run_adaptive_over_pool`).

    ``compute_scale``: per-unit-work compute scaling (see
    ``run_batch_over_pool``).  The default ``"auto"`` resolves to the
    planner's per-construction work factor when a planner is given
    (different constructions do different per-worker work on the same
    trace) and to 1.0 otherwise; pass a float to force one scale.

    ``decode_mode`` / ``error_budget`` / ``max_subset_tries``: the
    corruption-handling knobs of ``run_over_pool``, resolved *per
    replay* against each trace's configured fault model (replays in one
    pipeline may face differently-provisioned fault draws);
    ``decode_mode="hybrid"`` escalates to BW correction after the first
    rejected responder (``hybrid_state`` shares/pre-escalates the
    cross-replay state).

    Randomness: replay k draws from ``default_rng([seed, k])`` and the
    folded key ``gf.fold_in(gf.prng_key(seed), k)``, so replays are
    independent but the whole pipeline is reproducible per seed.

    Every replay runs on ``device`` (default: the GPU); ``mesh`` raises
    ``NotImplementedError`` (not ported yet).

    Returns :class:`PipelineRun` with per-replay results on one
    absolute clock plus the aggregate :class:`PipelineMetrics`.
    """
    _refuse_mesh(mesh)
    device = proto.resolve_device(device)
    depth = len(traces)
    if depth == 0:
        raise ValueError("need at least one trace/replay")
    if plan is None and planner is None:
        raise ValueError("need a plan or a planner")
    if planner is None:
        for k, trace in enumerate(traces):
            if trace.n != plan.n_total:
                raise ValueError(
                    f"trace {k} covers {trace.n} workers, plan provisions "
                    f"{plan.n_total}"
                )
    else:
        sizes = {trace.n for trace in traces}
        if len(sizes) != 1:
            raise ValueError(
                f"pipelined replays need one pool size, got {sorted(sizes)}"
            )
    a, b = _prep_pipeline_operands(plan, a, b, depth)
    session = PipelineSession(
        plan,
        seed=seed,
        verify_extras=verify_extras,
        master_decode_cost=master_decode_cost,
        mesh=mesh,
        axis=axis,
        mode=mode,
        backend=backend,
        planner=planner,
        plan_seed=plan_seed,
        compute_scale=compute_scale,
        decode_mode=decode_mode,
        error_budget=error_budget,
        max_subset_tries=max_subset_tries,
        hybrid_state=hybrid_state,
        device=device,
    )
    for k, trace in enumerate(traces):
        session.append(a[k], b[k], trace)
    return session.result()
