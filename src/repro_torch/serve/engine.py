"""Continuous-batching serving engine for private matmul traffic.

``ServingEngine`` multiplexes many users' requests into the batched
CMPC protocol: requests queue with simulated arrival times, an
admission controller driven by the runtime's fitted
:class:`~repro.runtime.metrics.PoolEstimate` sheds or defers load the
pool cannot carry, and admitted requests fold into protocol replays
appended to an in-flight :class:`~repro.runtime.PipelineSession` — the
request -> batch -> protocol path the ROADMAP's serving tier calls for.

Batching discipline (``mode``):

* ``"continuous"`` — a new batch launches as soon as fewer than
  ``pipe_depth`` replays remain in flight (``session.ready_at``),
  i.e. its Phase-1 upload runs *inside* the tail replay's
  Phase-2/Phase-3 window.  Requests that arrived while the pipeline
  was busy ride the very next upload instead of waiting for the pool
  to drain — that is what bounds tail latency under load.
* ``"boundary"`` — a new batch waits for every in-flight replay to
  decode (``ready_at(1)``): the classic batch-boundary server the
  benchmark compares against.

Admission control: before each launch the engine predicts the replay's
service time from its fitted pool estimate (or the shared
:class:`~repro.runtime.AutoPlanner`'s, when one drives construction
selection) and

* **sheds** a request whose deadline the prediction already rules out
  (``launch + predicted_service > deadline``), and
* **defers** load when pool-health estimates disagree or degrade — a
  recent-window estimate predicting more than ``degrade_factor`` times
  the all-history service (or predicting infeasibility while history
  says healthy) halves the admission cap until the estimates
  reconverge.

Pool reconfiguration: the pipeline's serialized occupancy assumes one
worker set, so when the trace source (e.g. an ``ElasticPool``) changes
size the engine drains in-flight work, rebuilds the session at
``base_time = busy_until()`` (the reconfiguration barrier), re-fits
the construction's spares to the new pool, and resets the hybrid
escalation state; the estimator's observations survive — the master
pool is the same physical fleet, and a post-shrink prediction on the
smaller pool is exactly what makes admission shed.

Byzantine posture: ``decode_mode="hybrid"`` (the default) starts every
pool in cheap detect mode and escalates to Berlekamp-Welch correction
after the first rejected responder — threaded through every replay the
engine launches via the session's shared
:class:`~repro.runtime.HybridState`.

Everything is deterministic per seed: arrivals, traces, the event
loop, and therefore every latency percentile the report publishes.

The counterpart of ``repro.serve.engine``: the batcher loop, admission,
reconfiguration and accounting are the reference's, in its order of
float operations, so the same requests and traces give the reference's
``EngineReport``, counters and trace records exactly.  Every replay's
data plane runs on ``device`` (default: the GPU, resolved once at
construction and handed to every ``PipelineSession`` the engine
builds) through the port's kernels; the decode runs on the host.
With ``mesh=`` every replay's Phase 2 is the sharded exchange of
``core.distributed`` (``axis``, ``exchange_mode``), handed to every
session the engine builds.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import numpy as np

from ..core.constructions import PlanConfig
from ..core.gf import Field
from ..core.layers import choose_scales
from ..core.planner import BlockShapes, CMPCPlan, get_plan_for
from ..core.protocol import resolve_device
from ..obs.metrics import REGISTRY
from ..obs.tracer import TRACER
from ..runtime.metrics import estimate_pool, observed_run
from ..runtime.pipeline import PipelineRun, PipelineSession
from ..runtime.pool import ElasticPool, WorkerTrace
from ..runtime.scheduler import DEFAULT_SUBSET_TRIES, HybridState
from .request import DONE, SHED, EngineReport, Request

TraceSource = Union[WorkerTrace, ElasticPool, Sequence[WorkerTrace]]


def _trace_list(traces: TraceSource) -> List[WorkerTrace]:
    """Normalize a trace source to a (cycled) list of per-replay traces."""
    if isinstance(traces, WorkerTrace):
        return [traces]
    if isinstance(traces, ElasticPool):
        return list(traces)
    out = list(traces)
    if not out or not all(isinstance(t, WorkerTrace) for t in out):
        raise ValueError(
            "traces must be a WorkerTrace, an ElasticPool, or a non-empty "
            "sequence of WorkerTrace"
        )
    return out


class ServingEngine:
    """Request queue + continuous batcher over one private weight matrix.

    ``w``: [k, out] — the layer owner's private operand (every request
    multiplies against it; per-request fixed-point scales are chosen
    from each request's own activation range, so one engine serves
    requests of very different magnitudes exactly).

    Usage: ``submit()`` requests (simulated arrival stamps), then one
    ``run()`` to drain the queue; ``report.requests`` carries each
    request's full lifecycle.  ``submit`` after ``run`` starts a new
    load wave on the same engine clock.

    Every replay runs on ``device`` (default: the GPU); with ``mesh``
    its Phase 2 is the sharded collective over the ``axis`` mesh
    dimension in ``exchange_mode``.
    """

    def __init__(
        self,
        w: np.ndarray,
        traces: TraceSource,
        config: Optional[PlanConfig] = None,
        *,
        field: Optional[Field] = None,
        seed: int = 0,
        mode: str = "continuous",
        pipe_depth: int = 2,
        max_batch: int = 8,
        slo: Optional[float] = None,
        admission: bool = True,
        degrade_factor: float = 3.0,
        recent_window: int = 5,
        decode_mode: str = "hybrid",
        verify_extras="auto",
        error_budget="auto",
        master_decode_cost: float = 0.0,
        max_subset_tries: int = DEFAULT_SUBSET_TRIES,
        backend: str = "auto",
        mesh=None,
        axis: str = "workers",
        exchange_mode: str = "all_to_all",
        planner=None,
        plan_seed: int = 0,
        validate: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        if mode not in ("continuous", "boundary"):
            raise ValueError(f"mode must be 'continuous' or 'boundary', got {mode!r}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.w = np.asarray(w, np.float64)
        if self.w.ndim != 2:
            raise ValueError(f"w must be [k, out], got {self.w.shape}")
        self.config = config or PlanConfig()
        self.field = field or Field()
        self.seed = seed
        self.mode = mode
        if pipe_depth < 2:
            raise ValueError(
                f"pipe_depth must be >= 2 (1 is 'boundary' mode), got {pipe_depth}"
            )
        self.pipe_depth = int(pipe_depth)
        self.max_batch = int(max_batch)
        self.slo = slo
        self.admission = admission
        self.degrade_factor = float(degrade_factor)
        self.recent_window = int(recent_window)
        self.planner = planner
        self.validate = validate
        self._session_kw = dict(
            verify_extras=verify_extras,
            master_decode_cost=master_decode_cost,
            mesh=mesh,
            axis=axis,
            mode=exchange_mode,
            backend=backend,
            plan_seed=plan_seed,
            decode_mode=decode_mode,
            error_budget=error_budget,
            max_subset_tries=max_subset_tries,
            device=self.device,
        )
        self._decode_mode = decode_mode
        self._plan_seed = plan_seed
        k, out = self.w.shape
        if k % self.config.s:
            raise ValueError(
                f"s={self.config.s} must divide w's inner dim k={k}"
            )
        if out % self.config.t:
            raise ValueError(
                f"t={self.config.t} must divide w's output dim {out}"
            )

        self._traces = _trace_list(traces)
        self._t_idx = 0
        self._rows: Optional[int] = None  # per-request row count, fixed
        self._wq_cache: dict = {}  # scale -> encoded W
        self._queue: List[Request] = []
        self._all: List[Request] = []
        self._next_rid = 0
        self._obs: list = []  # engine-side ObservedRun history
        self._session: Optional[PipelineSession] = None
        self._pool_n: Optional[int] = None
        self._cfg_fit: Optional[PlanConfig] = None
        self._clock = 0.0  # reconfiguration barrier carries across sessions
        self._replays_total = 0  # across sessions/reconfigurations

    # -- submission ------------------------------------------------------

    def submit(
        self,
        x: np.ndarray,
        arrival: float,
        deadline: Optional[float] = None,
    ) -> Request:
        """Queue one request: ``x`` [rows, k] activation rows arriving
        at simulated time ``arrival``.  ``deadline`` is absolute; when
        ``None`` and the engine has an ``slo``, it defaults to
        ``arrival + slo``.  Returns the live :class:`Request` record
        (mutated in place as the engine serves it)."""
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            x = x[None]
        if x.ndim != 2 or x.shape[1] != self.w.shape[0]:
            raise ValueError(
                f"x must be [rows, k={self.w.shape[0]}], got {x.shape}"
            )
        if self._rows is None:
            if x.shape[0] % self.config.t:
                raise ValueError(
                    f"t={self.config.t} must divide request rows {x.shape[0]}"
                )
            self._rows = int(x.shape[0])
        elif x.shape[0] != self._rows:
            raise ValueError(
                f"request rows {x.shape[0]} != engine rows {self._rows} "
                "(one batched plan serves every request)"
            )
        if deadline is None and self.slo is not None:
            deadline = float(arrival) + float(self.slo)
        req = Request(
            rid=self._next_rid,
            x=x,
            arrival=float(arrival),
            deadline=deadline,
        )
        self._next_rid += 1
        self._queue.append(req)
        self._all.append(req)
        REGISTRY.counter("serve.requests").inc()
        return req

    # -- pool health / admission ----------------------------------------

    def _estimate_all(self):
        if self.planner is not None:
            return self.planner.estimate()
        return estimate_pool(self._obs)

    def _predicted_service(self) -> tuple:
        """(service prediction or None, degraded flag).

        The prediction is the more pessimistic of the all-history and
        recent-window fits; ``degraded`` flags the two disagreeing by
        more than ``degrade_factor`` (or recent infeasibility), which
        is the defer signal.  ``None`` = no observations yet: admit
        optimistically and let the first replays train the estimator.
        """
        cfg = self._cfg_fit
        args = (cfg.n_workers, cfg.decode_threshold, self._pool_n)
        est_all = self._estimate_all()
        pred_all = (
            est_all.predict_completion(*args) if est_all.n_runs else None
        )
        pred_recent = None
        if len(self._obs) >= self.recent_window:
            est_recent = estimate_pool(self._obs[-self.recent_window:])
            pred_recent = est_recent.predict_completion(*args)
        if pred_all is None and pred_recent is None:
            return None, False
        degraded = (
            pred_all is not None
            and pred_recent is not None
            and math.isfinite(pred_all)
            and (
                not math.isfinite(pred_recent)
                or pred_recent > self.degrade_factor * pred_all
            )
        )
        finite = [
            p for p in (pred_all, pred_recent)
            if p is not None and math.isfinite(p)
        ]
        predicted = max(finite) if finite else float("inf")
        return predicted, degraded

    def _shed(self, req: Request, t: float, reason: str) -> None:
        req.state = SHED
        req.shed_reason = reason
        REGISTRY.counter("serve.shed").inc()
        if TRACER.enabled:
            TRACER.sim_event(
                "serve.shed", float(t), track=("request", req.rid),
                request=req.rid, reason=reason,
            )

    def _admit(self, t_launch: float) -> List[Request]:
        """FIFO admission over requests already arrived at ``t_launch``,
        shedding hopeless deadlines and halving the cap while the pool
        estimates disagree (degraded => defer the tail to later
        launches).  Mutates the queue; returns the admitted batch."""
        candidates = [r for r in self._queue if r.arrival <= t_launch + 1e-12]
        if not self.admission:
            batch = candidates[: self.max_batch]
            for r in batch:
                self._queue.remove(r)
            return batch
        predicted, degraded = self._predicted_service()
        cap = self.max_batch if not degraded else max(1, self.max_batch // 2)
        admitted: List[Request] = []
        for r in candidates:
            if len(admitted) == cap:
                break  # deferred to a later launch, not shed
            if (
                r.deadline is not None
                and predicted is not None
                and t_launch + predicted > r.deadline + 1e-9
            ):
                self._queue.remove(r)
                self._shed(r, t_launch, "deadline")
                continue
            self._queue.remove(r)
            admitted.append(r)
        return admitted

    # -- session / pool management --------------------------------------

    def _peek_trace(self) -> WorkerTrace:
        return self._traces[self._t_idx % len(self._traces)]

    def _reconfigure(self, n: int) -> bool:
        """(Re)build the session for a pool of ``n`` workers at the
        reconfiguration barrier.  Returns False when the pool cannot
        seat the construction (caller sheds the remaining queue)."""
        if self._session is not None:
            self._clock = self._session.busy_until()
        try:
            cfg = self.config.fit_to_pool(n)
        except ValueError:
            return False
        self._pool_n = n
        self._cfg_fit = cfg
        hybrid = (
            HybridState() if self._decode_mode == "hybrid" else None
        )
        if self.planner is not None:
            self._session = PipelineSession(
                None, planner=self.planner, seed=self.seed,
                base_time=self._clock, hybrid_state=hybrid,
                **self._session_kw,
            )
        else:
            plan = self._plan_for(cfg)
            self._session = PipelineSession(
                plan, seed=self.seed, base_time=self._clock,
                hybrid_state=hybrid, **self._session_kw,
            )
        return True

    def _plan_for(self, cfg: PlanConfig) -> CMPCPlan:
        k, out = self.w.shape
        shapes = BlockShapes(
            k=k, ma=self._rows, mb=out, s=cfg.s, t=cfg.t
        )
        return get_plan_for(cfg, shapes, field=self.field, seed=self._plan_seed)

    def _wq(self, scale: int) -> np.ndarray:
        wq = self._wq_cache.get(scale)
        if wq is None:
            wq = self.field.encode(self.w, scale)
            self._wq_cache[scale] = wq
        return wq

    # -- the batcher loop ------------------------------------------------

    def run(self) -> EngineReport:
        """Drain the queue: admit, launch, decode, account.  Returns the
        :class:`EngineReport`; every submitted request ends ``done`` or
        ``shed`` — a drained queue leaves nothing in flight."""
        k_dim, out = self.w.shape
        with TRACER.span("serve.run", requests=len(self._queue)):
            while self._queue:
                trace = self._peek_trace()
                if self._pool_n != trace.n:
                    if not self._reconfigure(trace.n):
                        # Pool cannot seat the construction: nothing this
                        # engine launches can complete — shed the queue.
                        t = self._clock
                        for r in list(self._queue):
                            self._shed(r, t, "pool")
                        self._queue.clear()
                        break
                t_ready = self._session.ready_at(
                    self.pipe_depth if self.mode == "continuous" else 1
                )
                t_launch = max(t_ready, min(r.arrival for r in self._queue))
                batch = self._admit(t_launch)
                if not batch:
                    continue  # everything eligible was shed; queue shrank
                self._t_idx += 1
                scales = [
                    choose_scales(
                        k_dim,
                        float(np.abs(r.x).max() + 1e-9),
                        float(np.abs(self.w).max() + 1e-9),
                        self.field.p,
                    )
                    for r in batch
                ]
                aq = np.stack([
                    self.field.encode(r.x.T, s) for r, s in zip(batch, scales)
                ])  # [batch, k, rows]
                bq = np.stack([self._wq(s) for s in scales])  # [batch, k, out]
                replay = self._session.append(
                    aq, bq, trace, not_before=t_launch,
                    obs_attrs={"n_requests": len(batch)},
                )
                self._obs.append(observed_run(replay.metrics, start=replay.start))
                self._replays_total += 1
                REGISTRY.counter("serve.replays").inc()
                yq = np.asarray(replay.y)  # [batch, rows, out] field values
                for i, (r, s) in enumerate(zip(batch, scales)):
                    if self.validate:
                        want = self.field.matmul(aq[i].T, bq[i])
                        if not np.array_equal(yq[i], want):
                            raise AssertionError(
                                f"request {r.rid}: decode disagrees with the "
                                f"field oracle on replay {replay.index}"
                            )
                    r.y = self.field.decode(yq[i], s * s)
                    r.state = DONE
                    r.launch = replay.start
                    r.completion = replay.completion
                    r.replay = replay.index
                    if not r.met_deadline:
                        REGISTRY.counter("serve.deadline_miss").inc()
                    if TRACER.enabled:
                        rtrack = ("request", r.rid)
                        TRACER.sim_span(
                            "serve.queue", r.arrival, replay.start,
                            track=rtrack, request=r.rid, replay=replay.index,
                        )
                        TRACER.sim_span(
                            "serve.service", replay.start, replay.completion,
                            track=rtrack, request=r.rid, replay=replay.index,
                            deadline_met=r.met_deadline,
                        )
        return self.report()

    def report(self) -> EngineReport:
        done = [r for r in self._all if r.state == DONE]
        makespan = 0.0
        if done:
            makespan = max(r.completion for r in done) - min(
                r.arrival for r in self._all
            )
        return EngineReport(
            requests=list(self._all),
            replays=self._replays_total,
            makespan=makespan,
        )

    def pipeline_result(self) -> PipelineRun:
        """The underlying session's :class:`PipelineRun` (current pool's
        session only — earlier sessions end at reconfigurations)."""
        if self._session is None:
            raise ValueError("nothing launched yet")
        return self._session.result()
