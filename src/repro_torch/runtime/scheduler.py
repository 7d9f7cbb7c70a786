"""Event-driven scheduler: the three-phase protocol over a worker pool.

The static plan machinery already answers "which subsets can serve each
phase" (``phase2_matrix`` / ``decode_matrix`` for arbitrary ids); this
module decides *which subset actually does*, by replaying a
``WorkerTrace`` through a priority-queue event loop:

1. shares go out at t=0 and reach worker n at ``share_delay[n]``;
   worker n finishes H(alpha_n) ``compute_delay[n]`` later (dropouts
   never do),
2. the moment the fastest ``n_workers`` workers have finished, the
   Phase-2 set is fixed — exactly the paper's straggler mitigation:
   spares keep primaries from gating the exchange — and every live
   worker receives its summed I(alpha_n) one exchange leg later: the
   scalar D2D delay, or (link-resolved traces) the max over its
   incoming links from the sender set,
3. responses stream back to the master; decode triggers as soon as the
   fastest ``decode_threshold`` responders are in (the per-subset
   decode matrix comes from the plan's subset cache, so recurring
   fastest-subsets cost one Gauss-Jordan total).

Corrupted responses — two strategies, picked by ``decode_mode``:

* ``"detect"`` (confirm-and-retry): when ``verify_extras > 0`` the
  master withholds acceptance until a decode is *confirmed* by that
  many responders outside the decode subset (the interpolated I(x)
  must reproduce their evaluations).  A corrupt response is garbage,
  so it can neither be confirmed as part of a subset nor falsely
  confirm a clean one; mismatching responders are reported as
  detected-corrupt.  Under heavy corruption this degrades into the
  seeded-random subset hunt of ``_candidate_subsets``.
* ``"correct"`` (Berlekamp-Welch): the responses are a Reed-Solomon
  codeword, so with ``error_budget = e`` the master waits for the
  fastest ``thr + 2e`` responders and runs ONE error-correcting decode
  (``core.bw_decode``) that recovers I(x) *and* names the corrupt
  responders (``RunMetrics.corrected_workers``) — no subset search,
  no retry.  If more than ``e`` responders are corrupt, later arrivals
  widen the window (budget ``(k - thr) // 2`` at ``k`` responses)
  until the clean responders run out.
* ``"auto"``: ``"correct"`` when the resolved error budget is > 0,
  ``"detect"`` otherwise.
* ``"hybrid"``: detect until the *first rejection on the pool*, then
  escalate to BW correction for every later replay against it.  The
  escalation is cross-replay state, so it lives in a
  :class:`HybridState` the caller threads through its replay calls
  (the serving engine keeps one per pool/session); a bare call with no
  state behaves as a fresh pool — detect.

``verify_extras="auto"`` / ``error_budget="auto"`` resolve from the
trace's *configured* fault model (``WorkerTrace.fault_model`` — what
the master knows because it provisioned the pool), never from the
sampled ``trace.corrupt`` flags, which are ground truth the master
cannot see.  A hand-built corrupt trace with no fault model therefore
gets NO automatic protection — exactly the honest semantics.

Two replay entry points share ONE event loop (``_replay_events``):

* ``run_over_pool``        — per-product reference (numpy-rng share
                              path, dense Phase-2 simulation),
* ``run_batch_over_pool``  — a whole batch of products through one
                              trace: shares come from the batched
                              engine, the batch folds into the
                              per-worker payload so the event loop,
                              Phase-2 subset selection, and the
                              decode-subset search are paid ONCE.

The counterpart of ``repro.runtime.scheduler``.  The event loop, the
decode search and the corruption handling are the reference's, on the
host (numpy), with the same draws from the same ``numpy`` rng in the
same order, so a given trace and seed give the reference's timelines,
subsets and metrics.  The data plane runs on the device (default: the
GPU): ``share_a/b``, ``worker_multiply``, ``degree_reduce`` and
``share_batched`` of ``repro_torch.core.protocol``, every product
through the GF(p) kernels; the Phase-2 evaluations come to the host in
one copy when the Phase-2 set is fixed.  The reference's ``mesh=``
path (the ``shard_map`` Phase-2 exchange) is not ported yet: passing a
mesh raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core import gf
from ..core import protocol as proto
from ..core.bw_decode import BWDecodeError, bw_decode_evals, bw_system_size
from ..core.planner import CMPCPlan
from ..obs.metrics import REGISTRY
from ..obs.tracer import TRACER
from .metrics import RunMetrics
from .pool import WorkerTrace

_EMPTY_IDS = np.array([], np.int64)


class DecodeFailure(RuntimeError):
    """The pool could not complete the protocol (too many faults)."""


def _refuse_mesh(mesh) -> None:
    """The sharded Phase-2 exchange (``mesh=``) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the sharded Phase-2 exchange) is not ported to repro_torch "
            "yet: ROADMAP item 11 (torch.distributed); run without a mesh for "
            "the dense Phase 2"
        )


def _to_host(i_all) -> np.ndarray:
    """The Phase-2 evaluations as a writable host array of their own
    dtype (int32): one copy from the device; corrupt rows are
    overwritten in it."""
    if isinstance(i_all, torch.Tensor):
        host = i_all.cpu().numpy()
        return host if i_all.device.type != "cpu" else host.copy()
    return np.array(i_all)


@dataclasses.dataclass
class EdgeRun:
    """Result of one execution over the pool."""

    y: np.ndarray
    metrics: RunMetrics


@dataclasses.dataclass
class BatchEdgeRun:
    """Result of one batched execution over the pool.

    One event-loop replay served every product: ``per_product`` metrics
    share the timeline and subsets, differing only in the (per-product)
    communication trace; ``metrics`` carries the whole-batch trace.
    The subset id arrays (``phase2_ids``, ``responder_ids``, ...) are
    shared views across entries and the aggregate — treat them as
    read-only.
    """

    y: np.ndarray  # [batch, ma, mb]
    metrics: RunMetrics  # aggregate (batch-level comm accounting)
    per_product: List[RunMetrics]


# Default bound on per-event decode-subset search when hunting for a
# confirmable subset among corrupt responses; the search resumes at the
# next arrival.  Half the budget goes to the deterministic colex front
# (fastest-first), half to seeded random subsets that keep heavy
# corruption from starving the front (see _candidate_subsets).  Callers
# override via ``max_subset_tries`` to trade search time for success
# rate deterministically under heavy corruption.
DEFAULT_SUBSET_TRIES = 128


@dataclasses.dataclass
class _Replay:
    """Everything the event loop decided for one trace replay."""

    coeffs: np.ndarray  # [thr, payload] interpolated I(x) coefficients
    phase2_ids: np.ndarray
    responder_ids: np.ndarray
    confirmed_by: np.ndarray
    rejected_ids: np.ndarray
    corrected_ids: np.ndarray  # BW-identified (and corrected) corrupt
    phase1_last: float
    phase2_set_time: float
    first_response: float
    completion: float
    n_arrived: int


def _emit_replay_obs(
    plan: CMPCPlan,
    res: _Replay,
    trace: WorkerTrace,
    alive: np.ndarray,
    share_at: np.ndarray,
    finish_at: np.ndarray,
    arrived: list,
    bw_log: list,
    attrs: dict,
) -> None:
    """Render one replay's event-loop timeline as simulated-clock trace
    records: per-worker ``("worker", w)`` lanes carry the share /
    compute / respond spans (the flame chart of workers x phases), the
    ``("replay", k)`` lane carries the whole-replay span, the Phase-2
    barrier, BW attempts, and decode acceptance.

    Every timestamp is read off the already-decided replay — nothing
    here draws randomness or reorders events, so enabling the tracer
    cannot perturb the (deterministic) replay it records.
    """
    ridx = int(attrs.get("replay", 0))
    rtrack = ("replay", ridx)
    t_start = float(attrs.get("t_start", 0.0))
    p2 = {int(i) for i in res.phase2_ids}
    comm = _comm_trace(
        plan, int(alive.sum()), res.n_arrived, int(attrs.get("batch", 1))
    )
    TRACER.sim_span(
        "replay", t_start, res.completion, track=rtrack,
        wire_bytes_total=comm.total_bytes,
        phase1_bytes=comm.phase1_bytes,
        phase2_bytes=comm.phase2_bytes,
        phase3_bytes=comm.phase3_bytes,
        **attrs,
    )
    for w in np.flatnonzero(alive):
        w = int(w)
        wtrack = ("worker", w)
        TRACER.sim_span(
            "phase1.share", t_start, float(share_at[w]), track=wtrack,
            replay=ridx, worker=w,
        )
        TRACER.sim_span(
            "phase2.compute", float(share_at[w]), float(finish_at[w]),
            track=wtrack, replay=ridx, worker=w, in_set=w in p2,
        )
    TRACER.sim_event(
        "phase2.barrier", res.phase2_set_time, track=rtrack,
        replay=ridx, n_set=int(res.phase2_ids.size),
    )
    for t_arr, w in arrived:
        TRACER.sim_span(
            "phase3.respond", res.phase2_set_time, float(t_arr),
            track=("worker", int(w)), replay=ridx, worker=int(w),
        )
    for t_a, e_eff, window, ok in bw_log:
        TRACER.sim_event(
            "phase3.bw_attempt", float(t_a), track=rtrack,
            replay=ridx, e_eff=int(e_eff), window=int(window), ok=bool(ok),
        )
    TRACER.sim_event(
        "phase3.decode", res.completion, track=rtrack,
        replay=ridx,
        n_arrived=res.n_arrived,
        n_responders=int(res.responder_ids.size),
        n_rejected=int(res.rejected_ids.size),
        n_corrected=int(res.corrected_ids.size),
    )


def _check_pool(plan: CMPCPlan, trace: WorkerTrace) -> np.ndarray:
    """Validate the trace against the plan; returns the alive mask."""
    if trace.n != plan.n_total:
        raise ValueError(
            f"trace covers {trace.n} workers, plan provisions {plan.n_total} "
            f"({plan.n_workers} + {plan.n_spare} spare)"
        )
    alive = ~trace.dropout
    if int(alive.sum()) < plan.n_workers:
        raise DecodeFailure(
            f"{int(trace.dropout.sum())} dropouts leave "
            f"{int(alive.sum())} live workers < n_workers={plan.n_workers}"
        )
    return alive


def _replay_events(
    plan: CMPCPlan,
    trace: WorkerTrace,
    alive: np.ndarray,
    compute_i_all: Callable[[np.ndarray], np.ndarray],
    verify_extras: int,
    rng: np.random.Generator,
    master_decode_cost: float,
    share_arrival: Optional[np.ndarray] = None,
    compute_finish: Optional[np.ndarray] = None,
    compute_scale: float = 1.0,
    decode_mode: str = "detect",
    error_budget: int = 0,
    max_subset_tries: int = DEFAULT_SUBSET_TRIES,
    obs_attrs: Optional[dict] = None,
) -> _Replay:
    """The shared event loop: timestamps, subsets, and the decode search.

    ``compute_i_all(phase2_ids)`` supplies the numeric Phase-2 result as
    an ``[n_total, ...]`` worker-stacked array (any trailing payload
    shape — the batched runtime folds its whole batch in there);
    corruption is injected here so every caller gets identical fault
    semantics.

    ``share_arrival`` / ``compute_finish`` override the trace-derived
    Phase-1 arrival and H(alpha_n) completion times with absolute
    timestamps — the hook the pipelined runtime uses to account for
    master-uplink serialization and per-worker compute occupancy
    across overlapping replays.  Defaults reproduce the standalone
    semantics: arrival at ``share_delay``, completion one
    ``compute_delay`` later.

    ``compute_scale`` multiplies every worker's compute delay — the
    hook for heterogeneous-work comparisons, where one trace's
    ``compute_delay`` is time per unit work and each construction's
    per-worker work (Corollary 10; ``CostPrediction.compute_factor``)
    sets the scale.  The default 1.0 keeps replays byte-identical to
    the legacy semantics.

    With a link-resolved trace (``trace.link_delay`` set), a receiver's
    exchange completes at the max over its *incoming* links from the
    Phase-2 sender set rather than one scalar D2D delay; a dead
    (infinite) incoming link starves the receiver, which then never
    responds in Phase 3.

    ``decode_mode`` must arrive resolved (``"detect"`` or
    ``"correct"``).  In ``"correct"`` mode ``verify_extras`` is ignored
    (the BW decode self-verifies against every clean responder in the
    window) and acceptance waits for ``thr + 2 * error_budget``
    responses; ``max_subset_tries`` bounds the ``"detect"`` subset
    search per arrival.

    ``obs_attrs`` annotates this replay's trace records when the
    process tracer is enabled — the pipelined/adaptive runtimes pass
    ``replay`` (lane index), ``t_start`` (absolute pipeline start), and
    the ``decision_id``/``config`` of the :class:`PlanDecision` that
    picked the construction, linking each decision to the replay it
    decided.
    """
    tracing = TRACER.enabled
    p = plan.field.p
    share_at = trace.share_delay if share_arrival is None else share_arrival
    phase1_last = float(share_at[alive].max())
    finish_at = (
        share_at + compute_scale * trace.compute_delay
        if compute_finish is None
        else compute_finish
    )

    # Heap entries: (time, seq, kind, worker).
    events: list = []
    seq = itertools.count()
    for w in np.flatnonzero(alive):
        heapq.heappush(
            events,
            (float(finish_at[w]), next(seq), "compute", int(w)),
        )

    computed: list = []  # worker ids in compute-completion order
    link_starved: list = []  # receivers with a dead incoming link
    phase2_ids: Optional[np.ndarray] = None
    phase2_set_time = float("nan")
    i_all: Optional[np.ndarray] = None
    vander_check: Optional[np.ndarray] = None
    arrived: list = []  # (time, worker) in response-arrival order
    first_response = float("nan")
    decode_cache: dict = {}  # subset id-tuple -> coeffs, across arrivals
    bw_attempts = 0  # correct-mode decode attempts, for the failure census
    bw_log: list = []  # (t, e_eff, window, ok) per attempt, when tracing

    def _finish(res: _Replay) -> _Replay:
        REGISTRY.counter("runtime.replays").inc()
        if tracing:
            _emit_replay_obs(
                plan, res, trace, alive, share_at, finish_at, arrived,
                bw_log, obs_attrs or {},
            )
        return res

    while events:
        t_now, _, kind, w = heapq.heappop(events)

        if kind == "compute":
            computed.append(w)
            if len(computed) != plan.n_workers:
                continue
            # Fastest n_workers fix the Phase-2 set; the mixing matrix
            # interpolates over exactly this subset (sorted for a
            # canonical subset-cache key).
            phase2_ids = np.sort(np.array(computed))
            phase2_set_time = t_now
            # a host copy of its own: corrupt rows are overwritten below
            i_all = _to_host(compute_i_all(phase2_ids))
            # Corrupt workers respond with garbage of the right shape
            # (garbage spans their whole payload — every product of a
            # batched replay sees the same worker corrupt).
            for c in np.flatnonzero(trace.corrupt & alive):
                i_all[c] = rng.integers(0, p, size=i_all[c].shape, dtype=np.int64)
            vander_check = plan.decode_check_matrix()
            # Live, non-crashed workers respond one exchange + uplink
            # delay after the set is announced.  With a link matrix the
            # exchange leg is the max over the receiver's incoming
            # links from the sender set (its own diagonal entry is 0);
            # a dead incoming link starves the receiver's I(alpha_r)
            # sum, so it never responds.  Exchange messages all go out
            # at the announcement, so a time-varying fabric resolves to
            # the matrix in effect *now*.
            link_now = trace.link_at(t_now)
            for r in np.flatnonzero(alive & ~trace.crash_after_phase2):
                if link_now is not None:
                    exchange = float(link_now[phase2_ids, r].max())
                    if not np.isfinite(exchange):
                        link_starved.append(int(r))
                        continue
                else:
                    exchange = float(trace.d2d_delay[r])
                heapq.heappush(
                    events,
                    (
                        float(t_now + exchange + trace.uplink_delay[r]),
                        next(seq),
                        "response",
                        int(r),
                    ),
                )
            continue

        # kind == "response"
        if not arrived:
            first_response = t_now
        arrived.append((t_now, w))
        if decode_mode == "correct":
            thr = plan.decode_threshold
            if len(arrived) < bw_system_size(thr, error_budget):
                continue
            # Fastest thr + 2e window at budget e; each further arrival
            # widens both the window and the budget ((k - thr) // 2), so
            # under-budgeted corruption degrades gracefully instead of
            # failing outright.
            e_eff = (len(arrived) - thr) // 2
            window = np.array(
                [wk for _, wk in arrived[: bw_system_size(thr, e_eff)]]
            )
            bw_attempts += 1
            REGISTRY.counter("runtime.bw_attempts").inc()
            try:
                coeffs, corrected = bw_decode_evals(
                    plan, i_all, window, e_eff, rng=rng
                )
            except BWDecodeError:
                if tracing:
                    bw_log.append((t_now, e_eff, len(window), False))
                continue  # > e_eff corrupt in the window: wait for more
            if tracing:
                bw_log.append((t_now, e_eff, len(window), True))
            responders = window[~np.isin(window, corrected)]
            return _finish(_Replay(
                coeffs=coeffs,
                phase2_ids=phase2_ids,
                responder_ids=np.sort(responders),
                confirmed_by=_EMPTY_IDS.copy(),
                rejected_ids=_EMPTY_IDS.copy(),
                corrected_ids=corrected,
                phase1_last=phase1_last,
                phase2_set_time=phase2_set_time,
                first_response=float(first_response),
                completion=float(t_now + master_decode_cost),
                n_arrived=len(arrived),
            ))
        if len(arrived) < plan.decode_threshold + verify_extras:
            continue
        accepted = _try_decode(
            plan, i_all, arrived, verify_extras, vander_check, rng,
            decode_cache, max_subset_tries,
        )
        if accepted is None:
            continue
        coeffs, responder_ids, confirmed_by, rejected = accepted
        return _finish(_Replay(
            coeffs=coeffs,
            phase2_ids=phase2_ids,
            responder_ids=responder_ids,
            confirmed_by=confirmed_by,
            rejected_ids=rejected,
            corrected_ids=_EMPTY_IDS.copy(),
            phase1_last=phase1_last,
            phase2_set_time=phase2_set_time,
            first_response=float(first_response),
            completion=float(t_now + master_decode_cost),
            n_arrived=len(arrived),
        ))

    REGISTRY.counter("runtime.decode_failures").inc()
    if decode_mode == "correct":
        raise DecodeFailure(
            f"events exhausted before a Berlekamp-Welch decode: "
            f"{len(arrived)} responses arrived, need "
            f"{plan.decode_threshold} + 2*{error_budget} "
            f"(threshold {plan.decode_threshold}, error budget "
            f"{error_budget}, {bw_attempts} BW attempts); "
            f"dropouts={int(trace.dropout.sum())}, "
            f"crashed={int((trace.crash_after_phase2 & alive).sum())}, "
            f"corrupt={int((trace.corrupt & alive).sum())}, "
            f"link_starved={len(link_starved)}"
        )
    raise DecodeFailure(
        f"events exhausted before an acceptable decode: {len(arrived)} "
        f"responses arrived, need {plan.decode_threshold} + {verify_extras} "
        f"confirmations (threshold {plan.decode_threshold}); "
        f"dropouts={int(trace.dropout.sum())}, "
        f"crashed={int((trace.crash_after_phase2 & alive).sum())}, "
        f"corrupt={int((trace.corrupt & alive).sum())}, "
        f"link_starved={len(link_starved)}"
    )


def _comm_trace(
    plan: CMPCPlan, n_recv: int, n_arrived: int, batch: int = 1
) -> proto.Trace:
    """Runtime communication accounting for one replay.

    Delegates to ``protocol.batch_trace`` (ONE home for the
    Corollary-12 formulas), overriding Phase 2's receivers with the
    *live* pool (crashed-after-phase-2 workers fully serve the
    exchange; dropouts receive nothing) and Phase 3 with the responses
    that actually arrived at acceptance.
    """
    return proto.batch_trace(
        plan, batch, n_receivers=n_recv, n_responses=n_arrived
    )


def _build_metrics(
    plan: CMPCPlan,
    trace: WorkerTrace,
    alive: np.ndarray,
    res: _Replay,
    batch: int = 1,
) -> RunMetrics:
    # crash-after-phase-2 workers fully serve the exchange (they only
    # skip the Phase-3 report), so they count as receivers
    n_recv = int(alive.sum())
    return RunMetrics(
        completion_time=res.completion,
        phase1_last_share=res.phase1_last,
        phase2_set_time=res.phase2_set_time,
        first_response=res.first_response,
        n_provisioned=plan.n_total,
        n_dropped=int(trace.dropout.sum()),
        n_crashed=int((trace.crash_after_phase2 & alive).sum()),
        phase2_ids=res.phase2_ids,
        responder_ids=res.responder_ids,
        confirmed_by=res.confirmed_by,
        rejected_ids=res.rejected_ids,
        corrected_workers=res.corrected_ids,
        trace=_comm_trace(plan, n_recv, res.n_arrived, batch),
        batch=batch,
    )


def _resolve_verify_extras(verify_extras, trace: WorkerTrace) -> int:
    """``"auto"`` -> 1 extra confirmation iff the pool was *provisioned*
    with a corrupting fault model.

    The master only ever sees what it configured (``trace.fault_model``),
    never the sampled ``trace.corrupt`` flags — those are ground truth.
    A hand-built corrupt trace with no fault model resolves to 0 extras
    and an unverified decode, exactly like a master that provisioned an
    honest pool.
    """
    if verify_extras == "auto":
        fm = trace.fault_model
        return 1 if fm is not None and fm.corrupt_frac > 0 else 0
    return int(verify_extras)


def _resolve_error_budget(error_budget, trace: WorkerTrace, plan: CMPCPlan) -> int:
    """``"auto"`` -> expected corrupt count under the *configured* fault
    model, capped at what the pool can afford ((n_total - thr) // 2);
    integers pass through (validated >= 0)."""
    if error_budget == "auto":
        fm = trace.fault_model
        if fm is None or fm.corrupt_frac <= 0:
            return 0
        cap = (plan.n_total - plan.decode_threshold) // 2
        want = int(np.ceil(fm.corrupt_frac * trace.n))
        return max(0, min(want, cap))
    e = int(error_budget)
    if e < 0:
        raise ValueError(f"error_budget must be >= 0, got {e}")
    return e


def _resolve_decode_mode(decode_mode: str, error_budget: int) -> str:
    """``"auto"`` -> ``"correct"`` iff the resolved error budget buys any
    protection; explicit modes pass through (validated).  ``"hybrid"``
    must already have been resolved against a :class:`HybridState`
    (``_resolve_hybrid``) before reaching here."""
    if decode_mode == "auto":
        return "correct" if error_budget > 0 else "detect"
    if decode_mode not in ("detect", "correct"):
        raise ValueError(
            f"decode_mode must be 'detect', 'correct', 'auto', or "
            f"'hybrid', got {decode_mode!r}"
        )
    return decode_mode


@dataclasses.dataclass
class HybridState:
    """Cross-replay escalation state for ``decode_mode="hybrid"``.

    Hybrid starts every pool in cheap detect mode (confirm-and-retry)
    and escalates to Berlekamp-Welch correction only after the first
    *evidence of corruption on this pool* — a rejected responder in a
    detect decode.  The evidence outlives any single replay, so the
    state is an explicit object the caller threads through consecutive
    replays against the same pool (the serving engine keeps one per
    session and resets it when the pool is reconfigured).  A call with
    no state gets a fresh one: a single replay can never escalate
    itself mid-flight, matching "escalate only *after* the first
    rejection".
    """

    escalated: bool = False
    rejections_seen: int = 0

    def note(self, metrics: RunMetrics) -> None:
        """Fold one finished replay's verdicts into the state."""
        n_bad = int(metrics.rejected_ids.size) + int(
            metrics.corrected_workers.size
        )
        if n_bad > 0:
            self.rejections_seen += n_bad
            self.escalated = True

    def reset(self) -> None:
        """Forget the pool (call after a reconfiguration)."""
        self.escalated = False
        self.rejections_seen = 0


def _resolve_hybrid(
    decode_mode: str,
    hybrid_state: Optional[HybridState],
    error_budget: int,
    plan: CMPCPlan,
) -> Tuple[str, int, Optional[HybridState]]:
    """Resolve ``"hybrid"`` against the pool's escalation state.

    Pre-escalation: plain detect with the caller's budget untouched.
    Post-escalation: BW correction with a budget of at least 1 (the
    auto-resolved budget is often 0 exactly when hybrid matters — the
    master provisioned an honest pool and was wrong), capped at what
    the pool can afford; a pool too small to fund any BW window stays
    in detect.  Non-hybrid modes pass through so the callers can
    resolve unconditionally.
    """
    if decode_mode != "hybrid":
        return decode_mode, error_budget, hybrid_state
    state = hybrid_state if hybrid_state is not None else HybridState()
    if not state.escalated:
        return "detect", error_budget, state
    cap = (plan.n_total - plan.decode_threshold) // 2
    budget = min(max(1, error_budget), cap)
    if budget <= 0:
        return "detect", error_budget, state
    return "correct", budget, state


def run_over_pool(
    plan: CMPCPlan,
    a: np.ndarray,
    b: np.ndarray,
    trace: WorkerTrace,
    seed: int = 0,
    verify_extras="auto",
    master_decode_cost: float = 0.0,
    compute_scale: float = 1.0,
    decode_mode: str = "detect",
    error_budget="auto",
    max_subset_tries: int = DEFAULT_SUBSET_TRIES,
    obs_attrs: Optional[dict] = None,
    hybrid_state: Optional[HybridState] = None,
    device=None,
) -> EdgeRun:
    """Execute Y = A^T B over the simulated pool described by ``trace``.

    ``decode_mode`` selects corruption handling (module docstring):
    ``"detect"`` confirm-and-retry (the default; ``verify_extras``
    confirmations, subset search bounded by ``max_subset_tries``),
    ``"correct"`` one Berlekamp-Welch decode over the fastest
    ``thr + 2 * error_budget`` responders, ``"auto"`` correct iff the
    resolved error budget is positive, ``"hybrid"`` detect until the
    first rejection recorded in ``hybrid_state`` then correct.
    ``error_budget="auto"`` resolves from the trace's configured fault
    model.

    The data plane runs on ``device`` (default: the GPU).  Returns the
    decoded product (a host int64 array) and the run's
    :class:`RunMetrics`.  Raises :class:`DecodeFailure` when the
    surviving pool cannot serve Phase 2 (fewer than ``n_workers`` live
    workers) or the master never accumulates an acceptable responder
    subset.
    """
    device = proto.resolve_device(device)
    alive = _check_pool(plan, trace)
    verify_extras = _resolve_verify_extras(verify_extras, trace)
    error_budget = _resolve_error_budget(error_budget, trace, plan)
    decode_mode, error_budget, hybrid_state = _resolve_hybrid(
        decode_mode, hybrid_state, error_budget, plan
    )
    decode_mode = _resolve_decode_mode(decode_mode, error_budget)
    rng = np.random.default_rng(seed)

    # Data plane, Phase 1: sources evaluate and ship shares.
    fa = proto.share_a(plan, a, rng, device=device)
    fb = proto.share_b(plan, b, rng, device=device)
    h = proto.worker_multiply(plan, fa, fb)

    def compute_i_all(phase2_ids: np.ndarray) -> np.ndarray:
        return proto.degree_reduce(plan, h, rng, worker_ids=phase2_ids)

    res = _replay_events(
        plan, trace, alive, compute_i_all, verify_extras, rng,
        master_decode_cost, compute_scale=compute_scale,
        decode_mode=decode_mode, error_budget=error_budget,
        max_subset_tries=max_subset_tries, obs_attrs=obs_attrs,
    )
    y = proto.assemble_y(plan, res.coeffs)
    metrics = _build_metrics(plan, trace, alive, res)
    if hybrid_state is not None:
        hybrid_state.note(metrics)
    return EdgeRun(y=y, metrics=metrics)


def _batched_compute_closure(
    plan: CMPCPlan,
    fa: torch.Tensor,
    fb: torch.Tensor,
    rng: np.random.Generator,
    batch: int,
    backend: str,
) -> Callable[[np.ndarray], torch.Tensor]:
    """``compute_i_all`` for a batched replay (shared with the pipeline).

    Folds the whole batch into each worker's payload so one Phase-2
    pass serves every product: the dense single-host simulation, on
    the shares' device, every product on ``backend``.
    """
    bry, bcy = plan.shapes.blk_y

    def compute_i_all(phase2_ids: np.ndarray) -> torch.Tensor:
        # Dense simulation: fold the batch into the block rows so the
        # existing degree-reduction matmul serves every product at once.
        h = proto.worker_multiply(plan, fa, fb, backend=backend)  # [batch, n_total, bry, bcy]
        h_w = h.movedim(0, 1).reshape(plan.n_total, batch * bry, bcy)
        return proto.degree_reduce(plan, h_w, rng, worker_ids=phase2_ids, backend=backend)

    return compute_i_all


def _unfold_batched_y(plan: CMPCPlan, coeffs: np.ndarray, batch: int) -> np.ndarray:
    """Per-product assembly: the interpolated coefficients carry the
    batch in their payload; unfold and lay out every Y at once (the
    batched mirror of ``assemble_y``)."""
    t = plan.scheme.t
    sh = plan.shapes
    bry, bcy = sh.blk_y
    blocks = coeffs.reshape(-1, batch, bry, bcy)[: t * t].reshape(
        t, t, batch, bry, bcy
    )  # [l, i, b, ., .]
    return blocks.transpose(2, 1, 3, 0, 4).reshape(batch, sh.ma, sh.mb)


def run_batch_over_pool(
    plan: CMPCPlan,
    a: np.ndarray,
    b: np.ndarray,
    trace: WorkerTrace,
    seed: int = 0,
    verify_extras="auto",
    master_decode_cost: float = 0.0,
    mesh=None,
    axis: str = "workers",
    mode: str = "all_to_all",
    backend: str = "auto",
    compute_scale: float = 1.0,
    decode_mode: str = "detect",
    error_budget="auto",
    max_subset_tries: int = DEFAULT_SUBSET_TRIES,
    obs_attrs: Optional[dict] = None,
    hybrid_state: Optional[HybridState] = None,
    device=None,
) -> BatchEdgeRun:
    """Replay a whole batch of products through ONE worker trace.

    a: [batch, k, ma], b: [batch, k, mb] (2D operands promote to batch
    1).  The event loop, Phase-2 fastest-subset barrier, and the
    decode-subset search run once for the whole batch: products fold
    into each worker's payload, which is sound because the timeline
    depends only on the trace, and a corrupt/crashed/dropped worker is
    faulty for every product it touches.  Shares come from the batched
    engine (``share_batched``, key ``gf.prng_key(seed)``), Phase 2 is
    the dense single-host simulation (``worker_multiply`` and
    ``degree_reduce``), all on ``device`` (default: the GPU), every
    product on ``backend``; the decode runs on the host.

    ``mesh`` (the reference's sharded Phase-2 exchange) is not ported
    yet and raises ``NotImplementedError``; ``axis`` and ``mode`` belong
    to it.

    ``decode_mode`` / ``error_budget`` / ``max_subset_tries`` select the
    corruption-handling strategy exactly as in ``run_over_pool``; a
    Berlekamp-Welch decode (``"correct"``) corrects each corrupt
    worker's whole folded payload at once, so the whole batch rides one
    error-correcting decode.

    Returns :class:`BatchEdgeRun` (y a host int64 array); raises
    :class:`DecodeFailure` exactly like ``run_over_pool``.
    """
    _refuse_mesh(mesh)
    device = proto.resolve_device(device)
    alive = _check_pool(plan, trace)
    verify_extras = _resolve_verify_extras(verify_extras, trace)
    error_budget = _resolve_error_budget(error_budget, trace, plan)
    decode_mode, error_budget, hybrid_state = _resolve_hybrid(
        decode_mode, hybrid_state, error_budget, plan
    )
    decode_mode = _resolve_decode_mode(decode_mode, error_budget)
    rng = np.random.default_rng(seed)

    a_t, b_t = proto._prep_batched_operands(plan, a, b, device)
    batch = int(a_t.shape[0])
    fa, fb = proto.share_batched(
        plan, a_t, b_t, gf.prng_key(seed), backend=backend, device=device
    )
    compute_i_all = _batched_compute_closure(plan, fa, fb, rng, batch, backend)

    res = _replay_events(
        plan, trace, alive, compute_i_all, verify_extras, rng,
        master_decode_cost, compute_scale=compute_scale,
        decode_mode=decode_mode, error_budget=error_budget,
        max_subset_tries=max_subset_tries,
        obs_attrs={**(obs_attrs or {}), "batch": batch},
    )
    y = _unfold_batched_y(plan, res.coeffs, batch)

    aggregate = _build_metrics(plan, trace, alive, res, batch=batch)
    if hybrid_state is not None:
        hybrid_state.note(aggregate)
    # one replay served every product, so the per-product metrics are
    # identical by construction: build once, then give each entry its
    # own object (the subset id arrays stay shared read-only views)
    first = _build_metrics(plan, trace, alive, res, batch=1)
    per_product = [first] + [
        dataclasses.replace(first) for _ in range(batch - 1)
    ]
    return BatchEdgeRun(y=y, metrics=aggregate, per_product=per_product)


def _candidate_subsets(
    k: int, thr: int, rng: np.random.Generator,
    max_tries: int = DEFAULT_SUBSET_TRIES,
):
    """Arrival-position subsets, fastest-first, with a randomized tail.

    The deterministic front is *colex* order — every subset of the
    fastest ``m`` arrivals is enumerated before any subset touching
    arrival ``m+1`` — so the first candidate is the fastest ``thr``
    and a capped search always spends its budget on the fastest
    responders (plain lex order front-loads subsets *containing* the
    earliest arrivals, which livelocks when one of those is corrupt).
    After half the budget the generator switches to seeded random
    subsets: with ``c`` corrupt responders among ``k`` a uniform draw
    is clean with probability C(k-c, thr)/C(k, thr), so a few dozen
    draws find a clean subset even when the colex front is saturated
    with corrupt members.
    """
    n = 0
    for m in range(thr, k + 1):
        for head in itertools.combinations(range(m - 1), thr - 1):
            yield head + (m - 1,)
            n += 1
            if n >= max_tries // 2:
                break
        else:
            continue
        break
    while n < max_tries:
        yield tuple(np.sort(rng.choice(k, size=thr, replace=False)))
        n += 1


def _try_decode(
    plan: CMPCPlan,
    i_all: np.ndarray,
    arrived: list,
    verify_extras: int,
    vander_check: np.ndarray,
    rng: np.random.Generator,
    decode_cache: dict,
    max_subset_tries: int = DEFAULT_SUBSET_TRIES,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Search arrival-ordered responder subsets for an acceptable decode.

    Returns (coeffs, responder_ids, confirmed_by, rejected_ids) or None
    if no subset of the responses so far can be accepted.  A subset is
    accepted when the interpolated I(x) reproduces the responses of at
    least ``verify_extras`` responders outside it (garbage responses
    can neither pass as subset members nor confirm a clean subset, so
    a corrupt witness only defers acceptance to the next arrival).
    A rejected subset must be re-*verified* at later arrivals (a new
    witness can confirm it) but never re-*decoded*: ``decode_cache``
    holds its coefficients across calls within one run.
    """
    thr = plan.decode_threshold
    ids_by_arrival = [w for _, w in arrived]
    flat = i_all.reshape(i_all.shape[0], -1)
    seen = set()
    # One wall span per decode search (not per subset candidate): the
    # host-side price of Phase 3 at this arrival.
    with TRACER.span(
        "protocol.phase3.subset_search", n_arrived=len(ids_by_arrival)
    ):
        for subset_pos in _candidate_subsets(
            len(ids_by_arrival), thr, rng, max_subset_tries
        ):
            if subset_pos in seen:
                continue
            seen.add(subset_pos)
            subset = [ids_by_arrival[i] for i in subset_pos]
            ids = np.sort(np.array(subset))
            key = tuple(int(i) for i in ids)
            coeffs = decode_cache.get(key)
            if coeffs is None:
                w_dec = plan.decode_matrix_cached(ids)
                coeffs = plan.field.matmul(w_dec, flat[ids])
                decode_cache[key] = coeffs
            if verify_extras == 0:
                return (
                    coeffs, ids, np.array([], np.int64), np.array([], np.int64)
                )
            others = np.array([j for j in ids_by_arrival if j not in subset])
            pred = plan.field.matmul(vander_check[others], coeffs)
            ok = np.all(pred == flat[others], axis=1)
            if int(ok.sum()) >= verify_extras:
                return coeffs, ids, others[ok], others[~ok]
    return None
