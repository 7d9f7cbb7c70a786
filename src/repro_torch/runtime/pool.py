"""Simulated edge worker pool: latency models and fault injection.

A ``WorkerTrace`` is the *replayable* per-worker behaviour of one
protocol execution: message and compute delays plus fault flags, all
sampled up front from a seeded generator.  Sampling is separated from
scheduling so the same trace can be replayed against different schemes
— the scheme-comparison benchmark samples one trace at the largest
provisioned pool size and hands each scheme a prefix (``take``), so
PolyDot-CMPC and AGE-CMPC face byte-identical worker behaviour.

Latency models (per-worker, independent):

* ``Deterministic``        — constant; the all-fast baseline and the
                              unit-test fixture (schedule fully known),
* ``ShiftedExponential``   — shift + Exp(scale): the standard
                              straggler model of the coded-computation
                              literature,
* ``HeavyTail``            — shift + scale * Pareto(alpha): rare but
                              extreme stragglers (alpha <= 2 has
                              infinite variance).

Fault injection (``FaultSpec`` for Bernoulli sampling, or the explicit
``with_faults`` placement used when a test/benchmark needs exact
counts, e.g. "dropouts up to n_spare"):

* straggler          — compute slowed by ``straggler_slowdown``,
* dropout            — never computes or responds (lost share / dead),
* crash-after-phase-2 — serves the Phase-2 exchange, then crashes
                        before reporting I(alpha_n) to the master,
* corrupt            — responds on time with garbage (detected by the
                        scheduler via decode-consistency checks).

Fault flags are made disjoint with priority dropout > crash > corrupt
(a dropped worker cannot also crash later).

Per-link network models (``NetworkModel``): edge networks are defined
by heterogeneous *links*, not just heterogeneous workers, so a trace
can carry link-resolved delays instead of one scalar per worker:

* Phase 1 (master -> worker): the ``share_delay`` vector,
* Phase 2 (worker <-> worker): a ``link_delay[s, r]`` matrix — the
  delay of the exchange message from sender ``s`` to receiver ``r``
  (diagonal 0: a worker's own contribution crosses no link),
* Phase 3 (worker -> master): the ``uplink_delay`` vector.

``UniformLinks`` draws every link i.i.d., ``AsymmetricLinks`` scales
the master downlink / uplink / D2D fabrics independently (asymmetric
uplink is the defining property of last-mile edge connectivity), and
``ClusteredEdge`` partitions workers into clusters with fast
intra-cluster and slow inter-cluster links.  When ``link_delay`` is
``None`` the scheduler falls back to the scalar ``d2d_delay`` —
replays of existing traces are byte-identical — and ``take`` slices
the matrix ``[:n, :n]``, so link traces stay prefix-sliceable.
``with_dropped_links`` marks individual directed links dead
(infinite delay): a receiver missing an incoming Phase-2 link *from a
Phase-2 sender* can never finish its I(alpha_n) sum, so it goes
silent in Phase 3 while still serving as a Phase-2 *sender* —
strictly weaker than dropping the worker.  A dead link from a worker
outside the fastest-``n_workers`` sender set has no effect: receivers
only sum contributions from the senders.

A copy of the JAX package's ``repro.runtime.pool`` (plain Python and numpy),
kept here so that the port imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


# ----------------------------------------------------------------------
# latency models
# ----------------------------------------------------------------------
class LatencyModel:
    """Per-worker delay distribution; ``sample`` returns seconds > 0."""

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Deterministic(LatencyModel):
    value: float = 1.0

    def sample(self, rng, n):
        rng.random(n)  # consume the stream so fault draws stay aligned
        return np.full(n, float(self.value))


@dataclasses.dataclass(frozen=True)
class ShiftedExponential(LatencyModel):
    shift: float = 1.0
    scale: float = 1.0

    def sample(self, rng, n):
        return self.shift + rng.exponential(self.scale, size=n)


@dataclasses.dataclass(frozen=True)
class HeavyTail(LatencyModel):
    shift: float = 1.0
    scale: float = 0.5
    alpha: float = 1.5

    def sample(self, rng, n):
        return self.shift + self.scale * rng.pareto(self.alpha, size=n)


# ----------------------------------------------------------------------
# per-link network models
# ----------------------------------------------------------------------
class NetworkModel:
    """Per-link delay sampler for one protocol execution.

    ``sample_links(rng, n)`` returns ``(share, link, uplink)``:

    * ``share[r]``    — master -> worker ``r`` Phase-1 delivery delay,
    * ``link[s, r]``  — worker ``s`` -> worker ``r`` Phase-2 exchange
                         delay (diagonal forced to 0),
    * ``uplink[r]``   — worker ``r`` -> master Phase-3 response delay.

    The draw order is fixed (share, then the row-major link matrix,
    then uplink), so a seeded trace is reproducible.
    """

    def sample_links(self, rng: np.random.Generator, n: int):
        raise NotImplementedError

    @staticmethod
    def _zero_diag(link: np.ndarray) -> np.ndarray:
        np.fill_diagonal(link, 0.0)
        return link


@dataclasses.dataclass(frozen=True)
class UniformLinks(NetworkModel):
    """Every link i.i.d. from one latency model, uniformly scaled.

    The link-resolved generalization of the legacy scalar sampling: a
    receiver's Phase-2 completion becomes the max over its incoming
    links instead of one draw.
    """

    model: LatencyModel = Deterministic(1.0)
    scale: float = 0.1

    def sample_links(self, rng, n):
        share = self.scale * self.model.sample(rng, n)
        link = self._zero_diag(
            self.scale * self.model.sample(rng, n * n).reshape(n, n)
        )
        uplink = self.scale * self.model.sample(rng, n)
        return share, link, uplink


@dataclasses.dataclass(frozen=True)
class AsymmetricLinks(NetworkModel):
    """Asymmetric master downlink / D2D fabric / master uplink.

    Last-mile edge connectivity is uplink-constrained: the Phase-3
    worker -> master responses ride the slow direction while Phase-1
    share delivery rides the fast one.  Each direction draws from the
    same latency model under its own scale.
    """

    model: LatencyModel = Deterministic(1.0)
    down_scale: float = 0.1  # master -> worker (Phase-1 shares)
    d2d_scale: float = 0.1  # worker <-> worker (Phase-2 exchange)
    up_scale: float = 0.5  # worker -> master (Phase-3 responses)

    def sample_links(self, rng, n):
        share = self.down_scale * self.model.sample(rng, n)
        link = self._zero_diag(
            self.d2d_scale * self.model.sample(rng, n * n).reshape(n, n)
        )
        uplink = self.up_scale * self.model.sample(rng, n)
        return share, link, uplink


@dataclasses.dataclass(frozen=True)
class ClusteredEdge(NetworkModel):
    """Workers in round-robin clusters; inter-cluster links are slow.

    Worker ``w`` belongs to cluster ``w % n_clusters``.  Intra-cluster
    Phase-2 links scale by ``intra_scale``, inter-cluster by
    ``inter_scale``; master links (Phase 1 / Phase 3) by
    ``master_scale``.  Models the paper's edge setting where devices
    hang off a few access points: D2D within an access point is cheap,
    crossing between them is not.
    """

    model: LatencyModel = Deterministic(1.0)
    n_clusters: int = 2
    intra_scale: float = 0.05
    inter_scale: float = 0.5
    master_scale: float = 0.1

    def sample_links(self, rng, n):
        share = self.master_scale * self.model.sample(rng, n)
        raw = self.model.sample(rng, n * n).reshape(n, n)
        cluster = np.arange(n) % self.n_clusters
        same = cluster[:, None] == cluster[None, :]
        link = self._zero_diag(
            np.where(same, self.intra_scale, self.inter_scale) * raw
        )
        uplink = self.master_scale * self.model.sample(rng, n)
        return share, link, uplink


# ----------------------------------------------------------------------
# fault injection
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Bernoulli fault probabilities, applied per worker."""

    straggler_frac: float = 0.0
    straggler_slowdown: float = 10.0
    dropout_frac: float = 0.0
    crash_after_phase2_frac: float = 0.0
    corrupt_frac: float = 0.0


NO_FAULTS = FaultSpec()


@dataclasses.dataclass(frozen=True)
class WorkerTrace:
    """Replayable behaviour of every provisioned worker.

    All arrays are length ``n`` (the pool size).  Delays are in
    arbitrary time units; the scheduler only compares and adds them.
    """

    share_delay: np.ndarray  # Phase-1 share delivery to worker n
    compute_delay: np.ndarray  # Phase-2a H(alpha_n) compute duration
    d2d_delay: np.ndarray  # Phase-2 exchange receive delay at worker n
    uplink_delay: np.ndarray  # Phase-3 response delay worker -> master
    dropout: np.ndarray  # bool
    crash_after_phase2: np.ndarray  # bool
    corrupt: np.ndarray  # bool
    # Optional [n, n] Phase-2 link matrix: link_delay[s, r] is the
    # sender-s -> receiver-r exchange delay (diagonal 0; np.inf = dead
    # link).  None = legacy scalar model: every incoming link of
    # receiver r costs d2d_delay[r].
    link_delay: Optional[np.ndarray] = None
    # Optional time-varying fabric: sorted (start_time, [n, n] matrix)
    # entries.  From ``start_time`` onward the entry's matrix replaces
    # ``link_delay`` for Phase-2 exchange legs *sent* at or after that
    # time; before the first entry ``link_delay`` applies.  Attached by
    # ``TimeVaryingLinks.apply`` (explicit matrices, no extra random
    # draws, so the pre-degradation replay is byte-identical).
    link_schedule: Optional[Tuple[Tuple[float, np.ndarray], ...]] = None
    # The *configured* fault model this trace was sampled under — what
    # the master legitimately knows about the pool (it provisioned it),
    # as opposed to the sampled fault flags above, which are ground
    # truth the master must never peek at.  ``verify_extras="auto"`` and
    # ``error_budget="auto"`` resolve from this; ``None`` means "no
    # fault model declared" (hand-built traces), which resolves to no
    # protection.
    fault_model: Optional[FaultSpec] = None

    @property
    def n(self) -> int:
        return int(self.share_delay.size)

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name in ("link_delay", "link_schedule", "fault_model"):
                continue
            arr = getattr(self, f.name)
            if arr.shape != (self.n,):
                raise ValueError(f"{f.name} must be a [{self.n}] vector")
        if self.link_delay is not None and self.link_delay.shape != (self.n, self.n):
            raise ValueError(
                f"link_delay must be a [{self.n}, {self.n}] matrix, "
                f"got {self.link_delay.shape}"
            )
        if self.link_schedule is not None:
            if self.link_delay is None:
                raise ValueError(
                    "link_schedule needs a base link_delay matrix "
                    "(materialize with with_links first)"
                )
            for start, mat in self.link_schedule:
                if mat.shape != (self.n, self.n):
                    raise ValueError(
                        f"link_schedule matrix at t={start} must be "
                        f"[{self.n}, {self.n}], got {mat.shape}"
                    )

    def link_at(self, t: float) -> Optional[np.ndarray]:
        """Phase-2 link matrix in effect for exchanges sent at time ``t``.

        ``None`` when the trace is scalar (no link matrix at all);
        otherwise the latest scheduled matrix whose start time is
        <= ``t``, falling back to ``link_delay`` before the first one.
        """
        mat = self.link_delay
        if self.link_schedule:
            for start, m in self.link_schedule:
                if t >= start:
                    mat = m
        return mat

    def _copy_fields(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            arr = getattr(self, f.name)
            if arr is None:
                out[f.name] = None
            elif f.name == "link_schedule":
                out[f.name] = tuple((s, m.copy()) for s, m in arr)
            elif f.name == "fault_model":
                out[f.name] = arr  # frozen spec, shared by reference
            else:
                out[f.name] = arr.copy()
        return out

    def take(self, n: int) -> "WorkerTrace":
        """First-n-workers prefix (replay one trace across schemes).

        The link matrices slice ``[:n, :n]`` — a prefix pool keeps
        exactly the sub-fabric among its own workers.
        """
        if n > self.n:
            raise ValueError(f"trace holds {self.n} workers, need {n}")
        return self.select(np.arange(n))

    def select(self, ids: Sequence[int]) -> "WorkerTrace":
        """Arbitrary-membership sub-pool (elastic workers join/leave).

        Generalizes ``take``: the returned trace covers exactly the
        workers in ``ids`` (in the given order), with link matrices
        sliced to the sub-fabric among them, so a worker keeps
        byte-identical behaviour across every replay it attends.
        """
        idx = self._checked_ids("select ids", ids)
        out = {}
        for f in dataclasses.fields(self):
            arr = getattr(self, f.name)
            if arr is None:
                out[f.name] = None
            elif f.name == "link_delay":
                out[f.name] = arr[np.ix_(idx, idx)].copy()
            elif f.name == "link_schedule":
                out[f.name] = tuple(
                    (s, m[np.ix_(idx, idx)].copy()) for s, m in arr
                )
            elif f.name == "fault_model":
                out[f.name] = arr  # pool-level configuration, id-free
            else:
                out[f.name] = arr[idx].copy()
        return WorkerTrace(**out)

    def with_link_matrix(self, link: np.ndarray) -> "WorkerTrace":
        """Attach an explicit [n, n] Phase-2 link matrix.

        Validates the documented invariants beyond the shape check of
        ``__post_init__``: entries are non-negative and not NaN
        (``np.inf`` marks a dead link), and the diagonal is 0 — a
        worker's own contribution crosses no link, so a nonzero
        diagonal would silently add a phantom self-exchange delay.
        """
        link = np.asarray(link, float)
        if np.isnan(link).any() or (link < 0).any():
            raise ValueError("link_delay entries must be >= 0 (inf = dead)")
        if link.ndim == 2 and link.shape[0] == link.shape[1] and (
            np.diag(link) != 0.0
        ).any():
            raise ValueError("link_delay diagonal must be 0 (no self-link)")
        return dataclasses.replace(self, link_delay=link)

    def with_links(self) -> "WorkerTrace":
        """Materialize the scalar D2D model as an equivalent link matrix.

        Every incoming link of receiver ``r`` costs ``d2d_delay[r]``
        (receiver-constant columns, diagonal 0), so a replay is
        timeline-identical to the scalar trace — the starting point for
        link-level edits such as ``with_dropped_links``.
        """
        link = np.broadcast_to(self.d2d_delay[None, :], (self.n, self.n)).copy()
        np.fill_diagonal(link, 0.0)
        return dataclasses.replace(self, link_delay=link)

    def with_dropped_links(
        self, links: Sequence[Tuple[int, int]]
    ) -> "WorkerTrace":
        """Mark directed Phase-2 links (sender, receiver) as dead.

        A dead incoming link from a *Phase-2 sender* starves the
        receiver's I(alpha_n) sum, so the receiver never responds in
        Phase 3 — but unlike a dropped *worker* it still computes and
        serves as a Phase-2 sender itself.  A dead link whose sender
        ends up outside the fastest-``n_workers`` set is harmless
        (receivers only sum the senders' contributions), so experiments
        that need the starvation should check the sender landed in
        ``RunMetrics.phase2_ids``.  Materializes the link matrix if the
        trace is still scalar.
        """
        base = self if self.link_delay is not None else self.with_links()
        link = base.link_delay.copy()
        for s, r in links:
            s = int(s)
            r = int(r)
            if not (0 <= s < self.n and 0 <= r < self.n):
                raise ValueError(
                    f"link ({s}, {r}) out of range for a pool of {self.n}"
                )
            if s == r:
                raise ValueError(f"link ({s}, {r}) is a self-loop")
            link[s, r] = np.inf
        return dataclasses.replace(base, link_delay=link)

    def _checked_ids(self, name: str, ids: Sequence[int]) -> np.ndarray:
        """Validate explicit worker indices against the pool size.

        numpy fancy indexing would silently wrap negatives and raise an
        opaque IndexError past ``n``; fault placement demands exact
        worker identities, so reject out-of-range and duplicate ids with
        a pool-aware error instead.
        """
        arr = np.asarray(list(ids), dtype=np.int64)
        if arr.size == 0:
            return arr
        bad = arr[(arr < 0) | (arr >= self.n)]
        if bad.size:
            raise ValueError(
                f"{name} indices {bad.tolist()} out of range for a pool "
                f"of {self.n} workers (need 0 <= id < {self.n})"
            )
        if np.unique(arr).size != arr.size:
            raise ValueError(f"{name} contains duplicate worker indices: {arr.tolist()}")
        return arr

    def with_faults(
        self,
        dropout_ids: Sequence[int] = (),
        crash_ids: Sequence[int] = (),
        corrupt_ids: Sequence[int] = (),
        straggler_ids: Sequence[int] = (),
        straggler_slowdown: float = 10.0,
    ) -> "WorkerTrace":
        """Deterministic fault placement on explicit worker indices.

        Explicit placement is a *configuration* act, so the trace's
        ``fault_model`` is updated to admit at least the placed fraction
        of each fault class: the master learns "corruption is possible
        on this pool" (which it would know, having configured it), never
        *which* workers the flags landed on.
        """
        out = self._copy_fields()
        drop = self._checked_ids("dropout_ids", dropout_ids)
        crash = self._checked_ids("crash_ids", crash_ids)
        corr = self._checked_ids("corrupt_ids", corrupt_ids)
        out["dropout"][drop] = True
        out["crash_after_phase2"][crash] = True
        out["corrupt"][corr] = True
        sl = self._checked_ids("straggler_ids", straggler_ids)
        out["compute_delay"][sl] = out["compute_delay"][sl] * straggler_slowdown
        fm = out["fault_model"] or NO_FAULTS
        out["fault_model"] = dataclasses.replace(
            fm,
            dropout_frac=max(fm.dropout_frac, drop.size / self.n),
            crash_after_phase2_frac=max(
                fm.crash_after_phase2_frac, crash.size / self.n
            ),
            corrupt_frac=max(fm.corrupt_frac, corr.size / self.n),
        )
        return WorkerTrace(**out)._disjoint()

    def _disjoint(self) -> "WorkerTrace":
        crash = self.crash_after_phase2 & ~self.dropout
        corrupt = self.corrupt & ~self.dropout & ~crash
        return dataclasses.replace(self, crash_after_phase2=crash, corrupt=corrupt)


# ----------------------------------------------------------------------
# time-varying links and elastic pools (the auto-planner's scenarios)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TimeVaryingLinks:
    """Deterministic mid-replay Phase-2 link degradation schedule.

    ``schedule`` holds ``(start_time, factor)`` entries with strictly
    increasing non-negative start times: from ``start_time`` onward
    every Phase-2 link delay is the trace's base matrix scaled by
    ``factor`` (> 1 degrades, < 1 recovers; the 0 diagonal and dead
    ``inf`` links are preserved by scaling).  ``apply`` attaches the
    schedule to a trace as explicit matrices — no extra random draws —
    so the replay before the first start time is byte-identical to the
    base trace, and the scheduled trace prefix-slices (``take`` /
    ``select``) like any link-resolved trace.
    """

    schedule: Tuple[Tuple[float, float], ...]

    def __post_init__(self):
        starts = [float(s) for s, _ in self.schedule]
        if any(s < 0 for s in starts):
            raise ValueError("schedule start times must be >= 0")
        if any(b <= a for a, b in zip(starts, starts[1:])):
            raise ValueError("schedule start times must be strictly increasing")
        if any(float(f) <= 0 for _, f in self.schedule):
            raise ValueError("schedule factors must be > 0")

    def apply(self, trace: WorkerTrace) -> WorkerTrace:
        base = trace if trace.link_delay is not None else trace.with_links()
        entries = tuple(
            (float(s), base.link_delay * float(f)) for s, f in self.schedule
        )
        return dataclasses.replace(base, link_schedule=entries)


@dataclasses.dataclass(frozen=True)
class ElasticPool:
    """Per-replay worker membership over one master trace.

    ``master`` records the behaviour of every worker that ever appears;
    ``membership[k]`` lists the ids present for replay ``k``, so
    workers join and leave between replays while each attending
    worker's behaviour stays byte-identical (every replay trace is a
    ``select`` of the same master draw — an elastic replay equals a
    static run over the same members).  A shrinking pool is what forces
    an auto-planner to re-fit spares or switch constructions between
    replays.  Iterating yields the per-replay traces.
    """

    master: WorkerTrace
    membership: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        norm = tuple(tuple(int(i) for i in ids) for ids in self.membership)
        object.__setattr__(self, "membership", norm)
        for k, ids in enumerate(norm):
            self.master._checked_ids(f"membership[{k}]", ids)

    @property
    def depth(self) -> int:
        return len(self.membership)

    def sizes(self) -> Tuple[int, ...]:
        return tuple(len(ids) for ids in self.membership)

    def trace_for(self, k: int) -> WorkerTrace:
        return self.master.select(self.membership[k])

    def __len__(self) -> int:
        return self.depth

    def __iter__(self):
        return (self.trace_for(k) for k in range(self.depth))


def sample_trace(
    n: int,
    latency: Optional[LatencyModel] = None,
    faults: FaultSpec = NO_FAULTS,
    seed: int = 0,
    net_scale: float = 0.1,
    network: Optional[NetworkModel] = None,
) -> WorkerTrace:
    """Sample one replayable trace for a pool of ``n`` workers.

    ``latency`` drives the compute-time draw.  Without ``network``, the
    three network delays (share delivery, D2D exchange, uplink) are
    independent per-worker draws from the same model scaled by
    ``net_scale`` (edge links are fast relative to compute, but share
    the same tail shape).  With a ``network`` model the delays are
    link-resolved instead: ``share_delay`` / ``uplink_delay`` become
    the master links and the trace carries the full ``link_delay[s, r]``
    Phase-2 matrix (``net_scale`` is then unused; ``d2d_delay`` is kept
    as the per-receiver mean of its incoming links — a display summary
    the scheduler ignores once the matrix is present).

    Draw order is fixed, so two calls with the same seed, ``n``, and
    model arguments are identical — but traces of different ``n`` are
    *not* prefixes of each other; sample once at the largest pool size
    and ``take`` prefixes when several schemes must see identical
    worker (and link) behaviour.
    """
    latency = latency or Deterministic()
    rng = np.random.default_rng(seed)
    compute = latency.sample(rng, n)
    if network is None:
        share = net_scale * latency.sample(rng, n)
        d2d = net_scale * latency.sample(rng, n)
        uplink = net_scale * latency.sample(rng, n)
        link = None
    else:
        share, link, uplink = network.sample_links(rng, n)
        off_diag = link.sum(axis=0) / max(n - 1, 1)  # incoming mean, diag is 0
        d2d = off_diag
    straggler = rng.random(n) < faults.straggler_frac
    compute = np.where(straggler, compute * faults.straggler_slowdown, compute)
    trace = WorkerTrace(
        share_delay=share,
        compute_delay=compute,
        d2d_delay=d2d,
        uplink_delay=uplink,
        dropout=rng.random(n) < faults.dropout_frac,
        crash_after_phase2=rng.random(n) < faults.crash_after_phase2_frac,
        corrupt=rng.random(n) < faults.corrupt_frac,
        link_delay=link,
        fault_model=faults,
    )
    return trace._disjoint()
