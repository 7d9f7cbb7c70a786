"""The port's edge runtime against the JAX package's, on the same inputs.

The same ``WorkerTrace`` (sampled by the reference, carried across with
``convert.worker_trace_from_reference``) and the same seed go through
``repro.runtime`` and ``repro_torch.runtime`` (``device="cpu"``).  The
event loop, the decode search and every numpy-rng draw are the
reference's, so every comparison is exact: Y, every ``RunMetrics`` /
``PipelineMetrics`` field, the planner's decisions, the runtime
counters and the simulated trace records.  On the batched paths the
unfused secrets come from different generators by construction (the
reference draws them with ``jax.random.randint``); Y and the metrics do
not depend on them.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro import runtime as R
from repro.core import constructions as rc
from repro.core import planner as rpl
from repro.core.constructions import PlanConfig as RPlanConfig
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch import runtime as T
from repro_torch.core import constructions as tc
from repro_torch.core import planner as tpl
from repro_torch.core.constructions import PlanConfig as TPlanConfig

P = 65521
SHAPES = dict(k=8, ma=8, mb=4, s=2, t=2)


@pytest.fixture(scope="module")
def setup():
    rplan = rpl.make_plan(rc.build_scheme("age", 2, 2, 2), rpl.BlockShapes(**SHAPES), n_spare=3, seed=1)
    tplan = tpl.make_plan(tc.build_scheme("age", 2, 2, 2), tpl.BlockShapes(**SHAPES), n_spare=3, seed=1)
    rng = np.random.default_rng(0)
    a = rng.integers(0, P, (3, 8, 8))
    b = rng.integers(0, P, (3, 8, 4))
    want = np.einsum("bki,bkj->bij", a.astype(object), b.astype(object)) % P
    return rplan, tplan, a, b, want.astype(np.int64)


def _carry(rtrace):
    return convert.worker_trace_from_reference(
        {f.name: getattr(rtrace, f.name) for f in dataclasses.fields(rtrace)}
    )


def _fastest(trace):
    """Worker ids by their standalone response time, fastest first."""
    t = trace.share_delay + trace.compute_delay + trace.d2d_delay + trace.uplink_delay
    return [int(w) for w in np.argsort(t, kind="stable")]


def _reference_trace(name: str, n: int):
    """The scenarios of ``benchmarks/edge_runtime.py`` plus link-resolved,
    time-varying, crash and heavy-corruption traces.  Corrupt workers sit
    among the fastest responders, so that the decode must reject or
    correct them."""
    if name == "all_fast":
        return R.sample_trace(n, R.Deterministic(1.0), seed=2)
    if name == "stragglers_exp":
        return R.sample_trace(
            n, R.ShiftedExponential(1.0, 1.0),
            R.FaultSpec(straggler_frac=0.2, straggler_slowdown=10.0), seed=3,
        )
    if name == "dropouts":
        return R.sample_trace(n, R.ShiftedExponential(1.0, 0.5), seed=4).with_faults(
            dropout_ids=[0, 1, 2]
        )
    if name == "heavy_tail_corrupt":
        base = R.sample_trace(n, R.HeavyTail(1.0, 0.5, 1.5), seed=5)
        return base.with_faults(corrupt_ids=[_fastest(base)[1]])
    if name == "clustered_edge":
        base = R.sample_trace(
            n, R.ShiftedExponential(1.0, 0.5), seed=6,
            network=R.ClusteredEdge(R.ShiftedExponential(1.0, 1.0), n_clusters=3),
        )
        return base.with_faults(corrupt_ids=[_fastest(base)[0]])
    if name == "time_varying_links":
        base = R.sample_trace(
            n, R.ShiftedExponential(1.0, 0.5), seed=7,
            network=R.UniformLinks(R.ShiftedExponential(0.2, 0.2), scale=0.3),
        )
        return R.TimeVaryingLinks(((0.5, 2.0), (1.5, 4.0))).apply(base)
    if name == "crash_after_phase2":
        base = R.sample_trace(n, R.ShiftedExponential(1.0, 0.5), seed=8)
        fast = _fastest(base)
        return base.with_faults(crash_ids=[fast[0], 5], corrupt_ids=[fast[2]])
    if name == "heavy_corruption":
        base = R.sample_trace(n, R.ShiftedExponential(1.0, 0.5), seed=9)
        return base.with_faults(corrupt_ids=_fastest(base)[1:8:2])
    raise ValueError(name)


# a short subset search, so that heavy corruption reaches its random tail
SEARCH = {"heavy_corruption": dict(max_subset_tries=6)}


SCENARIOS = ("all_fast", "stragglers_exp", "dropouts", "heavy_tail_corrupt",
             "clustered_edge", "time_varying_links", "crash_after_phase2",
             "heavy_corruption")
MODES = ("detect", "correct", "auto", "hybrid")


def _equal(x, y, what):
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=what)
    elif dataclasses.is_dataclass(x):
        assert type(x).__name__ == type(y).__name__, what
        for f in dataclasses.fields(x):
            _equal(getattr(x, f.name), getattr(y, f.name), f"{what}.{f.name}")
    elif isinstance(x, (tuple, list)):
        assert len(x) == len(y), what
        for i, (xi, yi) in enumerate(zip(x, y)):
            _equal(xi, yi, f"{what}[{i}]")
    elif isinstance(x, float) and np.isnan(x):
        assert np.isnan(y), what
    else:
        assert x == y, (what, x, y)


def _counters(registry, names=("runtime.replays", "runtime.bw_attempts",
                               "runtime.decode_failures", "bw.combine_attempts",
                               "bw.combine_exhausted")):
    return {n: registry.counter(n).value for n in names}


# ----------------------------------------------------------------------
# traces
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", SCENARIOS)
def test_carried_trace_equals_reference(name):
    rtrace = _reference_trace(name, 20)
    ttrace = _carry(rtrace)
    _equal(rtrace, ttrace, name)
    assert isinstance(ttrace, T.WorkerTrace) and isinstance(ttrace.fault_model, T.FaultSpec)


def _models(pkg):
    faults = pkg.FaultSpec(straggler_frac=0.2, dropout_frac=0.1, crash_after_phase2_frac=0.1,
                           corrupt_frac=0.1)
    return [
        dict(latency=pkg.Deterministic(1.0)),
        dict(latency=pkg.ShiftedExponential(1.0, 1.0), faults=faults),
        dict(latency=pkg.HeavyTail(1.0, 0.5, 1.5), faults=faults, net_scale=0.2),
        dict(latency=pkg.ShiftedExponential(1.0, 0.5),
             network=pkg.ClusteredEdge(pkg.ShiftedExponential(1.0, 1.0), n_clusters=3)),
        dict(latency=pkg.ShiftedExponential(1.0, 0.5),
             network=pkg.AsymmetricLinks(pkg.ShiftedExponential(0.2, 0.2))),
    ]


@pytest.mark.parametrize("case", range(5))
def test_sample_trace_equals_reference(case):
    for seed in (0, 3):
        rtrace = R.sample_trace(20, seed=seed, **_models(R)[case])
        ttrace = T.sample_trace(20, seed=seed, **_models(T)[case])
        _equal(rtrace, ttrace, f"model {case} seed {seed}")


def test_worker_trace_from_reference_rejects_bad_fields():
    fields = {f.name: getattr(_reference_trace("all_fast", 5), f.name)
              for f in dataclasses.fields(R.WorkerTrace)}
    with pytest.raises(ValueError, match="unknown"):
        convert.worker_trace_from_reference(dict(fields, bogus=1))
    with pytest.raises(ValueError, match="lacks"):
        convert.worker_trace_from_reference({k: v for k, v in fields.items() if k != "corrupt"})


# ----------------------------------------------------------------------
# run_over_pool / run_batch_over_pool
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCENARIOS)
def test_runs_over_pool_equal_reference(setup, name, mode):
    rplan, tplan, a, b, want = setup
    rtrace = _reference_trace(name, rplan.n_total)
    ttrace = _carry(rtrace)
    kw = dict(seed=11, decode_mode=mode, verify_extras="auto", error_budget="auto",
              **SEARCH.get(name, {}))
    if mode == "hybrid":
        rstate, tstate = R.HybridState(), T.HybridState()
        # a pool that already rejected someone: hybrid escalates to BW
        rstate.escalated = tstate.escalated = "corrupt" in name
        kw_r, kw_t = dict(kw, hybrid_state=rstate), dict(kw, hybrid_state=tstate)
    else:
        kw_r = kw_t = kw
    before = _counters(tobs.REGISTRY), _counters(robs.REGISTRY)
    r1 = R.run_over_pool(rplan, a[0], b[0], rtrace, **kw_r)
    t1 = T.run_over_pool(tplan, a[0], b[0], ttrace, device="cpu", **kw_t)
    np.testing.assert_array_equal(t1.y, r1.y)
    np.testing.assert_array_equal(t1.y, want[0])
    _equal(r1.metrics, t1.metrics, f"{name}/{mode} run_over_pool")
    r2 = R.run_batch_over_pool(rplan, a, b, rtrace, **kw_r)
    t2 = T.run_batch_over_pool(tplan, a, b, ttrace, device="cpu", **kw_t)
    np.testing.assert_array_equal(t2.y, r2.y)
    np.testing.assert_array_equal(t2.y, want)
    _equal(r2.metrics, t2.metrics, f"{name}/{mode} run_batch_over_pool")
    assert len(t2.per_product) == len(r2.per_product) == 3
    for mr, mt in zip(r2.per_product, t2.per_product):
        _equal(mr, mt, f"{name}/{mode} per product")
    if mode == "hybrid":
        _equal(rstate, tstate, "hybrid state")
    after = _counters(tobs.REGISTRY), _counters(robs.REGISTRY)
    deltas = [{k: a_[k] - b_[k] for k in a_} for a_, b_ in zip(after, before)]
    assert deltas[0] == deltas[1]


def _failure_message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("case", ["too_many_dropouts", "detect_exhausted", "correct_exhausted"])
def test_decode_failures_equal_reference(setup, case):
    rplan, tplan, a, b, _ = setup
    n = rplan.n_total
    base = R.sample_trace(n, R.ShiftedExponential(1.0, 0.5), seed=21)
    if case == "too_many_dropouts":
        rtrace, kw = base.with_faults(dropout_ids=range(4)), {}
    elif case == "detect_exhausted":
        rtrace = base.with_faults(corrupt_ids=range(8), crash_ids=range(8, 12))
        kw = dict(decode_mode="detect", verify_extras=2, max_subset_tries=4)
    else:
        rtrace = base.with_faults(corrupt_ids=range(8))
        kw = dict(decode_mode="correct", error_budget=1)
    ttrace = _carry(rtrace)
    for rfn, tfn, x, y in ((R.run_over_pool, T.run_over_pool, a[0], b[0]),
                           (R.run_batch_over_pool, T.run_batch_over_pool, a, b)):
        want = _failure_message(lambda: rfn(rplan, x, y, rtrace, seed=3, **kw))
        got = _failure_message(lambda: tfn(tplan, x, y, ttrace, seed=3, device="cpu", **kw))
        assert want[0] == "DecodeFailure"
        assert got == want


# ----------------------------------------------------------------------
# the pipeline and the auto-planner
# ----------------------------------------------------------------------
def test_pipeline_session_and_run_pipeline_equal_reference(setup):
    rplan, tplan, a, b, want = setup
    names = ("stragglers_exp", "heavy_tail_corrupt", "time_varying_links")
    rtraces = [_reference_trace(nm, rplan.n_total) for nm in names]
    ttraces = [_carry(t) for t in rtraces]
    stack_a = np.stack([a[:2]] * 3)
    stack_b = np.stack([b[:2]] * 3)
    kw = dict(seed=4, decode_mode="hybrid", master_decode_cost=0.05)
    rrun = R.run_pipeline_over_pool(rplan, stack_a, stack_b, rtraces, **kw)
    trun = T.run_pipeline_over_pool(tplan, stack_a, stack_b, ttraces, device="cpu", **kw)
    np.testing.assert_array_equal(trun.y, rrun.y)
    np.testing.assert_array_equal(trun.y[1], want[:2])
    _equal(rrun.metrics, trun.metrics, "PipelineMetrics")
    for mr, mt in zip(rrun.replay_metrics, trun.replay_metrics):
        _equal(mr, mt, "replay metrics")

    # appends with request floors and changing batch sizes
    rses = R.PipelineSession(rplan, seed=9, decode_mode="correct", error_budget=1)
    tses = T.PipelineSession(tplan, seed=9, decode_mode="correct", error_budget=1, device="cpu")
    for k, (nb, floor) in enumerate(((1, 0.0), (3, 0.4), (2, 5.0))):
        rr = rses.append(a[:nb], b[:nb], rtraces[k], not_before=floor)
        tr = tses.append(a[:nb], b[:nb], ttraces[k], not_before=floor)
        np.testing.assert_array_equal(tr.y, rr.y)
        for field in ("index", "start", "completion", "batch"):
            assert getattr(tr, field) == getattr(rr, field), field
        _equal(rr.metrics, tr.metrics, f"append {k}")
        assert tses.ready_at(2) == rses.ready_at(2)
        assert tses.next_start() == rses.next_start()
    _equal(rses.result().metrics, tses.result().metrics, "session PipelineMetrics")


def _cands(PlanConfig):
    return [PlanConfig("age", 2, 2, 2), PlanConfig("age", 4, 1, 2), PlanConfig("polydot", 2, 2, 2)]


def test_adaptive_over_elastic_pool_equal_reference():
    m, big, small = 8, 20, 12
    rmaster = R.sample_trace(
        big, R.ShiftedExponential(1.0, 0.5), R.FaultSpec(corrupt_frac=0.05), seed=42,
        network=R.UniformLinks(R.ShiftedExponential(0.2, 0.2), scale=0.3),
    )
    membership = (tuple(range(big)),) * 3 + (tuple(range(small)),)
    rpool = R.ElasticPool(rmaster, membership)
    tpool = T.ElasticPool(_carry(rmaster), membership)
    rng = np.random.default_rng(7)
    a = rng.integers(0, P, (len(membership), 2, m, m))
    b = rng.integers(0, P, (len(membership), 2, m, m))
    rplanner = R.AutoPlanner(_cands(RPlanConfig), window=6)
    tplanner = T.AutoPlanner(_cands(TPlanConfig), window=6)
    rrun = R.run_adaptive_over_pool(rplanner, a, b, rpool, seed=2, decode_mode="auto")
    trun = T.run_adaptive_over_pool(tplanner, a, b, tpool, seed=2, decode_mode="auto",
                                    device="cpu")
    np.testing.assert_array_equal(trun.y, rrun.y)
    assert len(trun.decisions) == len(rrun.decisions) == len(membership)
    for dr, dt in zip(rrun.decisions, trun.decisions):
        assert dt.config.label() == dr.config.label()
        assert (dt.replay, dt.pool_size, dt.predicted, dt.reason, dt.switched, dt.respared) == (
            dr.replay, dr.pool_size, dr.predicted, dr.reason, dr.switched, dr.respared)
    for mr, mt in zip(rrun.replay_metrics, trun.replay_metrics):
        _equal(mr, mt, "adaptive replay")
    assert trun.decisions[-1].pool_size == small

    # the same planner choices inside the pipeline
    rtraces = [R.sample_trace(17, R.ShiftedExponential(1.0, 0.5), seed=s) for s in (1, 2, 3)]
    rp = R.run_pipeline_over_pool(None, a[:3], b[:3], rtraces, planner=R.AutoPlanner(_cands(RPlanConfig)))
    tp = T.run_pipeline_over_pool(None, a[:3], b[:3], [_carry(t) for t in rtraces],
                                  planner=T.AutoPlanner(_cands(TPlanConfig)), device="cpu")
    np.testing.assert_array_equal(tp.y, rp.y)
    _equal(rp.metrics, tp.metrics, "planned pipeline")


# ----------------------------------------------------------------------
# observability
# ----------------------------------------------------------------------
def _sim_records(tracer):
    """Simulated records with trace ids renumbered by their position (the
    wall records between them differ: the reference also logs its jit
    lowering)."""
    sims = [dict(e) for e in tracer.events if e["clock"] == "sim"]
    ids = {e["id"]: i + 1 for i, e in enumerate(sims)}
    for e in sims:
        e["id"] = ids[e["id"]]
        e["parent"] = ids.get(e["parent"], 0)
    return sims


def _wall_span_names(tracer, prefixes=("protocol.", "runtime.")):
    return sorted(e["name"] for e in tracer.events
                  if e["clock"] == "wall" and e["kind"] == "span" and e["name"].startswith(prefixes))


def test_tracer_records_equal_reference(setup):
    rplan, tplan, a, b, _ = setup
    rtrace = _reference_trace("heavy_tail_corrupt", rplan.n_total)
    ttrace = _carry(rtrace)
    records = {}
    for name, tracer, rt, fn in (
        ("reference", robs.TRACER, R, lambda m: R.run_batch_over_pool(
            rplan, a, b, rtrace, seed=1, decode_mode=m, obs_attrs={"replay": 2})),
        ("port", tobs.TRACER, T, lambda m: T.run_batch_over_pool(
            tplan, a, b, ttrace, seed=1, decode_mode=m, obs_attrs={"replay": 2}, device="cpu")),
    ):
        tracer.clear()
        tracer.enable()
        try:
            fn("detect")
            fn("correct")
            if name == "reference":
                R.run_over_pool(rplan, a[0], b[0], rtrace, seed=1)
            else:
                T.run_over_pool(tplan, a[0], b[0], ttrace, seed=1, device="cpu")
        finally:
            tracer.disable()
        records[name] = (_sim_records(tracer), _wall_span_names(tracer))
        tracer.clear()
    (rsim, rwall), (tsim, twall) = records["reference"], records["port"]
    assert len(tsim) > 0 and tsim == rsim
    assert robs.to_chrome(rsim) == tobs.to_chrome(tsim)
    assert tobs.validate_chrome(tobs.to_chrome(tsim)) == []
    assert tobs.to_jsonl(tsim) == robs.to_jsonl(rsim)
    # the protocol and runtime wall spans: the same names, as often
    assert twall == rwall
    assert "protocol.phase3.subset_search" in twall and "protocol.phase1.share_a" in twall


# ----------------------------------------------------------------------
# guards
# ----------------------------------------------------------------------
def test_runtime_entry_points_refuse_to_run_without_a_gpu_or_a_device(setup, monkeypatch):
    _, tplan, a, b, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace = T.sample_trace(tplan.n_total, T.Deterministic(1.0), seed=2)
    calls = [
        lambda: T.run_over_pool(tplan, a[0], b[0], trace),
        lambda: T.run_batch_over_pool(tplan, a, b, trace),
        lambda: T.run_pipeline_over_pool(tplan, a[None], b[None], [trace]),
        lambda: T.PipelineSession(tplan),
        lambda: T.run_adaptive_over_pool(T.AutoPlanner(_cands(TPlanConfig)), a[None], a[None], [trace]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
