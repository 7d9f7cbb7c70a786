"""The port's serving tier against the JAX package's, on the same inputs.

Counterparts of the engine tests of ``tests/test_serve.py``.  Each
scenario runs twice: through ``repro.serve`` and through
``repro_torch.serve`` (``device="cpu"``), with the same weight, request
rows and arrival times (numpy, from one seed) and the same worker
traces (sampled by the reference, carried across with
``convert.worker_trace_from_reference``).  Every comparison is exact:
each request's state, shed reason, launch, completion, replay and y;
``EngineReport.summary()``; the engine's observed runs; the serve
counters; and the simulated trace records with the tracer on.  The
reference test's own assertions are then checked on the port's result.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro import runtime as R
from repro import serve as RS
from repro.core import constructions as rc
from repro.core import gf as rgf
from repro.core import planner as rpl
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch import runtime as T
from repro_torch import serve as TS
from repro_torch.core import constructions as tc
from repro_torch.core import gf as tgf
from repro_torch.core import layers as tl
from repro_torch.core import planner as tpl

CFG = ("age", 2, 2, 1)
N_WORKERS = tc.PlanConfig(*CFG).n_workers
POOL = N_WORKERS + 2
K_DIM, OUT, ROWS = 16, 8, 4
COUNTERS = ("serve.requests", "serve.shed", "serve.replays", "serve.deadline_miss")


def _carry(rtrace):
    return convert.worker_trace_from_reference(
        {f.name: getattr(rtrace, f.name) for f in dataclasses.fields(rtrace)}
    )


def _traces(n, pool=POOL, seed0=100, latency=None, net_scale=0.3):
    latency = latency or R.ShiftedExponential(shift=0.1, scale=0.5)
    return [
        R.sample_trace(pool, latency, seed=seed0 + i, net_scale=net_scale)
        for i in range(n)
    ]


@dataclasses.dataclass
class Side:
    """One package's serving engine, fed reference-sampled traces."""

    port: bool
    serve: object
    PlanConfig: type
    Field: type
    tracer: object
    registry: object

    def engine(self, traces=None, config=CFG, **kw):
        rng = np.random.default_rng(0)
        w = rng.normal(size=(K_DIM, OUT))
        traces = traces if traces is not None else _traces(16)
        if self.port:
            traces = [_carry(t) for t in traces]
            kw["device"] = "cpu"
        eng = self.serve.ServingEngine(
            w, traces, self.PlanConfig(*config), field=self.Field(),
            seed=0, validate=True, **kw,
        )
        return eng, w, rng


REF = Side(False, RS, rc.PlanConfig, rgf.Field, robs.TRACER, robs.REGISTRY)
PORT = Side(True, TS, tc.PlanConfig, tgf.Field, tobs.TRACER, tobs.REGISTRY)


def _exact_y(x, w):
    """The engine's fixed-point answer, from first principles."""
    field = tgf.Field()
    s = tl.choose_scales(
        K_DIM, float(np.abs(x).max() + 1e-9), float(np.abs(w).max() + 1e-9), field.p
    )
    yq = field.matmul(field.encode(x.T, s).T, field.encode(w, s))
    return field.decode(yq, s * s)


# ----------------------------------------------------------------------
# the scenarios of tests/test_serve.py; each returns [(engine, report)]
# ----------------------------------------------------------------------
def _decode_exactly(side):
    eng, w, rng = side.engine()
    xs = [rng.normal(size=(ROWS, K_DIM)) * mag for mag in (0.1, 1.0, 30.0)]
    for i, x in enumerate(xs):
        eng.submit(x, 0.2 * i)
    return [(eng, eng.run())]


def _deadline_census(side):
    det = _traces(4, latency=R.Deterministic(1.0), net_scale=0.1)
    probe, _, rng = side.engine(traces=det)
    x = rng.normal(size=(ROWS, K_DIM))
    c = probe.submit(x, 0.0)
    runs = [(probe, probe.run())]
    completion = c.completion
    eng, _, _ = side.engine(traces=det)
    eng.submit(x, 0.0, deadline=completion + 0.5)
    eng.submit(x, 0.0, deadline=completion - 0.5)
    eng.submit(x, 0.0, deadline=completion)  # boundary: met
    return runs + [(eng, eng.run())]


def _sheds_hopeless(side):
    eng, _, rng = side.engine(slo=2.0)
    for i in range(12):
        eng.submit(rng.normal(size=(ROWS, K_DIM)), 0.05 * i)
    return [(eng, eng.run())]


def _drained(side):
    eng, _, rng = side.engine(slo=2.5)
    for i in range(10):
        eng.submit(rng.normal(size=(ROWS, K_DIM)), 0.1 * i)
    return [(eng, eng.run())]


def _pool_shrink(side):
    big = R.sample_trace(POOL, R.ShiftedExponential(0.1, 0.5), seed=7, net_scale=0.3)
    small = big.take(N_WORKERS - 2)
    eng, _, rng = side.engine(traces=[big, big] + [small] * 20)
    for i in range(8):
        eng.submit(rng.normal(size=(ROWS, K_DIM)), 3.0 * i)
    return [(eng, eng.run())]


def _degraded(side):
    det = _traces(8, latency=R.Deterministic(1.0), net_scale=0.1)
    base, _, rng = side.engine(traces=det, max_batch=4)
    xs = [rng.normal(size=(ROWS, K_DIM)) for _ in range(4)]
    for x in xs:
        base.submit(x, 0.0)
    runs = [(base, base.run())]
    eng, _, _ = side.engine(traces=det, max_batch=4)
    eng._predicted_service = lambda: (0.5, True)
    for x in xs:
        eng.submit(x, 0.0)
    return runs + [(eng, eng.run())]


def _continuous_vs_boundary(side):
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(24, ROWS, K_DIM))
    arrivals = np.cumsum(rng.exponential(1.4, 24))
    runs = []
    for mode in ("continuous", "boundary"):
        eng, _, _ = side.engine(traces=_traces(32), mode=mode)
        for x, t in zip(xs, arrivals):
            eng.submit(x, float(t))
        runs.append((eng, eng.run()))
    return runs


def _hybrid_escalates(side):
    pool = tc.PlanConfig("age", 2, 2, 2).n_workers + 6
    trace = R.sample_trace(pool, R.Deterministic(1.0), seed=2)
    trace = dataclasses.replace(trace, uplink_delay=0.1 + 0.01 * np.arange(pool))
    trace = trace.with_faults(corrupt_ids=[0])
    eng, _, rng = side.engine(
        traces=[trace], config=("age", 2, 2, 2), decode_mode="hybrid", verify_extras=2
    )
    for i in range(3):
        eng.submit(rng.normal(size=(ROWS, K_DIM)), 8.0 * i)
    return [(eng, eng.run())]


def _spans(side):
    eng, _, rng = side.engine(slo=2.0)
    for i in range(8):
        eng.submit(rng.normal(size=(ROWS, K_DIM)), 0.05 * i)
    return [(eng, eng.run())]


SCENARIOS = {
    "decode_exactly": _decode_exactly,
    "deadline_census": _deadline_census,
    "sheds_hopeless": _sheds_hopeless,
    "drained": _drained,
    "pool_shrink": _pool_shrink,
    "degraded": _degraded,
    "continuous_vs_boundary": _continuous_vs_boundary,
    "hybrid_escalates": _hybrid_escalates,
    "spans": _spans,
}


def _sim_records(tracer):
    """Simulated records with trace ids renumbered by their position."""
    sims = [dict(e) for e in tracer.events if e["clock"] == "sim"]
    ids = {e["id"]: i + 1 for i, e in enumerate(sims)}
    for e in sims:
        e["id"] = ids[e["id"]]
        e["parent"] = ids.get(e["parent"], 0)
    return sims


def _value(x):
    """A float as something that compares equal to itself when nan."""
    return "nan" if isinstance(x, float) and math.isnan(x) else x


def _request(r):
    return tuple(_value(getattr(r, f)) for f in (
        "rid", "state", "shed_reason", "arrival", "deadline", "launch", "completion", "replay"))


def _outcome(side, scenario):
    side.tracer.clear()
    side.tracer.enable()
    before = {n: side.registry.counter(n).value for n in COUNTERS}
    try:
        runs = SCENARIOS[scenario](side)
    finally:
        side.tracer.disable()
    counters = {n: side.registry.counter(n).value - before[n] for n in COUNTERS}
    sims = _sim_records(side.tracer)
    walls = sorted(e["name"] for e in side.tracer.events
                   if e["clock"] == "wall" and e["kind"] == "span"
                   and e["name"].startswith(("serve.", "runtime.")))
    side.tracer.clear()
    return runs, counters, sims, walls


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_equals_reference(scenario):
    rruns, rcount, rsim, rwall = _outcome(REF, scenario)
    truns, tcount, tsim, twall = _outcome(PORT, scenario)
    assert len(truns) == len(rruns)
    for i, ((reng, rrep), (teng, trep)) in enumerate(zip(rruns, truns)):
        assert trep.summary() == rrep.summary(), (scenario, i)
        assert len(trep.requests) == len(rrep.requests)
        for rr, tr in zip(rrep.requests, trep.requests):
            assert _request(tr) == _request(rr), (scenario, i, rr.rid)
            if rr.y is None:
                assert tr.y is None
            else:
                np.testing.assert_array_equal(tr.y, rr.y)
        assert [dataclasses.astuple(o) for o in teng._obs] == [
            dataclasses.astuple(o) for o in reng._obs]
        assert teng._queue == [] and reng._queue == []
        rstate, tstate = reng._session.hybrid_state, teng._session.hybrid_state
        assert (tstate is None) == (rstate is None)
        if rstate is not None:
            assert tstate.escalated == rstate.escalated
    assert tcount == rcount
    assert len(tsim) > 0 and tsim == rsim
    assert twall == rwall and "serve.run" in twall
    _check_reference_claims(scenario, truns)


def _check_reference_claims(scenario, runs):
    """The assertions of the reference's own test, on the port's result."""
    (eng, rep), *rest = runs
    reqs = rep.requests
    done = [r for r in reqs if r.state == TS.DONE]
    shed = [r for r in reqs if r.state == TS.SHED]
    for r in done:
        np.testing.assert_array_equal(r.y, _exact_y(r.x, eng.w))
        assert r.completion > r.launch >= r.arrival
    if scenario == "decode_exactly":
        s = rep.summary()
        assert s["served"] == 3 and s["shed"] == 0
        assert s["p99_latency"] >= s["p95_latency"] >= s["p50_latency"] > 0
    elif scenario == "deadline_census":
        hit, miss, exact = rest[0][1].requests
        assert {r.completion for r in (hit, miss, exact)} == {reqs[0].completion}
        assert hit.met_deadline and exact.met_deadline and not miss.met_deadline
        assert rest[0][1].summary()["deadline_misses"] == 1
    elif scenario in ("sheds_hopeless", "spans"):
        assert shed and done and all(r.shed_reason == "deadline" for r in shed)
        assert all(r.y is None and math.isnan(r.completion) for r in shed)
    elif scenario == "drained":
        s = rep.summary()
        assert s["served"] + s["shed"] == s["requests"] == 10
    elif scenario == "pool_shrink":
        assert done and shed and all(r.shed_reason == "pool" for r in shed)
        assert max(r.arrival for r in done) < min(r.arrival for r in shed)
    elif scenario == "degraded":
        assert rep.summary()["replays"] == 1
        assert all(r.state == TS.DONE for r in rest[0][1].requests)
        assert rest[0][1].summary()["replays"] == 2
    elif scenario == "continuous_vs_boundary":
        cont, bound = rep.summary(), rest[0][1].summary()
        assert cont["served"] == bound["served"] == 24
        assert cont["p95_latency"] < bound["p95_latency"]
        assert cont["throughput"] >= 0.99 * bound["throughput"]
    elif scenario == "hybrid_escalates":
        assert len(done) == 3 and rep.summary()["replays"] >= 2
        assert eng._session.hybrid_state.escalated
        assert eng._obs[0].n_corrected == 0
        assert any(o.n_corrected for o in eng._obs[1:])


def test_serve_spans_link_queue_to_replay():
    """Each served request has a serve.queue and a serve.service sim span
    on its own ("request", rid) lane, bounded by the replay it rode; each
    shed request a serve.shed instant."""
    tobs.TRACER.clear()
    tobs.TRACER.enable()
    try:
        (eng, rep), = _spans(PORT)
    finally:
        tobs.TRACER.disable()
    sim = tobs.TRACER.sim_events()
    tobs.TRACER.clear()
    by_name = {}
    for e in sim:
        by_name.setdefault(e["name"], []).append(e)
    served = [r for r in rep.requests if r.state == TS.DONE]
    shed = [r for r in rep.requests if r.state == TS.SHED]
    assert len(by_name["serve.service"]) == len(by_name["serve.queue"]) == len(served)
    assert len(by_name.get("serve.shed", [])) == len(shed) > 0
    for r in served:
        svc = next(e for e in by_name["serve.service"] if e["track"] == ("request", r.rid))
        q = next(e for e in by_name["serve.queue"] if e["track"] == ("request", r.rid))
        assert (svc["t0"], svc["t1"], q["t0"], q["t1"]) == (
            r.launch, r.completion, r.arrival, r.launch)
        assert svc["attrs"]["replay"] == r.replay


def _errors(side):
    """The messages of the reference's submit-validation failures."""
    eng, w, rng = side.engine()
    traces = _traces(1)
    if side.port:
        traces = [_carry(t) for t in traces]
    extra = dict(device="cpu") if side.port else {}
    calls = [
        lambda: eng.submit(rng.normal(size=(3, K_DIM)), 0.0),  # t=2 does not divide 3
        lambda: eng.submit(rng.normal(size=(ROWS, K_DIM)), 0.0),
        lambda: eng.submit(rng.normal(size=(ROWS + 2, K_DIM)), 0.0),  # != first
        lambda: eng.submit(rng.normal(size=(ROWS, K_DIM + 1)), 0.0),
        lambda: side.serve.ServingEngine(w, traces, side.PlanConfig(*CFG), mode="batchy", **extra),
        lambda: side.serve.ServingEngine(w, traces, side.PlanConfig(*CFG), pipe_depth=1, **extra),
        lambda: side.serve.ServingEngine(w, traces, side.PlanConfig(*CFG), max_batch=0, **extra),
        lambda: side.serve.ServingEngine(w[:15], traces, side.PlanConfig(*CFG), **extra),
        lambda: side.serve.ServingEngine(w, ["no trace"], side.PlanConfig(*CFG), **extra),
    ]
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def test_submit_validation_equals_reference():
    want = _errors(REF)
    assert _errors(PORT) == want
    assert want[1] is None and sum(m is None for m in want) == 1
    assert "rows" in want[0] and "rows" in want[2] and "k=" in want[3]
    assert "mode" in want[4] and "pipe_depth" in want[5]


# ----------------------------------------------------------------------
# the session under the engine
# ----------------------------------------------------------------------
SHAPES = dict(k=8, ma=4, mb=4, s=2, t=2)


def _session_plans():
    rplan = rpl.get_plan_for(rc.PlanConfig("age", 2, 2, 1, n_spare=2),
                             rpl.BlockShapes(**SHAPES), field=rgf.Field())
    tplan = tpl.get_plan_for(tc.PlanConfig("age", 2, 2, 1, n_spare=2),
                             tpl.BlockShapes(**SHAPES), field=tgf.Field())
    return rplan, tplan


def test_ready_at_boundary_vs_continuous_equals_reference():
    """ready_at(1) waits for the pipeline to drain; ready_at(2) only needs
    the master uplink free — on both packages, at the same times."""
    rplan, tplan = _session_plans()
    rses = R.PipelineSession(rplan, seed=0, base_time=1.5)
    tses = T.PipelineSession(tplan, seed=0, base_time=1.5, device="cpu")
    assert tses.ready_at(1) == tses.ready_at(2) == rses.ready_at(1) == 1.5
    rng = np.random.default_rng(0)
    a = rgf.Field().random(rng, (1, 8, 4))
    b = rgf.Field().random(rng, (1, 8, 4))
    trace = _traces(1, pool=rplan.n_total)[0]
    rr = rses.append(a, b, trace, not_before=2.0)
    tr = tses.append(a, b, _carry(trace), not_before=2.0)
    assert (tr.start, tr.completion, tr.index) == (rr.start, rr.completion, rr.index)
    np.testing.assert_array_equal(tr.y, rr.y)
    assert tr.start >= 2.0
    for depth in (1, 2, 3):
        assert tses.ready_at(depth) == rses.ready_at(depth)
    assert tses.ready_at(1) == tr.completion
    assert tses.ready_at(2) < tr.completion  # uplink frees mid-flight
    with pytest.raises(ValueError, match="pipe_depth"):
        tses.ready_at(0)


def test_session_matches_run_pipeline_over_pool_and_the_reference():
    """K appends on a fresh session replay byte-identically to the
    one-shot pipeline entry point, and to the reference's session."""
    rplan, tplan = _session_plans()
    K, batch = 3, 2
    rng = np.random.default_rng(5)
    a = rgf.Field().random(rng, (K, batch, 8, 4))
    b = rgf.Field().random(rng, (K, batch, 8, 4))
    rtraces = _traces(K, pool=rplan.n_total, seed0=50)
    ttraces = [_carry(t) for t in rtraces]
    one_shot = T.run_pipeline_over_pool(tplan, a, b, ttraces, seed=9, device="cpu")
    tses = T.PipelineSession(tplan, seed=9, device="cpu")
    reps = [tses.append(a[k], b[k], ttraces[k]) for k in range(K)]
    run = tses.result()
    rses = R.PipelineSession(rplan, seed=9)
    rreps = [rses.append(a[k], b[k], rtraces[k]) for k in range(K)]
    rrun = rses.result()
    for other in (one_shot, rrun):
        np.testing.assert_array_equal(run.y, other.y)
        assert run.metrics.makespan == other.metrics.makespan
        assert run.metrics.occupancy == other.metrics.occupancy
        assert [m.completion_time for m in run.replay_metrics] == [
            m.completion_time for m in other.replay_metrics]
    assert [r.completion for r in reps] == [r.completion for r in rreps] == [
        m.completion_time for m in one_shot.replay_metrics]


# ----------------------------------------------------------------------
# guards
# ----------------------------------------------------------------------
def test_engine_refuses_to_run_without_a_gpu_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.zeros((K_DIM, OUT))
    traces = [_carry(t) for t in _traces(1)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.ServingEngine(w, traces, tc.PlanConfig(*CFG))


def test_reconfigured_session_keeps_the_engine_device():
    """A pool resize rebuilds the session at the barrier, on the engine's
    device, with the hybrid state reset."""
    big = R.sample_trace(POOL, R.ShiftedExponential(0.1, 0.5), seed=7, net_scale=0.3)
    eng, _, rng = PORT.engine(traces=[big, big.take(POOL - 1)])
    sessions = []
    for i in range(2):
        eng.submit(rng.normal(size=(ROWS, K_DIM)), 3.0 * i)
        eng.run()
        sessions.append(eng._session)
    first, second = sessions
    assert first is not second
    assert first.device == second.device == eng.device == torch.device("cpu")
    assert second.base_time == first.busy_until()
    assert second.hybrid_state is not first.hybrid_state
    assert eng._cfg_fit.n_spare == POOL - 1 - N_WORKERS
