"""The port's sharded Phase 2 against the JAX package's, on the same inputs.

``repro_torch.core.distributed.run_phase2_sharded`` and the ``mesh=``
paths built on it (``run_batched_sharded``, ``run_batch_over_pool``,
``run_pipeline_over_pool``, ``ServingEngine``) run on ``torch.distributed``
gloo groups on the CPU: a one-rank group in the test process, and
groups of 4 and 8 ranks spawned over a pool of 23 workers (padded to
24: the last rank holds a pad worker, which only receives).  The
reference runs on a one-device ``Mesh`` in the test process, as its own
``tests/test_sharded_batched.py`` does; the shares and per-worker noise
are the same numpy arrays on both sides, so every I(alpha) is compared
exactly, and on every rank.  Y is exact against the reference and a
host oracle; the edge runtime's draws come from the same numpy rng at
the same point of the stream, so ``RunMetrics``, ``PipelineMetrics``,
``EngineReport.summary()`` and the simulated trace records are equal.
"""
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import _torch_ranks
from repro import obs as robs
from repro import runtime as R
from repro.core import constructions as rc
from repro.core import distributed as rdist
from repro.core import planner as rpl
from repro.core import protocol as rproto
from repro.core.gf import Field as RField
from repro_torch import obs as tobs
from repro_torch import runtime as T
from repro_torch.core import constructions as tc
from repro_torch.core import distributed as tdist
from repro_torch.core import planner as tpl
from repro_torch.core import protocol as tproto
from test_torch_runtime import _carry, _equal, _sim_records, _wall_span_names
from test_torch_serve import PORT, REF

P = 65521
MODES = ("all_to_all", "psum", "psum_scatter")
SHAPES = dict(k=8, ma=12, mb=4, s=2, t=2)


def _plans(scheme=("age", 2, 2, 2), shapes=SHAPES, n_spare=3, seed=1):
    rplan = rpl.make_plan(rc.build_scheme(*scheme), rpl.BlockShapes(**shapes), n_spare=n_spare,
                          seed=seed)
    tplan = tpl.make_plan(tc.build_scheme(*scheme), tpl.BlockShapes(**shapes), n_spare=n_spare,
                          seed=seed)
    return rplan, tplan


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """(reference one-device Mesh, the port's one-rank gloo mesh)."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield Mesh(np.array(jax.devices()), ("workers",)), tdist.workers_mesh("cpu")
    finally:
        dist.destroy_process_group()


def _exchange_inputs(rplan, batch, seed):
    """Shares from the reference's numpy-rng share path and per-worker
    noise, all as numpy arrays: fa, fb [batch, n_total, ., .], noise
    [batch, n_workers, z, bry, bcy]."""
    rng = np.random.default_rng(seed)
    field = RField()
    a = field.random(rng, (batch, rplan.shapes.k, rplan.shapes.ma))
    b = field.random(rng, (batch, rplan.shapes.k, rplan.shapes.mb))
    fa = np.stack([np.asarray(rproto.share_a(rplan, a[i], rng)) for i in range(batch)])
    fb = np.stack([np.asarray(rproto.share_b(rplan, b[i], rng)) for i in range(batch)])
    noise = field.random(rng, (batch, rplan.n_workers, rplan.scheme.z) + rplan.shapes.blk_y)
    return a, b, fa, fb, noise


def _subset(plan, skip=(0, 2)):
    return np.array([i for i in range(plan.n_total) if i not in skip])[: plan.n_workers]


def _oracle(a, b):
    y = np.einsum("bki,bkj->bij", a.astype(object), b.astype(object)) % P
    return y.astype(np.int64)


# ----------------------------------------------------------------------
# run_phase2_sharded on one rank
# ----------------------------------------------------------------------
@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_phase2_sharded_equals_reference(meshes, mode, subset):
    rmesh, tmesh = meshes
    rplan, tplan = _plans()
    _, _, fa, fb, noise = _exchange_inputs(rplan, 3, seed=5)
    ids = _subset(rplan) if subset else None
    want = rdist.run_phase2_sharded(rplan, fa, fb, noise, rmesh, mode=mode, worker_ids=ids)
    got = tdist.run_phase2_sharded(tplan, fa, fb, noise, tmesh, mode=mode, worker_ids=ids)
    assert got.dtype == torch.int32 and got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_phase2_sharded_batched_matches_unbatched(meshes):
    """The batch fold reproduces per-product exchanges on the same shares
    and noise, on both sides, and each decodes to its product."""
    rmesh, tmesh = meshes
    rplan, tplan = _plans()
    a, b, fa, fb, noise = _exchange_inputs(rplan, 3, seed=9)
    want = _oracle(a, b)
    i_batched = tdist.run_phase2_sharded(tplan, fa, fb, noise, tmesh).numpy()
    assert i_batched.shape == (3, tplan.n_total) + tplan.shapes.blk_y
    for i in range(3):
        i_one = tdist.run_phase2_sharded(tplan, fa[i], fb[i], noise[i], tmesh).numpy()
        np.testing.assert_array_equal(i_batched[i], i_one)
        np.testing.assert_array_equal(
            i_one, rdist.run_phase2_sharded(rplan, fa[i], fb[i], noise[i], rmesh))
        np.testing.assert_array_equal(tproto.reconstruct(tplan, i_one), want[i])


def test_large_pool_passes_int32_bound(meshes):
    """The ~230-worker PolyDot 5/5/3 pool of the reference's regression
    test: int32-safe (npad * p < 2**31) and exact."""
    rmesh, tmesh = meshes
    rng = np.random.default_rng(3)
    field = RField()
    shapes = dict(k=5, ma=5, mb=5, s=5, t=5)
    rplan, tplan = _plans(("polydot", 5, 5, 3), shapes, n_spare=2, seed=0)
    assert tplan.n_workers >= 180 and tplan.n_total * P < (1 << 31)
    a, b = field.random(rng, (5, 5)), field.random(rng, (5, 5))
    fa = np.asarray(rproto.share_a(rplan, a, rng))
    fb = np.asarray(rproto.share_b(rplan, b, rng))
    noise = field.random(rng, (rplan.n_workers, rplan.scheme.z) + rplan.shapes.blk_y)
    got = tdist.run_phase2_sharded(tplan, fa, fb, noise, tmesh).numpy()
    np.testing.assert_array_equal(got, rdist.run_phase2_sharded(rplan, fa, fb, noise, rmesh))
    np.testing.assert_array_equal(tproto.reconstruct(tplan, got), field.matmul(a.T, b))


def test_phase2_sharded_refuses_what_it_cannot_run(meshes):
    _, tmesh = meshes
    rplan, tplan = _plans()
    _, _, fa, fb, noise = _exchange_inputs(rplan, 1, seed=2)
    with pytest.raises(ValueError, match="unknown mode"):
        tdist.run_phase2_sharded(tplan, fa, fb, noise, tmesh, mode="ring")
    # the int32 bound: npad * p >= 2**31
    big = types.SimpleNamespace(field=tplan.field, n_total=(1 << 31) // P + 1)
    with pytest.raises(AssertionError, match=r"int32 reduction bound: npad \* p < 2\*\*31"):
        tdist.run_phase2_sharded(big, fa, fb, noise, tmesh)
    # shares on another device type than the mesh's: no host staging
    with pytest.raises(ValueError, match="cpu mesh cannot take tensors on meta"):
        tdist.run_phase2_sharded(tplan, torch.as_tensor(fa).to("meta"), fb, noise, tmesh)


# ----------------------------------------------------------------------
# run_batched_sharded
# ----------------------------------------------------------------------
@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_run_batched_sharded_equals_reference(meshes, mode, subset):
    rmesh, tmesh = meshes
    rplan, tplan = _plans()
    a, b, _, _, _ = _exchange_inputs(rplan, 3, seed=1)
    kw = {}
    if subset:
        kw = dict(phase2_ids=_subset(rplan), phase3_ids=np.arange(2, 2 + rplan.decode_threshold))
    ry, rtr = rproto.run_batched_sharded(rplan, a, b, rmesh, mode=mode, seed=4, **kw)
    ty, ttr = tproto.run_batched_sharded(tplan, a, b, tmesh, mode=mode, seed=4, **kw)
    assert ty.dtype == torch.int64
    np.testing.assert_array_equal(ty.numpy(), ry)
    np.testing.assert_array_equal(ty.numpy(), _oracle(a, b))
    assert ttr == tproto.Trace(**vars(rtr))


def test_sharded_wall_spans_equal_reference(meshes):
    rmesh, tmesh = meshes
    rplan, tplan = _plans()
    a, b, _, _, _ = _exchange_inputs(rplan, 2, seed=6)
    rtrace = R.sample_trace(rplan.n_total, R.Deterministic(1.0), seed=3).with_faults(
        straggler_ids=[1], straggler_slowdown=50.0)
    names = {}
    for side, tracer, call in (
        ("reference", robs.TRACER, lambda: (
            rproto.run_batched_sharded(rplan, a, b, rmesh, mode="psum", seed=1),
            R.run_batch_over_pool(rplan, a, b, rtrace, seed=2, mesh=rmesh))),
        ("port", tobs.TRACER, lambda: (
            tproto.run_batched_sharded(tplan, a, b, tmesh, mode="psum", seed=1),
            T.run_batch_over_pool(tplan, a, b, _carry(rtrace), seed=2, mesh=tmesh,
                                  device="cpu"))),
    ):
        tracer.clear()
        tracer.enable()
        try:
            call()
        finally:
            tracer.disable()
        names[side] = (_wall_span_names(tracer), _sim_records(tracer))
        tracer.clear()
    assert names["port"] == names["reference"]
    assert "protocol.phase2.sharded_exchange" in names["port"][0]
    assert "protocol.run_batched_sharded" in names["port"][0]


# ----------------------------------------------------------------------
# the mesh= path of the edge runtime, the pipeline and the ServingEngine
# ----------------------------------------------------------------------
def _batch_case(n_total):
    rng = np.random.default_rng(29)
    a = rng.integers(0, P, (3, SHAPES["k"], SHAPES["ma"]))
    b = rng.integers(0, P, (3, SHAPES["k"], SHAPES["mb"]))
    strag = R.sample_trace(n_total, R.Deterministic(1.0), seed=30).with_faults(
        straggler_ids=[1], straggler_slowdown=50.0)
    base = R.sample_trace(n_total, R.ShiftedExponential(1.0, 0.5), seed=9)
    order = np.argsort(base.d2d_delay + base.uplink_delay, kind="stable")
    corrupt = base.with_faults(corrupt_ids=[int(order[0]), int(order[2])], dropout_ids=[5])
    return a, b, strag, corrupt


@pytest.mark.parametrize("decode_mode", ["detect", "correct"])
@pytest.mark.parametrize("mode", MODES)
def test_batch_over_pool_mesh_equals_reference(meshes, mode, decode_mode):
    """Counterpart of the reference's ``test_batch_over_pool_sharded_mesh``
    (a straggler forces a non-prefix Phase-2 subset through the mesh),
    plus corrupt fast responders that the decode must reject or correct."""
    rmesh, tmesh = meshes
    rplan, tplan = _plans()
    a, b, strag, corrupt = _batch_case(rplan.n_total)
    runs = []
    for i, rtrace in enumerate((strag, corrupt)):
        kw = dict(seed=31 + i, mode=mode, decode_mode=decode_mode, verify_extras="auto",
                  error_budget="auto")
        rrun = R.run_batch_over_pool(rplan, a, b, rtrace, mesh=rmesh, **kw)
        trun = T.run_batch_over_pool(tplan, a, b, _carry(rtrace), mesh=tmesh, device="cpu", **kw)
        np.testing.assert_array_equal(trun.y, rrun.y)
        np.testing.assert_array_equal(trun.y, _oracle(a, b))
        _equal(rrun.metrics, trun.metrics, f"{mode}/{decode_mode}/{i}")
        for mr, mt in zip(rrun.per_product, trun.per_product):
            _equal(mr, mt, "per product")
        runs.append(trun.metrics)
    assert 1 not in runs[0].phase2_ids  # the straggler sits out Phase 2
    bad = runs[1].rejected_ids if decode_mode == "detect" else runs[1].corrected_workers
    assert len(bad) > 0  # a corrupt responder was caught


def test_pipeline_over_pool_mesh_equals_reference(meshes):
    rmesh, tmesh = meshes
    rplan, tplan = _plans()
    a, b, strag, corrupt = _batch_case(rplan.n_total)
    rtraces = [strag, corrupt, strag]
    stack_a, stack_b = np.stack([a[:2]] * 3), np.stack([b[:2]] * 3)
    kw = dict(seed=4, decode_mode="hybrid", master_decode_cost=0.05, mode="psum_scatter")
    rrun = R.run_pipeline_over_pool(rplan, stack_a, stack_b, rtraces, mesh=rmesh, **kw)
    trun = T.run_pipeline_over_pool(tplan, stack_a, stack_b, [_carry(t) for t in rtraces],
                                    mesh=tmesh, device="cpu", **kw)
    np.testing.assert_array_equal(trun.y, rrun.y)
    np.testing.assert_array_equal(trun.y[0], _oracle(a[:2], b[:2]))
    _equal(rrun.metrics, trun.metrics, "PipelineMetrics")
    for mr, mt in zip(rrun.replay_metrics, trun.replay_metrics):
        _equal(mr, mt, "replay metrics")
    # a session holds the mesh for every append
    rses = R.PipelineSession(rplan, seed=9, mesh=rmesh, mode="all_to_all")
    tses = T.PipelineSession(tplan, seed=9, mesh=tmesh, mode="all_to_all", device="cpu")
    for k, nb in enumerate((1, 3)):
        rr = rses.append(a[:nb], b[:nb], rtraces[k], not_before=0.3 * k)
        tr = tses.append(a[:nb], b[:nb], _carry(rtraces[k]), not_before=0.3 * k)
        np.testing.assert_array_equal(tr.y, rr.y)
        _equal(rr.metrics, tr.metrics, f"append {k}")
    _equal(rses.result().metrics, tses.result().metrics, "session PipelineMetrics")


@pytest.mark.parametrize("exchange_mode", ["all_to_all", "psum_scatter"])
def test_serving_engine_mesh_equals_reference(meshes, exchange_mode):
    rmesh, tmesh = meshes
    reports = []
    for side, mesh in ((REF, rmesh), (PORT, tmesh)):
        eng, _, rng = side.engine(mesh=mesh, exchange_mode=exchange_mode)
        for i in range(6):
            eng.submit(rng.normal(size=(4, 16)) * (0.1 + i), 0.3 * i)
        reports.append(eng.run())
    rrep, trep = reports
    assert trep.summary() == rrep.summary()
    assert len(trep.requests) == len(rrep.requests) == 6
    for rr, tr in zip(rrep.requests, trep.requests):
        assert (tr.state, tr.launch, tr.completion, tr.replay) == (
            rr.state, rr.launch, rr.completion, rr.replay)
        np.testing.assert_array_equal(tr.y, rr.y)


# ----------------------------------------------------------------------
# several gloo ranks: 23 workers over 4 and over 8 ranks
# ----------------------------------------------------------------------
RANKS_SPEC = dict(scheme=("age", 2, 2, 2), shapes=SHAPES, n_spare=6, seed=1)


def _rank_cases(rplan):
    ids = _subset(rplan, skip=(0, 3, 7))
    return [(mode, ids_) for mode in MODES for ids_ in (None, ids)]


@pytest.mark.parametrize("d", [4, 8])
def test_gloo_ranks_equal_reference(meshes, tmp_path, d):
    """Every rank's I equals the reference's, in every mode, with and
    without a sender subset; at d = 4 every rank's ``run_batch_over_pool
    (mesh=...)`` gives the reference's Y and RunMetrics too.  One spawn
    per rank count."""
    rmesh, _ = meshes
    rplan, _ = _plans(n_spare=RANKS_SPEC["n_spare"])
    assert rplan.n_total == 23 and 23 % d  # pad workers on the last rank
    _, _, fa, fb, noise = _exchange_inputs(rplan, 2, seed=11)
    cases = _rank_cases(rplan)
    want = [rdist.run_phase2_sharded(rplan, fa, fb, noise, rmesh, mode=m, worker_ids=ids)
            for m, ids in cases]
    edge_calls, ref_runs = [], []
    if d == 4:
        a, b, strag, corrupt = _batch_case(rplan.n_total)
        for rtrace, mode, decode_mode in ((strag, "all_to_all", "detect"),
                                          (corrupt, "psum", "correct"),
                                          (corrupt, "psum_scatter", "detect")):
            kw = dict(seed=3, mode=mode, decode_mode=decode_mode, verify_extras="auto",
                      error_budget="auto")
            ref_runs.append(R.run_batch_over_pool(rplan, a, b, rtrace, mesh=rmesh, **kw))
            edge_calls.append((a, b, _carry(rtrace), kw))
    results = _torch_ranks.run_ranks(d, tmp_path, _torch_ranks.ranks_job, RANKS_SPEC,
                                     fa, fb, noise, cases, edge_calls)
    assert len(results) == d
    for rank, (i_evals, edge_runs) in enumerate(results):
        for (mode, ids), w, g in zip(cases, want, i_evals):
            np.testing.assert_array_equal(g, w, err_msg=f"rank {rank} {mode} subset {ids}")
        assert len(edge_runs) == len(ref_runs)
        for (y, metrics, per_product), rrun, (a, b, _, kw) in zip(edge_runs, ref_runs, edge_calls):
            np.testing.assert_array_equal(y, rrun.y)
            np.testing.assert_array_equal(y, _oracle(a, b))
            _equal(rrun.metrics, metrics, f"rank {rank} {kw}")
            for mr, mt in zip(rrun.per_product, per_product):
                _equal(mr, mt, f"rank {rank} per product")
