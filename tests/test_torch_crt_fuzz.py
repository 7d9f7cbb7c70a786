"""The port's CRT route, tile autotuning and kernel fuzz harness against
the JAX package's, on the same inputs (``device="cpu"``).

Every comparison is exact: ``crt_combine`` values and guard messages,
``mod_matmul_crt`` on the plain backends, ``run_batched_crt`` /
``secure_matmul_crt`` (the combined integers, Y and the summed
``Trace``), and the fuzz harness's cases and operand arrays.  Unfused
batched secrets differ from the reference's by construction (a
``torch.Generator`` against ``jax.random.randint``); the combined
integers and Y do not depend on them, so only those are compared.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import constructions as rc
from repro.core import gf as rgf
from repro.core import layers as rl
from repro.core import planner as rpl
from repro.core import protocol as rp
from repro.kernels.modmatmul import fuzz as rfuzz
from repro.kernels.modmatmul import ops as rops
from repro_torch.core import constructions as tc
from repro_torch.core import gf as tgf
from repro_torch.core import layers as tl
from repro_torch.core import planner as tpl
from repro_torch.core import protocol as tp
from repro_torch.kernels.modmatmul import fuzz as tfuzz
from repro_torch.kernels.modmatmul import ops as tops

PRIMES = (65521, 65519)
PBIG = PRIMES[0] * PRIMES[1]


def _message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


# ----------------------------------------------------------------------
# crt_combine and mod_matmul_crt
# ----------------------------------------------------------------------
def test_crt_combine_equals_reference():
    rng = np.random.default_rng(0)
    for primes in (PRIMES, (3, 5, 7), (251, 257, 4093)):
        x = rng.integers(-(2**40), 2**40, (6, 5))
        residues = [x % q for q in primes]
        got = tgf.crt_combine(residues, primes)
        np.testing.assert_array_equal(got, rgf.crt_combine(residues, primes))
        prod = int(np.prod(primes))
        np.testing.assert_array_equal(got, x % prod)
    for residues, primes in (
        ([np.zeros(1, np.int64)] * 4, [65521, 65519, 65497, 65479]),  # >= 2**62
        ([np.zeros(1, np.int64)] * 2, [12, 8]),  # not coprime
        ([np.zeros(1, np.int64)], [3, 5]),  # one residue short
    ):
        want = _message(lambda: rgf.crt_combine(residues, primes))
        assert _message(lambda: tgf.crt_combine(residues, primes)) == want
        assert want[0] == "ValueError"


@pytest.mark.parametrize("backend", ["auto", "int32", "f32limb"])
@pytest.mark.parametrize("sa,sb", [((9, 300), (300, 7)), ((2, 5, 33), (33, 4)), ((3, 4), (2, 4, 6))])
def test_mod_matmul_crt_equals_reference(backend, sa, sb):
    """Signed operands past one field, reduced per prime with numpy's
    sign rule: equal to the reference and to a @ b mod p1*p2."""
    rng = np.random.default_rng(sum(sa) + sum(sb))
    a = rng.integers(-(2**20), 2**20, sa)
    b = rng.integers(-(2**20), 2**20, sb)
    got = tops.mod_matmul_crt(a, b, primes=PRIMES, backend=backend, device="cpu")
    want = rops.mod_matmul_crt(a, b, primes=PRIMES, backend=backend)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.asarray(want))
    oracle = (a.astype(object) @ b.astype(object)) % PBIG
    np.testing.assert_array_equal(got, oracle.astype(np.int64))
    assert _message(lambda: tops.mod_matmul_crt(a, b, primes=(5, 5), device="cpu")) == (
        _message(lambda: rops.mod_matmul_crt(a, b, primes=(5, 5))))


def test_mod_matmul_crt_refuses_operands_on_two_devices():
    """Two tensors on different devices raise instead of copying one to
    the other's; a lone tensor names the device the residues run on."""
    a = torch.ones((3, 4), dtype=torch.int64)
    b = torch.ones((4, 5), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="two devices"):
        tops.mod_matmul_crt(a, b, primes=PRIMES)
    with pytest.raises(ValueError, match="two devices"):
        tops.mod_matmul_crt(b.T, a.T, primes=PRIMES)
    got = tops.mod_matmul_crt(a, np.ones((4, 5), dtype=np.int64), primes=PRIMES)
    np.testing.assert_array_equal(got, np.full((3, 5), 4))


# ----------------------------------------------------------------------
# run_batched_crt and secure_matmul_crt
# ----------------------------------------------------------------------
SHAPES = dict(k=16, ma=8, mb=4, s=2, t=2)


def _crt_plans(primes=PRIMES, z=2, n_spare=1):
    rplans = [rpl.get_plan(rc.build_scheme("age", 2, 2, z), rpl.BlockShapes(**SHAPES),
                           field=rgf.Field(p), n_spare=n_spare, seed=3 + 17 * i)
              for i, p in enumerate(primes)]
    tplans = [tpl.get_plan(tc.build_scheme("age", 2, 2, z), tpl.BlockShapes(**SHAPES),
                           field=tgf.Field(p), n_spare=n_spare, seed=3 + 17 * i)
              for i, p in enumerate(primes)]
    return rplans, tplans


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("subsets", [False, True])
def test_run_batched_crt_equals_reference(fused, subsets):
    rplans, tplans = _crt_plans()
    rng = np.random.default_rng(7)
    a = rng.integers(-(2**12), 2**12, (3, 16, 8))  # signed: reduced per prime
    b = rng.integers(-(2**12), 2**12, (3, 16, 4))
    ids = {}
    if subsets:  # the spare in for worker 0, and the last responders decoding
        n, nw, thr = rplans[0].n_total, rplans[0].n_workers, rplans[0].decode_threshold
        ids = dict(phase2_ids=[n - 1] + list(range(1, nw)), phase3_ids=list(range(n - thr, n)))
    rcomb, rtrace = rp.run_batched_crt(rplans, a, b, seed=5, fused_masks=fused, **ids)
    tcomb, ttrace = tp.run_batched_crt(tplans, a, b, seed=5, fused_masks=fused, device="cpu", **ids)
    assert isinstance(tcomb, np.ndarray) and tcomb.dtype == np.int64
    np.testing.assert_array_equal(tcomb, np.asarray(rcomb))
    want = np.einsum("bki,bkj->bij", a.astype(object), b.astype(object)) % PBIG
    np.testing.assert_array_equal(tcomb, want.astype(np.int64))
    assert dataclasses.asdict(ttrace) == dataclasses.asdict(rtrace)
    # the summed trace: one run_batched trace per residue
    one = tp.batch_trace(tplans[0], 3)
    assert ttrace.phase1_source_to_worker == 2 * one.phase1_source_to_worker
    with pytest.raises(ValueError, match="distinct primes"):
        tp.run_batched_crt(tplans[:1] * 2, a, b, device="cpu")


def test_sum_traces_equals_reference():
    traces = [(3, 10, 20, 30), (2, 1, 2, 3), (4, 5, 6, 7)]
    rt = [rp.Trace(elem_bytes=e, phase1_source_to_worker=x, phase2_worker_to_worker=y,
                   phase3_worker_to_master=z) for e, x, y, z in traces]
    tt = [tp.Trace(elem_bytes=e, phase1_source_to_worker=x, phase2_worker_to_worker=y,
                   phase3_worker_to_master=z) for e, x, y, z in traces]
    assert dataclasses.asdict(tp._sum_traces(tt)) == dataclasses.asdict(rp._sum_traces(rt))


@pytest.mark.parametrize("fused", [False, True])
def test_secure_matmul_crt_equals_reference(fused):
    """Float operands, the scale search over P and the centered lift: the
    same y and the same summed Trace (the 2D form: the precision test)."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(3, 16, 8)) * 3.0
    b = rng.normal(size=(3, 16, 4))
    kw = dict(s=2, t=2, z=2, seed=4, n_spare=1, fused_masks=fused)
    want = rl.secure_matmul_crt(a, b, **kw)
    got = tl.secure_matmul_crt(a, b, device="cpu", **kw)
    assert got.y.shape == want.y.shape == (3, 8, 4)
    np.testing.assert_array_equal(got.y.numpy(), want.y)
    assert dataclasses.asdict(got.trace) == dataclasses.asdict(want.trace)
    assert got.plan.field.p == want.plan.field.p == PRIMES[0]
    np.testing.assert_array_equal(got.plan.alphas, want.plan.alphas)


def test_secure_matmul_crt_precision():
    """The counterpart of the reference's precision test: P ~ 2**32 gives
    the fixed-point headroom for a 2-decimal answer at k = 16."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(16, 12))
    b = rng.normal(size=(16, 8))
    res = tl.secure_matmul_crt(a, b, s=2, t=2, z=2, device="cpu")
    assert np.abs(res.y.numpy() - a.T @ b).max() < 0.02
    np.testing.assert_array_equal(res.y.numpy(), rl.secure_matmul_crt(a, b, s=2, t=2, z=2).y)


# ----------------------------------------------------------------------
# the fuzz harness
# ----------------------------------------------------------------------
def test_fuzz_cases_and_operands_equal_reference():
    for seed in (0, 1, 123, 2**31 - 1):
        rrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
        for i in range(12):
            rcase = rfuzz.sample_case(rrng, deep_k=i % 4 == 0)
            tcase = tfuzz.sample_case(trng, deep_k=i % 4 == 0)
            assert dataclasses.asdict(tcase) == dataclasses.asdict(rcase)
            assert tcase.describe() == rcase.describe()
            for x, y in zip(tfuzz.operands(tcase), rfuzz.operands(rcase)):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
    assert (tfuzz.PRIMES, tfuzz.CRT_PRIMES, tfuzz.MODES, tfuzz.LAYOUTS) == (
        rfuzz.PRIMES, rfuzz.CRT_PRIMES, rfuzz.MODES, rfuzz.LAYOUTS)


def test_run_fuzz_plain_engines_and_crt_clean():
    found = tfuzz.run_fuzz(examples=16, seed=7, engines=["f32limb", "int32", "crt"],
                           deep_every=4, device="cpu")
    assert found == [], "\n".join(m.describe() for m in found)


def test_fuzz_harness_detects_a_planted_bug():
    """The harness must actually be able to fail: a corrupted engine is
    reported as a mismatch (guards against a vacuous oracle)."""
    case = tfuzz.Case(batch=1, m=3, k=5, n=2, p=251, mode="uniform", layout="2d", seed=7)
    broken = dict(tfuzz.ENGINES)
    broken["evil"] = lambda a, b, p, device: tfuzz.ENGINES["f32limb"](a, b, p, device) + 1
    orig = tfuzz.ENGINES
    tfuzz.ENGINES = broken
    try:
        bad = tfuzz.check_case(case, engines=["evil"])
    finally:
        tfuzz.ENGINES = orig
    assert len(bad) == 1 and bad[0].engine == "evil" and bad[0].n_bad == 6
    assert bad[0].got == bad[0].want + 1


def test_kernel_engines_refuse_a_cpu_device():
    case = tfuzz.Case(batch=1, m=3, k=5, n=2, p=251, mode="uniform", layout="2d", seed=7)
    for engine in ("cuda", "cuda_int32"):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            tfuzz.check_case(case, engines=[engine], device="cpu")


# ----------------------------------------------------------------------
# autotune_tiles
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["cuda_int32", "cuda"])
@pytest.mark.parametrize("shape", [(5, 7, 9), (40, 300, 70)])
def test_autotune_tiles_pins_and_pick_tiles_returns_the_pin(backend, shape, monkeypatch):
    monkeypatch.setattr(tops, "_AUTOTUNE_CACHE", {})
    m, k, n = shape
    compiled = tops.pick_tiles(m, k, n, backend=backend)
    best = tops.autotune_tiles(m, k, n, backend=backend, batch=2, repeats=1, device="cpu")
    assert best == compiled
    assert tops._AUTOTUNE_CACHE == {(backend, m, k, n, 0): best}
    # the pin is consulted first: it wins over the registered chooser
    monkeypatch.setitem(tops._TILE_CHOOSERS, backend, lambda *dims: (1, 2, 3))
    assert tops.pick_tiles(m, k, n, backend=backend) == best
    assert tops.pick_tiles(m + 1, k, n, backend=backend) == (1, 2, 3)


def test_autotune_tiles_reports_candidates_that_are_not_compiled(monkeypatch):
    monkeypatch.setattr(tops, "_AUTOTUNE_CACHE", {})
    compiled = tops.pick_tiles(40, 300, 70, backend="cuda_int32")
    with pytest.warns(UserWarning, match="not compiled"):
        best = tops.autotune_tiles(40, 300, 70, candidates=[(8, 128, 128), compiled],
                                   repeats=1, device="cpu")
    assert best == compiled
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="no autotune candidate ran"):
            tops.autotune_tiles(40, 300, 70, candidates=[(8, 128, 128)], device="cpu")
    with pytest.raises(ValueError, match="kernel backends"):
        tops.autotune_tiles(4, 4, 4, backend="int32", device="cpu")
    assert tops._AUTOTUNE_CACHE == {("cuda_int32", 40, 300, 70, 0): compiled}
