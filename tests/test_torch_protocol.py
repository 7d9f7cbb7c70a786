"""The port's planner, batched protocol engine and float API against the
JAX package's, on the same inputs.

Y and every plan constant are integers: parity is exact equality.  With
fused masks the shares themselves are bit-identical (same key
derivation, same threefry stream); without, the secret draws differ by
construction and only Y is compared.  ``secure_matmul_batched`` decodes
the same integers, so its float output is equal too.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import constructions as rc
from repro.core import layers as rl
from repro.core import planner as rpl
from repro.core import protocol as rp
from repro_torch import convert
from repro_torch.core import constructions as tc
from repro_torch.core import gf as tgf
from repro_torch.core import layers as tl
from repro_torch.core import planner as tpl
from repro_torch.core import protocol as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 65521


def _plans(method, s, t, z, k, ma, mb, n_spare=0):
    shapes = dict(k=k, ma=ma, mb=mb, s=s, t=t)
    rplan = rpl.get_plan(rc.build_scheme(method, s, t, z), rpl.BlockShapes(**shapes), n_spare=n_spare)
    tplan = tpl.get_plan(tc.build_scheme(method, s, t, z), tpl.BlockShapes(**shapes), n_spare=n_spare)
    return rplan, tplan


def _oracle(a, b):
    prod = np.einsum("bki,bkj->bij", np.asarray(a, object), np.asarray(b, object))
    return (prod % P).astype(np.int64)


# ----------------------------------------------------------------------
# planner
# ----------------------------------------------------------------------
_GRID = [(1, 2, 1), (2, 1, 2), (2, 2, 1), (2, 2, 2), (3, 2, 2)]


@pytest.mark.parametrize("method", ["polydot", "age", "age-paper", "entangled-greedy"])
def test_plan_constants_equal_reference(method):
    for s, t, z in _GRID:
        if method == "polydot" and s == t == 1:
            continue
        rplan, tplan = _plans(method, s, t, z, k=2 * s, ma=2 * t, mb=2 * t, n_spare=2)
        assert tplan.n_total == rplan.n_total and tplan.n_workers == rplan.n_workers
        assert tplan.decode_threshold == rplan.decode_threshold
        assert tplan.scheme.fa_powers == rplan.scheme.fa_powers
        for name in ("alphas", "va", "vb", "mix", "vnoise", "decode_w", "important_idx"):
            np.testing.assert_array_equal(getattr(tplan, name), getattr(rplan, name), err_msg=name)
        ids2 = np.arange(tplan.n_total)[::-1][: tplan.n_workers]
        ids3 = np.arange(tplan.n_total)[1 : 1 + tplan.decode_threshold]
        np.testing.assert_array_equal(
            tplan.phase2_matrix_cached(ids2), rplan.phase2_matrix_cached(ids2)
        )
        np.testing.assert_array_equal(
            tplan.decode_matrix_cached(ids3), rplan.decode_matrix_cached(ids3)
        )


# ----------------------------------------------------------------------
# the batched engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True])
def test_run_batched_equals_reference(fused):
    rplan, tplan = _plans("age", 2, 2, 2, k=8, ma=4, mb=6)
    rng = np.random.default_rng(0)
    a = rng.integers(0, P, (3, 8, 4))
    b = rng.integers(0, P, (3, 8, 6))
    yr, trr = rp.run_batched(rplan, a, b, seed=5, fused_masks=fused)
    yt, trt = tp.run_batched(tplan, a, b, seed=5, fused_masks=fused, device="cpu")
    assert yt.dtype == torch.int64 and yt.device.type == "cpu"
    np.testing.assert_array_equal(yt.numpy(), yr)
    np.testing.assert_array_equal(yt.numpy(), _oracle(a, b))
    assert trt == tp.Trace(**vars(trr))


@pytest.mark.parametrize("fused", [False, True])
def test_run_batched_explicit_worker_subsets_equal_reference(fused):
    rplan, tplan = _plans("polydot", 2, 2, 1, k=4, ma=4, mb=2, n_spare=2)
    rng = np.random.default_rng(1)
    a = rng.integers(0, P, (2, 4, 4))
    b = rng.integers(0, P, (2, 4, 2))
    ids2 = np.arange(tplan.n_total)[::-1][: tplan.n_workers]
    ids3 = np.arange(tplan.n_total)[2 : 2 + tplan.decode_threshold]
    kw = dict(seed=3, phase2_ids=ids2, phase3_ids=ids3, fused_masks=fused)
    yr, _ = rp.run_batched(rplan, a, b, **kw)
    yt, _ = tp.run_batched(tplan, a, b, device="cpu", **kw)
    np.testing.assert_array_equal(yt.numpy(), yr)
    np.testing.assert_array_equal(yt.numpy(), _oracle(a, b))


def test_fused_shares_bit_identical_to_reference():
    rplan, tplan = _plans("age", 2, 2, 2, k=8, ma=4, mb=6)
    rng = np.random.default_rng(2)
    a = rng.integers(0, P, (2, 8, 4)).astype(np.int32)
    b = rng.integers(0, P, (2, 8, 6)).astype(np.int32)
    for seed in (0, 7):
        fa_r, fb_r = rp.share_batched(
            rplan, jnp.asarray(a), jnp.asarray(b), jax.random.PRNGKey(seed), fused_masks=True
        )
        fa_t, fb_t = tp.share_batched(
            tplan, a, b, tgf.prng_key(seed), fused_masks=True, device="cpu"
        )
        np.testing.assert_array_equal(fa_t.numpy(), np.asarray(fa_r))
        np.testing.assert_array_equal(fb_t.numpy(), np.asarray(fb_r))


def test_run_batched_kernel_backend_matches_reference_pallas_int32():
    """The reference through its Pallas int32 kernel (interpret mode)
    and the port through its int32 kernel's wrapper give the same Y."""
    rplan, tplan = _plans("age", 1, 2, 1, k=2, ma=2, mb=2)
    rng = np.random.default_rng(3)
    a = rng.integers(0, P, (1, 2, 2))
    b = rng.integers(0, P, (1, 2, 2))
    yr, _ = rp.run_batched(rplan, a, b, seed=1, backend="pallas_int32", fused_masks=True)
    yt, _ = tp.run_batched(tplan, a, b, seed=1, backend="cuda_int32", fused_masks=True, device="cpu")
    np.testing.assert_array_equal(yt.numpy(), yr)
    np.testing.assert_array_equal(yt.numpy(), _oracle(a, b))


def test_secure_matmul_batched_equals_reference():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 8, 4))
    b = rng.standard_normal((8, 6))
    want = rl.secure_matmul_batched(a, b, z=2, seed=3)
    got = tl.secure_matmul_batched(a, b, z=2, seed=3, device="cpu")
    assert got.y.dtype == torch.float64
    np.testing.assert_array_equal(got.y.numpy(), want.y)
    assert got.trace == tp.Trace(**vars(want.trace))
    np.testing.assert_array_equal(got.plan.mix, want.plan.mix)


# ----------------------------------------------------------------------
# carrying the plan constants across
# ----------------------------------------------------------------------
def _reference_arrays(rplan):
    dp = rp.device_plan(rplan)
    arrays = {k: np.asarray(getattr(dp, k)) for k in convert.FIELDS}
    arrays["plan.mix"] = rplan.mix
    arrays["plan.decode_w"] = rplan.decode_w
    return arrays


def test_convert_round_trips_the_reference_device_plan():
    rplan, tplan = _plans("age", 2, 2, 2, k=8, ma=4, mb=6, n_spare=1)
    arrays = _reference_arrays(rplan)
    dp = convert.device_plan_from_reference(arrays, P, device="cpu")
    own = tp.device_plan(tplan, "cpu")
    for k in convert.FIELDS:
        assert torch.equal(getattr(dp, k), getattr(own, k)), k
    back = convert.device_plan_to_arrays(dp)
    for k in convert.FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k])
    bad = dict(arrays, mix_t=(arrays["mix_t"] + 1) % P)
    with pytest.raises(ValueError, match="disagrees"):
        convert.device_plan_from_reference(bad, P)
    with pytest.raises(ValueError, match="lack"):
        convert.device_plan_from_reference({"va": arrays["va"]}, P)


# ----------------------------------------------------------------------
# guards
# ----------------------------------------------------------------------
def test_port_imports_neither_jax_nor_the_reference():
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path[:0] = [{src!r}, {root!r}]
        import numpy as np
        import repro_torch
        for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(mod.name)
        import chip_smoke  # noqa: F401
        import repro_torch.core.bw_decode, repro_torch.obs.export  # noqa: F401
        from repro_torch import runtime
        from repro_torch.core import constructions, planner, protocol
        plan = planner.get_plan(
            constructions.build_scheme("age", 2, 2, 2),
            planner.BlockShapes(k=4, ma=2, mb=4, s=2, t=2),
        )
        rng = np.random.default_rng(0)
        a = rng.integers(0, 65521, (2, 4, 2))
        b = rng.integers(0, 65521, (2, 4, 4))
        want = np.einsum("bki,bkj->bij", a.astype(object), b.astype(object)) % 65521
        for fused in (False, True):
            y, _ = protocol.run_batched(plan, a, b, fused_masks=fused, device="cpu")
            assert np.array_equal(y.numpy(), want.astype(np.int64))
        trace = runtime.sample_trace(plan.n_total, runtime.HeavyTail(1.0, 0.5, 1.5), seed=1)
        trace = trace.with_faults(corrupt_ids=[0])
        for mode in ("detect", "correct"):
            run = runtime.run_batch_over_pool(plan, a, b, trace, decode_mode=mode, device="cpu")
            assert np.array_equal(run.y, want.astype(np.int64))
            run = runtime.run_over_pool(plan, a[0], b[0], trace, decode_mode=mode, device="cpu")
            assert np.array_equal(run.y, want[0].astype(np.int64))
        import repro_torch.serve, repro_torch.kernels.modmatmul.fuzz as fuzz  # noqa: F401
        from repro_torch.core import constructions as tc
        traces = [runtime.sample_trace(tc.PlanConfig("age", 2, 2, 1).n_workers + 2,
                                       runtime.ShiftedExponential(0.1, 0.5), seed=s) for s in (1, 2)]
        eng = repro_torch.serve.ServingEngine(np.ones((4, 4)), traces, tc.PlanConfig("age", 2, 2, 1),
                                              validate=True, device="cpu")
        for i in range(3):
            eng.submit(rng.normal(size=(2, 4)), 0.5 * i)
        assert eng.run().summary()["served"] == 3
        assert fuzz.run_fuzz(examples=2, engines=["int32", "crt"], device="cpu") == []
        loaded = [m for m in sys.modules if sys.modules[m] is not None
                  and (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
        assert not loaded, loaded
        print("CLEAN")
        """
    ).format(src=os.path.join(ROOT, "src"), root=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, cwd=ROOT, timeout=300
    )
    assert res.returncode == 0 and "CLEAN" in res.stdout, res.stderr[-3000:]


def test_entry_points_refuse_to_run_without_a_gpu_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tplan = _plans("age", 2, 2, 2, k=8, ma=4, mb=6)
    a = np.zeros((1, 8, 4), np.int64)
    b = np.zeros((1, 8, 6), np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.run_batched(tplan, a, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.share_batched(tplan, a, b, tgf.prng_key(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.secure_matmul_batched(a.astype(float), b.astype(float))


def test_operand_validation():
    _, tplan = _plans("age", 2, 2, 2, k=8, ma=4, mb=6)
    with pytest.raises(ValueError, match="disagree with plan"):
        tp.run_batched(tplan, np.zeros((1, 8, 2)), np.zeros((1, 8, 6)), device="cpu")
    with pytest.raises(ValueError, match="two 32-bit words"):
        tp.share_batched(tplan, np.zeros((1, 8, 4)), np.zeros((1, 8, 6)), (1, 2, 3), device="cpu")
