"""The port's per-product reference path, Berlekamp-Welch decode and the
rest of ``core/layers.py`` against the JAX package's, on the same inputs.

This path draws its secrets and blinding terms from the caller's numpy
rng in the reference's order, dtypes and shapes, so the shares, the
Phase-2 evaluations and Y are equal exactly, not only Y.
"""
import numpy as np
import pytest
import torch

import jax

from repro.core import bw_decode as rbw
from repro.core import constructions as rc
from repro.core import layers as rl
from repro.core import planner as rpl
from repro.core import protocol as rp
from repro_torch.core import bw_decode as tbw
from repro_torch.core import constructions as tc
from repro_torch.core import gf as tgf
from repro_torch.core import layers as tl
from repro_torch.core import planner as tpl
from repro_torch.core import protocol as tp

P = 65521


def _plans(method, s, t, z, k, ma, mb, n_spare=0):
    shapes = dict(k=k, ma=ma, mb=mb, s=s, t=t)
    rplan = rpl.get_plan(rc.build_scheme(method, s, t, z), rpl.BlockShapes(**shapes), n_spare=n_spare)
    tplan = tpl.get_plan(tc.build_scheme(method, s, t, z), tpl.BlockShapes(**shapes), n_spare=n_spare)
    return rplan, tplan


def test_fold_in_equals_jax():
    for seed, data in [(0, 0), (0, 1), (5, 7), (123, 2**31 + 5), (2**32 - 1, 2**32 - 1)]:
        want = jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        assert tgf.fold_in(tgf.prng_key(seed), data) == tuple(int(w) for w in np.asarray(want))
    # folding a split key, as the pipeline folds its session key
    k1 = jax.random.split(jax.random.PRNGKey(9), 2)[1]
    want = np.asarray(jax.random.key_data(jax.random.fold_in(k1, 3)))
    assert tgf.fold_in(tgf.split(tgf.prng_key(9), 2)[1], 3) == tuple(int(w) for w in want)


def test_device_plan_keeps_host_positions():
    rplan, tplan = _plans("age", 2, 2, 2, k=8, ma=4, mb=6, n_spare=1)
    rdp, tdp = rp.device_plan(rplan), tp.device_plan(tplan, "cpu")
    for name in ("a_pos", "sa_pos", "b_pos", "sb_pos"):
        np.testing.assert_array_equal(getattr(tdp, f"{name}_h"), getattr(rdp, f"{name}_h"))
        np.testing.assert_array_equal(getattr(tdp, name).numpy(), getattr(tdp, f"{name}_h"))


# (method, s, t, z, n_spare, k, ma, mb, Phase-2 ids rule, Phase-3 ids rule)
PHASE_CASES = [
    ("age", 2, 2, 2, 3, 8, 8, 4, None, None),
    ("age", 2, 2, 2, 3, 8, 8, 4, "reversed", "shifted"),
    ("polydot", 2, 2, 1, 2, 4, 4, 6, "reversed", None),
    ("age", 1, 2, 2, 1, 2, 4, 2, None, "shifted"),
    ("entangled-greedy", 2, 1, 2, 0, 4, 3, 5, None, None),
]


def _ids(plan, rule, n):
    if rule is None:
        return None
    if rule == "reversed":
        return np.arange(plan.n_total)[::-1][:n]
    return np.arange(plan.n_total)[plan.n_total - n:]


@pytest.mark.parametrize("case", PHASE_CASES)
def test_phase_functions_equal_reference(case):
    method, s, t, z, spare, k, ma, mb, rule2, rule3 = case
    rplan, tplan = _plans(method, s, t, z, k, ma, mb, n_spare=spare)
    gen = np.random.default_rng(len(method) + k)
    a = gen.integers(0, P, (k, ma))
    b = gen.integers(0, P, (k, mb))
    ids2 = _ids(tplan, rule2, tplan.n_workers)
    ids3 = _ids(tplan, rule3, tplan.decode_threshold)
    r_rng, t_rng = np.random.default_rng(3), np.random.default_rng(3)
    fa_r, fa_t = rp.share_a(rplan, a, r_rng), tp.share_a(tplan, a, t_rng, device="cpu")
    fb_r, fb_t = rp.share_b(rplan, b, r_rng), tp.share_b(tplan, b, t_rng, device="cpu")
    assert fa_t.dtype == torch.int32 and fa_t.device.type == "cpu"
    np.testing.assert_array_equal(fa_t.numpy(), np.asarray(fa_r))
    np.testing.assert_array_equal(fb_t.numpy(), np.asarray(fb_r))
    h_r, h_t = rp.worker_multiply(rplan, fa_r, fb_r), tp.worker_multiply(tplan, fa_t, fb_t)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_r))
    i_r = rp.degree_reduce(rplan, h_r, r_rng, worker_ids=ids2)
    i_t = tp.degree_reduce(tplan, h_t, t_rng, worker_ids=ids2)
    assert i_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
    y_r = rp.reconstruct(rplan, i_r, worker_ids=ids3)
    y_t = tp.reconstruct(tplan, i_t, worker_ids=ids3)
    assert y_t.dtype == np.int64
    np.testing.assert_array_equal(y_t, y_r)
    np.testing.assert_array_equal(y_t, (a.T.astype(object) @ b.astype(object)) % P)
    # the coded-computation decode of H(x), over a non-prefix subset
    ids = np.arange(tplan.n_total)[-tplan.n_workers:]
    np.testing.assert_array_equal(
        tp.reconstruct_coded_only(tplan, h_t, ids), rp.reconstruct_coded_only(rplan, h_r, ids)
    )
    # run: the same four steps under one seed
    yr, trr = rp.run(rplan, a, b, seed=4, phase2_ids=ids2, phase3_ids=ids3)
    yt, trt = tp.run(tplan, a, b, seed=4, phase2_ids=ids2, phase3_ids=ids3, device="cpu")
    np.testing.assert_array_equal(yt, yr)
    assert trt == tp.Trace(**vars(trr))


def test_reconstruct_corrected_equals_reference():
    rplan, tplan = _plans("age", 2, 2, 2, k=8, ma=8, mb=4, n_spare=3)
    gen = np.random.default_rng(8)
    a, b = gen.integers(0, P, (8, 8)), gen.integers(0, P, (8, 4))
    rng_r, rng_t = np.random.default_rng(1), np.random.default_rng(1)
    h_r = rp.worker_multiply(rplan, rp.share_a(rplan, a, rng_r), rp.share_b(rplan, b, rng_r))
    h_t = tp.worker_multiply(tplan, tp.share_a(tplan, a, rng_t, device="cpu"),
                             tp.share_b(tplan, b, rng_t, device="cpu"))
    i_r = np.array(rp.degree_reduce(rplan, h_r, rng_r))
    i_t = tp.degree_reduce(tplan, h_t, rng_t)
    i_t[3] = torch.from_numpy(gen.integers(0, P, i_t[3].shape).astype(np.int32))
    i_r[3] = i_t[3].numpy()
    ids = np.array([0, 3, 5, 7, 9, 11, 13, 15, 17, 19])
    yr, cr = rp.reconstruct_corrected(rplan, i_r, ids, 2, rng=np.random.default_rng(2))
    yt, ct = tp.reconstruct_corrected(tplan, i_t, ids, 2, rng=np.random.default_rng(2))
    np.testing.assert_array_equal(yt, yr)
    np.testing.assert_array_equal(ct, cr)
    np.testing.assert_array_equal(ct, [3])


def _outcome(fn):
    try:
        coeffs, err = fn()
    except (ValueError, ZeroDivisionError) as exc:
        return type(exc).__name__, str(exc)
    return np.asarray(coeffs).tolist(), np.asarray(err).tolist()


# (corrupt rows, responders, e, payload columns)
BW_CASES = [
    ([], 10, 2, 1),
    ([2], 10, 2, 5),
    ([0, 7], 10, 2, 4),
    ([1, 4, 6], 10, 2, 3),  # past the budget
    ([5], 8, 2, 2),  # too few responders for e = 2
    ([3], 9, 1, 1),
]


@pytest.mark.parametrize("case", BW_CASES)
def test_bw_decode_equals_reference(case):
    corrupt, k, e, cols = case
    rplan, tplan = _plans("age", 2, 2, 2, k=8, ma=8, mb=4, n_spare=3)
    gen = np.random.default_rng(k + e + cols)
    thr = tplan.decode_threshold
    coeffs = gen.integers(0, P, (thr, cols))
    evals = tplan.field.matmul(tplan.decode_check_matrix(), coeffs)  # [n_total, cols]
    ids = gen.permutation(tplan.n_total)[:k]
    for pos in corrupt:  # the responders at these arrival positions lie
        evals[ids[pos]] = gen.integers(0, P, cols)
    want = _outcome(lambda: rbw.bw_decode_evals(rplan, evals, ids, e, rng=np.random.default_rng(5)))
    got = _outcome(lambda: tbw.bw_decode_evals(tplan, evals, ids, e, rng=np.random.default_rng(5)))
    assert got == want
    if len(corrupt) <= e and k >= thr + 2 * e:
        assert got == (coeffs.tolist(), sorted(int(ids[pos]) for pos in corrupt))
    xs = tplan.alphas[ids]
    want = _outcome(lambda: rbw.bw_interpolate(rplan.field, xs, evals[ids], thr, e,
                                               rng=np.random.default_rng(6)))
    got = _outcome(lambda: tbw.bw_interpolate(tplan.field, xs, evals[ids], thr, e,
                                              rng=np.random.default_rng(6)))
    assert got == want
    assert tbw.bw_system_size(thr, e) == rbw.bw_system_size(thr, e)


def test_bw_error_names_match():
    assert issubclass(tbw.BWDecodeError, ValueError)
    assert tbw.BWDecodeError.__name__ == rbw.BWDecodeError.__name__


# ----------------------------------------------------------------------
# core/layers.py
# ----------------------------------------------------------------------
def test_secure_matmul_equals_reference():
    gen = np.random.default_rng(4)
    a = gen.standard_normal((8, 4))
    b = gen.standard_normal((8, 6)) * 0.1
    for kw in (dict(z=2, seed=3), dict(method="polydot", z=1, n_spare=2, seed=1)):
        want = rl.secure_matmul(a, b, **kw)
        got = tl.secure_matmul(a, b, device="cpu", **kw)
        assert got.y.dtype == torch.float64 and got.y.device.type == "cpu"
        np.testing.assert_array_equal(got.y.numpy(), want.y)
        assert got.trace == tp.Trace(**vars(want.trace))


@pytest.mark.parametrize("executor", [False, True])
@pytest.mark.parametrize("blocks", [1, 2])
def test_private_linear_equals_reference(executor, blocks):
    gen = np.random.default_rng(blocks)
    w = gen.standard_normal((8, 4)) * 0.3
    x = gen.standard_normal((4, 8))
    rex = rl.InlineExecutor(seed=5) if executor else None
    tex = tl.InlineExecutor(seed=5, device="cpu") if executor else None
    rlin = rl.PrivateLinear(w, z=2, blocks=blocks, seed=2, executor=rex)
    tlin = tl.PrivateLinear(w, z=2, blocks=blocks, seed=2, executor=tex, device="cpu")
    for _ in range(2):
        want = rlin(x)
        got = tlin(x)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)
    if executor:
        assert (tex.flushes, tex.submitted) == (rex.flushes, rex.submitted)
        # the async form: two layers' products fold into one flush
        hr, ht = rlin.submit(x), tlin.submit(x)
        hr2, ht2 = rlin.submit(x * 2), tlin.submit(x * 2)
        assert not ht.done() and tex.pending() == rex.pending() == 2 * blocks
        np.testing.assert_array_equal(ht2.result().numpy(), hr2.result())
        np.testing.assert_array_equal(ht.result().numpy(), hr.result())
        assert ht.done() and tex.flushes == rex.flushes


def test_secure_matmul_submit_equals_reference():
    gen = np.random.default_rng(11)
    ops = [(gen.standard_normal((8, 4)), gen.standard_normal((8, 6)), dict(z=2)),
           (gen.standard_normal((8, 4)) * 3, gen.standard_normal((8, 6)), dict(z=2)),
           (gen.standard_normal((4, 2)), gen.standard_normal((4, 2)), dict(method="polydot"))]
    rex, tex = rl.InlineExecutor(seed=7), tl.InlineExecutor(seed=7, device="cpu")
    rh = [rl.secure_matmul_submit(a, b, executor=rex, **kw) for a, b, kw in ops]
    th = [tl.secure_matmul_submit(a, b, executor=tex, **kw) for a, b, kw in ops]
    assert tex.flush() == rex.flush() == 3
    for hr, ht in zip(rh, th):
        np.testing.assert_array_equal(ht.result().y.numpy(), hr.result().y)
        assert ht.result().trace == tp.Trace(**vars(hr.result().trace))
    # without an executor: one private flush per handle
    a, b, kw = ops[0]
    want = rl.secure_matmul_submit(a, b, seed=3, **kw).result()
    got = tl.secure_matmul_submit(a, b, seed=3, device="cpu", **kw).result()
    np.testing.assert_array_equal(got.y.numpy(), want.y)
    with pytest.raises(ValueError, match="executor field"):
        tl.secure_matmul_submit(a, b, field=tgf.Field(65519), executor=tex)


def test_reference_path_refuses_to_run_without_a_gpu_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tplan = _plans("age", 2, 2, 2, k=8, ma=4, mb=6)
    a, b = np.zeros((8, 4)), np.zeros((8, 6))
    for call in (
        lambda: tp.run(tplan, a, b),
        lambda: tp.share_a(tplan, a, np.random.default_rng(0)),
        lambda: tl.secure_matmul(a, b),
        lambda: tl.InlineExecutor(),
        lambda: tl.PrivateLinear(b),
        lambda: tl.secure_matmul_submit(a, b),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
