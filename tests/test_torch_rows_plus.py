"""The degree reduction as one product, ``a @ h[rows] + v @ r`` (CPU).

``ops.mod_matmul_rows_plus`` runs the skinny kernel's loaded-rows form
on the card where ``ops.skinny_fuses`` holds, and the selection, two
products and ``mod_add`` elsewhere.  Here: the dispatch rule, the plain
route against the three-step arithmetic and an integer oracle, the
``protocol.reduce.*`` counters of ``run_batched``, and, on a fake card
(every launch replaced by its plain version, counted as the wrapper
counts it), the launches one call records.  The kernel itself is held
against the same arithmetic in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import constructions, gf, planner, protocol
from repro_torch.kernels.modmatmul import fuzz, ops, ref
from repro_torch.kernels.modmatmul import kernel as K
from repro_torch.obs.metrics import REGISTRY

P = 65521
CUDA = torch.device("cuda")  # a device value only: nothing is allocated on it


@pytest.mark.parametrize(
    "m,k,z,fuses",
    [(17, 17, 2, True), (14, 14, 1, True), (1, 1, 1, True), (32, 32, 96, True),
     (33, 17, 2, False), (17, 33, 2, False), (32, 32, 97, False), (35, 35, 4, False)],
)
def test_rows_plus_fuses_on_the_card_inside_the_skinny_rule(m, k, z, fuses):
    for backend in ("auto", "cuda_int32", "cuda"):
        assert ops.skinny_fuses(backend, CUDA, m, k, z) is fuses
        assert ops.skinny_fuses(backend, "cpu", m, k, z) is False
    for backend in ("int32", "f32limb"):
        assert ops.skinny_fuses(backend, CUDA, m, k, z) is False


def _operands(seed, batch, m, k, z, n, n_rows, permuted, extra_stride=0, mode="uniform", p=P):
    """a [m, k], h [batch, n_rows, n] (a slice of a taller tensor when
    ``extra_stride``, so its batch stride passes n_rows * n), rows [k],
    v [m, z], r [batch, z, n]."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        if mode == "maximal":
            return torch.full(shape, p - 1, dtype=torch.int32)
        return torch.as_tensor(rng.integers(0, p, shape), dtype=torch.int32)

    a = draw((m, k))
    h = draw((batch, n_rows + extra_stride, n))[:, :n_rows]
    rows = torch.as_tensor(rng.permutation(n_rows)[:k] if permuted else np.arange(k), dtype=torch.int64)
    v = draw((m, z))
    r = draw((batch, z + extra_stride, n))[:, :z]
    return a, h, rows, v, r


def _three_step(a, h, rows, v, r, p=P, backend="auto"):
    return gf.mod_add(ops.mod_matmul(a, h.index_select(-2, rows), p=p, backend=backend),
                      ops.mod_matmul(v, r, p=p, backend=backend), p)


def _oracle(a, h, rows, v, r, p=P):
    obj = lambda x: np.asarray(x, np.int64).astype(object)  # noqa: E731
    picked = obj(h)[..., np.asarray(rows), :]
    return ((obj(a) @ picked + obj(v) @ obj(r)) % p).astype(np.int64)


# (batch, m, k, z, n, n_rows, permuted, extra_stride, mode)
_CASES = [
    (4, 17, 17, 2, 1000, 17, False, 0, "uniform"),  # the q-projection's reduce, no spares
    (1, 14, 14, 1, 333, 14, False, 0, "uniform"),  # the head's
    (3, 17, 17, 2, 257, 20, True, 0, "uniform"),  # a permuted subset of 20 rows
    (5, 9, 7, 4, 101, 12, True, 3, "uniform"),  # batch strides past K * N
    (2, 32, 32, 96, 65, 40, True, 2, "maximal"),  # 128 terms, every one p - 1
    (2, 40, 36, 3, 50, 36, False, 0, "uniform"),  # outside the skinny rule
]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: "b{}-m{}-k{}-z{}-n{}".format(*c[:5]))
@pytest.mark.parametrize("variant", ["int32", "f32"])
def test_plain_route_equals_the_three_step_arithmetic(case, variant):
    a, h, rows, v, r = _operands(len(_CASES) + case[1], *case)
    want = _three_step(a, h, rows, v, r)
    np.testing.assert_array_equal(want.numpy(), _oracle(a, h, rows, v, r))
    # the kernel wrapper on CPU tensors: its plain version
    got = K.modmatmul_rows_plus_cuda(a, h, rows, v, r, P, variant)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(ref.modmatmul_rows_plus_plain(a, h, rows, v, r, P, variant), want)
    for backend in ("auto", "int32", "f32limb"):
        assert torch.equal(ops.mod_matmul_rows_plus(a, h, rows, v, r, p=P, backend=backend), want)


def test_plain_route_takes_2d_operands():
    a, h, rows, v, r = _operands(3, 1, 6, 5, 2, 77, 9, True)
    got = ops.mod_matmul_rows_plus(a, h[0], rows, v, r[0])
    assert got.shape == (6, 77) and torch.equal(got, _three_step(a, h, rows, v, r)[0])
    ab = torch.stack([a, (a * 3) % P])  # a batched a against a shared h and r
    got = ops.mod_matmul_rows_plus(ab, h[0], rows, v, r[0])
    assert torch.equal(got, _three_step(ab, h[0], rows, v, r[0]))


def test_rows_plus_wrapper_refuses_bad_shapes():
    a, h, rows, v, r = _operands(4, 2, 5, 4, 2, 30, 6, False)
    with pytest.raises(ValueError, match="rows must be"):
        K.modmatmul_rows_plus_cuda(a, h, rows[:3], v, r)
    with pytest.raises(ValueError, match="v must be"):
        K.modmatmul_rows_plus_cuda(a, h, rows, v[:4], r)
    with pytest.raises(ValueError, match="r must be"):
        K.modmatmul_rows_plus_cuda(a, h, rows, v, r[:, :1])
    with pytest.raises(ValueError, match="batch dims disagree"):
        K.modmatmul_rows_plus_cuda(a, h, rows, v, r[:1])


def test_rows_plus_fuzz_engines():
    found = fuzz.run_fuzz(examples=24, seed=5, engines=["int32_rows_plus"], device="cpu")
    assert found == [], "\n".join(m.describe() for m in found)
    case = fuzz.Case(batch=2, m=3, k=5, n=7, p=251, mode="uniform", layout="2d", seed=7)
    a, b = fuzz.operands(case)
    a1, h, rows, v, r = fuzz.rows_plus_operands(a, b, case.p)
    assert a1.shape == (3, 1) and v.shape == (3, 4) and h.shape == (4, 7) and len(rows) == 1
    for engine in ("cuda_rows_plus", "cuda_int32_rows_plus"):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            fuzz.check_case(case, engines=[engine], device="cpu")


def _plan(s=2, t=2, z=2, n_spare=0):
    return planner.get_plan(
        constructions.build_scheme("age", s, t, z),
        planner.BlockShapes(k=8 * s, ma=4 * t, mb=6 * t, s=s, t=t), n_spare=n_spare,
    )


def _inputs(plan, batch=2, seed=1):
    rng = np.random.default_rng(seed)
    sh = plan.shapes
    return rng.integers(0, P, (batch, sh.k, sh.ma)), rng.integers(0, P, (batch, sh.k, sh.mb))


def _oracle_y(a, b):
    return np.einsum("bki,bkj->bij", a.astype(object), b.astype(object)) % P


def _reduce_counts():
    snap = REGISTRY.snapshot()["counters"]
    return snap.get("protocol.reduce.fused", 0), snap.get("protocol.reduce.unfused", 0)


def test_reduce_counts_unfused_once_per_call_on_the_cpu():
    plan = _plan()
    a, b = _inputs(plan)
    before = _reduce_counts()
    for seed in (1, 2):
        y, _ = protocol.run_batched(plan, a, b, seed=seed, device="cpu")
        np.testing.assert_array_equal(y.numpy(), _oracle_y(a, b).astype(np.int64))
    protocol.run_batched(plan, a, b, seed=3, fused_masks=True, device="cpu")  # no choice to count
    after = _reduce_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (0, 2)


def _treat_cpu_as_card(monkeypatch):
    """The dispatch rule as it reads on the card, for CPU tensors (the
    share's blocks form takes it too)."""
    rule = ops.skinny_fuses

    def on_card(backend, device, m, k, z):
        return rule(backend, CUDA, m, k, z)

    monkeypatch.setattr(ops, "skinny_fuses", on_card)
    monkeypatch.setattr(protocol, "skinny_fuses", on_card)


# 3 spares: a permuted subset of 17 senders among 20 workers
_SUBSET = [4, 0, 19, 2, 9, 1, 3, 17, 6, 8, 10, 11, 12, 13, 14, 15, 16]


@pytest.mark.parametrize("n_spare,phase2_ids", [(0, None), (3, _SUBSET)])
def test_reduce_where_the_rule_holds_counts_fused_and_gives_the_same_y(monkeypatch, n_spare, phase2_ids):
    plan = _plan(n_spare=n_spare)
    a, b = _inputs(plan, seed=n_spare)
    kw = dict(seed=5, phase2_ids=phase2_ids, backend="cuda_int32", device="cpu")
    want, _ = protocol.run_batched(plan, a, b, **kw)
    _treat_cpu_as_card(monkeypatch)
    before = _reduce_counts()
    got, _ = protocol.run_batched(plan, a, b, **kw)
    after = _reduce_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), _oracle_y(a, b).astype(np.int64))


def test_run_batched_refuses_phase2_ids_outside_the_plan():
    plan = _plan(n_spare=1)
    a, b = _inputs(plan)
    ids = list(range(plan.n_workers))
    for bad in (plan.n_total, -1):
        with pytest.raises(ValueError, match="phase2_ids"):
            protocol.run_batched(plan, a, b, phase2_ids=ids[:-1] + [bad], device="cpu")


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors through the kernel wrappers' launch paths: the device
    check passes, each launch writes its plain version's result and is
    counted as on the card, and the rule reads as on the card."""
    variant_of = lambda design: design.split("_")[0]  # noqa: E731

    def launch_into(lib, design, a, b, out, p, v=None, key=(0, 0)):
        variant = variant_of(design)
        out.copy_(ref.PLAIN[variant](a, b, p) if v is None
                  else ref.modmatmul_masked_plain(a, b, v, key, p, variant))
        return 0

    def launch_rows_plus_into(lib, design, a, h, rows, v, r, out, p):
        out.copy_(ref.modmatmul_rows_plus_plain(a, h, rows, v, r, p, variant_of(design)))
        return 0

    def launch_blocks_plus_into(lib, design, a, x, offsets, bc, ld, v, r, out, p):
        out.copy_(ref.modmatmul_blocks_plus_plain(a, x, offsets, bc, ld, v, r, p, variant_of(design)))
        return 0

    monkeypatch.setattr(K, "_check_device", lambda name, *tensors: None)
    monkeypatch.setattr(K, "load_library", lambda: None)
    monkeypatch.setattr(K, "launch_into", launch_into)
    monkeypatch.setattr(K, "launch_rows_plus_into", launch_rows_plus_into)
    monkeypatch.setattr(K, "launch_blocks_plus_into", launch_blocks_plus_into)
    monkeypatch.setattr(ops, "modmatmul_cuda", lambda a, b, p, variant: K._launch(variant, a, b, p))
    monkeypatch.setattr(ops, "modmatmul_rows_plus_cuda",
                        lambda a, h, rows, v, r, p, variant: K._launch_rows_plus(variant, a, h, rows, v, r, p))
    monkeypatch.setattr(ops, "modmatmul_blocks_plus_cuda",
                        lambda a, x, offsets, bc, ld, v, r, p, variant:
                        K._launch_blocks_plus(variant, a, x, offsets, bc, ld, v, r, p))
    _treat_cpu_as_card(monkeypatch)
    K.reset_launch_counts()
    yield
    K.reset_launch_counts()


@pytest.mark.parametrize("variant", ["int32", "f32"])
def test_a_call_records_the_reduce_once_as_k_plus_z_rows(fake_card, variant):
    plan = _plan()
    a, b = _inputs(plan, batch=3)
    backend = {"int32": "cuda_int32", "f32": "cuda"}[variant]
    y, _ = protocol.run_batched(plan, a, b, seed=4, backend=backend, device="cpu")
    np.testing.assert_array_equal(y.numpy(), _oracle_y(a, b).astype(np.int64))
    assert {k: c for k, c in K.LAUNCHES.items() if c} == {f"modmatmul_{variant}": 5}
    # every product of this small plan is skinny, the P2 multiply too
    assert {k: c for k, c in K.LAUNCHES_BY_KERNEL.items() if c} == {f"{variant}_skinny": 5}
    sh = plan.shapes
    blk = sh.blk_y[0] * sh.blk_y[1]
    reduce_shape = (3, plan.n_total, plan.n_workers + plan.scheme.z, blk)
    assert K.LAUNCH_SHAPES_BY_KERNEL[f"{variant}_skinny"][reduce_shape] == 1
    assert K.LAUNCH_SHAPES[f"modmatmul_{variant}"][reduce_shape] == 1


def test_a_call_outside_the_rule_keeps_the_mix_and_noise_launches(fake_card):
    plan = _plan(s=4, t=2, z=4)  # 35 workers: past the skinny designs' 32 rows
    a, b = _inputs(plan)
    before = _reduce_counts()
    y, _ = protocol.run_batched(plan, a, b, seed=4, backend="cuda_int32", device="cpu")
    after = _reduce_counts()
    np.testing.assert_array_equal(y.numpy(), _oracle_y(a, b).astype(np.int64))
    assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
    assert K.LAUNCHES["modmatmul_int32"] == 6
    sh = plan.shapes
    blk = sh.blk_y[0] * sh.blk_y[1]
    n, nw, z = plan.n_total, plan.n_workers, plan.scheme.z
    assert K.LAUNCH_SHAPES["modmatmul_int32"][(2, n, nw, blk)] == 1  # the mix
    assert K.LAUNCH_SHAPES["modmatmul_int32"][(2, n, z, blk)] == 1  # the noise
