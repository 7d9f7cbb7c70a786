"""The port on the card: each CUDA kernel against its plain version, and
the batched engine and the edge runtime through the kernels against the
same entry points on the CPU.

Every test here needs a CUDA GPU and skips without one.  The file
imports torch, numpy and the port only, so it runs on a machine without
JAX:  ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import runtime
from repro_torch.core import constructions, gf, planner, protocol
from repro_torch.kernels.modmatmul import kernel as K
from repro_torch.kernels.modmatmul import ops, ref

pytestmark = pytest.mark.cuda

P = 65521


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the GPU machine)")
    return torch.device("cuda")


def _draw(rng, shape, mode, p=P):
    if mode == "uniform":
        return rng.integers(0, p, shape)
    if mode == "maximal":
        return np.full(shape, p - 1)
    if mode == "near_p":
        return p - 1 - rng.integers(0, 9, shape)
    if mode == "high_limb":  # both 8-bit limbs dense-high, clipped below p
        return np.minimum(rng.integers(192, 256, shape) * 256 + rng.integers(192, 256, shape), p - 1)
    raise ValueError(mode)


# (a shape, b shape, p, mode) by the int32 design each lands on: shared
# operands on either side, ragged M/N/K around the tiles and the lazy
# reduction, a deep K; for skinny also the M/K cap, each row bucket and
# N % 4 != 0.  The f32 variant runs each case on its own design of the
# same shape rule: "wgmma" where int32 takes "mma", "skinny" otherwise.
_CASES = {
    "mma": [
        ((3, 17, 129), (3, 129, 100), 65521, "uniform"),
        ((2, 70, 257), (257, 65), 65519, "high_limb"),
        ((2, 33, 128), (2, 128, 77), 4093, "near_p"),
        ((40, 8192), (8192, 50), 65521, "high_limb"),
        ((2, 33, 32), (2, 32, 100), 65521, "maximal"),
    ],
    "skinny": [
        ((17, 6), (4, 6, 1000), 65521, "maximal"),
        ((2, 32, 32), (2, 32, 1001), 65521, "maximal"),
        ((6, 6), (3, 6, 4093), 65519, "high_limb"),
        ((3, 9, 17), (17, 7), 4093, "near_p"),
        ((1, 1), (1, 1), 65521, "uniform"),
    ],
}
_KERNEL_CASES = [(variant, design, case) for design, cases in _CASES.items()
                 for case in cases for variant in ("int32", "f32")]


@pytest.mark.parametrize(
    "variant,design,case", _KERNEL_CASES,
    ids=lambda x: x if isinstance(x, str) else f"{x[0]}@{x[1]}-{x[3]}",
)
def test_kernel_matches_plain_version(cuda, variant, design, case):
    sa, sb, p, mode = case
    rng = np.random.default_rng(len(sa) * 1000 + sa[-1])
    a, b = (torch.as_tensor(_draw(rng, s, mode, p), dtype=torch.int32, device=cuda) for s in (sa, sb))
    # z = 5 crosses one 4-row pass of a tiled epilogue's mask generation
    v = torch.as_tensor(_draw(rng, (sa[-2], 5), mode, p), dtype=torch.int32, device=cuda)
    K.reset_launch_counts()
    got = K.modmatmul_cuda(a, b, p, variant)
    gotm = K.modmatmul_masked_cuda(a, b, v, (5, 6), p, variant)
    torch.cuda.synchronize()
    assert K.LAUNCHES[f"modmatmul_{variant}"] == 1
    assert K.LAUNCHES[f"modmatmul_{variant}_masked"] == 1
    ran = design if variant == "int32" else {"mma": "wgmma", "skinny": "skinny"}[design]
    assert {k: v for k, v in K.LAUNCHES_BY_KERNEL.items() if v} == {
        f"{variant}_{ran}": 1, f"{variant}_{ran}_masked": 1}
    assert torch.equal(got, ref.PLAIN[variant](a, b, p))
    assert torch.equal(gotm, ref.modmatmul_masked_plain(a, b, v, (5, 6), p, variant))
    np.testing.assert_array_equal(got.cpu().numpy(), ref.modmatmul_ref(a.cpu(), b.cpu(), p))


def test_int32_kernel_folds_past_the_raw_accumulator_bound(cuda):
    for k in (K.MMA_FOLD_K + 1, 2 * gf.INT32_ACC_K + 5):
        a = torch.full((3, k), P - 1, dtype=torch.int32, device=cuda)
        b = torch.full((k, 5), P - 1, dtype=torch.int32, device=cuda)
        got = K.modmatmul_cuda(a, b, P, "int32")
        assert bool((got == (k * (P - 1) ** 2) % P).all())


@pytest.mark.parametrize("k", [127, 129, 255, 257, 4 * 128 + 1, 2 * 33024 + 5])
def test_f32_kernel_folds_at_every_period(cuda, k):
    # all operands p - 1: every limb sum at its largest, crossing the 128 K
    # fold of either consumer warpgroup (the second folds first after 64)
    a = torch.full((2, 130, k), P - 1, dtype=torch.int32, device=cuda)
    b = torch.full((2, k, 129), P - 1, dtype=torch.int32, device=cuda)
    K.reset_launch_counts()
    got = K.modmatmul_cuda(a, b, P, "f32")
    assert K.LAUNCHES_BY_KERNEL["f32_wgmma"] == 1
    assert bool((got == (k * (P - 1) ** 2) % P).all())


@pytest.mark.parametrize("variant", ["int32", "f32"])
@pytest.mark.parametrize("sa,sb", [((40, 6), (6, 10_000_000)), ((70_000, 40), (40, 8))])
def test_tensor_core_designs_take_wide_and_tall_grids(cuda, variant, sa, sb):
    # N tiles past grid.y's 65535, and M past it for f32_wgmma's A split
    rng = np.random.default_rng(9)
    a, b = (torch.as_tensor(_draw(rng, s, "uniform"), dtype=torch.int32, device=cuda) for s in (sa, sb))
    K.reset_launch_counts()
    got = K.modmatmul_cuda(a, b, P, variant)
    assert K.LAUNCHES_BY_KERNEL["int32_mma" if variant == "int32" else "f32_wgmma"] == 1
    assert torch.equal(got, ref.PLAIN[variant](a, b, P))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    a = torch.ones((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.modmatmul_cuda(a.t(), a, P)
    with pytest.raises(ValueError, match="int32"):
        K.modmatmul_cuda(a.long(), a.t().contiguous().long(), P)
    with pytest.raises(ValueError, match="CPU tensors only"):
        ops.mod_matmul(a, a.t().contiguous(), backend="int32")


def _run_on_card_and_cpu(k, ma, mb, fused):
    plan = planner.get_plan(
        constructions.build_scheme("age", 2, 2, 2),
        planner.BlockShapes(k=k, ma=ma, mb=mb, s=2, t=2),
    )
    rng = np.random.default_rng(5)
    a = rng.integers(0, P, (3, k, ma))
    b = rng.integers(0, P, (3, k, mb))
    want, _ = protocol.run_batched(plan, a, b, seed=2, fused_masks=fused, device="cpu")
    K.reset_launch_counts()
    got, _ = protocol.run_batched(plan, a, b, seed=2, fused_masks=fused)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    return plan, a, b


@pytest.mark.parametrize("fused", [False, True])
def test_run_batched_on_the_card_equals_the_cpu_run(cuda, fused):
    plan, a, b = _run_on_card_and_cpu(64, 32, 48, fused)
    expect = {"modmatmul_int32": 2, "modmatmul_int32_masked": 3} if fused else {"modmatmul_int32": 6}
    assert {k: v for k, v in K.LAUNCHES.items() if v} == expect
    # at k = 64 every product is skinny, the P2 multiply ([16, 32] blocks) too
    expect = {"int32_skinny": 2, "int32_skinny_masked": 3} if fused else {"int32_skinny": 6}
    assert {k: v for k, v in K.LAUNCHES_BY_KERNEL.items() if v} == expect
    if fused:  # the in-kernel mask stream: shares bit-identical to the CPU's
        key = gf.prng_key(9)
        for x, y in zip(
            protocol.share_batched(plan, a, b, key, fused_masks=True),
            protocol.share_batched(plan, a, b, key, fused_masks=True, device="cpu"),
        ):
            assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("fused", [False, True])
def test_run_batched_reaches_the_tensor_core_kernel(cuda, fused):
    # k = 128: the P2 multiply is [32, 64] @ [64, 24], too deep for skinny
    _run_on_card_and_cpu(128, 64, 48, fused)
    expect = ({"int32_mma": 1, "int32_skinny": 1, "int32_skinny_masked": 3} if fused
              else {"int32_mma": 1, "int32_skinny": 5})
    assert {k: v for k, v in K.LAUNCHES_BY_KERNEL.items() if v} == expect


# ----------------------------------------------------------------------
# the edge runtime at a reduced width (k = 256, ma = 32, mb = 64)
# ----------------------------------------------------------------------
def _same(x, y, what):
    """Exact equality of runtime results: arrays, dataclasses, floats."""
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=what)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _same(getattr(x, f.name), getattr(y, f.name), f"{what}.{f.name}")
    elif isinstance(x, float) and np.isnan(x):
        assert np.isnan(y), what
    else:
        assert x == y, (what, x, y)


def _edge_setup(depth=1):
    plan = planner.get_plan(
        constructions.build_scheme("age", 2, 2, 2),
        planner.BlockShapes(k=256, ma=32, mb=64, s=2, t=2), n_spare=3,
    )
    rng = np.random.default_rng(12)
    a = rng.integers(0, P, (depth, 4, 256, 32))
    b = rng.integers(0, P, (depth, 4, 256, 64))
    traces = [
        runtime.sample_trace(
            plan.n_total, runtime.ShiftedExponential(1.0, 1.0),
            runtime.FaultSpec(straggler_frac=0.2), seed=7 + k,
        ).with_faults(dropout_ids=[2 + k], corrupt_ids=[1])
        for k in range(depth)
    ]
    want = np.einsum("rbki,rbkj->rbij", a.astype(object), b.astype(object)) % P
    return plan, a, b, traces, want.astype(np.int64)


@pytest.mark.parametrize("backend", ["auto", "cuda"])
@pytest.mark.parametrize("mode", ["detect", "correct"])
def test_edge_replays_on_the_card_equal_the_cpu_run(cuda, backend, mode):
    plan, a, b, traces, want = _edge_setup()
    kw = dict(seed=3, decode_mode=mode, verify_extras=1, error_budget=1, backend=backend)
    cpu = runtime.run_batch_over_pool(plan, a[0], b[0], traces[0], device="cpu", **kw)
    K.reset_launch_counts()
    card = runtime.run_batch_over_pool(plan, a[0], b[0], traces[0], **kw)
    variant = "int32" if backend == "auto" else "f32"
    deep = "int32_mma" if backend == "auto" else "f32_wgmma"
    assert {k: v for k, v in K.LAUNCHES_BY_KERNEL.items() if v} == {
        deep: 1, f"{variant}_skinny": 4}
    np.testing.assert_array_equal(card.y, want[0])
    np.testing.assert_array_equal(card.y, cpu.y)
    _same(cpu.metrics, card.metrics, "batched replay")
    bad = card.metrics.rejected_ids if mode == "detect" else card.metrics.corrected_workers
    assert 1 in bad.tolist() and 2 not in card.metrics.phase2_ids.tolist()


def test_per_product_pipeline_and_planner_on_the_card_equal_the_cpu_run(cuda):
    plan, a, b, traces, want = _edge_setup(depth=3)
    cpu = runtime.run_over_pool(plan, a[0, 0], b[0, 0], traces[0], seed=5, device="cpu")
    K.reset_launch_counts()
    card = runtime.run_over_pool(plan, a[0, 0], b[0, 0], traces[0], seed=5)
    # share A, share B, the worker-stacked multiply, mix and noise
    assert {k: v for k, v in K.LAUNCHES_BY_KERNEL.items() if v} == {
        "int32_mma": 1, "int32_skinny": 4}
    np.testing.assert_array_equal(card.y, want[0, 0])
    np.testing.assert_array_equal(card.y, cpu.y)
    _same(cpu.metrics, card.metrics, "per-product replay")
    # per-product shares come from the numpy rng: equal on the card and the CPU
    fa_card = protocol.share_a(plan, a[0, 0], np.random.default_rng(1))
    fa_cpu = protocol.share_a(plan, a[0, 0], np.random.default_rng(1), device="cpu")
    assert torch.equal(fa_card.cpu(), fa_cpu)

    cpu = runtime.run_pipeline_over_pool(plan, a, b, traces, seed=2, device="cpu")
    card = runtime.run_pipeline_over_pool(plan, a, b, traces, seed=2)
    np.testing.assert_array_equal(card.y, want)
    np.testing.assert_array_equal(card.y, cpu.y)
    _same(cpu.metrics, card.metrics, "pipeline")

    def cands():
        return [constructions.PlanConfig("age", 2, 2, 2), constructions.PlanConfig("polydot", 2, 2, 2)]

    cpu = runtime.run_adaptive_over_pool(runtime.AutoPlanner(cands()), a, b, traces, device="cpu")
    card = runtime.run_adaptive_over_pool(runtime.AutoPlanner(cands()), a, b, traces)
    np.testing.assert_array_equal(card.y, want)
    assert [d.config.label() for d in card.decisions] == [d.config.label() for d in cpu.decisions]
    for mc, mg in zip(cpu.replay_metrics, card.replay_metrics):
        _same(mc, mg, "adaptive replay")
