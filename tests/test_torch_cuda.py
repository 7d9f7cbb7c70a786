"""The port on the card: each CUDA kernel against its plain version, and
the batched engine, the edge runtime, the serving engine and the CRT
route through the kernels against the same entry points on the CPU; the
fuzz harness on the kernel engines, and ``autotune_tiles``; the reduced
dense decoder, the reduced DeepSeek-V2-Lite (MLA and MoE), the reduced
InternVL2 (with patches) and SeamlessM4T (encoder-decoder) and the
launcher's private head on the card against the CPU.

Every test here needs a CUDA GPU and skips without one.  The file
imports torch, numpy and the port only, so it runs on a machine without
JAX:  ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import argparse
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs, runtime, serve
from repro_torch.core import constructions, gf, layers, planner, protocol
from repro_torch.kernels.modmatmul import fuzz
from repro_torch.kernels.modmatmul import kernel as K
from repro_torch.kernels.modmatmul import ops, ref
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model

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


def _corrupt_among_responders(plan, seed, dropout):
    """The first trace from ``seed`` on (worker ``dropout`` dropped, worker
    1 corrupt) where worker 1's response leg is among the decode
    threshold's fastest, so that the decode meets the corrupt response
    (chip_smoke.py's ``edge_trace`` rule)."""
    for s in range(seed, seed + 1000):
        trace = runtime.sample_trace(
            plan.n_total, runtime.ShiftedExponential(1.0, 1.0),
            runtime.FaultSpec(straggler_frac=0.2), seed=s,
        ).with_faults(dropout_ids=[dropout], corrupt_ids=[1])
        leg = trace.d2d_delay + trace.uplink_delay
        order = [int(w) for w in np.argsort(leg, kind="stable") if not trace.dropout[w]]
        if 1 in order[: plan.decode_threshold]:
            return trace, s
    raise AssertionError("no trace seed puts worker 1 among the fastest responders")


def _edge_setup(depth=1):
    plan = planner.get_plan(
        constructions.build_scheme("age", 2, 2, 2),
        planner.BlockShapes(k=256, ma=32, mb=64, s=2, t=2), n_spare=3,
    )
    rng = np.random.default_rng(12)
    a = rng.integers(0, P, (depth, 4, 256, 32))
    b = rng.integers(0, P, (depth, 4, 256, 64))
    traces, seed = [], 7
    for k in range(depth):
        trace, seed = _corrupt_among_responders(plan, seed, dropout=2 + k)
        traces.append(trace)
        seed += 1
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


# ----------------------------------------------------------------------
# the serving tier, the CRT route, the fuzz harness and autotune_tiles
# ----------------------------------------------------------------------
def _serve_stream(device, backend):
    """chip_smoke.py's [serve] stream at k = 256, rows 32, out 64."""
    cfg = constructions.PlanConfig("age", 2, 2, 2)
    traces = [runtime.sample_trace(cfg.n_workers + 4, runtime.ShiftedExponential(0.1, 0.5),
                                   seed=9000 + i, net_scale=0.3) for i in range(8)]
    rng = np.random.default_rng(4)
    w = rng.normal(size=(256, 64))
    eng = serve.ServingEngine(w, traces, cfg, slo=30.0, pipe_depth=2, max_batch=4,
                              decode_mode="hybrid", backend=backend, validate=True, device=device)
    for t in np.cumsum(rng.exponential(1 / 0.6, 8)):
        eng.submit(rng.normal(size=(32, 256)), float(t))
    return eng, eng.run()


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_serving_engine_on_the_card_equals_the_cpu_run(cuda, backend):
    _, cpu = _serve_stream("cpu", backend)
    K.reset_launch_counts()
    eng, card = _serve_stream(None, backend)
    assert eng.device.type == "cuda" and eng._session.device == eng.device
    assert card.summary() == cpu.summary() and card.summary()["served"] == 8
    for rc_, rp_ in zip(card.requests, cpu.requests):
        assert (rc_.state, rc_.launch, rc_.completion, rc_.replay) == (
            rp_.state, rp_.launch, rp_.completion, rp_.replay)
        np.testing.assert_array_equal(rc_.y, rp_.y)
    # per replay: share A, share B, the Phase-2 multiply, mix and noise
    deep = "int32_mma" if backend == "auto" else "f32_wgmma"
    skinny = "int32_skinny" if backend == "auto" else "f32_skinny"
    assert {k: v for k, v in K.LAUNCHES_BY_KERNEL.items() if v} == {
        deep: card.replays, skinny: 4 * card.replays}


@pytest.mark.parametrize("backend", ["auto", "cuda"])
@pytest.mark.parametrize("fused", [False, True])
def test_secure_matmul_crt_on_the_card_equals_the_cpu_run(cuda, backend, fused):
    rng = np.random.default_rng(6)
    a = rng.normal(size=(2, 128, 32))
    b = rng.normal(size=(2, 128, 64))
    kw = dict(s=2, t=2, z=2, backend=backend, fused_masks=fused)
    cpu = layers.secure_matmul_crt(a, b, device="cpu", **kw)
    K.reset_launch_counts()
    card = layers.secure_matmul_crt(a, b, **kw)
    torch.cuda.synchronize()
    assert card.y.device.type == "cuda"
    assert torch.equal(card.y.cpu(), cpu.y)
    variant = "int32" if backend == "auto" else "f32"
    # twice run_batched's launches: one pass per prime
    expect = ({f"modmatmul_{variant}": 4, f"modmatmul_{variant}_masked": 6} if fused
              else {f"modmatmul_{variant}": 12})
    assert {k: v for k, v in K.LAUNCHES.items() if v} == expect
    x = rng.integers(-(2**20), 2**20, (40, 300))
    y = rng.integers(-(2**20), 2**20, (300, 33))
    want = (x.astype(object) @ y.astype(object)) % (65521 * 65519)
    got = ops.mod_matmul_crt(torch.as_tensor(x, device=cuda), torch.as_tensor(y, device=cuda),
                             backend="cuda_int32" if backend == "auto" else "cuda")
    np.testing.assert_array_equal(got, want.astype(np.int64))
    with pytest.raises(ValueError, match="two devices"):
        ops.mod_matmul_crt(torch.as_tensor(x), torch.as_tensor(y, device=cuda))


def test_fuzz_kernel_engines_clean(cuda):
    K.reset_launch_counts()
    found = fuzz.run_fuzz(examples=32, seed=1, engines=["cuda", "cuda_int32", "crt"])
    assert found == [], "\n".join(m.describe() for m in found)
    # the cases straddle the skinny / tensor-core boundary on both variants
    launched = {k for k, v in K.LAUNCHES_BY_KERNEL.items() if v}
    assert {"int32_mma", "int32_skinny", "f32_wgmma", "f32_skinny"} <= launched


@pytest.mark.parametrize("backend", ["cuda_int32", "cuda"])
@pytest.mark.parametrize("shape", [(5, 7, 9), (40, 300, 70)])
def test_autotune_tiles_on_the_card(cuda, backend, shape, monkeypatch):
    monkeypatch.setattr(ops, "_AUTOTUNE_CACHE", {})
    m, k, n = shape
    compiled = ops.pick_tiles(m, k, n, backend=backend)
    assert ops.autotune_tiles(m, k, n, backend=backend, batch=2) == compiled
    assert ops._AUTOTUNE_CACHE == {(backend, m, k, n, 0): compiled}
    rng = np.random.default_rng(m)
    a, b = (torch.as_tensor(rng.integers(0, P, s), dtype=torch.int32, device=cuda)
            for s in ((m, k), (k, n)))
    assert torch.equal(ops.mod_matmul(a, b, backend=backend).cpu(),
                       ref.PLAIN["int32"](a.cpu(), b.cpu(), P))


# the reduced dense decoder, card against CPU on one set of weights.
# float32: the card's float32 matmuls (TF32 off, PyTorch's default) sum
# in another order than the CPU's, as tests/test_torch_models.py allows
# between the packages; bfloat16: the card and the CPU round products
# and sums to bfloat16 at other points, 2**-5 of the largest value.
MODEL_TOL = {"float32": lambda ref: 2e-4, "bfloat16": lambda ref: 2.0**-5 * ref.abs().max().item()}


def _model_pair(cuda, dtype, arch="mistral-nemo-12b"):
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)), compute_dtype=dtype)
    cpu = build_model(cfg, seed=5, device="cpu")
    card = build_model(cfg, seed=6, device=cuda)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_model_on_the_card_equals_the_cpu_run(cuda, dtype):
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu, card = _model_pair(cuda, dtype)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        logits, cache = model.prefill({"tokens": prompts}, model.init_cache(2, 11))
        tok = prompts[:, -1:]
        steps = []
        for i in range(3):
            pos = np.full((2, 1), 8 + i, np.int32)
            hidden, cache = model.hidden_step(tok, cache, pos)
            steps.append(hidden.float().cpu())
        out[name] = (logits.float().cpu(), steps, {k: v.float().cpu() for k, v in cache["layers"].items()})
    (lc, hc, cc), (lg, hg, cg) = out["cpu"], out["card"]
    tol = MODEL_TOL[dtype]
    assert (lg - lc).abs().max().item() <= tol(lc)
    for a, b in zip(hc, hg):
        assert (b - a).abs().max().item() <= tol(a)
    assert torch.equal(cc["idx"], cg["idx"])
    for k in ("k", "v"):
        if dtype == "float32":  # float32 K/V rounded into bfloat16 buffers: one ulp apart
            assert ((cg[k] - cc[k]).abs() <= 2.0**-7 * cc[k].abs() + 1e-6).all()
        else:  # K/V computed in bfloat16: the compute tolerance
            assert (cg[k] - cc[k]).abs().max().item() <= tol(cc[k])


def test_private_head_on_the_card_equals_the_cpu_run(cuda):
    """The launcher's private-head decode at the reduced width with
    float32 compute: the same tokens and engine summary on the card as
    on the CPU, every step served."""
    cfg, cpu, card = _model_pair(cuda, "float32")
    args = argparse.Namespace(batch=2, prompt_len=8, gen_len=4, workers=16)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        logits, cache = model.prefill({"tokens": prompts}, model.init_cache(2, 12))
        tok = launcher.argmax_last(logits, cfg.vocab_size)
        steps, report, worst = launcher._decode_private_head(args, cfg, model, cache, tok)
        out[name] = (tok, steps, report.summary(),
                     [r.y[:2].argmax(-1) for r in report.requests])
    assert out["card"][2]["served"] == out["card"][1] == 3
    np.testing.assert_array_equal(out["card"][0], out["cpu"][0])
    assert out["card"][1:3] == out["cpu"][1:3]
    for a, b in zip(out["card"][3], out["cpu"][3]):
        np.testing.assert_array_equal(a, b)


def test_reduced_deepseek_on_the_card_equals_the_cpu_run(cuda):
    """Reduced DeepSeek-V2-Lite (MLA, a dense first layer, MoE) at
    float32 with TF32 off: prefill and three decode steps on the card
    against the CPU on the same weights, both feeding the CPU's greedy
    tokens.  The c / k_rope caches are held in float32 here: in the
    bfloat16 buffers a last-bit difference between the two sides can
    flip a rounding (observed: 3.2e-4 on logits of magnitude ~4), which
    the Mistral test above already covers.  So logits and caches within
    the float32 tolerance of ``tests/test_torch_moe.py`` (one rounding per
    operation in another order), and the same greedy tokens."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu, card = _model_pair(cuda, "float32", "deepseek-v2-lite-16b")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        cache = {g: {n: c.float() if c.is_floating_point() else c for n, c in leaves.items()}
                 for g, leaves in model.init_cache(2, 11).items()}
        logits, cache = model.prefill({"tokens": prompts}, cache)
        steps = [logits.cpu()]
        for i in range(3):  # both feed the CPU run's greedy tokens
            lead = steps if name == "cpu" else out["cpu"][0]
            tok = launcher.argmax_last(lead[i], cfg.vocab_size)
            logits, cache = model.decode_step(tok[:, None], cache, np.full((2, 1), 8 + i, np.int32))
            steps.append(logits.cpu())
        out[name] = (steps, {f"{g}.{n}": c.cpu() for g in cache for n, c in cache[g].items()})
    (lc, cc), (lg, cg) = out["cpu"], out["card"]
    assert sorted(cc) == sorted(cg) and "dense_0.c" in cc and "layers.k_rope" in cc
    for a, b in zip(lc, lg):
        assert torch.allclose(b, a, rtol=1e-4, atol=2e-4), (b - a).abs().max().item()
        np.testing.assert_array_equal(launcher.argmax_last(b, cfg.vocab_size),
                                      launcher.argmax_last(a, cfg.vocab_size))
    for k in cc:
        if k.endswith("idx"):
            assert torch.equal(cc[k], cg[k])
        else:
            assert cg[k].dtype == torch.float32, k
            assert torch.allclose(cg[k], cc[k], rtol=1e-4, atol=2e-4), k


def _float32_caches(cache):
    """A cache tree with its floating leaves in float32 (as the DeepSeek
    test above holds them: no bfloat16 rounding flips between sides)."""
    return {k: _float32_caches(v) if isinstance(v, dict) else
            (v.float() if v.is_floating_point() else v) for k, v in cache.items()}


def _flat(cache, prefix=""):
    out = {}
    for k, v in cache.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v.cpu()})
    return out


def _decode_on_both(cfg, cpu, card, batch, max_len, pos0):
    """Prefill ``batch``, then three greedy decode steps on the CPU and on
    the card (both feeding the CPU's tokens) with float32 caches; the
    logits and caches of both within the float32 tolerance of the CPU
    tests, and the same greedy tokens."""
    out = {}
    b = len(batch["tokens"])
    for name, model in (("cpu", cpu), ("card", card)):
        logits, cache = model.prefill(batch, _float32_caches(model.init_cache(b, max_len)))
        steps = [logits.cpu()]
        for i in range(3):
            lead = steps if name == "cpu" else out["cpu"][0]
            tok = launcher.argmax_last(lead[i], cfg.vocab_size)
            logits, cache = model.decode_step(tok[:, None], cache, np.full((b, 1), pos0 + i, np.int32))
            steps.append(logits.cpu())
        out[name] = (steps, _flat(cache))
    (lc, cc), (lg, cg) = out["cpu"], out["card"]
    assert sorted(cc) == sorted(cg)
    for a, g in zip(lc, lg):
        assert torch.isfinite(g).all()
        assert torch.allclose(g, a, rtol=1e-4, atol=2e-4), (g - a).abs().max().item()
        np.testing.assert_array_equal(launcher.argmax_last(g, cfg.vocab_size),
                                      launcher.argmax_last(a, cfg.vocab_size))
    for k in cc:
        if cc[k].is_floating_point():
            assert cg[k].dtype == torch.float32, k
            assert torch.allclose(cg[k], cc[k], rtol=1e-4, atol=2e-4), k
        else:
            assert torch.equal(cc[k], cg[k]), k
    return cc


def test_reduced_internvl2_with_patches_on_the_card_equals_the_cpu_run(cuda):
    """Reduced InternVL2 at float32 with TF32 off: a prefill of 8 patch
    embeddings and 8 tokens, then three decode steps from position 16."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu, card = _model_pair(cuda, "float32", "internvl2-26b")
    rng = np.random.default_rng(4)
    batch = {"patches": rng.normal(size=(2, cfg.frontend_len, cfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)}
    caches = _decode_on_both(cfg, cpu, card, batch, cfg.frontend_len + 12, cfg.frontend_len + 8)
    assert int(caches["layers.idx"][0]) == cfg.frontend_len + 11


def test_reduced_seamless_on_the_card_equals_the_cpu_run(cuda):
    """Reduced SeamlessM4T at float32 with TF32 off: 12 frames encoded and
    two decoder tokens prefilled, the cached ``enc_out`` (float32 here)
    padded to 16 with ``enc_len`` 12, then three decode steps."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu, card = _model_pair(cuda, "float32", "seamless-m4t-large-v2")
    rng = np.random.default_rng(5)
    batch = {"frames": rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)}
    caches = _decode_on_both(cfg, cpu, card, batch, 16, 12)
    assert int(caches["enc_len"]) == 12 and not caches["enc_out"][:, 12:].any()
    assert card.hidden_step is None and card.head_matrix is None


RECURRENT = ("xlstm-1.3b", "zamba2-2.7b")


@pytest.mark.parametrize("arch", RECURRENT)
def test_reduced_recurrent_model_on_the_card_equals_the_cpu_run(cuda, arch):
    """Reduced xLSTM and Zamba2 at float32 with TF32 off, every
    zero-initialised leaf (the gate and conv biases, A, the step bias,
    the LoRA b_q) drawn from seeded normals on both sides: a prefill of
    34 tokens (17 mLSTM and 17 Mamba2 chunks of 2), then three decode
    steps, logits and every cache leaf within the float32 tolerance."""
    from repro_torch.models import registry
    from repro_torch.models.common import iter_leaves

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu, card = _model_pair(cuda, "float32", arch)
    gen = torch.Generator().manual_seed(7)
    kinds = {name: info.init for name, info in iter_leaves(registry.params_abstract(cfg))}
    sd = {k: torch.randn(v.shape, generator=gen) * 0.5 if kinds[k] == "zeros" else v
          for k, v in cpu.state_dict().items()}
    cpu.load_state_dict(sd)
    card.load_state_dict(sd)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 34)).astype(np.int32)
    caches = _decode_on_both(cfg, cpu, card, {"tokens": prompts}, 40, 34)
    if arch == "zamba2-2.7b":
        assert caches["shared.idx"].tolist() == [37, 37]
    assert card.hidden_step is None and card.head_matrix is None


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_init_cache_on_the_card(cuda, arch):
    """``init_cache`` on the device: every leaf named ``m`` at -1e30,
    every other at zero, in the CPU model's shapes and dtypes."""
    _, cpu, card = _model_pair(cuda, "bfloat16", arch)
    got = card.init_cache(2, 8)
    flat = _flat(got)
    assert all(v.device.type == "cuda" for v in _leaves(got))
    want = _flat(cpu.init_cache(2, 8))
    assert {k: (v.shape, v.dtype) for k, v in flat.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}
    for k, v in flat.items():
        fill = -1e30 if k.endswith(".m") else 0
        assert torch.equal(v, torch.full_like(v, fill)), k
    assert any(k.endswith(".m") for k in flat) == (arch == "xlstm-1.3b")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


@pytest.mark.parametrize("arch", RECURRENT)
def test_launcher_recurrent_runs_on_the_card(cuda, arch, capsys):
    launcher.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "20",
                   "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "on cuda" in out and "ms/step (batch 2)" in out
    with pytest.raises(SystemExit, match="does not expose one"):
        launcher.main(["--arch", arch, "--reduced", "--private-head", "--batch", "2",
                       "--prompt-len", "8", "--gen-len", "4"])


def test_launcher_encdec_runs_on_the_card(cuda, capsys):
    launcher.main(["--arch", "seamless-m4t-large-v2", "--reduced", "--batch", "2",
                   "--prompt-len", "8", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "on cuda" in out and "ms/step (batch 2)" in out
    with pytest.raises(SystemExit, match="does not expose one"):
        launcher.main(["--arch", "seamless-m4t-large-v2", "--reduced", "--private-head",
                       "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])


def test_launcher_private_head_runs_on_the_card(cuda):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mistral-nemo-12b",
         "--reduced", "--private-head", "--batch", "2", "--prompt-len", "8", "--gen-len", "4"],
        capture_output=True, text=True, timeout=600, cwd=".",
        env=dict(os.environ, PYTHONPATH="src"),
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "on cuda" in res.stdout
    assert "private head: 3 protocol replays over 3 steps on 16 workers" in res.stdout


# ----------------------------------------------------------------------
# the sharded Phase 2: a one-rank group, NCCL for the card's tensors and
# gloo for the CPU's, so one process holds both meshes
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def meshes():
    """(a ``workers`` mesh on the card over NCCL, one on the CPU over gloo)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the GPU machine)")
    import torch.distributed as dist

    from repro_torch.core import distributed

    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield distributed.workers_mesh("cuda"), distributed.workers_mesh("cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["all_to_all", "psum", "psum_scatter"])
def test_sharded_phase2_on_the_card_equals_the_cpu_run(meshes, mode):
    from repro_torch.core import distributed

    card_mesh, cpu_mesh = meshes
    plan, a, b, _, want = _edge_setup()
    a, b, want = a[0], b[0], want[0]
    fa, fb = protocol.share_batched(plan, a, b, gf.prng_key(4), device="cpu")
    rng = np.random.default_rng(8)
    noise = rng.integers(0, P, (4, plan.n_workers, plan.scheme.z) + plan.shapes.blk_y)
    ids = np.array([i for i in range(plan.n_total) if i not in (0, 2)])[: plan.n_workers]
    for worker_ids in (None, ids):
        cpu = distributed.run_phase2_sharded(plan, fa, fb, noise, cpu_mesh, mode=mode,
                                             worker_ids=worker_ids)
        card = distributed.run_phase2_sharded(plan, fa.cuda(), fb.cuda(), noise, card_mesh,
                                              mode=mode, worker_ids=worker_ids)
        assert card.device.type == "cuda" and torch.equal(card.cpu(), cpu)
    # the card's mesh refuses CPU tensors: nothing is staged through the host
    with pytest.raises(ValueError, match="cuda mesh cannot take tensors on cpu"):
        distributed.run_phase2_sharded(plan, fa, fb, noise, card_mesh, mode=mode)
    kw = dict(mode=mode, seed=3, phase2_ids=ids, phase3_ids=np.arange(2, 2 + plan.decode_threshold))
    y_cpu, _ = protocol.run_batched_sharded(plan, a, b, cpu_mesh, **kw)
    K.reset_launch_counts()
    y_card, _ = protocol.run_batched_sharded(plan, a, b, card_mesh, **kw)
    torch.cuda.synchronize()
    # shares A and B, the per-shard multiply, the decode: the mix is tensor ops
    assert sum(K.LAUNCHES_BY_KERNEL.values()) == 4
    assert y_card.device.type == "cuda"
    np.testing.assert_array_equal(y_card.cpu().numpy(), want)
    np.testing.assert_array_equal(y_cpu.numpy(), want)


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_mesh_edge_and_serving_on_the_card_equal_the_cpu_run(meshes, backend):
    card_mesh, cpu_mesh = meshes
    plan, a, b, traces, want = _edge_setup()
    kw = dict(seed=3, decode_mode="correct", verify_extras=1, error_budget=1, backend=backend,
              mode="psum_scatter")
    cpu = runtime.run_batch_over_pool(plan, a[0], b[0], traces[0], mesh=cpu_mesh, device="cpu",
                                      **kw)
    card = runtime.run_batch_over_pool(plan, a[0], b[0], traces[0], mesh=card_mesh, **kw)
    np.testing.assert_array_equal(card.y, want[0])
    np.testing.assert_array_equal(card.y, cpu.y)
    _same(cpu.metrics, card.metrics, "mesh batched replay")
    assert 1 in card.metrics.corrected_workers.tolist()

    reports = []
    for device, mesh in (("cpu", cpu_mesh), (None, card_mesh)):
        cfg = constructions.PlanConfig("age", 2, 2, 2)
        traces = [runtime.sample_trace(cfg.n_workers + 4, runtime.ShiftedExponential(0.1, 0.5),
                                       seed=9000 + i, net_scale=0.3) for i in range(4)]
        rng = np.random.default_rng(4)
        eng = serve.ServingEngine(rng.normal(size=(256, 64)), traces, cfg, slo=30.0, max_batch=4,
                                  backend=backend, mesh=mesh, device=device)
        for t in np.cumsum(rng.exponential(1 / 0.6, 4)):
            eng.submit(rng.normal(size=(32, 256)), float(t))
        reports.append(eng.run())
    cpu_rep, card_rep = reports
    assert card_rep.summary() == cpu_rep.summary() and card_rep.summary()["served"] == 4
    for rc_, rp_ in zip(card_rep.requests, cpu_rep.requests):
        np.testing.assert_array_equal(rc_.y, rp_.y)


# ----------------------------------------------------------------------
# the training path (float32 compute, TF32 off: the card against the CPU)
# ----------------------------------------------------------------------
def _reduced_trainer(device, weights=None):
    from repro_torch import convert

    cfg = dataclasses.replace(configs.reduced(configs.get_config("minicpm-2b")),
                              compute_dtype="float32")
    model = build_model(cfg, seed=0, device=device, train=True)
    if weights is not None:
        model.load_state_dict(convert.decoder_params_from_reference(cfg, weights))
    return cfg, model


def test_reduced_train_step_on_the_card_equals_the_cpu_run(cuda):
    """Three train steps of the reduced MiniCPM from the same weights:
    metrics within 1e-4 relative, parameters within 2 x the summed
    learning rates (an entry with a near-zero gradient can take either
    sign of m / sqrt(v)) and within 1e-5 for all but 1e-3 of them."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.common import iter_leaves, map_tree
    from repro_torch.train.optimizer import adamw_init

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu_model = _reduced_trainer("cpu")
    weights = map_tree(lambda _, a: a.detach().numpy(), cpu_model.params())
    _, card_model = _reduced_trainer(cuda, weights)
    shape = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=32, global_batch=4)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4))
    runs = []
    for model in (cpu_model, card_model):
        step = build_train_step(model, None, shape, lr=1e-3, schedule="wsd", total_steps=3)
        params, opt, metrics = model.params(), None, []
        opt = adamw_init(params, step.opt_cfg)
        for i in range(3):
            params, opt, m = step(params, opt, data.batch(i))
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((params, metrics))
    (cpu_params, cpu_m), (card_params, card_m) = runs
    for c, g in zip(cpu_m, card_m):
        for k in c:
            assert g[k] == pytest.approx(c[k], rel=1e-4, abs=1e-9), (k, c, g)
    bound = 2 * sum(m["lr"] for m in cpu_m)
    beyond = total = 0
    for (name, c), (_, g) in zip(iter_leaves(cpu_params), iter_leaves(card_params)):
        assert g.device.type == "cuda"
        diff = (g.detach().cpu() - c.detach()).abs()
        assert float(diff.max()) <= bound, name
        beyond += int((diff > 1e-5).sum())
        total += diff.numel()
    assert beyond / total < 1e-3


def test_chunked_softmax_xent_on_the_card(cuda):
    """The loss and both gradients over 100 tokens in chunks of 32 (the
    last padded) against a head of 1000 padded to 1024 columns, -1 labels
    ignored: the card within 2**-10 of each value's largest."""
    from repro_torch.models.common import chunked_softmax_xent

    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((4, 25, 64), generator=gen)
    head = torch.randn((64, 1024), generator=gen) * 0.2
    labels = torch.randint(0, 1000, (4, 25), generator=gen)
    labels[1, 3] = labels[3, 24] = -1
    out = {}
    for device in ("cpu", cuda):
        # fresh leaves on each side (``to`` returns the tensor itself on its device)
        xs = x.detach().to(device).requires_grad_(True)
        hs = head.detach().to(device).requires_grad_(True)
        loss = chunked_softmax_xent(xs, hs, labels.to(device), logit_scale=0.3, chunk=32,
                                    n_vocab=1000)
        loss.backward()
        out[str(device)] = (loss.detach().cpu(), xs.grad.cpu(), hs.grad.cpu())
    for c, g in zip(out["cpu"], out["cuda"]):
        assert float((g - c).abs().max()) <= 2.0**-10 * float(c.abs().max())


def test_checkpoint_round_trip_from_the_card(cuda, tmp_path):
    """A trainable model's parameters and AdamW state saved from the card
    restore exactly onto the card and onto the CPU."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.common import iter_leaves, map_tree
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    _, model = _reduced_trainer(cuda)
    opt = adamw_init(model.params(), AdamWConfig(lr=None))
    opt.mu["embed"].normal_()
    state = {"params": model.params(), "opt": opt._asdict()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state)
    for device in (cuda, torch.device("cpu")):
        template = map_tree(lambda _, a: torch.zeros_like(a, device=device), state)
        step, got = mgr.restore(template)
        assert step == 7
        for (name, a), (_, b) in zip(iter_leaves(state), iter_leaves(got)):
            assert b.device.type == device.type and b.dtype == a.dtype, name
            assert torch.equal(b.cpu(), a.detach().cpu()), name
