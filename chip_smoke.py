#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port of the coded-MPC engine on one GPU.

    python3 chip_smoke.py [--seed 0] [--batch 4] [--reps 5]
    python3 chip_smoke.py --variant-path f32|int32 [--src DIR] [--k 5120]

Phases (each raises on failure; the exit code is then not 0):

1. build   — compile ``src/repro_torch/csrc/modmatmul.cu`` (it includes
             ``common.cuh``, ``int32_mma.cuh``, ``f32_wgmma.cuh`` and
             ``skinny.cuh``) with nvcc and print the build time, the
             compiler's register report and the card's name and power
             limit; count the tensor-core and conversion instructions in
             each kernel's SASS (raises if ``int32_mma`` or
             ``f32_wgmma`` has no tensor-core instruction, or the
             f32_wgmma design, its A pre-pass included, an I2F);
2. kernels — all eight compiled kernels (int32 mma and skinny, f32 wgmma
             and skinny, plain and fused-mask) against their plain
             PyTorch versions on the card, on ragged, shared-operand,
             deep and adversarial shapes and at the edges of each design
             (the skinny cap, the fold periods of both tensor-core
             kernels, ragged M/N at their block tile, N % 4 != 0,
             z = 1, 2, 5): exact equality, and each case on the design
             it was meant for;
3. main    — ``run_batched`` (AGE, s = t = z = 2) at the width of one
             Mistral-NeMo-12B attention projection: a = X^T for a
             512-token chunk [batch, 5120, 512], b = W_q [batch, 5120,
             4096], unfused and fused, Y checked exactly against a
             float64 matmul mod p; the launch counts (per TPU kernel
             and per compiled kernel) prove the kernels carried the
             path; a profiler breakdown of one warm run of each; then
             ``secure_matmul_batched`` once;
4. f32     — ``run_batched(backend="cuda")`` at the same full-width
             shapes, unfused and fused, Y exact against the float64
             oracle, with the launch counts of the f32 kernels;
             a profiler breakdown of one warm run of each, and the peak
             device memory of the path;
5. edge    — the edge runtime at the same width on a pool of 20
             workers (AGE s = t = z = 2, 3 spares; a straggler trace with
             worker 0 dropped and worker 1 corrupt): ``run_batch_over_pool``
             in detect and correct mode on ``auto`` and on
             ``backend="cuda"``, ``run_over_pool`` on product 0,
             ``run_pipeline_over_pool`` (3 replays) and
             ``run_adaptive_over_pool`` (AGE or PolyDot, 3 replays); every Y
             exact against the float64 oracle, the corrupt worker rejected
             or corrected, the dropped one outside the Phase-2 set, the
             launches per compiled kernel and their shapes asserted; the
             wall time of each call (median of ``--reps``, of at most 3
             for the pipeline and the auto-planner) split into the
             device data plane and the host (blinding draw, the copy of
             the Phase-2 evaluations, event loop and decode), the peak
             device memory; and the same replays at k = 256, ma = 32,
             mb = 64 equal, Y and every metric, on the card and on the CPU;
6. timing  — each kernel at each launch site of its paths (the
             ``run_batched`` sites and the edge runtime's): CUDA-event
             time, device time of launches queued back to back (behind a
             busy-wait kernel), plain version, bound, library
             call, design; printed as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.  Without a GPU the
script exits with code 2 and prints no result.

``--variant-path`` runs none of the phases above.  It times one kernel
variant at each launch site of ``run_batched`` (at contraction depth
``--k``; each output checked against its plain version) and
``run_batched`` on that variant (Y checked against the float64 oracle),
through the wrappers, plain versions and engine alone, and prints one
JSON line.  ``--src`` names the ``src`` directory whose ``repro_torch``
is imported (default: this checkout's), so one call can time two trees:
unpack another commit with ``git archive`` into a gitignored directory
and pass its ``src``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

P = 65521
SOURCES = {
    "int32_mma": "src/repro_torch/csrc/int32_mma.cuh",
    "int32_skinny": "src/repro_torch/csrc/skinny.cuh",
    "f32_wgmma": "src/repro_torch/csrc/f32_wgmma.cuh",
    "f32_skinny": "src/repro_torch/csrc/skinny.cuh",
}
TPU_KERNELS = {
    "modmatmul_int32": "src/repro/kernels/modmatmul/kernel.py:152",
    "modmatmul_f32": "src/repro/kernels/modmatmul/kernel.py:101",
    "modmatmul_int32_masked": "src/repro/kernels/modmatmul/kernel.py:193",
    "modmatmul_f32_masked": "src/repro/kernels/modmatmul/kernel.py:193",
}
# Peaks of one H100 SXM (dense): HBM bytes/s, int8 tensor-core ops/s
# (the rate the limb dots map onto; the bound of either variant, since
# both compute the same function) and fp16 tensor-core flop/s (the floor
# of f32_wgmma's own arithmetic) are NVIDIA's published figures; the
# 32-bit integer pipe (the threefry mask stream and the mask terms) does
# 64 lanes per SM per clock: 132 SMs * 64 * 1.98 GHz.
HBM_BPS = 3.35e12
INT8_TC_OPS = 1979e12
FP16_TC_FLOPS = 989e12
INT32_OPS = 132 * 64 * 1.98e9
# 32-bit ALU ops per threefry2x32 word and its Barrett reduction: 20
# rounds of add/rotate/xor, 5 key injections, the counter add, and
# mulhi/mul/sub/select; per masked term: multiply, Barrett, add.
THREEFRY_OPS = 20 * 3 + 5 * 2 + 2 + 4
MASK_TERM_OPS = 6


def log(*args):
    print(*args, flush=True)


# ----------------------------------------------------------------------
# phase 1: build
# ----------------------------------------------------------------------
def phase_build(K) -> None:
    t0 = time.perf_counter()
    K.load_library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {K.BUILD_INFO.get('seconds', 0.0):.2f} s) -> {K.BUILD_INFO['library']}")
    for line in K.BUILD_INFO.get("log", "").splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill", "warning")):
            log("[build]", line.strip())
    counts = sass_op_counts(K.BUILD_INFO["library"])
    for fn, n in counts.items():
        log(f"[build] {fn}: " + ", ".join(f"{op} {c}" for op, c in n.items()))
    for kernel in ("modmatmul_int32_mma", "modmatmul_f32_wgmma"):
        got = {fn: n for fn, n in counts.items() if kernel in fn}
        if not got or min(n["tensor_core"] for n in got.values()) == 0:
            raise AssertionError(f"no tensor-core instruction in {kernel}: {got}")
    # the f32_wgmma design: its A pre-pass and its main kernel
    i2f = {fn: n["I2F"] for fn, n in counts.items() if "wgmma_f32" in fn and n["I2F"]}
    if i2f:
        raise AssertionError(f"f32_wgmma converts with I2F: {i2f}")


def sass_op_counts(library: str) -> dict:
    """Kernel (mangled name) -> counts of tensor-core opcodes
    (IMMA/IGMMA/HGMMA/GMMA) and of the conversions I2F, F2I and FRND in
    the library's SASS, from cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = {"tensor_core": 0, "I2F": 0, "F2I": 0, "FRND": 0}
        elif fn:
            if re.search(r"\b(IMMA|IGMMA|HGMMA|GMMA)\b", line):
                counts[fn]["tensor_core"] += 1
            for op in ("I2F", "F2I", "FRND"):
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    return counts


# ----------------------------------------------------------------------
# phase 2: each kernel against its plain version, exact
# ----------------------------------------------------------------------
def draw(torch, gen, shape, mode):
    if mode == "uniform":
        return torch.randint(0, P, shape, generator=gen, device="cuda", dtype=torch.int32)
    if mode == "maximal":
        return torch.full(shape, P - 1, device="cuda", dtype=torch.int32)
    if mode == "high_limb":  # both 8-bit limbs dense-high, clipped below p
        hi = torch.randint(192, 256, shape, generator=gen, device="cuda", dtype=torch.int32)
        lo = torch.randint(192, 256, shape, generator=gen, device="cuda", dtype=torch.int32)
        return torch.clamp(hi * 256 + lo, max=P - 1)
    raise ValueError(mode)


def kernel_cases():
    """(a shape, b shape, mode, z) of phase 2, for both variants."""
    layouts = [
        ((3, 17, 129), (3, 129, 100)),  # batched x batched
        ((17, 6), (4, 6, 1000)),  # 2D x batched (shared LHS)
        ((2, 70, 300), (300, 65)),  # batched x 2D (shared RHS)
        ((5, 7), (7, 3)),  # 2D x 2D
    ]
    ragged = [((2, 33, k), (2, k, 77)) for k in (127, 128, 129, 255, 256, 257)]
    deep = [((1, 40, 8192), (1, 8192, 50))]
    # z = 3 and z = 6: within and across one 4-row pass of a tiled
    # epilogue's mask generation
    cases = [(sa, sb, mode, 3 if i % 2 else 6)
             for i, (sa, sb) in enumerate(layouts + ragged + deep)
             for mode in ("uniform", "maximal", "high_limb")]
    # the skinny cap (M, K = 32 / 33), each row bucket, N % 4 != 0, N
    # below one block, shared operands on either side, z = 1, 2, 5
    edges = [((2, m, k), (2, k, 1000)) for m in (32, 33) for k in (32, 33)]
    edges += [((8, 3), (2, 3, 1001)), ((9, 5), (3, 5, 1003)), ((16, 31), (31, 6)),
              ((2, 17, 6), (6, 5)), ((6, 6), (4, 6, 4093)), ((1, 1), (1, 1)),
              ((17, 17), (4, 17, 2050)), ((2, 17, 2), (2, 2, 7)),
              # mma with 16-byte loads (K, N % 4 == 0) and ragged M/N tiles
              ((2, 200, 96), (2, 96, 260)), ((3, 130, 64), (64, 132))]
    cases += [(sa, sb, mode, z) for sa, sb in edges for z in (1, 2, 5)
              for mode in ("uniform", "maximal")]
    # f32_skinny's short finish: K + z = 64 and 65 terms
    cases += [((2, 17, 32), (2, 32, 1000), mode, z) for z in (32, 33)
              for mode in ("maximal", "high_limb")]
    # f32_wgmma's fold edges (every 128 K; the second consumer's first
    # fold after 64) and ragged M/N at its 128 x 128 block tile
    cases += [((2, 40, k), (2, k, 70), mode, 2) for k in (255, 257, 511, 513)
              for mode in ("maximal", "high_limb")]
    cases += [((2, 129, 513), (2, 513, 127), "maximal", 3),
              ((127, 256), (3, 256, 130), "high_limb", 5),
              ((2, 250, 64), (64, 257), "maximal", 1)]
    # the depth folds: mma every 16512 K and the reference every 33024;
    # cross each edge and fold twice
    cases += [((3, k), (k, 5), "maximal", 2)
              for k in (16511, 16512, 16513, 33023, 33024, 33025, 2 * 16512 + 5, 2 * 33024 + 5)]
    cases += [((3, k), (k, 8), "maximal", 2) for k in (16512, 16516, 2 * 16512 + 8)]
    cases.append(((3, 70000), (70000, 5), "maximal", 3))
    # the grids: N tiles past grid.y's 65535, M past it (f32_wgmma's A split)
    cases += [((40, 6), (6, 10_000_000), "uniform", 2), ((70_000, 40), (40, 8), "uniform", 2)]
    return cases


def phase_kernels(torch, K, ref, seed: int) -> int:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n = 0
    designs = set()
    for variant in ("int32", "f32"):
        for sa, sb, mode, z in kernel_cases():
            a, b = draw(torch, gen, sa, mode), draw(torch, gen, sb, mode)
            v = draw(torch, gen, (sa[-2], z), mode)
            key = (seed + 1, 1000 + n)
            batch, m, k, nn = geometry(sa, sb)
            K.reset_launch_counts()
            got = K.modmatmul_cuda(a, b, P, variant)
            want = ref.PLAIN[variant](a, b, P)
            gotm = K.modmatmul_masked_cuda(a, b, v, key, P, variant)
            wantm = ref.modmatmul_masked_plain(a, b, v, key, P, variant)
            torch.cuda.synchronize()
            ran = {name for name, c in K.LAUNCHES_BY_KERNEL.items() if c}
            expect = {f"{variant}_{K.choose_design(variant, False, batch, m, k, nn)}",
                      f"{variant}_{K.choose_design(variant, True, batch, m, k, nn, z)}_masked"}
            if ran != expect:
                raise AssertionError(f"{variant} at {sa} @ {sb} z={z} ran {ran}, expected {expect}")
            designs |= ran
            for tag, g_, w_ in (("plain", got, want), ("masked", gotm, wantm)):
                if g_.shape != w_.shape or not torch.equal(g_, w_):
                    raise AssertionError(
                        f"{variant} {tag} kernel != plain version at {sa} @ {sb} ({mode}, z={z})"
                    )
            n += 2
    if designs != set(K.COMPILED_NAMES):
        raise AssertionError(f"phase 2 reached only {sorted(designs)}")
    log(f"[kernels] {n} kernel launches on all {len(designs)} compiled kernels "
        f"equal their plain versions exactly")
    return n


# ----------------------------------------------------------------------
# phase 3/4: the main path
# ----------------------------------------------------------------------
def oracle_y(torch, a, b):
    """Y = A^T B mod p in float64: every partial sum is an integer below
    k*(p-1)**2 < 2**53, so the float64 product is exact."""
    if a.shape[1] * (P - 1) ** 2 >= 2**53:
        raise ValueError("float64 oracle is exact only while k*(p-1)**2 < 2**53")
    return torch.remainder(torch.matmul(a.transpose(1, 2).double(), b.double()), P).to(torch.int64)


def site_table(plan, batch: int) -> dict:
    """Launch sites of one run_batched: name -> ((a shape), (b shape))."""
    sch, sh = plan.scheme, plan.shapes
    n, nw, thr, z = plan.n_total, plan.n_workers, plan.decode_threshold, sch.z
    na, nb = len(sch.fa_powers), len(sch.fb_powers)
    bra, bca = sh.blk_a
    brb, bcb = sh.blk_b
    blk = sh.blk_y[0] * sh.blk_y[1]
    return {
        "P1 share A": ((n, na), (batch, na, bra * bca)),
        "P1 share B": ((n, nb), (batch, nb, brb * bcb)),
        "P2 multiply": ((batch * n, bra, bca), (batch * n, bca, bcb)),
        "P2 mix": ((n, nw), (batch, nw, blk)),
        "P2 noise": ((n, z), (batch, z, blk)),
        "P3 decode": ((thr, thr), (batch, thr, blk)),
    }


# the kernel each site launches, unfused and fused
UNFUSED_SITES = ("P1 share A", "P1 share B", "P2 multiply", "P2 mix", "P2 noise", "P3 decode")
FUSED_MASKED = ("P1 share A", "P1 share B", "P2 mix")
FUSED_PLAIN = ("P2 multiply", "P3 decode")


def geometry(sa, sb):
    batch = sa[0] if len(sa) == 3 else (sb[0] if len(sb) == 3 else 1)
    return (batch, sa[-2], sa[-1], sb[-1])


# cycles of the busy-wait kernel that device_ms queues its launches
# behind: ~25 ms at 1.98 GHz, far longer than the host takes to enqueue
# a few wrapper calls
QUEUE_CYCLES = 50_000_000


def device_ms(torch, fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls enqueued behind a
    busy-wait kernel (``torch.cuda._sleep``), so that the card runs them
    back to back, free of the wrapper's host cost that a lone launch's
    CUDA-event time includes; CUDA events around the ``reps`` calls,
    after one warm-up.  (torch.profiler loses device activities on the
    H100 machine as a process runs on: PERF.md section 7.)"""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_batched_ms(torch, protocol, plan, a, b, *, backend, fused, seed, reps) -> float:
    """Median CUDA-event ms of ``reps`` calls of run_batched."""
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        protocol.run_batched(plan, a, b, seed=seed, backend=backend, fused_masks=fused)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def main_operands(torch, planner, constructions, batch: int, k: int, seed: int):
    """The plan of AGE s = t = z = 2 at a = [batch, k, 512], b = [batch, k,
    4096], random operands from ``seed`` on the card, and their oracle Y."""
    scheme = constructions.build_scheme("age", 2, 2, 2)
    plan = planner.get_plan(scheme, planner.BlockShapes(k=k, ma=512, mb=4096, s=2, t=2))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    a = torch.randint(0, P, (batch, k, 512), generator=gen, device="cuda", dtype=torch.int32)
    b = torch.randint(0, P, (batch, k, 4096), generator=gen, device="cuda", dtype=torch.int32)
    return plan, a, b, oracle_y(torch, a, b)


def drive(torch, K, protocol, plan, a, b, want, *, backend, fused, tag, seed):
    """One run_batched with the counts zeroed just before and read just
    after; checks Y exactly.  Returns {compiled kernel: {shape: launches}}."""
    K.reset_launch_counts()
    y, _ = protocol.run_batched(plan, a, b, seed=seed, backend=backend, fused_masks=fused)
    torch.cuda.synchronize()
    counts = {name: dict(K.LAUNCH_SHAPES_BY_KERNEL[name]) for name in K.COMPILED_NAMES}
    totals = {name: K.LAUNCHES[name] for name in K.KERNEL_NAMES}
    if y.shape != want.shape or not torch.equal(y, want):
        bad = int((y != want).sum()) if y.shape == want.shape else -1
        raise AssertionError(f"[{tag}] Y differs from the float64 oracle in {bad} entries")
    log(f"[{tag}] Y exact {tuple(y.shape)}; launches {totals}")
    return counts


# launches of one run_batched at full width, per compiled kernel: the P2
# multiply on the tensor cores, every other site skinny
MAIN_BY_KERNEL = {
    False: {"int32_mma": 1, "int32_skinny": 5},
    True: {"int32_mma": 1, "int32_skinny": 1, "int32_skinny_masked": 3},
}
F32_BY_KERNEL = {
    False: {"f32_wgmma": 1, "f32_skinny": 5},
    True: {"f32_wgmma": 1, "f32_skinny": 1, "f32_skinny_masked": 3},
}


def expect_launches(K, kernel, masked_kernel, by_kernel, fused: bool, tag: str) -> None:
    want = {kernel: 2, masked_kernel: 3} if fused else {kernel: 6}
    got = {k: v for k, v in K.LAUNCHES.items() if v}
    got_by = {k: v for k, v in K.LAUNCHES_BY_KERNEL.items() if v}
    if got != want or got_by != by_kernel[fused]:
        raise AssertionError(f"[{tag}] launches {got} / {got_by}, "
                             f"expected {want} / {by_kernel[fused]}")
    log(f"[{tag}] launches by compiled kernel {got_by}")


def phase_main(torch, K, protocol, layers, planner, constructions, args) -> dict:
    batch, k = args.batch, 5120
    plan, a, b, want = main_operands(torch, planner, constructions, batch, k, args.seed)
    torch.cuda.reset_peak_memory_stats()
    log(f"[main] AGE s=t=z=2: n_total={plan.n_total} thr={plan.decode_threshold}; "
        f"a [{batch}, {k}, 512] (X^T, 512 tokens x d_model 5120), "
        f"b [{batch}, {k}, 4096] (W_q, 5120 x 32*128)")
    counts = {}
    for fused in (False, True):
        tag = "main fused" if fused else "main unfused"
        counts[fused] = drive(torch, K, protocol, plan, a, b, want,
                              backend="auto", fused=fused, tag=tag, seed=args.seed)
        expect_launches(K, "modmatmul_int32", "modmatmul_int32_masked", MAIN_BY_KERNEL,
                        fused, tag)
    peak = torch.cuda.max_memory_allocated()
    times = {("fused" if fused else "unfused"): run_batched_ms(
        torch, protocol, plan, a, b, backend="auto", fused=fused, seed=args.seed, reps=args.reps)
        for fused in (False, True)}
    log(f"[main] run_batched median ms over {args.reps}: {times}; "
        f"peak allocated {peak / 2**30:.2f} GiB")
    profile_breakdown(torch, protocol, plan, a, b, args.seed, backend="auto")
    del a, b, want

    # the float API once, same shapes; exact against the quantized oracle
    gf = torch.Generator(device="cuda")
    gf.manual_seed(args.seed + 1)
    af = torch.randn((batch, k, 512), generator=gf, device="cuda", dtype=torch.float64)
    bf = torch.randn((batch, k, 4096), generator=gf, device="cuda", dtype=torch.float64) * 0.02
    K.reset_launch_counts()
    start = time.perf_counter()
    res = layers.secure_matmul_batched(af, bf, s=2, t=2, z=2, seed=args.seed)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    if K.LAUNCHES["modmatmul_int32"] != 6:
        raise AssertionError(f"[layers] launches {dict(K.LAUNCHES)}")
    scale = layers.choose_scales(
        k, float(af.abs().max()) + 1e-9, float(bf.abs().max()) + 1e-9, P
    )
    aq = torch.remainder(torch.round(af * scale).to(torch.int64), P)
    bq = torch.remainder(torch.round(bf * scale).to(torch.int64), P)
    yq = oracle_y(torch, aq, bq)
    want_f = torch.where(yq > (P - 1) // 2, yq - P, yq).double() / (scale * scale)
    if not bool(torch.isfinite(res.y).all()) or not torch.equal(res.y, want_f):
        raise AssertionError("[layers] secure_matmul_batched disagrees with its oracle")
    log(f"[layers] secure_matmul_batched exact, scale={scale}, {secs * 1e3:.1f} ms host wall")
    return {"plan": plan, "counts": counts, "times": times, "peak": peak, "batch": batch}


def phase_f32(torch, K, protocol, planner, constructions, args) -> dict:
    batch = args.batch
    plan, a, b, want = main_operands(torch, planner, constructions, batch, 5120, args.seed + 2)
    torch.cuda.reset_peak_memory_stats()
    counts = {}
    for fused in (False, True):
        tag = "f32 fused" if fused else "f32 unfused"
        counts[fused] = drive(torch, K, protocol, plan, a, b, want,
                              backend="cuda", fused=fused, tag=tag, seed=args.seed)
        expect_launches(K, "modmatmul_f32", "modmatmul_f32_masked", F32_BY_KERNEL, fused, tag)
    # f32_wgmma's A planes (device scratch, 8 bytes per A element) are in it
    peak = torch.cuda.max_memory_allocated()
    times = {("fused" if fused else "unfused"): run_batched_ms(
        torch, protocol, plan, a, b, backend="cuda", fused=fused, seed=args.seed, reps=args.reps)
        for fused in (False, True)}
    log(f"[f32] run_batched(backend='cuda') median ms over {args.reps}: {times}; "
        f"peak allocated {peak / 2**30:.2f} GiB")
    profile_breakdown(torch, protocol, plan, a, b, args.seed, backend="cuda")
    return {"plan": plan, "counts": counts, "batch": batch, "times": times, "peak": peak}


def profiled_ms(prof) -> list:
    """(self device ms, calls, name) of every device op a torch.profiler
    run recorded, largest first."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # a host op: its device time is its kernels' rows
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    return sorted(rows, reverse=True)


def profile_breakdown(torch, protocol, plan, a, b, seed: int, *, backend: str, top: int = 12) -> None:
    """One warm run_batched of each kind under torch.profiler: the top
    device ops (kernels, copies, fills) by self device time, and the
    device-idle share of the window (1 - summed device time / event-timed
    window; one stream, so they do not overlap).  The profiler's own host
    cost is inside the window."""
    from torch.profiler import ProfilerActivity, profile

    for fused in (False, True):
        tag = ("fused" if fused else "unfused") + ("" if backend == "auto" else f" {backend}")
        protocol.run_batched(plan, a, b, seed=seed, backend=backend, fused_masks=fused)  # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            protocol.run_batched(plan, a, b, seed=seed, backend=backend, fused_masks=fused)
            end.record()
            end.synchronize()
        window = start.elapsed_time(end)
        rows = profiled_ms(prof)
        busy = sum(r[0] for r in rows)
        if busy <= 0:
            log(f"[profile {tag}] window {window:.3f} ms; device time not measured "
                f"(the profiler recorded none)")
            continue
        log(f"[profile {tag}] " + json.dumps({
            "window_ms": round(window, 4),
            "device_busy_ms": round(busy, 4),
            "device_idle_share": round(max(0.0, 1.0 - busy / window), 4),
            "top": [{"op": k[:80], "self_device_ms": round(ms, 4), "calls": c}
                    for ms, c, k in rows[:top]],
        }))


def phase_variant_path(torch, K, ref, protocol, planner, constructions, args) -> dict:
    """``--variant-path``: one variant at each launch site of run_batched
    and run_batched on it, through the wrappers, plain versions and engine
    only (the repro_torch of ``--src`` may be another commit's, with other
    compiled designs)."""
    variant, batch, reps = args.variant_path, args.batch, args.reps
    plan, a, b, want = main_operands(torch, planner, constructions, batch, args.k, args.seed)
    z = plan.scheme.z
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 3)
    result = {"src": args.src, "variant": variant, "k": args.k, "sites": {}}
    for site, (sa, sb) in site_table(plan, batch).items():
        x, y, v = (torch.randint(0, P, s, generator=gen, device="cuda", dtype=torch.int32)
                   for s in (sa, sb, (sa[-2], z)))
        forms = [("plain", lambda: K.modmatmul_cuda(x, y, P, variant),
                  lambda: ref.PLAIN[variant](x, y, P))]
        if site in FUSED_MASKED:
            forms.append(("masked", lambda: K.modmatmul_masked_cuda(x, y, v, (7, 11), P, variant),
                          lambda: ref.modmatmul_masked_plain(x, y, v, (7, 11), P, variant)))
        for form, kern, plain in forms:
            if not torch.equal(kern(), plain()):
                raise AssertionError(f"{variant} {form} kernel != plain version at {site}")
            result["sites"][f"{site} {form}"] = {
                "ms": cuda_ms(torch, kern, reps), "device_ms": device_ms(torch, kern, reps)}
        del x, y, v
        torch.cuda.empty_cache()
    backend = {"int32": "cuda_int32", "f32": "cuda"}[variant]
    for fused in (False, True):
        tag = "fused" if fused else "unfused"
        drive(torch, K, protocol, plan, a, b, want, backend=backend, fused=fused,
              tag=f"{variant} {tag}", seed=args.seed)
        result[f"run_batched {tag}"] = run_batched_ms(
            torch, protocol, plan, a, b, backend=backend, fused=fused, seed=args.seed, reps=reps)
    return result


# ----------------------------------------------------------------------
# phase 5: per-site timing and the kernels line
# ----------------------------------------------------------------------
def measure_site(torch, K, ref, gen, name, variant, masked, site, sa, sb, z, n_launch, args) -> dict:
    """One launch site of ``variant`` on random inputs of its shape: the
    kernel against its plain version, then its times, bound and library
    call; logs a ``[timing]`` line and returns the ``kernels`` entry."""
    shape = geometry(sa, sb)
    design = K.choose_design(variant, masked, *shape, z if masked else 0)
    compiled = f"{variant}_{design}" + ("_masked" if masked else "")
    a = torch.randint(0, P, sa, generator=gen, device="cuda", dtype=torch.int32)
    b = torch.randint(0, P, sb, generator=gen, device="cuda", dtype=torch.int32)
    v = torch.randint(0, P, (sa[-2], z), generator=gen, device="cuda", dtype=torch.int32)
    wkey = (7, 11)
    if masked:
        kern = lambda: K.modmatmul_masked_cuda(a, b, v, wkey, P, variant)  # noqa: E731
        plain = lambda: ref.modmatmul_masked_plain(a, b, v, wkey, P, variant)  # noqa: E731
    else:
        kern = lambda: K.modmatmul_cuda(a, b, P, variant)  # noqa: E731
        plain = lambda: ref.PLAIN[variant](a, b, P)  # noqa: E731
    got, exp = kern(), plain()
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - exp.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"{name} at {site}: max abs error {err} against plain")
    del got, exp
    reps = args.reps
    ms = cuda_ms(torch, kern, reps)
    dev_ms = device_ms(torch, kern, reps)
    plain_ms = cuda_ms(torch, plain, reps)
    library_ms = None
    if not masked:  # float64 matmul + remainder: exact while K*(p-1)**2 < 2**53
        a64, b64 = a.double(), b.double()
        library_ms = cuda_ms(torch, lambda: torch.remainder(torch.matmul(a64, b64), P), reps)
        del a64, b64
    B, M, Kd, N = shape
    nbytes = 4 * (a.numel() + b.numel() + B * M * N + (v.numel() if masked else 0))
    tc_ops = 8 * B * M * (Kd + (z if masked else 0)) * N
    alu_ops = (B * z * N * THREEFRY_OPS + B * M * N * z * MASK_TERM_OPS) if masked else 0
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (tc_ops / INT8_TC_OPS + alu_ops / INT32_OPS) * 1e3
    base = f"{variant}_{design}"
    entry = {
        "name": name,
        "kernel": compiled,
        "design": design,
        "site": site,
        "shape": f"{list(sa)}@{list(sb)}" + (f"+v{[sa[-2], z]}" if masked else ""),
        "route": "cuda",
        "source": SOURCES[base],
        "replaces": TPU_KERNELS[name],
        "launches": n_launch,
        "max_abs_err": err,
        "ms": round(ms, 4),
        "device_ms": round(dev_ms, 4),
        "plain_ms": round(plain_ms, 4),
        "bound_ms": round(max(t_bytes, t_ops), 4),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None if library_ms is None else round(library_ms, 4),
    }
    # f32_wgmma's own floor: two fp16 sets of depth 2K, 8 flop per MNK
    floor = (f"  fp16 floor {8 * B * M * Kd * N / FP16_TC_FLOPS * 1e3:.4f}"
             if base == "f32_wgmma" else "")
    log(f"[timing] {compiled:20s} {site:12s} {entry['shape']:44s} "
        f"{ms:9.3f} ms  device {entry['device_ms']}  plain {plain_ms:9.3f}  "
        f"bound {entry['bound_ms']:7.3f} "
        f"({entry['bound_by']})  library {library_ms}{floor}")
    del a, b, v
    torch.cuda.empty_cache()
    return entry


def site_entries(torch, K, ref, run: dict, variant: str, args) -> list:
    plan, batch = run["plan"], run["batch"]
    sites = site_table(plan, batch)
    z = plan.scheme.z
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 3)
    entries = []
    plan_of = [(f"modmatmul_{variant}", False, UNFUSED_SITES, False),
               (f"modmatmul_{variant}", False, FUSED_PLAIN, True),
               (f"modmatmul_{variant}_masked", True, FUSED_MASKED, True)]
    seen = {}
    for name, masked, names, fused in plan_of:
        for site in names:
            sa, sb = sites[site]
            shape = geometry(sa, sb)
            design = K.choose_design(variant, masked, *shape, z if masked else 0)
            compiled = f"{variant}_{design}" + ("_masked" if masked else "")
            n_launch = run["counts"][fused][compiled].get(shape, 0)
            if n_launch < 1:
                raise AssertionError(f"{compiled} never launched at {site} {shape}")
            key = (name, site)
            if key in seen:  # the same site in the other run: add its launches
                seen[key]["launches"] += n_launch
                continue
            entry = measure_site(torch, K, ref, gen, name, variant, masked, site, sa, sb, z,
                                 n_launch, args)
            seen[key] = entry
            entries.append(entry)
    return entries


# ----------------------------------------------------------------------
# phase 5: the edge runtime
# ----------------------------------------------------------------------
def edge_sites(plan, batch: int) -> dict:
    """Launch sites of the edge runtime: ``run_over_pool`` (E) and
    ``run_batch_over_pool`` (B), name -> ((a shape), (b shape))."""
    sch, sh = plan.scheme, plan.shapes
    n, nw, z = plan.n_total, plan.n_workers, sch.z
    na, nb = len(sch.fa_powers), len(sch.fb_powers)
    bra, bca = sh.blk_a
    brb, bcb = sh.blk_b
    blk = sh.blk_y[0] * sh.blk_y[1]
    return {
        "E1 share A": ((n, na), (na, bra * bca)),
        "E1 share B": ((n, nb), (nb, brb * bcb)),
        "E2 multiply": ((n, bra, bca), (n, bca, bcb)),
        "E2 mix": ((n, nw), (nw, blk)),
        "E2 noise": ((n, z), (z, blk)),
        "B1 share A": ((n, na), (batch, na, bra * bca)),
        "B1 share B": ((n, nb), (batch, nb, brb * bcb)),
        "B2 multiply": ((batch * n, bra, bca), (batch * n, bca, bcb)),
        "B2 mix": ((n, nw), (nw, batch * blk)),
        "B2 noise": ((n, z), (z, batch * blk)),
    }


def expected_shapes(K, sites: dict, names, variant: str) -> dict:
    """{compiled kernel: {(B, M, K, N): launches}} of the given sites, by
    the design ``choose_design`` sends each to."""
    want: dict = {}
    for site in names:
        shape = geometry(*sites[site])
        compiled = f"{variant}_{K.choose_design(variant, False, *shape)}"
        want.setdefault(compiled, {})
        want[compiled][shape] = want[compiled].get(shape, 0) + 1
    return want


def launched_shapes(K) -> dict:
    return {name: dict(c) for name, c in K.LAUNCH_SHAPES_BY_KERNEL.items() if c}


def same_result(x, y, what: str) -> None:
    """Exact equality of two runtime results, field by field."""
    import dataclasses

    import numpy as np

    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"{what} differs")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            same_result(getattr(x, f.name), getattr(y, f.name), f"{what}.{f.name}")
    elif isinstance(x, (list, tuple)):
        if len(x) != len(y):
            raise AssertionError(f"{what} differs in length")
        for i, (xi, yi) in enumerate(zip(x, y)):
            same_result(xi, yi, f"{what}[{i}]")
    elif isinstance(x, float) and x != x:
        if y == y:
            raise AssertionError(f"{what}: {y} where nan")
    elif x != y:
        raise AssertionError(f"{what}: {x} != {y}")


def edge_trace(runtime, plan, seed: int):
    """``sample_trace(20, ShiftedExponential(1, 1), FaultSpec(straggler_frac
    = 0.2), s)`` with worker 0 dropped and worker 1 corrupt, at the first
    s >= ``seed`` where worker 1's response leg (exchange + uplink) is
    among the decode threshold's fastest: a corrupt response that the
    decode never reads would test nothing."""
    import numpy as np

    for s in range(seed, seed + 1000):
        trace = runtime.sample_trace(
            plan.n_total, runtime.ShiftedExponential(1.0, 1.0),
            runtime.FaultSpec(straggler_frac=0.2), seed=s,
        ).with_faults(dropout_ids=[0], corrupt_ids=[1])
        leg = trace.d2d_delay + trace.uplink_delay
        order = [int(w) for w in np.argsort(leg, kind="stable") if not trace.dropout[w]]
        if 1 in order[: plan.decode_threshold]:
            return trace, s
    raise AssertionError("no trace seed puts worker 1 among the fastest responders")


def edge_traces(runtime, plan, seed: int, depth: int = 3):
    """``depth`` traces of ``edge_trace`` at increasing seeds, and the seeds."""
    traces, seeds = [], []
    for _ in range(depth):
        trace, seed = edge_trace(runtime, plan, seed)
        traces.append(trace)
        seeds.append(seed)
        seed += 1
    return traces, seeds


def wall_ms(torch, fn, reps: int) -> float:
    """Median wall ms of ``reps`` calls of ``fn``, the card synchronized
    before and after each."""
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


# the port's data-plane functions an instrumented call wraps
SPLIT_TARGETS = (("protocol", "share_batched"), ("protocol", "share_a"),
                 ("protocol", "share_b"), ("protocol", "polyeval"),
                 ("protocol", "worker_multiply"), ("protocol", "degree_reduce"),
                 ("protocol", "_blinding_sum"), ("scheduler", "_to_host"))


def split_call(torch, modules: dict, fn) -> dict:
    """One call of ``fn`` with the port's data-plane functions wrapped:
    each wrapper synchronizes the card and records CUDA events around the
    function.  The call's wall time splits into the device data plane
    (the share evaluation, worker multiply and degree reduction, less the
    host blinding draw inside the latter) and the host: the per-product
    share preparation (block stacking, the secret draws and their upload,
    around the share evaluation), the blinding draw, the copy of the
    Phase-2 evaluations to the host, and the rest (event loop and
    decode).  Each wrapper's two synchronizations are inside the wall."""
    parts: dict = {}
    saved = []

    def wrap(key, f):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            out = f(*a, **kw)
            e1.record()
            torch.cuda.synchronize()
            rec = parts.setdefault(key, {"event_ms": 0.0, "wall_ms": 0.0, "calls": 0})
            rec["event_ms"] += e0.elapsed_time(e1)
            rec["wall_ms"] += (time.perf_counter() - t0) * 1e3
            rec["calls"] += 1
            return out
        return timed

    try:
        for mod, attr in SPLIT_TARGETS:
            f = getattr(modules[mod], attr)
            saved.append((modules[mod], attr, f))
            setattr(modules[mod], attr, wrap(attr, f))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)

    def ev(name, key="event_ms"):
        return parts.get(name, {}).get(key, 0.0)

    draw = ev("_blinding_sum", "wall_ms")
    # the batched share's polyeval is inside share_batched; the per-product
    # one is the device part of share_a / share_b
    per_product = "share_a" in parts
    prep = ev("share_a") + ev("share_b") - ev("polyeval") if per_product else 0.0
    device = (ev("share_batched") + (ev("polyeval") if per_product else 0.0)
              + ev("worker_multiply") + ev("degree_reduce") - draw)
    d2h = ev("_to_host", "wall_ms")
    host = wall - device
    return {
        "wall_ms": round(wall, 3),
        "device_data_plane_ms": round(device, 3),
        "host_ms": round(host, 3),
        "host_share_prep_ms": round(prep, 3),
        "host_blinding_draw_ms": round(draw, 3),
        "host_d2h_copy_ms": round(d2h, 3),
        "host_event_loop_and_decode_ms": round(host - prep - draw - d2h, 3),
        "parts": {k: {kk: round(vv, 3) for kk, vv in v.items()} for k, v in parts.items()},
    }


EDGE_PRODUCT_SITES = ("E1 share A", "E1 share B", "E2 multiply", "E2 mix", "E2 noise")
EDGE_BATCH_SITES = ("B1 share A", "B1 share B", "B2 multiply", "B2 mix", "B2 noise")


def phase_edge(torch, K, protocol, planner, constructions, runtime, scheduler, args) -> dict:
    import numpy as np

    batch, k = args.batch, 5120
    scheme = constructions.build_scheme("age", 2, 2, 2)
    plan = planner.get_plan(scheme, planner.BlockShapes(k=k, ma=512, mb=4096, s=2, t=2), n_spare=3)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 4)
    a = torch.randint(0, P, (batch, k, 512), generator=gen, device="cuda", dtype=torch.int32)
    b = torch.randint(0, P, (batch, k, 4096), generator=gen, device="cuda", dtype=torch.int32)
    want = oracle_y(torch, a, b).cpu().numpy()
    traces, seeds = edge_traces(runtime, plan, args.seed)
    trace = traces[0]
    sites = edge_sites(plan, batch)
    log(f"[edge] AGE s=t=z=2, 3 spares: n_workers={plan.n_workers} n_total={plan.n_total} "
        f"thr={plan.decode_threshold}; a [{batch}, {k}, 512], b [{batch}, {k}, 4096]; "
        f"trace seeds {seeds}: worker 0 dropped, worker 1 corrupt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    modules = {"protocol": protocol, "scheduler": scheduler}
    reps = args.reps
    times, counts = {}, {}

    def check(run, y_want, mode, tag):
        if not np.array_equal(run.y, y_want):
            bad = int((run.y != y_want).sum()) if run.y.shape == y_want.shape else -1
            raise AssertionError(f"[{tag}] Y differs from the float64 oracle in {bad} entries")
        m = run.metrics
        bad_ids = (m.rejected_ids if mode == "detect" else m.corrected_workers).tolist()
        if 1 not in bad_ids or 0 in m.phase2_ids.tolist():
            raise AssertionError(f"[{tag}] corrupt worker 1 not caught ({bad_ids}) or dropped "
                                 f"worker 0 in the Phase-2 set {m.phase2_ids.tolist()}")
        log(f"[{tag}] Y exact; phase2 {m.phase2_ids.tolist()} responders "
            f"{m.responder_ids.tolist()} rejected {m.rejected_ids.tolist()} corrected "
            f"{m.corrected_workers.tolist()} completion {m.completion_time}")

    for backend, variant in (("auto", "int32"), ("cuda", "f32")):
        for mode in ("detect", "correct"):
            tag = f"edge batch {backend} {mode}"
            kw = dict(seed=args.seed, decode_mode=mode, verify_extras=1, error_budget=1,
                      backend=backend)
            call = lambda: runtime.run_batch_over_pool(plan, a, b, trace, **kw)  # noqa: E731
            torch.cuda.synchronize()
            K.reset_launch_counts()
            run = call()
            torch.cuda.synchronize()
            got = launched_shapes(K)
            expect = expected_shapes(K, sites, EDGE_BATCH_SITES, variant)
            if got != expect:
                raise AssertionError(f"[{tag}] launches {got}, expected {expect}")
            counts[(backend, mode)] = got
            check(run, want, mode, tag)
            times[tag] = {"median_wall_ms": round(wall_ms(torch, call, reps), 3),
                          "split": split_call(torch, modules, call)}
            log(f"[edge time] {tag}: " + json.dumps(times[tag]))

    tag = "edge product 0"
    call = lambda: runtime.run_over_pool(plan, a[0], b[0], trace, seed=args.seed,  # noqa: E731
                                         verify_extras=1)
    K.reset_launch_counts()
    run = call()
    torch.cuda.synchronize()
    got = launched_shapes(K)
    expect = expected_shapes(K, sites, EDGE_PRODUCT_SITES, "int32")
    if got != expect:
        raise AssertionError(f"[{tag}] launches {got}, expected {expect}")
    counts["product"] = got
    check(run, want[0], "detect", tag)
    times[tag] = {"median_wall_ms": round(wall_ms(torch, call, reps), 3),
                  "split": split_call(torch, modules, call)}
    log(f"[edge time] {tag}: " + json.dumps(times[tag]))

    stack_a, stack_b = a.expand(3, *a.shape), b.expand(3, *b.shape)
    for tag, call in (
        ("edge pipeline", lambda: runtime.run_pipeline_over_pool(
            plan, stack_a, stack_b, traces, seed=args.seed, verify_extras=1)),
        ("edge adaptive", lambda: runtime.run_adaptive_over_pool(
            runtime.AutoPlanner([constructions.PlanConfig("age", 2, 2, 2),
                                 constructions.PlanConfig("polydot", 2, 2, 2)]),
            stack_a, stack_b, traces, seed=args.seed, verify_extras=1)),
    ):
        start = time.perf_counter()
        run = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        if run.y.shape != (3,) + want.shape or not all(np.array_equal(y, want) for y in run.y):
            raise AssertionError(f"[{tag}] Y differs from the float64 oracle")
        for m in run.replay_metrics:
            if 1 not in m.rejected_ids.tolist() or 0 in m.phase2_ids.tolist():
                raise AssertionError(f"[{tag}] a replay missed the corrupt or dropped worker")
        extra = ""
        if tag == "edge adaptive":
            extra = f"; decisions {[d.config.label() + ':' + d.reason for d in run.decisions]}"
        # 3 runs at most: one replay sequence takes tens of seconds
        walls = [secs * 1e3] + [wall_ms(torch, call, 1) for _ in range(min(reps, 3) - 1)]
        times[tag] = {"median_wall_ms": round(statistics.median(walls), 3), "runs": len(walls),
                      "split": split_call(torch, modules, call)}
        log(f"[{tag}] 3 replays of batch {batch}: every Y exact, worker 1 rejected and "
            f"worker 0 outside Phase 2 in each{extra}")
        log(f"[edge time] {tag}: " + json.dumps(times[tag]))
    peak = torch.cuda.max_memory_allocated()
    log(f"[edge] peak allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    del a, b, stack_a, stack_b
    torch.cuda.empty_cache()
    phase_edge_reduced(torch, K, planner, constructions, runtime, args)
    return {"plan": plan, "batch": batch, "counts": counts, "times": times, "peak": peak}


def phase_edge_reduced(torch, K, planner, constructions, runtime, args) -> None:
    """The edge calls at k = 256, ma = 32, mb = 64 on the card and on the
    CPU: the same Y and equal metrics, field by field."""
    import numpy as np

    plan = planner.get_plan(constructions.build_scheme("age", 2, 2, 2),
                            planner.BlockShapes(k=256, ma=32, mb=64, s=2, t=2), n_spare=3)
    rng = np.random.default_rng(args.seed)
    a = rng.integers(0, P, (3, args.batch, 256, 32))
    b = rng.integers(0, P, (3, args.batch, 256, 64))
    traces, _ = edge_traces(runtime, plan, args.seed)

    def planner_():
        return runtime.AutoPlanner([constructions.PlanConfig("age", 2, 2, 2),
                                    constructions.PlanConfig("polydot", 2, 2, 2)])

    calls = {f"batch {backend} {mode}": (
        lambda dev, backend=backend, mode=mode: runtime.run_batch_over_pool(
            plan, a[0], b[0], traces[0], seed=args.seed, decode_mode=mode, verify_extras=1,
            error_budget=1, backend=backend, device=dev))
        for backend in ("auto", "cuda") for mode in ("detect", "correct")}
    calls["product 0"] = lambda dev: runtime.run_over_pool(
        plan, a[0, 0], b[0, 0], traces[0], seed=args.seed, verify_extras=1, device=dev)
    calls["pipeline"] = lambda dev: runtime.run_pipeline_over_pool(
        plan, a, b, traces, seed=args.seed, verify_extras=1, device=dev)
    # the planner object itself differs; its decisions are compared
    calls["adaptive"] = lambda dev: (lambda run: (run.y, run.replay_metrics, run.decisions))(
        runtime.run_adaptive_over_pool(planner_(), a, b, traces, seed=args.seed,
                                       verify_extras=1, device=dev))
    for name, call in calls.items():
        card, cpu = call(None), call("cpu")
        same_result(cpu, card, f"[edge reduced] {name}")
    log(f"[edge reduced] k=256 ma=32 mb=64: {len(calls)} calls equal on the card and the CPU "
        f"(Y and every metric): {sorted(calls)}")


def edge_entries(torch, K, ref, edge: dict, args) -> list:
    """The edge runtime's launch sites for the ``kernels`` line, with their
    launches per ``run_over_pool`` / ``run_batch_over_pool`` call."""
    plan, batch = edge["plan"], edge["batch"]
    sites = edge_sites(plan, batch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 5)
    entries = []
    for variant, names, counts in (
        ("int32", EDGE_PRODUCT_SITES, edge["counts"]["product"]),
        ("int32", EDGE_BATCH_SITES, edge["counts"][("auto", "detect")]),
        ("f32", EDGE_BATCH_SITES, edge["counts"][("cuda", "detect")]),
    ):
        for site in names:
            sa, sb = sites[site]
            shape = geometry(sa, sb)
            compiled = f"{variant}_{K.choose_design(variant, False, *shape)}"
            n_launch = counts.get(compiled, {}).get(shape, 0)
            if n_launch < 1:
                raise AssertionError(f"{compiled} never launched at edge site {site} {shape}")
            entries.append(measure_site(torch, K, ref, gen, f"modmatmul_{variant}", variant,
                                        False, site, sa, sb, plan.scheme.z, n_launch, args))
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is driven")
    ap.add_argument("--variant-path", choices=("int32", "f32"),
                    help="only time this variant's sites and run_batched on it")
    ap.add_argument("--k", type=int, default=5120, help="--variant-path's contraction depth")
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2

    from repro_torch import runtime
    from repro_torch.core import constructions, layers, planner, protocol
    from repro_torch.kernels.modmatmul import kernel as K
    from repro_torch.kernels.modmatmul import ref
    from repro_torch.runtime import scheduler

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    if args.variant_path:
        result = phase_variant_path(torch, K, ref, protocol, planner, constructions, args)
        print(json.dumps({**result, "device": smi}))
        return 0

    t0 = time.perf_counter()
    phase_build(K)
    phase_kernels(torch, K, ref, args.seed)
    main_run = phase_main(torch, K, protocol, layers, planner, constructions, args)
    f32_run = phase_f32(torch, K, protocol, planner, constructions, args)
    edge_run = phase_edge(torch, K, protocol, planner, constructions, runtime, scheduler, args)
    entries = site_entries(torch, K, ref, main_run, "int32", args)
    entries += site_entries(torch, K, ref, f32_run, "f32", args)
    entries += edge_entries(torch, K, ref, edge_run, args)
    for name in K.KERNEL_NAMES:
        if not any(e["name"] == name and e["launches"] > 0 for e in entries):
            raise AssertionError(f"kernel {name} was not launched on its path")
    on_path = {n for by in (MAIN_BY_KERNEL, F32_BY_KERNEL) for d in by.values() for n in d}
    on_path |= {n for counts in edge_run["counts"].values() for n in counts}
    for name in on_path:
        if not any(e["kernel"] == name and e["launches"] > 0 for e in entries):
            raise AssertionError(f"compiled kernel {name} was not launched on its path")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"run_batched ms {main_run['times']}, backend='cuda' {f32_run['times']}, "
        f"peak {main_run['peak']} / {f32_run['peak']} bytes; edge peak {edge_run['peak']} bytes")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
