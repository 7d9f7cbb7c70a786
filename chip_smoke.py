#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port of the coded-MPC engine on one GPU.

    python3 chip_smoke.py [--seed 0] [--batch 4] [--reps 5]
    python3 chip_smoke.py --variant-path f32|int32 [--src DIR] [--k 5120]
    python3 chip_smoke.py --only train|mesh|staging|dryrun [--src DIR]

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
             wall time of each call (median of ``--reps``; one run for
             the pipeline and the auto-planner) split into the
             device data plane and the host (blinding draw, the copy of
             the Phase-2 evaluations, event loop and decode), the peak
             device memory; and the same replays at k = 256, ma = 32,
             mb = 64 equal, Y and every metric, on the card and on the CPU;
6. serve   — ``ServingEngine`` at the same width: W_q [5120, 4096] and
             16 requests of one 512-token chunk [512, 5120] (unit
             normals from ``--seed``), Poisson arrivals at 0.6 per
             simulated second, AGE s = t = z = 2 on a pool of 21 with
             ``sample_trace(21, ShiftedExponential(0.1, 0.5), seed=9000+i,
             net_scale=0.3)``, SLO 30, ``pipe_depth=2``, ``max_batch=4``,
             hybrid decode; ``continuous`` and ``boundary`` on ``auto``
             and ``continuous`` on ``backend="cuda"``: every request done,
             every y equal to a float64 oracle on the card, no responder
             of these fault-free traces rejected or corrected and the
             hybrid decode never escalated, the launches
             per replay per compiled kernel, the wall of each ``run()``
             split into device data plane and host as ``[edge time]``
             splits it, the peak device memory; the escalation scenario
             (a corrupt fastest worker: detect, then BW correction); and
             the stream at k = 256 (also over a shrinking elastic pool)
             equal on the card and on the CPU;
7. crt     — ``secure_matmul_crt`` (p = 65521 * 65519, z = 2) on float
             [4, 5120, 512] and [4, 5120, 4096] on ``auto`` and
             ``backend="cuda"``, fused and unfused: y and the combined
             integers of ``run_batched_crt`` on the same plans exact
             against a float64 oracle on the card, the launches twice
             ``run_batched``'s, the wall per call and the share of it
             that ``crt_combine`` takes on these residues alone; one
             ``mod_matmul_crt`` of
             [512, 5120] @ [5120, 4096];
8. fuzz    — ``fuzz.run_fuzz`` (96 cases from ``--seed``) through the
             ``cuda``, ``cuda_int32`` and ``crt`` engines on the card:
             zero mismatches against the arbitrary-precision oracle;
9. model   — Mistral-NeMo-12B at full width and depth on the card
             (40 layers, d_model 5120, 32 x 128 heads, 8 KV heads, d_ff
             14336, vocab 131072; random weights from ``--seed``; trunk
             and embed in bfloat16, lm_head float32) and the launcher's
             ``--private-head`` path over it (``repro_torch.launch.serve``,
             batch 4, prompt 32, gen 4: three lm-head replays through the
             ServingEngine on ``auto`` over 16 workers): every step
             served, none shed; each replay's field values exact against
             a float64 product of the encoded operands on the card; each
             step's worst |logit - x W| below the bound that follows from
             its scale; layer 0 card (bfloat16) against CPU (float32)
             within 2**-5 of its largest output; init time, prefill ms and
             trunk ms per step (CUDA events), each replay's wall split as
             ``[serve time]`` splits it, the simulated p50/p95, the peak
             device memory and the launches per compiled kernel;
10. moe    — with the Mistral model freed, DeepSeek-V2-Lite-16B at full
             width and depth (27 layers, layer 0 dense with d_ff 10944,
             d_model 2048, 16 heads of MLA (kv_lora 512, rope 64, nope
             128, v 128), 64 experts top-6 + 2 shared with d_ff_expert
             1408, vocab 102400; 15,706,470,400 random parameters from
             ``--seed``) through the same launcher path and checks as
             ``model`` (lm head [2048, 102400]), and the capacity drops of
             the prefill; layer 0 (MLA + dense MLP) card (bfloat16)
             against CPU (float32), and layer 1 (MLA + MoE) in float32 on
             both sides with TF32 off: the same top-6 experts for every
             token whose 6th and 7th router probabilities are more than
             1e-6 apart, the outputs within 2**-12 of the largest;
11. vlm    — with DeepSeek freed, InternVL2-26B at full width and depth
             (48 layers, d_model 6144, 48 x 128 heads, 8 KV heads, d_ff
             16384, vocab 92553 padded to 92672; 19,862,722,560 random
             parameters from ``--seed``): a prefill of 1024 patch
             embeddings (normals from ``--seed``) and the 32-token prompt,
             then the same launcher path and checks as ``model`` from
             position 1056 (lm head [6144, 92672]); layer 0 card
             (bfloat16) against CPU (float32) over the patches and the
             prompt's embeddings;
12. encdec — with InternVL2 freed, SeamlessM4T-Large-v2 at full width and
             depth (24 encoder + 24 decoder layers, d_model 1024, 16 x 64
             heads, d_ff 8192, vocab 256206 padded to 256256; 2.03 B
             parameters) through ``launch.serve.main`` in process (batch
             4, 4096 frames, gen 8; the plain decode: an encoder-decoder
             has no private head): the launcher's prefill and decode ms,
             every step's logits finite, the peak device memory; encoder
             layer 0 and decoder block 0 (cross-attention over a padded
             encoder output with ``enc_len``) card (bfloat16) against CPU
             (float32); ``--private-head`` refused with the reference's
             message.  No TPU kernel runs in this phase;
13. xlstm  — with SeamlessM4T freed, xLSTM-1.3B at full width and depth
             (48 layers as 6 x [1 sLSTM + 7 mLSTM], d_model 2048, d_in
             4096, 4 heads, vocab 50304 padded to 50432; 4,335,536,464
             parameters, 10,491,204,928 bytes: lm_head and the float32-cast
             gate weights in float32) through ``launch.serve.main`` in
             process (batch 4, prompt 256 = 4 mLSTM chunks of 64, gen 8,
             the plain decode): the parameters and bytes, every step's
             logits finite, the launcher's prefill and decode ms, the peak
             device memory; sLSTM block 0 and mLSTM block (0, 0) over 128
             tokens card (bfloat16) against CPU (float32), outputs and final
             states, zero-initialised leaves drawn first; a warm prefill and
             3 decode steps by CUDA events beside the step's bound; the last
             logits of a prefill over 257 tokens against a prefill over 256
             and one step (bfloat16 recorded, float32 held within 2**-5);
             ``--private-head`` refused with the reference's message; no
             TPU kernel launched;
14. zamba  — the same for Zamba2-2.7B (54 Mamba2 layers, d_model 2560,
             state 64, chunk 128, the shared attention + MLP block (32 x 80
             heads, d_ff 10240) before every 6th layer with a rank-64 LoRA
             row each, vocab 32000; 2,425,619,360 parameters, 5,015,096,000
             bytes): the blocks are Mamba2 layer 1 over 256 tokens (2
             chunks) and the shared block at invocation 1 with a nonzero
             LoRA ``b_q``;
15. sharded — the sharded Phase 2 (``repro_torch.core.distributed``) at
             the main path's width: a one-rank NCCL group from a
             ``HashStore`` and its ``workers`` mesh on the card;
             ``run_batched_sharded`` in all_to_all, psum and psum_scatter
             on ``auto`` and in all_to_all on ``backend="cuda"`` (Y exact
             against the float64 oracle, the launches by shape at the X
             sites: X1 shares, X2 the per-shard multiply on ``int32_mma``
             / ``f32_wgmma``, X3 decode; CUDA-event median of ``--reps``,
             peak device memory, a ``[sharded time]`` split), once with
             a Phase-2 sender and a Phase-3 responder subset over 3
             spares; ``run_phase2_sharded``'s I in every mode equal to
             the dense Phase 2 (mix^T H + vnoise R_sum through the plain
             versions) on the same shares and per-worker noise;
             ``run_batch_over_pool(mesh=...)`` in correct mode on the
             [edge] pool and trace rule (Y exact, worker 1 corrected);
             a ``ServingEngine(mesh=...)`` stream of 4 [serve] requests
             (every y exact); then 4 gloo ranks sharing the card (n_total
             17 padded to 20): every rank's Y exact in every mode and its
             I equal to the dense Phase 2's;
16. timing — each kernel at each launch site of its paths (the
             ``run_batched`` sites, the edge runtime's, a serving
             replay's at n_total 21 and one request, the lm-head
             replays', H, D and V, at n_total 16, and any shape the
             sharded phase launched that no other site has; the plain
             version of the 10.7 GB H1 share B, the 3.4 GB D1 share B and
             the 9.1 GB V1 share B in column slices): exact against the
             plain version,
             CUDA-event time, device time of launches
             queued back to back (behind a busy-wait kernel), plain
             version, bound, library call, design; printed as one JSON
             line.  Every other shape the serving runs launched (a
             replay of several requests) is held exact against the plain
             version too, and a serving launch at no site's shape fails.
             ``secure_matmul_crt``'s residues launch at the main path's
             sites; ``mod_matmul_crt``'s one product is held whole
             against the oracle.

17. train — run after ``sharded``, before the timing above: MiniCPM-2B
             at full width and depth (40 layers, d_model 2304, 36 x 64
             heads, d_ff 5760, vocab 122753 padded to 122880, tied
             embeddings, full remat; 2,725,173,504 float32 parameters
             from seed 0) trained by ``repro_torch.launch.train.main`` in
             process for 4 steps of 4 micro-steps of 2 x 256 tokens on
             the WSD schedule, no checkpoint: every step's loss and
             gradient norm finite, step 0's loss within 0.25 of ln
             122753, the lr the schedule's, every parameter moved and
             finite, no TPU kernel launched; the warm step's CUDA-event
             ms and tokens/s against the FLOP bound (8 x parameters x
             tokens at the bf16 peak), the peak, and ``adamw_update``
             alone against its byte bound (28 B a parameter); layer 0's
             forward and backward over 256 tokens and
             ``chunked_softmax_xent`` over 64 against the full tied head,
             every gradient card against CPU in float32 with TF32 off
             within 2**-10 of each value's largest (layer 0 at bfloat16
             recorded); the reduced MiniCPM, 6 steps card against CPU
             from the same weights within 1e-4 relative, and 3 steps +
             save + restore + 3 against 6 straight on the card within
             1e-6; then the examples on the card: ``train_lm.py --profile
             100m --steps 200`` (the loss falls by 0.25), ``quickstart.py``,
             ``serve_lm.py`` (minicpm-2b, zamba2-2.7b) and
             ``private_inference.py`` on one NCCL rank.
18. mesh  — after ``train``: 4 spawned ranks (one NCCL rank a card
             with 4 cards or more, else gloo ranks sharing card 0 whose
             DTensor collectives run as plain gloo ones,
             ``distributed.staged``) on a 2x2 (data, model) mesh.
             ``[mesh train]``: MiniCPM-2B at full width, 2 of its 40
             layers (``MESH_LAYERS``: the cut that fits the script's time
             limit, PERF.md section 4), FSDP +
             TP from ``param_pspecs``, 2 steps of
             ``build_train_step`` at the launcher's defaults (2 micro-steps
             of 2 x 256 tokens a data shard): step 0's loss within 1e-3
             relative of the one-device model's on the same weights and
             rows (and of ``[train]``'s step 0 at all 40), CUDA-event ms, tokens/s,
             each rank's peak in training (read after the build, whose
             own peak is printed beside it) and serving;
             ``[mesh comm]``: one micro-step's all-gathers, reduce-scatters
             and all-reduces (``comm.CollectiveLog``) and the bytes a rank
             sends, equal to ``comm.design_collectives``' from the spec
             tables;
             ``[mesh train reduced]``: the reduced model at float32, 2 steps
             on the mesh against one rank, every parameter within 1e-5 of
             its leaf's largest; ``[mesh serve]``: the sharded prefill (4 x
             256) and 2 decode steps against the one-device model, logits
             within 2**-5 of the largest, greedy tokens equal where the
             top-2 margin exceeds that; ``[pipeline]``: ``pipeline_forward``
             over 4 stages of 10 blocks (float32, 8 micro-batches of 256
             tokens) against the sequential trunk within 2**-10 of its
             largest value, ms and bubble.  ``[mesh hybrid]``, in the same
             ranks: Zamba2-2.7B (54 Mamba2 layers, the shared block every
             6) at full width and depth, bfloat16 weights, served on the
             2x2 mesh through the sharded prefill (4 x 256) and 8 decode
             steps, the path of ``launch/serve.py --mesh 2x2``; then the
             prefill and 4 decode steps again on the same weights (stored
             and gathered in bfloat16, cast at use) at float32 compute,
             whose last logits
             must be within 2**-5 of the largest of the one-device
             model's at float32 compute (the bfloat16 figure recorded
             beside it); prefill and decode ms, each rank's peak, one
             decode step's collectives by kind.  No TPU kernel launches
             on any rank.
19. dryrun — ``repro_torch.launch.dryrun`` in a spawned process on a fake
             process group (no card): ``[mesh train]``'s own configuration on 2x2,
             whose micro-step collectives (counts and bytes a rank sends)
             must equal ``[mesh comm]``'s measured ones, its predicted peak
             beside the measured one; then ``minicpm-2b x train_4k`` on the
             production meshes (16 x 16 and 2 x 16 x 16): bytes, FLOPs and
             collectives a rank, trace seconds.

The last line is ``{"ok": true, "device": {...}}``.  Without a GPU the
script exits with code 2 and prints no result.

``--only train`` runs only ``[train]``'s launcher (its warm step ms,
from the ``--src`` tree); ``--only mesh`` only the mesh phases (no
``[train]`` loss to hold step 0 against beyond the one-device model's);
``--only staging`` only the comparison of a gloo collective's two forms
on ranks sharing the card (``staging_rank``); ``--only dryrun`` only the
dry-run's three cells.  Each prints one JSON line.

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
import collections
import json
import math
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


# f32_wgmma_masked takes no launch site on any path (choose_design sends
# every masked f32 product of the engine to f32_skinny_masked); phase 2
# launches it at these shapes among others (the largest output, and a
# ragged tile past one fold), where it is timed beside its bound
PHASE2_WGMMA_MASKED = (((40, 6), (6, 10_000_000), 2), ((2, 129, 513), (2, 513, 127), 3))


def time_wgmma_masked(torch, K, ref, args) -> list:
    """``[timing]`` lines of ``f32_wgmma_masked`` at ``PHASE2_WGMMA_MASKED``
    (each output checked against its plain version first).  The entries
    stay off the ``kernels`` line: no path launches this kernel, and no
    single PyTorch call computes a masked product (no library time)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 11)
    out = []
    for sa, sb, z in PHASE2_WGMMA_MASKED:
        e = measure_site(torch, K, ref, gen, "modmatmul_f32_masked", "f32", True, "phase 2",
                         sa, sb, z, 0, args)
        if e["kernel"] != "f32_wgmma_masked":
            raise AssertionError(f"{sa} @ {sb}: {e['kernel']}, not f32_wgmma_masked")
        out.append(e)
    log(f"[timing] f32_wgmma_masked takes no site on any path: the lines above are phase 2's "
        f"shapes, off the kernels line")
    return out


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


# the kernel each site launches, unfused and fused.  Unfused, the degree
# reduction is one loaded-rows launch, REDUCE_SITE, in the place of "P2
# mix" and "P2 noise" (which stay in site_table for --variant-path and
# the parent trees it times), and each share is one blocks-form launch
# at its site's counted shape (measure_site hands it to
# measure_share_site)
UNFUSED_SITES = ("P1 share A", "P1 share B", "P2 multiply", "P3 decode")
FUSED_MASKED = ("P1 share A", "P1 share B", "P2 mix")
FUSED_PLAIN = ("P2 multiply", "P3 decode")
REDUCE_SITE = "P2 mix + noise"


def reduce_site(plan, batch: int) -> tuple:
    """Shapes of run_batched's unfused degree reduction, a @ h[rows] +
    v @ r: (a, h, v, r), with rows the first n_workers of h's n_total."""
    n, nw, z = plan.n_total, plan.n_workers, plan.scheme.z
    blk = plan.shapes.blk_y[0] * plan.shapes.blk_y[1]
    return (n, nw), (batch, n, blk), (n, z), (batch, z, blk)


def reduce_operands(torch, gen, plan, batch: int) -> tuple:
    """Random (a, h, rows, v, r) of ``REDUCE_SITE`` on the card, rows the
    prefix of h's rows that run_batched picks."""
    sa, sh, sv, sr = reduce_site(plan, batch)
    a, h, v, r = (torch.randint(0, P, s, generator=gen, device="cuda", dtype=torch.int32)
                  for s in (sa, sh, sv, sr))
    return a, h, torch.arange(sa[1], device="cuda"), v, r


def share_blocks_operands(torch, gen, protocol, plan, batch: int) -> dict:
    """Random operands of run_batched's two blocks-form share launches on
    the card, as ``_share`` passes them: site -> (a, x, offsets, bc, ld,
    v, r), x being A^T [batch, ma, k] or B [batch, k, mb]."""
    dp = protocol.device_plan(plan, "cuda")
    sh, z = plan.shapes, plan.scheme.z
    (bra, bca), (brb, bcb) = sh.blk_a, sh.blk_b
    rand = lambda shape: torch.randint(0, P, shape, generator=gen, device="cuda",  # noqa: E731
                                       dtype=torch.int32)
    return {
        "P1 share A": (dp.va_blocks, rand((batch, sh.ma, sh.k)), dp.a_offsets, bca, sh.k,
                       dp.va_secrets, rand((batch, z, bra * bca))),
        "P1 share B": (dp.vb_blocks, rand((batch, sh.k, sh.mb)), dp.b_offsets, bcb, sh.mb,
                       dp.vb_secrets, rand((batch, z, brb * bcb))),
    }


def blocks_share(protocol, ops, plan, site: str, variant: str) -> bool:
    """Whether ``site`` is a Phase-1 share that ``protocol._share``
    launches as the blocks form: an unmasked share of ``run_batched`` or
    ``share_batched`` (every share site but the per-product edge path's
    E1) whose plan passes ``ops.skinny_fuses`` on the card."""
    if site[0] == "E" or not site[1:].startswith("1 share "):
        return False
    backend = {"int32": "cuda_int32", "f32": "cuda"}[variant]
    sch = plan.scheme
    return (protocol.device_plan(plan, "cuda").va_blocks is not None
            and ops.skinny_fuses(backend, "cuda", plan.n_total, sch.t * sch.s, sch.z))


def reduce_launch_shape(plan, batch: int) -> tuple:
    """The (B, M, K + z, N) the reduce's launch is counted at."""
    sa, sh, sv, _ = reduce_site(plan, batch)
    return (batch, sa[0], sa[1] + sv[1], sh[-1])


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


def median_event_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event ms of ``reps`` calls of ``fn``, each timed alone."""
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def run_batched_ms(torch, protocol, plan, a, b, *, backend, fused, seed, reps) -> float:
    """Median CUDA-event ms of ``reps`` calls of run_batched."""
    return median_event_ms(torch, lambda: protocol.run_batched(
        plan, a, b, seed=seed, backend=backend, fused_masks=fused), reps)


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
    False: {"int32_mma": 1, "int32_skinny": 4},
    True: {"int32_mma": 1, "int32_skinny": 1, "int32_skinny_masked": 3},
}
F32_BY_KERNEL = {
    False: {"f32_wgmma": 1, "f32_skinny": 4},
    True: {"f32_wgmma": 1, "f32_skinny": 1, "f32_skinny_masked": 3},
}


def expect_launches(K, kernel, masked_kernel, by_kernel, fused: bool, tag: str) -> None:
    want = {kernel: 2, masked_kernel: 3} if fused else {kernel: 5}
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
    if K.LAUNCHES["modmatmul_int32"] != 5:
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
    if hasattr(K, "modmatmul_rows_plus_cuda"):  # a parent tree may predate the form
        x, h, rows, v, r = reduce_operands(torch, gen, plan, batch)
        kern = lambda: K.modmatmul_rows_plus_cuda(x, h, rows, v, r, P, variant)  # noqa: E731
        if not torch.equal(kern(), ref.modmatmul_rows_plus_plain(x, h, rows, v, r, P, variant)):
            raise AssertionError(f"{variant} loaded-rows kernel != plain version at {REDUCE_SITE}")
        result["sites"][f"{REDUCE_SITE} rows_plus"] = {
            "ms": cuda_ms(torch, kern, reps), "device_ms": device_ms(torch, kern, reps)}
        del x, h, v, r
        torch.cuda.empty_cache()
    if hasattr(K, "modmatmul_blocks_plus_cuda"):  # a parent tree may predate the form
        for site, ops_ in share_blocks_operands(torch, gen, protocol, plan, batch).items():
            kern = lambda: K.modmatmul_blocks_plus_cuda(*ops_, P, variant)  # noqa: E731
            if not torch.equal(kern(), ref.modmatmul_blocks_plus_plain(*ops_, P, variant)):
                raise AssertionError(f"{variant} blocks kernel != plain version at {site}")
            result["sites"][f"{site} blocks_plus"] = {
                "ms": cuda_ms(torch, kern, reps), "device_ms": device_ms(torch, kern, reps)}
        del ops_
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
def plain_error(torch, ref, variant, a, b, got, cols=0) -> int:
    """max |got - plain(a, b)| over the whole output, or over column
    slices of width ``cols`` (each slice's plain result dropped after its
    comparison)."""
    if not cols:
        return int((got.to(torch.int64) - ref.PLAIN[variant](a, b, P).to(torch.int64)).abs().max())
    err = 0
    for c0 in range(0, b.shape[-1], cols):
        exp = ref.PLAIN[variant](a, b[..., c0:c0 + cols], P).to(torch.int64)
        err = max(err, int((got[..., c0:c0 + cols].to(torch.int64) - exp).abs().max()))
    return err


def check_site(torch, K, ref, gen, what, variant, masked, sa, sb, z, plain_cols=0):
    """Random inputs of one launch site's shape through the kernel and its
    plain version; raises unless they agree exactly.  Returns the
    operands, the two calls and the error (0).  With ``plain_cols`` the
    plain version runs over column slices of that width (each held
    against the kernel's columns, then dropped), for outputs whose plain
    version's int64 temporaries would not fit beside them."""
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
    if plain_cols and not masked:
        def parts():
            for c0 in range(0, sb[-1], plain_cols):
                yield ref.PLAIN[variant](a, b[..., c0:c0 + plain_cols], P)

        plain = lambda: collections.deque(parts(), maxlen=0)  # noqa: E731
        got = kern()
        err = plain_error(torch, ref, variant, a, b, got, plain_cols)
        torch.cuda.synchronize()
        del got
        if err:
            raise AssertionError(f"{what}: max abs error {err} against plain")
        return a, b, v, kern, plain, err
    got, exp = kern(), plain()
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - exp.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"{what}: max abs error {err} against plain")
    return a, b, v, kern, plain, err


def measure_site(torch, K, ref, gen, name, variant, masked, site, sa, sb, z, n_launch, args,
                 plain_cols=0, blocks=None) -> dict:
    """One launch site of ``variant`` on random inputs of its shape: the
    kernel against its plain version (over column slices of
    ``plain_cols``, if given: ``check_site``), then its times, bound and
    library call; logs a ``[timing]`` line and returns the ``kernels``
    entry.  ``blocks`` = (protocol, ops, plan) for a path through
    ``protocol._share``: an unmasked share there that launches the blocks
    form (``blocks_share``) is measured as that launch instead
    (``measure_share_site``)."""
    if blocks is not None and not masked and blocks_share(*blocks, site, variant):
        protocol, _, plan = blocks
        return measure_share_site(torch, K, ref, gen, protocol, variant, plan, site, sa, sb,
                                  n_launch, args, plain_cols)
    shape = geometry(sa, sb)
    design = K.choose_design(variant, masked, *shape, z if masked else 0)
    compiled = f"{variant}_{design}" + ("_masked" if masked else "")
    a, b, v, kern, plain, err = check_site(torch, K, ref, gen, f"{name} at {site}", variant,
                                           masked, sa, sb, z, plain_cols)
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
        "geometry": list(shape),
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
    if plain_cols:
        entry["plain_cols"] = plain_cols
        floor += f"  (plain in column slices of {plain_cols})"
    log(f"[timing] {compiled:20s} {site:12s} {entry['shape']:44s} "
        f"{ms:9.3f} ms  device {entry['device_ms']}  plain {plain_ms:9.3f}  "
        f"bound {entry['bound_ms']:7.3f} "
        f"({entry['bound_by']})  library {library_ms}{floor}")
    del a, b, v
    torch.cuda.empty_cache()
    return entry


def measure_reduce_site(torch, K, ref, gen, variant, plan, batch, n_launch, args) -> dict:
    """``REDUCE_SITE`` of ``variant`` on random inputs of its shape (rows
    the prefix run_batched picks): the loaded-rows launch against its
    plain version, then its times and bound (no single library call
    computes it); logs a ``[timing]`` line and returns the ``kernels``
    entry."""
    sa, sh, sv, sr = reduce_site(plan, batch)
    a, h, rows, v, r = reduce_operands(torch, gen, plan, batch)
    kern = lambda: K.modmatmul_rows_plus_cuda(a, h, rows, v, r, P, variant)  # noqa: E731
    plain = lambda: ref.modmatmul_rows_plus_plain(a, h, rows, v, r, P, variant)  # noqa: E731
    got, exp = kern(), plain()
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - exp.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"{variant} loaded-rows kernel at {REDUCE_SITE}: max abs error {err}")
    del got, exp
    reps = args.reps
    ms, dev_ms = cuda_ms(torch, kern, reps), device_ms(torch, kern, reps)
    plain_ms = cuda_ms(torch, plain, reps)
    B, M, Kt, N = reduce_launch_shape(plan, batch)
    # the rows read (K of h, z of r), the coefficients, the output
    nbytes = 4 * (M * Kt + B * Kt * N + B * M * N)
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, 8 * B * M * Kt * N / INT8_TC_OPS * 1e3
    entry = {
        "name": f"modmatmul_{variant}",
        "kernel": f"{variant}_skinny",
        "design": "skinny",
        "site": REDUCE_SITE,
        "shape": f"{list(sa)}@{list(sh)}[:{sa[1]}]+{list(sv)}@{list(sr)}",
        "geometry": [B, M, Kt, N],
        "route": "cuda",
        "source": SOURCES[f"{variant}_skinny"],
        "replaces": TPU_KERNELS[f"modmatmul_{variant}"],
        "launches": n_launch,
        "max_abs_err": err,
        "ms": round(ms, 4),
        "device_ms": round(dev_ms, 4),
        "plain_ms": round(plain_ms, 4),
        "bound_ms": round(max(t_bytes, t_ops), 4),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    log(f"[timing] {entry['kernel']:20s} {REDUCE_SITE:12s} {entry['shape']:44s} "
        f"{ms:9.3f} ms  device {entry['device_ms']}  plain {plain_ms:9.3f}  "
        f"bound {entry['bound_ms']:7.3f} ({entry['bound_by']})  library None")
    del a, h, v, r
    torch.cuda.empty_cache()
    return entry


def check_share_site(torch, K, ref, gen, protocol, variant, plan, site, sa, sb, plain_cols=0):
    """Random operands of the share ``site`` (A or B by its last letter)
    as ``_share`` passes them to the blocks form, at the batch of its
    counted shape ``geometry(sa, sb)``: the launch against its plain
    version (over column slices of whole block rows, ``plain_cols`` wide
    or more, if given); raises unless they agree exactly.  Returns the
    operands, the two calls and the error (0)."""
    batch = geometry(sa, sb)[0]
    ops_ = share_blocks_operands(torch, gen, protocol, plan, batch)[f"P1 share {site[9]}"]
    a, x, offsets, bc, ld, v, r = ops_
    n = int(r.shape[-1])
    if (batch, a.shape[0], a.shape[1] + v.shape[1], n) != geometry(sa, sb):
        raise AssertionError(f"{site}: blocks operands {list(a.shape)} {list(r.shape)} are not "
                             f"the counted {geometry(sa, sb)}")
    step = max(bc, plain_cols // bc * bc) if plain_cols else n
    kern = lambda: K.modmatmul_blocks_plus_cuda(*ops_, P, variant)  # noqa: E731

    def parts():  # output columns [c0, c0 + step) are block rows c0 / bc on
        for c0 in range(0, n, step):
            yield c0, ref.modmatmul_blocks_plus_plain(
                a, x, offsets + (c0 // bc) * ld, bc, ld, v, r[..., c0:c0 + step], P, variant)

    got = kern()
    err = 0
    for c0, exp in parts():
        err = max(err, int((got[..., c0:c0 + step].to(torch.int64) - exp.to(torch.int64)).abs().max()))
    torch.cuda.synchronize()
    del got
    if err:
        raise AssertionError(f"{variant} blocks kernel at {site}: max abs error {err} against plain")
    plain = lambda: collections.deque(parts(), maxlen=0)  # noqa: E731
    return ops_, kern, plain, err


def measure_share_site(torch, K, ref, gen, protocol, variant, plan, site, sa, sb, n_launch, args,
                       plain_cols=0) -> dict:
    """A Phase-1 share ``site`` that ``_share`` launches as the blocks
    form (``blocks_share``): the launch against its plain version
    (``check_share_site``), then its times and bound (no single library
    call computes it); logs a ``[timing]`` line and returns the
    ``kernels`` entry, counted at the site's shape."""
    ops_, kern, plain, err = check_share_site(torch, K, ref, gen, protocol, variant, plan, site,
                                              sa, sb, plain_cols)
    a, x, offsets, bc, ld, v, r = ops_
    reps = args.reps
    ms, dev_ms = cuda_ms(torch, kern, reps), device_ms(torch, kern, reps)
    plain_ms = cuda_ms(torch, plain, reps)
    B, M, Kt, N = geometry(sa, sb)
    # the blocks read in place (K of them, N each) and the z rows of r,
    # the coefficients, the output: the stack form's bytes
    nbytes = 4 * (M * Kt + B * Kt * N + B * M * N)
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, 8 * B * M * Kt * N / INT8_TC_OPS * 1e3
    entry = {
        "name": f"modmatmul_{variant}",
        "kernel": f"{variant}_skinny",
        "design": "skinny",
        "site": site,
        "shape": (f"{list(a.shape)}@blocks{list(x.shape)}(bc {bc}, ld {ld})"
                  f"+{list(v.shape)}@{list(r.shape)}"),
        "geometry": [B, M, Kt, N],
        "route": "cuda",
        "source": SOURCES[f"{variant}_skinny"],
        "replaces": TPU_KERNELS[f"modmatmul_{variant}"],
        "launches": n_launch,
        "max_abs_err": err,
        "ms": round(ms, 4),
        "device_ms": round(dev_ms, 4),
        "plain_ms": round(plain_ms, 4),
        "bound_ms": round(max(t_bytes, t_ops), 4),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    if plain_cols:
        entry["plain_cols"] = max(bc, plain_cols // bc * bc)
    log(f"[timing] {entry['kernel']:20s} {site:12s} {entry['shape']:44s} "
        f"{ms:9.3f} ms  device {entry['device_ms']}  plain {plain_ms:9.3f}  "
        f"bound {entry['bound_ms']:7.3f} ({entry['bound_by']})  library None")
    del a, x, v, r, ops_
    torch.cuda.empty_cache()
    return entry


def site_entries(torch, K, ref, protocol, ops, run: dict, variant: str, args) -> list:
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
                                 n_launch, args, blocks=(protocol, ops, plan))
            seen[key] = entry
            entries.append(entry)
    n_launch = run["counts"][False][f"{variant}_skinny"].get(reduce_launch_shape(plan, batch), 0)
    if n_launch < 1:
        raise AssertionError(f"{variant}_skinny never launched at {REDUCE_SITE}")
    entries.append(measure_reduce_site(torch, K, ref, gen, variant, plan, batch, n_launch, args))
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


def split_call(torch, modules: dict, fn, targets=SPLIT_TARGETS) -> dict:
    """One call of ``fn`` with the port's data-plane functions wrapped:
    each wrapper synchronizes the card and records CUDA events around the
    function.  The call's wall time splits into the device data plane
    (the share evaluation, worker multiply and degree reduction, less the
    host blinding draw inside the latter) and the host: the per-product
    share preparation (block stacking, the secret draws and their upload,
    around the share evaluation), the blinding draw, the copy of the
    Phase-2 evaluations to the host, and the rest (event loop and
    decode).  Each wrapper's two synchronizations are inside the wall.
    ``targets`` may add the sharded path's functions: the exchange and the
    device decode join the device data plane, the host's per-worker
    blinding draw joins the blinding draw."""
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
        for mod, attr in targets:
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

    blind = ev("_blinding_sum", "wall_ms")
    draw = blind + ev("_sender_noise", "wall_ms")
    # the batched share's polyeval is inside share_batched; the per-product
    # one is the device part of share_a / share_b
    per_product = "share_a" in parts
    prep = ev("share_a") + ev("share_b") - ev("polyeval") if per_product else 0.0
    device = (ev("share_batched") + (ev("polyeval") if per_product else 0.0)
              + ev("worker_multiply") + ev("degree_reduce") + ev("run_phase2_sharded")
              + ev("_decode_batched") - blind)
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
        # one timed run (the checked one): a replay sequence takes tens of
        # seconds, and the script's later phases need the time
        walls = [secs * 1e3]
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


def edge_entries(torch, K, ref, protocol, ops, edge: dict, args) -> list:
    """The edge runtime's launch sites for the ``kernels`` line, with their
    launches per ``run_over_pool`` / ``run_batch_over_pool`` call (the
    latter's shares through ``_share``)."""
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
                                        False, site, sa, sb, plan.scheme.z, n_launch, args,
                                        blocks=(protocol, ops, plan)))
    return entries


# ----------------------------------------------------------------------
# phase 6: the serving tier
# ----------------------------------------------------------------------
SERVE_REQUESTS = 16
SERVE_RATE = 0.6  # Poisson arrivals, requests per simulated second
SERVE_MAX_BATCH = 4
# (k, rows, out) of the serving and CRT phases: d_model 5120, a 512-token
# chunk, W_q's 32 heads x 128
WIDTH = (5120, 512, 4096)


def serve_stream(np, runtime, constructions, seed: int, k: int, rows: int, out: int):
    """The [serve] configuration: AGE s = t = z = 2 on a pool of 21
    (n_workers + 4, as benchmarks/serve_load.py provisions), traces
    ``sample_trace(21, ShiftedExponential(0.1, 0.5), seed=9000 + i,
    net_scale=0.3)``, w [k, out] and 16 requests x [rows, k] of unit
    normals from ``seed``, arriving Poisson at 0.6 per simulated second."""
    cfg = constructions.PlanConfig("age", 2, 2, 2)
    pool = cfg.n_workers + 4
    traces = [runtime.sample_trace(pool, runtime.ShiftedExponential(0.1, 0.5),
                                   seed=9000 + i, net_scale=0.3)
              for i in range(SERVE_REQUESTS)]
    rng = np.random.default_rng(seed + 6)
    w = rng.normal(size=(k, out))
    xs = [rng.normal(size=(rows, k)) for _ in range(SERVE_REQUESTS)]
    arrivals = np.cumsum(rng.exponential(1 / SERVE_RATE, SERVE_REQUESTS))
    return cfg, traces, w, xs, arrivals


def serve_oracle(torch, np, layers, gf, w, x, cache: dict):
    """The engine's answer for one request, computed on the card: the
    request's scale (``choose_scales``), ``encode`` on the host, the
    product in float64 on the card (exact: every partial sum is below
    k*(p-1)**2 < 2**53), ``% p``, ``decode``."""
    field = gf.Field(P)
    k = w.shape[0]
    s = layers.choose_scales(k, float(np.abs(x).max() + 1e-9), float(np.abs(w).max() + 1e-9), P)
    if s not in cache:
        cache[s] = torch.as_tensor(field.encode(w, s), device="cuda").double()
    aq = torch.as_tensor(field.encode(x, s), device="cuda").double()
    yq = torch.remainder(torch.matmul(aq, cache[s]).to(torch.int64), P).cpu().numpy()
    return field.decode(yq, s * s), s


def request_record(r) -> tuple:
    """A served or shed request's outcome, nan as a string (equal to itself)."""
    return tuple("nan" if isinstance(v, float) and v != v else v for v in (
        r.rid, r.state, r.shed_reason, r.arrival, r.deadline, r.launch, r.completion, r.replay))


def phase_serve(torch, K, serve, runtime, constructions, layers, gf, protocol, scheduler,
                args) -> dict:
    import numpy as np

    k, rows, out = WIDTH
    cfg, traces, w, xs, arrivals = serve_stream(np, runtime, constructions, args.seed, k, rows, out)
    log(f"[serve] AGE s=t=z=2 (n_workers {cfg.n_workers}) on a pool of {traces[0].n}; "
        f"w [{k}, {out}] (W_q, 5120 x 32*128); {SERVE_REQUESTS} requests x [{rows}, {k}] "
        f"arriving Poisson at {SERVE_RATE}/s; SLO 30, pipe_depth 2, max_batch 4, hybrid decode")
    cache, want, scales = {}, [], set()
    for x in xs:
        y, s = serve_oracle(torch, np, layers, gf, w, x, cache)
        want.append(y)
        scales.add(s)
    nonzero = float(np.mean(gf.Field(P).encode(w, min(scales)) != 0))
    log(f"[serve] request scales {sorted(scales)}: encoded W {nonzero:.4f} other than zero; "
        f"max |oracle y| {max(float(np.abs(y).max()) for y in want):.1f}")
    del cache
    modules = {"protocol": protocol, "scheduler": scheduler}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results = {}
    for mode, backend in (("continuous", "auto"), ("boundary", "auto"), ("continuous", "cuda")):
        tag = f"serve {mode} {backend}"
        eng = serve.ServingEngine(w, traces, cfg, seed=args.seed, mode=mode, pipe_depth=2,
                                  max_batch=SERVE_MAX_BATCH, slo=30.0, decode_mode="hybrid",
                                  backend=backend)
        for x, t in zip(xs, arrivals):
            eng.submit(x, float(t))
        held = torch.cuda.memory_allocated()
        K.reset_launch_counts()
        box = {}
        split = split_call(torch, modules, lambda: box.setdefault("report", eng.run()))
        rep = box["report"]
        by_kernel = {n: c for n, c in K.LAUNCHES_BY_KERNEL.items() if c}
        shapes = launched_shapes(K)
        variant = "int32" if backend == "auto" else "f32"
        deep = "int32_mma" if backend == "auto" else "f32_wgmma"
        if by_kernel != {deep: rep.replays, f"{variant}_skinny": 4 * rep.replays}:
            raise AssertionError(f"[{tag}] launches {by_kernel} over {rep.replays} replays")
        for r, y in zip(rep.requests, want):
            if r.state != "done" or not np.array_equal(r.y, y):
                raise AssertionError(f"[{tag}] request {r.rid} {r.state}: y differs from the "
                                     "card oracle")
        if eng.device != protocol.resolve_device() or eng._session.device != eng.device:
            raise AssertionError(f"[{tag}] the engine or its session is off the card")
        # no worker of these traces is faulty: a response the decode
        # rejected or corrected would be a wrong kernel result on its rows
        flagged = [(i, o.n_rejected, o.n_corrected) for i, o in enumerate(eng._obs)
                   if o.n_rejected or o.n_corrected]
        if flagged or eng._session.hybrid_state.escalated:
            raise AssertionError(f"[{tag}] fault-free stream: (replay, rejected, corrected) "
                                 f"{flagged}, escalated {eng._session.hybrid_state.escalated}")
        summary = rep.summary()
        sizes = collections.Counter(r.replay for r in rep.requests)
        batches = dict(sorted(collections.Counter(sizes.values()).items()))
        log(f"[{tag}] every request done, every y exact; no responder rejected or corrected in "
            f"{len(eng._obs)} replays, hybrid decode never escalated; replays by batch size "
            f"{batches}; " + json.dumps(summary))
        log(f"[{tag}] launches per replay {{{deep}: 1, {variant}_skinny: 4}} over "
            f"{rep.replays} replays; by shape {json.dumps({n: {str(sh): c for sh, c in v.items()} for n, v in shapes.items()})}")
        split["per_replay_wall_ms"] = round(split["wall_ms"] / rep.replays, 3)
        log(f"[serve time] {tag}: " + json.dumps(split))
        results[tag] = {"summary": summary, "split": split, "replays": rep.replays,
                        "counts": shapes, "variant": variant, "plan": eng._session.plan}
        del eng, rep, box
        # the plan's device constants (a few KiB, cached on the plan) may
        # stay; an operand stack or a session's tensors would be >= 10 MiB
        left = torch.cuda.memory_allocated()
        log(f"[{tag}] allocated before the run {held} bytes, after it {left}")
        if left - held > 1 << 20:
            raise AssertionError(f"[{tag}] {left - held} bytes still allocated after the run")
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] peak allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    serve_escalation(torch, K, serve, runtime, constructions, layers, gf, w, args)
    serve_reduced(torch, serve, runtime, constructions, args)
    return {"runs": results, "peak": peak}


def serve_escalation(torch, K, serve, runtime, constructions, layers, gf, w, args) -> None:
    """The scenario of the reference's test_engine_hybrid_escalates_and_corrects
    at full width: a persistently corrupt fastest worker; the first replay
    rejects it on the detect path, later replays BW-correct it."""
    import dataclasses

    import numpy as np

    cfg = constructions.PlanConfig("age", 2, 2, 2)
    pool = cfg.n_workers + 6
    trace = runtime.sample_trace(pool, runtime.Deterministic(1.0), seed=2)
    trace = dataclasses.replace(trace, uplink_delay=0.1 + 0.01 * np.arange(pool))
    trace = trace.with_faults(corrupt_ids=[0])
    eng = serve.ServingEngine(w, [trace], cfg, seed=args.seed, decode_mode="hybrid",
                              verify_extras=2)
    rng = np.random.default_rng(args.seed + 7)
    xs = [rng.normal(size=(512, w.shape[0])) for _ in range(3)]
    for i, x in enumerate(xs):
        eng.submit(x, 8.0 * i)
    t0 = time.perf_counter()
    rep = eng.run()
    secs = time.perf_counter() - t0
    cache: dict = {}
    for r, x in zip(rep.requests, xs):
        y, _ = serve_oracle(torch, np, layers, gf, w, x, cache)
        if r.state != "done" or not np.array_equal(r.y, y):
            raise AssertionError(f"[serve escalation] request {r.rid} wrong")
    corrected = [o.n_corrected for o in eng._obs]
    if not (eng._session.hybrid_state.escalated and corrected[0] == 0 and any(corrected[1:])):
        raise AssertionError(f"[serve escalation] corrected per replay {corrected}")
    log(f"[serve escalation] pool {pool}, worker 0 corrupt and fastest: every y exact; "
        f"corrected per replay {corrected} (detect first, then BW); {rep.replays} replays "
        f"in {secs:.2f} s; " + json.dumps(rep.summary()))


def serve_reduced(torch, serve, runtime, constructions, args) -> None:
    """The [serve] stream at k = 256, rows 32, out 64 on the card and on
    the CPU, on both kernel backends, and once over an elastic pool that
    shrinks from 21 to 19 workers (a reconfiguration barrier): equal
    summaries, requests and y."""
    import numpy as np

    cfg, traces, w, xs, arrivals = serve_stream(np, runtime, constructions, args.seed, 256, 32, 64)
    master = traces[0]
    elastic = runtime.ElasticPool(
        master, (tuple(range(21)),) * 3 + (tuple(range(19)),) * (SERVE_REQUESTS - 3))
    cases = {"continuous auto": (traces, "continuous", "auto"),
             "boundary auto": (traces, "boundary", "auto"),
             "continuous cuda": (traces, "continuous", "cuda"),
             "elastic 21 -> 19": (elastic, "continuous", "auto")}
    for name, (source, mode, backend) in cases.items():
        outcome = {}
        for dev in (None, "cpu"):
            eng = serve.ServingEngine(w, source, cfg, seed=args.seed, mode=mode, pipe_depth=2,
                                      max_batch=SERVE_MAX_BATCH, slo=30.0, decode_mode="hybrid",
                                      backend=backend, validate=True, device=dev)
            for x, t in zip(xs, arrivals):
                eng.submit(x, float(t))
            rep = eng.run()
            if eng._session.device != eng.device:
                raise AssertionError(f"[serve reduced] {name}: the session left the device")
            outcome[dev] = (rep.summary(), [request_record(r) for r in rep.requests],
                            [r.y for r in rep.requests])
        card, cpu = outcome[None], outcome["cpu"]
        if card[:2] != cpu[:2] or not all(
                (a is None and b is None) or np.array_equal(a, b) for a, b in zip(card[2], cpu[2])):
            raise AssertionError(f"[serve reduced] {name}: card and CPU differ")
        log(f"[serve reduced] {name}: card == CPU; " + json.dumps(card[0]))


def serve_sites(plan, batch: int) -> dict:
    """Launch sites of one serving replay of ``batch`` requests: those of
    ``run_batch_over_pool`` (B) on the engine's plan, named S."""
    return {"S" + name[1:]: shapes for name, shapes in edge_sites(plan, batch).items()
            if name.startswith("B")}


def serve_entries(torch, K, ref, protocol, ops, serve_run: dict, args) -> list:
    """The serving replays' launch sites for the ``kernels`` line: each
    site of a one-request replay, timed, with its launches over the
    [serve] runs of its variant; every other shape those runs launched
    (a replay of several requests) held exact against the plain version
    too.  A launch at a shape no serving site has fails."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 9)
    entries = []
    for variant in ("int32", "f32"):
        runs = [r for r in serve_run["runs"].values() if r["variant"] == variant]
        plan = runs[0]["plan"]
        counts: dict = {}
        for run in runs:
            for compiled, shapes in run["counts"].items():
                for shape, n in shapes.items():
                    counts[(compiled, shape)] = counts.get((compiled, shape), 0) + n
        sites = {}  # (compiled, shape) -> (batch, site, a shape, b shape)
        for batch in range(SERVE_MAX_BATCH, 0, -1):
            for site, (sa, sb) in serve_sites(plan, batch).items():
                shape = geometry(sa, sb)
                compiled = f"{variant}_{K.choose_design(variant, False, *shape)}"
                sites[(compiled, shape)] = (batch, site, sa, sb)
        stray = sorted(set(counts) - set(sites))
        if stray:
            raise AssertionError(f"[serve] {variant} launches at no serving site: {stray}")
        for key, (batch, site, sa, sb) in sites.items():
            if batch == 1:
                if counts.get(key, 0) < 1:
                    raise AssertionError(f"{key[0]} never launched at serving site {site} {key[1]}")
                entries.append(measure_site(torch, K, ref, gen, f"modmatmul_{variant}", variant,
                                            False, site, sa, sb, plan.scheme.z, counts[key], args,
                                            blocks=(protocol, ops, plan)))
            elif key in counts:
                if blocks_share(protocol, ops, plan, site, variant):
                    check_share_site(torch, K, ref, gen, protocol, variant, plan, site, sa, sb)
                else:
                    check_site(torch, K, ref, gen, f"{key[0]} at {site} of a {batch}-request replay",
                               variant, False, sa, sb, plan.scheme.z)
                log(f"[serve sites] {key[0]} {site} {list(sa)}@{list(sb)} ({batch} requests, "
                    f"{counts[key]} launches): exact against plain")
                torch.cuda.empty_cache()
    return entries


# ----------------------------------------------------------------------
# phase 7: the CRT route
# ----------------------------------------------------------------------
CRT_PRIMES = (65521, 65519)


def phase_crt(torch, K, layers, protocol, planner, constructions, gf, ops, args) -> dict:
    """``secure_matmul_crt`` at the main path's width (a [4, 5120, 512], b
    [4, 5120, 4096], float, z = 2) on both kernel backends, fused and
    unfused: y equal to the centered lift of the float64 card oracle of
    aq_signed^T bq_signed over scale**2, and the launches twice
    run_batched's; the combined integers of ``run_batched_crt`` on the
    same plans equal the oracle mod p1*p2; one ``mod_matmul_crt`` of
    [512, 5120] @ [5120, 4096] against the same oracle."""
    import numpy as np

    batch, (k, rows, out) = args.batch, WIDTH
    pbig = CRT_PRIMES[0] * CRT_PRIMES[1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 8)
    a = torch.randn((batch, k, rows), generator=gen, device="cuda", dtype=torch.float64)
    b = torch.randn((batch, k, out), generator=gen, device="cuda", dtype=torch.float64)
    # the scale search of secure_matmul_crt, over P = p1*p2
    a_max, w_max = float(a.abs().max()) + 1e-9, float(b.abs().max()) + 1e-9
    scale = 1
    while k * (a_max * 2 * scale) * (w_max * 2 * scale) < (pbig - 1) // 2:
        scale *= 2
    aq, bq = torch.round(a * scale).to(torch.int64), torch.round(b * scale).to(torch.int64)
    # exact: every partial sum is an integer far below 2**53
    exact = torch.matmul(aq.transpose(1, 2).double(), bq.double()).to(torch.int64)
    want = torch.remainder(exact, pbig).cpu().numpy()
    signed = exact.cpu().numpy()
    y_want = torch.as_tensor(signed.astype("float64") / (scale * scale), device="cuda")
    log(f"[crt] AGE s=t=z=2 over p = {CRT_PRIMES}: a [{batch}, {k}, {rows}], b [{batch}, {k}, {out}] "
        f"(unit normals), scale {scale}; |aq^T bq| up to {int(abs(signed).max())} "
        f"(p1*p2 = {pbig})")
    # the residue plans secure_matmul_crt takes from the plan cache
    scheme = constructions.build_scheme("age", 2, 2, 2)
    shapes = planner.BlockShapes(k=k, ma=rows, mb=out, s=2, t=2)
    plans = [planner.get_plan(scheme, shapes, field=gf.Field(q), n_spare=0,
                              seed=args.seed + 17 * i) for i, q in enumerate(CRT_PRIMES)]
    # the host combine on this product's residues, timed alone
    residues = [np.remainder(want, q) for q in CRT_PRIMES]
    combines = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        combined = gf.crt_combine(residues, CRT_PRIMES)
        combines.append((time.perf_counter() - t0) * 1e3)
    if not np.array_equal(combined, want):
        raise AssertionError("[crt] crt_combine of the oracle's residues differs from it")
    comb = statistics.median(combines)
    results = {}
    for backend, variant in (("auto", "int32"), ("cuda", "f32")):
        for fused in (False, True):
            tag = f"crt {backend} {'fused' if fused else 'unfused'}"
            call = lambda: layers.secure_matmul_crt(  # noqa: E731
                a, b, s=2, t=2, z=2, primes=CRT_PRIMES, seed=args.seed, backend=backend,
                fused_masks=fused)
            K.reset_launch_counts()
            res = call()
            torch.cuda.synchronize()
            got = {n: c for n, c in K.LAUNCHES.items() if c}
            by_kernel = {n: c for n, c in K.LAUNCHES_BY_KERNEL.items() if c}
            by = (MAIN_BY_KERNEL if variant == "int32" else F32_BY_KERNEL)[fused]
            expect = ({f"modmatmul_{variant}": 4, f"modmatmul_{variant}_masked": 6} if fused
                      else {f"modmatmul_{variant}": 10})
            if got != expect or by_kernel != {n: 2 * c for n, c in by.items()}:
                raise AssertionError(f"[{tag}] launches {got} / {by_kernel}")
            if res.plan is not plans[0] or not torch.equal(res.y, y_want):
                raise AssertionError(f"[{tag}] y differs from the oracle's centered lift")
            combined, _ = protocol.run_batched_crt(plans, aq, bq, seed=args.seed + 31,
                                                   backend=backend, fused_masks=fused)
            if not np.array_equal(combined, want):
                raise AssertionError(f"[{tag}] combined integers differ from the oracle")
            wall = wall_ms(torch, call, args.reps)
            results[tag] = {"median_wall_ms": round(wall, 3), "host_combine_ms": round(comb, 3),
                            "combine_share": round(comb / wall, 4), "launches": by_kernel}
            log(f"[{tag}] combined integers and y exact; launches {by_kernel} (twice "
                f"run_batched's); " + json.dumps(results[tag]))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = ops.mod_matmul_crt(aq[0].T, bq[0], primes=CRT_PRIMES)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not (got == want[0]).all():
        raise AssertionError("[crt mod_matmul_crt] differs from the oracle")
    by_kernel = {n: c for n, c in K.LAUNCHES_BY_KERNEL.items() if c}
    log(f"[crt mod_matmul_crt] [{rows}, {k}] @ [{k}, {out}] exact mod p1*p2 in {secs * 1e3:.1f} ms "
        f"(first call); launches {by_kernel}")
    del a, b, aq, bq, exact, y_want
    torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------
# phase 8: the fuzz harness on the kernel engines
# ----------------------------------------------------------------------
FUZZ_EXAMPLES = 96


def phase_fuzz(K, fuzz, args) -> dict:
    import numpy as np

    engines = ["cuda", "cuda_int32", "crt"]
    rng = np.random.default_rng(args.seed)
    cases = [fuzz.sample_case(rng, deep_k=i % 4 == 0) for i in range(FUZZ_EXAMPLES)]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    found = fuzz.run_fuzz(examples=FUZZ_EXAMPLES, seed=args.seed, engines=engines, deep_every=4)
    secs = time.perf_counter() - t0
    if found:
        raise AssertionError("[fuzz] " + "; ".join(m.describe() for m in found[:10]))
    by_kernel = {n: c for n, c in K.LAUNCHES_BY_KERNEL.items() if c}
    log(f"[fuzz] {FUZZ_EXAMPLES} cases (seed {args.seed}) through {engines} in {secs:.1f} s: "
        f"0 mismatches against the oracle; primes {sorted({c.p for c in cases})}, modes "
        f"{sorted({c.mode for c in cases})}, layouts {sorted({c.layout for c in cases})}, "
        f"max K {max(c.k for c in cases)}; launches {by_kernel}")
    return {"cases": FUZZ_EXAMPLES, "seconds": secs, "launches": by_kernel}


# ----------------------------------------------------------------------
# phases 9, 10 and 11: the decoders and the launcher's private head
# ----------------------------------------------------------------------
# phase tag -> (arch, the prefix of its lm-head launch sites)
MODEL_PHASES = {"model": ("mistral-nemo-12b", "H"), "moe": ("deepseek-v2-lite-16b", "D"),
                "vlm": ("internvl2-26b", "V")}
# the launch sites of one lm-head replay, [4, k] @ [k, vocab] on 16
# workers (AGE s = t = 2, z = 1): Mistral's head is [5120, 131072],
# DeepSeek's [2048, 102400], InternVL2's [6144, 92672]
MODEL_SITES = {
    "model": {"H1 share A": ((16, 5), (1, 5, 5120)), "H1 share B": ((16, 5), (1, 5, 167772160)),
              "H2 multiply": ((16, 2, 2560), (16, 2560, 65536)),
              "H2 mix": ((16, 14), (14, 131072)), "H2 noise": ((16, 1), (1, 131072))},
    "moe": {"D1 share A": ((16, 5), (1, 5, 2048)), "D1 share B": ((16, 5), (1, 5, 52428800)),
            "D2 multiply": ((16, 2, 1024), (16, 1024, 51200)),
            "D2 mix": ((16, 14), (14, 102400)), "D2 noise": ((16, 1), (1, 102400))},
    "vlm": {"V1 share A": ((16, 5), (1, 5, 6144)), "V1 share B": ((16, 5), (1, 5, 142344192)),
            "V2 multiply": ((16, 2, 3072), (16, 3072, 46336)),
            "V2 mix": ((16, 14), (14, 92672)), "V2 noise": ((16, 1), (1, 92672))},
}
# the sum of decoder_abstract's leaves at full width: DeepSeek-V2-Lite-16B,
# and InternVL2-26B (param_count() 19,860,664,320 leaves out the norms and
# the vocabulary's padding to 92,672)
PHASE_PARAMS = {"moe": 15_706_470_400, "vlm": 19_862_722_560}
# the launcher's --private-head path at batch 4, prompt 32, gen 4: three
# lm-head replays through the ServingEngine on 16 workers
MODEL_ARGS = dict(batch=4, prompt_len=32, gen_len=4, workers=16)
# one full-width block, bfloat16 on the card against float32 on the CPU
# (the same weights): the card rounds q, k, v, the attention and MLP
# outputs and the residual sums to bfloat16 (2**-9 relative each), so
# allow 4 bfloat16 ulps of the largest output, 2**-5 * max|cpu|
MODEL_BLOCK_TOL = 2.0**-5
# DeepSeek's first MoE block, float32 on the card (TF32 off) and on the
# CPU from the same weights: the two sum in other orders, and a
# 2048-long float32 dot is within 2048 * 2**-24 ~ 1.2e-4 of its value
# relative to the sum of its |terms|; allow two such products in a row,
# 2**-12 * max|cpu|.  A bfloat16 card against a float32 CPU would route
# tokens to other experts and could not be compared.
MOE_BLOCK_TOL = 2.0**-12
# the router's probabilities on the two sides differ by those orders
# (~1e-7 relative, ~1e-9 absolute near 1/64): a token whose 6th and 7th
# probabilities are this far apart must take the same 6 experts on both
MOE_ROUTE_GAP = 1e-6
# the plain version of a launch with more outputs than this runs in
# column slices: it holds about ten int64 temporaries of the output's
# size (limb sums and Barrett steps), ~43 GB at this many elements
PLAIN_SLICE_ELEMS = 1 << 29
PLAIN_COLS = 1 << 23
# the replay check's column slices hold at most this many elements of b
# or of the output each: the plain version makes two float32 limb copies
# of its b slice and about ten int64 temporaries of its output slice,
# beside the model and the replay's own operands.  2**27 (was 2**28):
# beside InternVL2's 38 GiB trunk, 2**28's ~20 GiB of temporaries would
# take the peak to ~77 of the card's 79 GiB
REPLAY_SLICE_ELEMS = 1 << 27


def first_layer(params: dict, map_tree) -> dict:
    """Layer 0's parameters: a dense prologue layer's, else the first of
    the stack."""
    return params.get("dense_layer_0") or map_tree(lambda _, a: a[0], params["layers"])


def model_block(torch, lm, map_tree, cfg, model, prompts, tag, patches=None) -> dict:
    """Layer 0 of the model on the prompt's embeddings (after a vlm's
    ``patches``): on the card in bfloat16 and on the CPU in float32, from
    the same (bfloat16-stored) weights; raises past ``MODEL_BLOCK_TOL``.
    Returns the errors and the CPU's output (``cpu_out``)."""
    params = model.params()
    layer0 = first_layer(params, map_tree)
    tokens = torch.as_tensor(prompts, device="cuda").long()
    x = lm._embed_tokens(cfg, params, tokens, torch.bfloat16)
    if patches is not None:
        x = torch.cat([torch.as_tensor(patches, device="cuda").to(torch.bfloat16), x], dim=1)
    pos = torch.arange(x.shape[1], device="cuda").expand(x.shape[:2])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    card = lm._block_apply(cfg, layer0, x, pos)[0]
    end.record()
    end.synchronize()
    t0 = time.perf_counter()
    cpu = lm._block_apply(cfg, map_tree(lambda _, a: a.float().cpu(), layer0),
                          x.float().cpu(), pos.cpu())[0]
    cpu_s = time.perf_counter() - t0
    card = card.float().cpu()
    err = float((card - cpu).abs().max())
    top = float(cpu.abs().max())
    rel = float((card - cpu).norm() / cpu.norm())
    if not bool(torch.isfinite(card).all()) or err > MODEL_BLOCK_TOL * top:
        raise AssertionError(f"[{tag} block] max |card - cpu| {err} > {MODEL_BLOCK_TOL} * {top}")
    log(f"[{tag} block] layer 0 on {tuple(x.shape)}: card (bfloat16) {start.elapsed_time(end):.3f} "
        f"ms, CPU (float32) {cpu_s:.2f} s; max |card - cpu| {err:.4e} <= {MODEL_BLOCK_TOL} * "
        f"max |cpu| {top:.4e}; relative Frobenius {rel:.3e}")
    return {"max_abs_err": err, "max_abs": top, "rel_fro": rel, "cpu_out": cpu}


def moe_block(torch, lm, ffn, map_tree, cfg, model, x, tag) -> dict:
    """The first MoE layer (layer 1) on x [B, T, d] float32 (layer 0's
    CPU output): on the card and on the CPU, both in float32 from the
    same bfloat16-stored weights, TF32 off.  Raises unless every token
    whose 6th and 7th router probabilities (the CPU's) are more than
    ``MOE_ROUTE_GAP`` apart takes the same experts on both sides, and the
    outputs of the dispatch groups whose tokens all agree are within
    ``MOE_BLOCK_TOL``.  Returns the counts and errors."""
    layer1 = map_tree(lambda _, a: a[0].float(), model.params()["layers"])
    pos = torch.arange(x.shape[1]).expand(x.shape[:2])
    routes, route = [], ffn.route

    def recording(logits, k):
        out = route(logits, k)
        routes.append((out[0].cpu(), out[2].cpu()))
        return out

    ffn.route = recording
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        card = lm._block_apply(cfg, layer1, x.cuda(), pos.cuda())[0].cpu()
        card_s = time.perf_counter() - t0
        cpu = lm._block_apply(cfg, map_tree(lambda _, a: a.cpu(), layer1), x.cpu(), pos)[0]
    finally:
        ffn.route = route
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (p_card, e_card), (p_cpu, e_cpu) = routes
    k = cfg.moe.num_experts_per_tok
    top = torch.sort(p_cpu, dim=-1, descending=True).values
    clear = (top[..., k - 1] - top[..., k]) > MOE_ROUTE_GAP  # [g, ng]
    same = (e_card.sort(-1).values == e_cpu.sort(-1).values).all(-1)
    if not bool(same[clear].all()):
        raise AssertionError(f"[{tag} block] {int((~same & clear).sum())} tokens outside the "
                             f"gap {MOE_ROUTE_GAP} take other experts on the card")
    g, ng = same.shape
    groups = same.all(-1)  # [g]: outputs of a group hang on all its routes
    rows = groups.repeat_interleave(ng)
    diff = (card - cpu).reshape(g * ng, -1)[rows]
    err = float(diff.abs().max()) if bool(rows.any()) else float("nan")
    mag = float(cpu.abs().max())
    if not bool(torch.isfinite(card).all()) or not groups.any() or err > MOE_BLOCK_TOL * mag:
        raise AssertionError(f"[{tag} block] layer 1: max |card - cpu| {err} > {MOE_BLOCK_TOL} * "
                             f"{mag} over {int(groups.sum())} of {g} groups")
    p_err = float((p_card - p_cpu).abs().max())
    log(f"[{tag} block] layer 1 (MLA + MoE) on {tuple(x.shape)}, float32 on both sides, TF32 "
        f"off: {g} dispatch groups of {ng}; top-{k} expert sets equal for {int(same.sum())} of "
        f"{same.numel()} tokens, {int((~clear).sum())} tokens inside the gap {MOE_ROUTE_GAP} "
        f"(probability {k} less probability {k + 1}), max |p_card - p_cpu| {p_err:.3e}; max "
        f"|card - cpu| {err:.4e} <= {MOE_BLOCK_TOL} * max |cpu| {mag:.4e} over "
        f"{int(groups.sum())} groups; card "
        f"{card_s:.3f} s (host clock, to the output's copy back)")
    return {"max_abs_err": err, "max_abs": mag, "tokens": same.numel(),
            "same_routes": int(same.sum()), "in_gap": int((~clear).sum()), "max_prob_err": p_err}


def phase_model(torch, K, ref, ops, serve, layers, gf, protocol, scheduler, args,
                tag="model") -> dict:
    """``MODEL_PHASES[tag]``'s model at full width and depth on the card
    (random weights from ``--seed``), and the launcher's private-head
    decode over it: prefill, then each step's trunk on the card and its
    lm-head matmul replayed under CMPC by the ServingEngine on ``auto``.
    A vlm's prefill puts ``frontend_len`` patch embeddings (normals from
    ``--seed``) before the prompt, and its decode positions start after
    both.  Frees the model before it returns."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import build_model, ffn, lm
    from repro_torch.models.common import count_params, map_tree

    arch, prefix = MODEL_PHASES[tag]
    cfg = get_config(arch)
    ns = argparse.Namespace(**MODEL_ARGS)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if {n_params} != {count_params(lm.decoder_abstract(cfg)), PHASE_PARAMS.get(tag, n_params)}:
        raise AssertionError(f"[{tag}] {n_params} parameters")
    attn = (f"MLA (kv_lora {cfg.mla.kv_lora_rank}, rope {cfg.mla.qk_rope_head_dim}, nope "
            f"{cfg.mla.qk_nope_head_dim}, v {cfg.mla.v_head_dim})" if cfg.mla
            else f"{cfg.resolved_head_dim}-wide heads ({cfg.num_kv_heads} KV)")
    ff = (f"{cfg.moe.num_experts} experts top-{cfg.moe.num_experts_per_tok} + "
          f"{cfg.moe.num_shared_experts} shared, d_ff_expert {cfg.moe.d_ff_expert}, dense "
          f"layers {list(cfg.moe.dense_layers)} d_ff {cfg.moe.d_ff_dense}" if cfg.moe
          else f"d_ff {cfg.d_ff}")
    log(f"[{tag}] {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads, "
        f"{attn}, {ff}, vocab {cfg.vocab_size}: {n_params} parameters (param_count "
        f"{cfg.param_count()}), random from seed {args.seed}, trunk and embed in "
        f"{cfg.compute_dtype}, lm_head float32: {torch.cuda.memory_allocated() - before} bytes "
        f"({before} allocated before); init {init_s:.2f} s")

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (ns.batch, ns.prompt_len)).astype(np.int32)
    batch, patches = {"tokens": prompts}, None
    if cfg.family == "vlm":
        patches = np.random.default_rng(args.seed).normal(
            size=(ns.batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        batch["patches"] = patches
        # the decode positions follow the patches and the prompt
        ns.prompt_len += cfg.frontend_len
        log(f"[{tag}] prefill of {cfg.frontend_len} patch embeddings (normals from seed "
            f"{args.seed}) then {len(prompts[0])} tokens; decode positions from {ns.prompt_len}")
    max_len = ns.prompt_len + ns.gen_len
    # warm-up prefill; on an MoE model it also counts the capacity drops
    drops, dispatch = [], ffn.dispatch

    def counting(eidx, e, cap):
        out = dispatch(eidx, e, cap)
        drops.append((int(out[2].numel()), int((~out[2]).sum())))
        return out

    ffn.dispatch = counting
    try:
        model.prefill(batch, model.init_cache(ns.batch, max_len))
    finally:
        ffn.dispatch = dispatch
    cache = model.init_cache(ns.batch, max_len)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logits, cache = model.prefill(batch, cache)
    end.record()
    end.synchronize()
    prefill_ms = start.elapsed_time(end)
    if tuple(logits.shape) != (ns.batch, 1, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"[{tag}] prefill logits {tuple(logits.shape)} not finite")
    tok = launcher.argmax_last(logits, cfg.vocab_size)
    dropped = None
    if cfg.moe:
        pairs, lost = sum(n for n, _ in drops), sum(d for _, d in drops)
        g, ng, cap = ffn.dispatch_shape(cfg, ns.batch * ns.prompt_len)
        dropped = {"pairs": pairs, "dropped": lost, "layers": len(drops), "groups": g,
                   "tokens_per_group": ng, "capacity": cap}
        log(f"[{tag}] prefill capacity drops: {lost} of {pairs} (token, expert) pairs "
            f"({lost / pairs:.4f}) over {len(drops)} MoE layers; {g} dispatch groups of {ng} "
            f"tokens, capacity {cap} per expert and group")
    block = model_block(torch, lm, map_tree, cfg, model, prompts, tag, patches)
    x1 = block.pop("cpu_out")
    if cfg.moe:
        block = {"layer0": block,
                 "layer1": moe_block(torch, lm, ffn, map_tree, cfg, model, x1, tag)}
    del x1

    # the launcher's private-head path; each trunk step timed with CUDA
    # events, each engine run split as [serve time] splits it; the first
    # replay's own kernel launches kept and, after its run, held against
    # the plain version (model_replay_check)
    trunk_ms, splits, engines, captured = [], [], [], []
    replay_check = {"launches": [], "seconds": 0.0, "peak": 0}
    modules = {"protocol": protocol, "scheduler": scheduler}
    hidden_step, engine_run = model.hidden_step, serve.ServingEngine.run
    launch = ops.modmatmul_cuda

    def capturing(a, b, p, variant):
        out = launch(a, b, p, variant)
        if len(engines) == 1:
            captured.append((a, b, out, variant))
        return out

    def timed_step(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = hidden_step(*a, **kw)
        e1.record()
        e1.synchronize()
        trunk_ms.append(e0.elapsed_time(e1))
        return out

    def split_run(self):
        engines.append(self)
        box = {}
        splits.append(split_call(torch, modules, lambda: box.setdefault("report", engine_run(self))))
        if len(engines) == 1:
            t0 = time.perf_counter()
            replay_check["launches"] = model_replay_check(torch, ref, captured,
                                                          self._session.plan, prefix, tag)
            captured.clear()
            replay_check["seconds"] = time.perf_counter() - t0
            # the held operands raise this replay's peak; the served peak
            # is read over the later replays
            replay_check["peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        return box["report"]

    model.hidden_step = timed_step
    serve.ServingEngine.run = split_run
    ops.modmatmul_cuda = capturing
    K.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        steps, report, worst = launcher._decode_private_head(ns, cfg, model, cache, tok)
        decode_s = time.perf_counter() - t0 - replay_check["seconds"]
    finally:
        serve.ServingEngine.run = engine_run
        ops.modmatmul_cuda = launch
        del model.hidden_step
    torch.cuda.synchronize()
    by_kernel = {n: c for n, c in K.LAUNCHES_BY_KERNEL.items() if c}
    shapes = launched_shapes(K)
    peak = torch.cuda.max_memory_allocated()
    eng = engines[0]
    summary = report.summary()
    if (steps != ns.gen_len - 1 or summary["served"] != steps or summary["shed"]
            or any(r.state != "done" for r in report.requests)):
        raise AssertionError(f"[{tag}] {steps} steps: {summary}")
    sites = model_sites(eng._session.plan, prefix)
    if sites != MODEL_SITES[tag]:
        raise AssertionError(f"[{tag}] lm-head sites {sites}, expected {MODEL_SITES[tag]}")
    want = {n: {sh: c * summary["replays"] for sh, c in v.items()}
            for n, v in expected_shapes(K, sites, sites, "int32").items()}
    if shapes != want:
        raise AssertionError(f"[{tag}] launches {shapes} over {summary['replays']} replays, "
                             f"expected {want}")

    # each replay's field values against a float64 product of the encoded
    # operands on the card; each logit within its quantisation bound.  At
    # k = 5120, 2048 and 6144 the encoded head is (nearly) all zero (ROADMAP C8), so
    # both checks compare zeros here; model_replay_check holds the kernels
    # on the replay's own (non-zero) operands
    field = gf.Field(P)
    k, vocab = eng.w.shape
    w_max = float(np.abs(eng.w).max() + 1e-9)
    cards, errors, bounds, scales, nonzero, x_max = {}, [], [], [], {}, []
    for r, rep in zip(report.requests, eng._session._replays):
        x_max.append(float(np.abs(r.x).max()))
        s = layers.choose_scales(k, x_max[-1] + 1e-9, w_max, P)
        scales.append(s)
        if s not in cards:
            wq = eng._wq_cache[s]
            nonzero[s] = float(np.count_nonzero(wq)) / wq.size
            cards[s] = torch.from_numpy(wq).to("cuda").double()
        aq = torch.as_tensor(field.encode(r.x, s), device="cuda").double()
        want = torch.remainder(aq @ cards[s], P).to(torch.int64).cpu().numpy()
        if rep.y.shape != (1,) + want.shape or not np.array_equal(rep.y[0], want):
            raise AssertionError(f"[{tag}] replay {rep.index}: field values differ from the "
                                 "card's float64 product")
        x = r.x[: ns.batch]
        errors.append(float(np.abs(r.y[: ns.batch, :vocab] - x @ eng.w).max()))
        bounds.append(launcher.head_error_bound(x, eng.w, s))
        if errors[-1] > bounds[-1]:
            raise AssertionError(f"[{tag}] replay {rep.index}: |logit - x W| {errors[-1]} > "
                                 f"bound {bounds[-1]}")
    if worst != max(errors):
        raise AssertionError(f"[{tag}] the launcher's worst {worst} != {max(errors)}")
    del cards
    log(f"[{tag}] prefill {prefill_ms:.3f} ms ({ns.batch} x {ns.prompt_len} positions); trunk "
        f"per decode step {[round(t, 3) for t in trunk_ms]} ms; {steps} steps in "
        f"{decode_s:.2f} s (without the {replay_check['seconds']:.2f} s of the replay check)")
    for rec in replay_check["launches"]:
        slices = f" in column slices of {rec['plain_cols']}" if rec["plain_cols"] else ""
        log(f"[{tag} replay 0] {rec['site']:12s} {rec['shape']:44s} exact against plain"
            f"{slices}; non-zero a {rec['nonzero_a']:.4f}, b {rec['nonzero_b']:.4f}, out "
            f"{rec['nonzero_out']:.6f}")
    log(f"[{tag}] private head [{k}, {vocab}] on {ns.workers} workers (PlanConfig() = AGE "
        f"s=t=2, z=1; n_total {eng._session.plan.n_total}): every step served, none shed; each "
        f"replay's field values exact against the card's float64 product; max |x| "
        f"{[round(v, 4) for v in x_max]}, max |W| {w_max:.4f}, scales {scales}, encoded head "
        f"non-zero {nonzero}; max |logit - x W| {[f'{e:.4e}' for e in errors]} <= bound "
        f"{[f'{b:.4e}' for b in bounds]}; launcher's worst {worst:.4e}; " + json.dumps(summary))
    for i, split in enumerate(splits):
        log(f"[{tag} time] replay {i}: " + json.dumps(split))
    log(f"[{tag}] launches by compiled kernel {by_kernel}; by shape "
        f"{json.dumps({n: {str(sh): c for sh, c in v.items()} for n, v in shapes.items()})}; "
        f"peak allocated {peak} bytes ({peak / 2**30:.2f} GiB) over the trunk steps and "
        f"replays 1-{len(splits) - 1}; {replay_check['peak']} bytes "
        f"({replay_check['peak'] / 2**30:.2f} GiB) through the prefill, replay 0 and its check "
        "(replay 0's operands held); the allocator freed its cache and retried "
        f"{torch.cuda.memory_stats().get('num_alloc_retries', 0) - retries} times in the phase")
    plan = eng._session.plan
    del model, hidden_step, engines, eng, report, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"plan": plan, "prefix": prefix, "counts": shapes, "summary": summary,
            "splits": splits, "prefill_ms": prefill_ms, "trunk_ms": trunk_ms, "init_s": init_s,
            "peak": peak, "block": block, "errors": errors, "bounds": bounds,
            "dropped": dropped, "replay_check": replay_check["launches"]}


def model_replay_check(torch, ref, captured: list, plan, prefix: str, tag: str) -> list:
    """The first lm-head replay's own launches (a, b, out, variant), each
    held against the plain version on its own operands, in column slices
    of at most ``REPLAY_SLICE_ELEMS`` elements of b or out.  The encoded
    head is zero at k = 5120, 2048 and 6144 (ROADMAP C8), but every share
    carries the z = 1 random noise, so these operands are not, and
    neither are the outputs of every site but the mix (H2, D2): a kernel
    that returned zeros, or wrong values, fails here where the decoded
    field values would still be exact.  Raises unless each site launched
    once, agreed exactly, had operands other than zero and an output
    (the mix: a b) at least half non-zero.  Returns a record per site."""
    names = {geometry(sa, sb): site for site, (sa, sb) in model_sites(plan, prefix).items()}
    shapes = [geometry(tuple(a.shape), tuple(b.shape)) for a, b, _, _ in captured]
    if sorted(shapes) != sorted(names):
        raise AssertionError(f"[{tag} replay 0] launches at {shapes}, expected {sorted(names)}")
    records = []
    for (a, b, out, variant), shape in zip(captured, shapes):
        n = shape[-1]
        cols = max(1, REPLAY_SLICE_ELEMS * n // max(b.numel(), out.numel()))
        err = plain_error(torch, ref, variant, a, b, out, cols)
        cols = cols if cols < n else 0
        frac = {f"nonzero_{k}": float(torch.count_nonzero(x)) / x.numel()
                for k, x in (("a", a), ("b", b), ("out", out))}
        site = names[shape]
        # the mix keeps only the coefficients of the workers' products
        # that carry A W: zero while the head encodes to zero; its b, the
        # products themselves, must not be
        live = frac["nonzero_b"] if site.endswith("2 mix") else frac["nonzero_out"]
        if err or not frac["nonzero_a"] or not frac["nonzero_b"] or live < 0.5:
            raise AssertionError(f"[{tag} replay 0] {site}: max abs error {err} against "
                                 f"plain, {frac}")
        records.append({"site": site, "shape": f"{list(a.shape)}@{list(b.shape)}",
                        "max_abs_err": err, "plain_cols": cols, **frac})
    torch.cuda.synchronize()
    return records


def model_sites(plan, prefix: str) -> dict:
    """Launch sites of one lm-head replay (one request): those of
    ``run_batch_over_pool`` (B) at batch 1 on the head engine's plan,
    named with ``prefix`` (H: Mistral-NeMo-12B, D: DeepSeek-V2-Lite)."""
    return {prefix + name[1:]: shapes for name, shapes in edge_sites(plan, 1).items()
            if name.startswith("B")}


def model_entries(torch, K, ref, protocol, ops, model_run: dict, args) -> list:
    """The lm-head replays' launch sites for the ``kernels`` line (the
    ``[model]`` / ``[moe]`` phase asserted their launches shape by
    shape), each timed and held against its plain version, in column
    slices where the output has more than ``PLAIN_SLICE_ELEMS`` elements."""
    plan, counts = model_run["plan"], model_run["counts"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 10)
    entries = []
    for site, (sa, sb) in model_sites(plan, model_run["prefix"]).items():
        b_, m_, _, n_ = shape = geometry(sa, sb)
        compiled = f"int32_{K.choose_design('int32', False, *shape)}"
        cols = PLAIN_COLS if b_ * m_ * n_ > PLAIN_SLICE_ELEMS else 0
        entries.append(measure_site(torch, K, ref, gen, "modmatmul_int32", "int32", False, site,
                                    sa, sb, plan.scheme.z, counts[compiled][shape], args,
                                    plain_cols=cols, blocks=(protocol, ops, plan)))
    return entries


# ----------------------------------------------------------------------
# phase 12: the encoder-decoder through the launcher's plain decode
# ----------------------------------------------------------------------
ENCDEC_ARCH = "seamless-m4t-large-v2"
# the launcher at batch 4 on 4096 frames (cfg.frontend_len) and 8 tokens:
# max_len 4104, whose largest divisor <= 1024 is 684, so the decoder's
# self- and cross-attention loop over 6 key chunks
ENCDEC_ARGS = dict(batch=4, prompt_len=4096, gen_len=8)
# the reference launcher's refusal of --private-head for a model without
# a split lm head (src/repro/launch/serve.py)
ENCDEC_REFUSAL = ("--private-head needs a decoder family with a split lm head; family 'encdec' "
                  "does not expose one")


def _launcher_argv(arch, batch, prompt_len, gen_len, *extra) -> list:
    return ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt_len),
            "--gen-len", str(gen_len), *extra]


def encdec_blocks(torch, lm, map_tree, cfg, model, frames, prompts, max_len) -> dict:
    """Encoder layer 0 on the launcher's frames (not causal), then decoder
    block 0 on the prompt's first 8 token embeddings with its
    cross-attention over encoder layer 0's CPU output as the cache holds
    an encoder output (bfloat16, zero-padded to ``max_len``, keys past
    ``enc_len`` masked): each on the card in bfloat16 and on the CPU in
    float32 from the same bfloat16 weights and inputs, within
    ``MODEL_BLOCK_TOL`` of the largest output."""
    params = model.params()
    enc0 = map_tree(lambda _, a: a[0], params["enc_layers"])
    dec0 = map_tree(lambda _, a: a[0], params["dec_layers"])
    to_cpu = lambda tree: map_tree(lambda _, a: a.float().cpu(), tree)  # noqa: E731
    x = torch.as_tensor(frames, device="cuda").to(torch.bfloat16)
    pos = torch.arange(x.shape[1], device="cuda").expand(x.shape[:2])
    out = {}

    def check(name, what, card_fn, cpu_fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        card = card_fn()
        end.record()
        end.synchronize()
        t0 = time.perf_counter()
        cpu = cpu_fn()
        cpu_s = time.perf_counter() - t0
        card = card.float().cpu()
        err = float((card - cpu).abs().max())
        top = float(cpu.abs().max())
        rel = float((card - cpu).norm() / cpu.norm())
        if not bool(torch.isfinite(card).all()) or err > MODEL_BLOCK_TOL * top:
            raise AssertionError(f"[encdec block] {what}: max |card - cpu| {err} > "
                                 f"{MODEL_BLOCK_TOL} * {top}")
        log(f"[encdec block] {what}: card (bfloat16) {start.elapsed_time(end):.3f} ms, CPU "
            f"(float32) {cpu_s:.2f} s; max |card - cpu| {err:.4e} <= {MODEL_BLOCK_TOL} * max "
            f"|cpu| {top:.4e}; relative Frobenius {rel:.3e}")
        out[name] = {"max_abs_err": err, "max_abs": top, "rel_fro": rel}
        return cpu

    enc_cpu = check("encoder", f"encoder layer 0 on {tuple(x.shape)}, not causal",
                    lambda: lm._enc_block_apply(cfg, enc0, x, pos),
                    lambda: lm._enc_block_apply(cfg, to_cpu(enc0), x.float().cpu(), pos.cpu()))
    te = enc_cpu.shape[1]
    enc_buf = torch.nn.functional.pad(enc_cpu, (0, 0, 0, max_len - te)).to(torch.bfloat16)
    valid = torch.arange(max_len) < te
    tokens = torch.as_tensor(prompts[:, :8], device="cuda").long()
    y = lm._embed_tokens(cfg, params, tokens, torch.bfloat16)
    ypos = torch.arange(y.shape[1], device="cuda").expand(y.shape[:2])
    check("decoder", f"decoder block 0 on {tuple(y.shape)}, cross-attention over "
          f"{tuple(enc_buf.shape)} with enc_len {te}",
          lambda: lm._dec_block_apply(cfg, dec0, y, ypos, enc_buf.cuda(), None, valid.cuda())[0],
          lambda: lm._dec_block_apply(cfg, to_cpu(dec0), y.float().cpu(), ypos.cpu(),
                                      enc_buf.float(), None, valid)[0])
    return out


def launch_in_process(torch, launcher, argv, tag):
    """``launcher.main(argv)`` in process on the card, its printed lines
    logged as ``[{tag} launcher]``: (the model it built, its printed
    text, (shape, finite) of the logits of every step, wall seconds with
    the weights' draw, peak allocated bytes since the call)."""
    import contextlib
    import io

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    built, logits_seen = [], []
    build, argmax = launcher.build_model, launcher.argmax_last

    def keeping(c, **kw):
        built.append(build(c, **kw))
        return built[-1]

    def checking(logits, vocab):
        logits_seen.append((tuple(logits.shape), bool(torch.isfinite(logits).all())))
        return argmax(logits, vocab)

    launcher.build_model, launcher.argmax_last = keeping, checking
    printed = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            launcher.main(argv)
        wall_s = time.perf_counter() - t0
    finally:
        launcher.build_model, launcher.argmax_last = build, argmax
    peak = torch.cuda.max_memory_allocated()
    text = printed.getvalue()
    for line in text.splitlines():
        log(f"[{tag} launcher] {line}")
    return built[0], text, logits_seen, wall_s, peak


def launcher_lines(text, arch, batch, prompt_len, tag):
    """The launcher's prefill and decode ms from its printed lines;
    raises unless it served ``arch`` on the card at this batch and
    prompt length."""
    pre = re.search(r"prefill: ([0-9.]+) ms for (\d+) x (\d+) tokens", text)
    dec = re.search(r"decode : ([0-9.]+) ms/step \(batch (\d+)\)", text)
    if (not pre or not dec or f"serving {arch} on cuda" not in text
            or (int(pre[2]), int(pre[3]), int(dec[2])) != (prompt_len, batch, batch)):
        raise AssertionError(f"[{tag}] the launcher printed {text!r}")
    return float(pre[1]), float(dec[1])


def cuda_timed(torch, fn):
    """(fn(), its CUDA-event ms)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def refused_private_head(launcher, arch, want, tag) -> None:
    """The launcher refuses ``--private-head`` on the reduced ``arch``
    (on the card, after its prefill) with the message ``want``."""
    import contextlib
    import io

    try:
        with contextlib.redirect_stdout(io.StringIO()):
            launcher.main(_launcher_argv(arch, 2, 16, 2, "--reduced", "--private-head"))
    except SystemExit as refused:
        if str(refused) != want:
            raise AssertionError(f"[{tag}] --private-head refused with {refused!r}") from None
    else:
        raise AssertionError(f"[{tag}] --private-head was not refused")
    log(f"[{tag}] --private-head refused as the reference refuses it: {want!r}")


def phase_encdec(torch, args) -> dict:
    """SeamlessM4T-Large-v2 at full width and depth on the card through
    ``launch.serve.main`` in process (``ENCDEC_ARGS``; weights from seed
    0, the launcher's own): the prefill encodes 4096 frames and prefills
    the decoder's first token, then 7 greedy decode steps, each with
    cross-attention over the cached 4104-row encoder output.  Raises
    unless the parameters are ``encdec_abstract``'s, every step's logits
    are finite and of the padded vocabulary, and the launcher printed its
    prefill and decode lines; then the block checks (``encdec_blocks``),
    the prefill and three decode steps again, warm, timed with CUDA
    events, and the launcher's refusal of ``--private-head``.  No TPU
    kernel runs here.  Frees the model before it returns."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import lm
    from repro_torch.models.common import count_params, map_tree

    cfg = get_config(ENCDEC_ARCH)
    ea = ENCDEC_ARGS
    before = torch.cuda.memory_allocated()
    model, text, logits_seen, wall_s, peak = launch_in_process(
        torch, launcher, _launcher_argv(ENCDEC_ARCH, ea["batch"], ea["prompt_len"], ea["gen_len"]),
        "encdec")
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if n_params != count_params(lm.encdec_abstract(cfg)):
        raise AssertionError(f"[encdec] {n_params} parameters")
    want = [((ea["batch"], 1, cfg.padded_vocab), True)] * ea["gen_len"]
    if logits_seen != want:
        raise AssertionError(f"[encdec] logits (shape, finite) {logits_seen}, expected {want}")
    pre_ms, dec_ms = launcher_lines(text, ENCDEC_ARCH, ea["batch"], ea["prompt_len"], "encdec")
    log(f"[encdec] {ENCDEC_ARCH}: {cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.resolved_head_dim} "
        f"({cfg.num_kv_heads} KV), d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}): {n_params} parameters (param_count {cfg.param_count()}), random "
        f"from seed 0 (the launcher's), lm_head float32, the rest {cfg.compute_dtype}: "
        f"{n_bytes} bytes ({before} allocated before); {ea['prompt_len']} frames x batch "
        f"{ea['batch']}, {ea['gen_len'] - 1} decode steps: prefill (encode + decoder prefill) "
        f"{pre_ms} ms, decode {dec_ms} ms/step, every step's logits finite "
        f"{list(want[0][0])}; launcher wall {wall_s:.2f} s with the weights' draw; peak "
        f"allocated {peak} bytes ({peak / 2**30:.2f} GiB)")

    rng = np.random.default_rng(0)  # the launcher's draws: prompts, then frames
    prompts = rng.integers(0, cfg.vocab_size, (ea["batch"], ea["prompt_len"])).astype(np.int32)
    frames = rng.normal(size=(ea["batch"], ea["prompt_len"], cfg.d_model)).astype(np.float32)
    max_len = ea["prompt_len"] + ea["gen_len"]
    blocks = encdec_blocks(torch, lm, map_tree, cfg, model, frames, prompts, max_len)

    # warm: the launcher's prefill and three of its decode steps again on
    # the same model and draws, each timed with CUDA events
    (logits, cache), warm_prefill_ms = cuda_timed(torch, lambda: model.prefill(
        {"frames": frames, "tokens": prompts[:, :1]}, model.init_cache(ea["batch"], max_len)))
    warm_step_ms = []
    for i in range(3):
        tok = launcher.argmax_last(logits, cfg.vocab_size)
        pos = np.full((ea["batch"], 1), ea["prompt_len"] + i, np.int32)
        (logits, cache), ms = cuda_timed(torch, lambda: model.decode_step(tok[:, None], cache, pos))
        warm_step_ms.append(ms)
    log(f"[encdec] warm: prefill {warm_prefill_ms:.3f} ms, decode steps "
        f"{[round(t, 3) for t in warm_step_ms]} ms (CUDA events)")
    del model, logits, cache
    gc.collect()
    torch.cuda.empty_cache()

    # --private-head: the reference's refusal, after the prefill
    refused_private_head(launcher, ENCDEC_ARCH, ENCDEC_REFUSAL, "encdec")
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n_params, "bytes": n_bytes, "prefill_ms": pre_ms,
            "decode_ms": dec_ms, "wall_s": wall_s, "peak": peak, "blocks": blocks,
            "warm_prefill_ms": warm_prefill_ms, "warm_step_ms": warm_step_ms}


# ----------------------------------------------------------------------
# phases 13 and 14: the recurrent families
# ----------------------------------------------------------------------
# tag: (arch, parameters, stored bytes, block-check length).  The sums of
# xlstm_abstract's and zamba_abstract's leaves at full width (xLSTM's
# config gives mLSTM full d_in x d_in q/k/v projections, d_in 4096, so
# 4.34 B where the name says 1.3); the bytes under lm.stored_infos:
# lm_head and the float32-cast leaves (sLSTM w_gates / r_gates, ...) in
# float32, the rest in bfloat16.  The block checks run over at least two
# chunks: 128 tokens are 2 mLSTM chunks of 64, 256 are 2 Mamba2 chunks
# of 128
RECURRENT_PHASES = {"xlstm": ("xlstm-1.3b", 4_335_536_464, 10_491_204_928, 128),
                    "zamba": ("zamba2-2.7b", 2_425_619_360, 5_015_096_000, 256)}
# the launcher at batch 4: 256 prompt tokens span 4 mLSTM chunks of 64
# and 2 Mamba2 chunks of 128, so the carried chunk state is used
RECURRENT_ARGS = dict(batch=4, prompt_len=256, gen_len=8)
# the normals (times this scale, from this seed) that replace every
# zero-initialised leaf of a checked block: b_if, b_gates, conv_b,
# a_log, dt_bias, the LoRA b_q
BLOCK_ZERO_SCALE = 0.5
BLOCK_SEED = 1234


def _refusal(family: str) -> str:
    """The reference launcher's refusal of --private-head for a model
    without a split lm head (src/repro/launch/serve.py)."""
    return ("--private-head needs a decoder family with a split lm head; "
            f"family {family!r} does not expose one")


def seeded_zero_leaves(torch, block: dict, infos: dict, gen, map_tree, iter_leaves) -> dict:
    """``block`` with every leaf that ``infos`` (the same names) marks
    ``init="zeros"`` replaced by seeded normals times
    ``BLOCK_ZERO_SCALE``, in its dtype and on its device: with zeros a
    fault in the term such a leaf feeds could not show."""
    kinds = {name: info.init for name, info in iter_leaves(infos)}

    def leaf(name, a):
        if kinds[name] != "zeros":
            return a
        draw = torch.randn(a.shape, generator=gen, device=a.device, dtype=torch.float32)
        return (draw * BLOCK_ZERO_SCALE).to(a.dtype)

    return map_tree(leaf, block)


def recurrent_blocks(torch, cfg, model, prompts, tag, t: int) -> dict:
    """Blocks of the model on the embeddings of the prompts' first ``t``
    tokens, each on the card in bfloat16 and on the CPU in float32 from
    the same weights (bfloat16-stored ones upcast), every zero-initialised
    leaf overwritten with seeded normals first: the output and every
    state it returns within ``MODEL_BLOCK_TOL`` of that value's largest
    |cpu|.  xLSTM: sLSTM block 0 and mLSTM block (0, 0), with their final
    states.  Zamba2: Mamba2 layer 1 with its final ``state`` and ``conv``,
    and the shared block at invocation 1 with a nonzero LoRA ``b_q``
    (which must move the output by more than the tolerance)."""
    from repro_torch.models import hybrid, lm, registry, ssm, xlstm
    from repro_torch.models.common import iter_leaves, map_tree

    params = model.params()
    infos = registry.params_abstract(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(BLOCK_SEED)
    x = lm._embed_tokens(cfg, params, torch.as_tensor(prompts[:, :t], device="cuda").long(),
                         torch.bfloat16)
    xc = x.float().cpu()
    pos = torch.arange(t, device="cuda").expand(x.shape[:2])
    to_cpu = lambda tree: map_tree(lambda _, a: a.float().cpu(), tree)  # noqa: E731
    out = {}

    def check(name, what, block, card_fn, cpu_fn):
        (card, card_state), card_ms = cuda_timed(torch, lambda: card_fn(block, x))
        t0 = time.perf_counter()
        cpu, cpu_state = cpu_fn(to_cpu(block), xc)
        cpu_s = time.perf_counter() - t0
        pairs = {"out": (card, cpu), **{k: (card_state[k], v) for k, v in (cpu_state or {}).items()}}
        errs = {}
        for key, (c, r) in pairs.items():
            c = c.float().cpu()
            err, top = float((c - r).abs().max()), float(r.abs().max())
            if not bool(torch.isfinite(c).all()) or err > MODEL_BLOCK_TOL * top:
                raise AssertionError(f"[{tag} block] {what} {key}: max |card - cpu| {err} > "
                                     f"{MODEL_BLOCK_TOL} * {top}")
            errs[key] = {"max_abs_err": err, "max_abs": top}
        rel = float((card.float().cpu() - cpu).norm() / cpu.norm())
        ratios = {k: round(e["max_abs_err"] / e["max_abs"], 6) for k, e in errs.items()}
        log(f"[{tag} block] {what} on {tuple(x.shape)}: card (bfloat16) {card_ms:.3f} ms, CPU "
            f"(float32) {cpu_s:.2f} s; max |card - cpu| / max |cpu| of each value {ratios} <= "
            f"{MODEL_BLOCK_TOL}; output relative Frobenius {rel:.3e}")
        out[name] = {**errs, "rel_fro": rel}
        return card

    def scan_block(core_scan):
        def run(block, h):
            return hybrid._block(cfg, None, core_scan, block, h, None, False, True)
        return run

    if cfg.family == "ssm":
        ps = seeded_zero_leaves(torch, map_tree(lambda _, a: a[0], params["slstm"]),
                                infos["slstm"], gen, map_tree, iter_leaves)
        check("slstm", "sLSTM block 0", ps, scan_block(xlstm.slstm_scan), scan_block(xlstm.slstm_scan))
        pm = seeded_zero_leaves(torch, map_tree(lambda _, a: a[0, 0], params["mlstm"]),
                                infos["mlstm"], gen, map_tree, iter_leaves)
        check("mlstm", f"mLSTM block (0, 0), {t // xlstm._chunk_len(cfg, t)} chunks", pm,
              scan_block(xlstm.mlstm_scan), scan_block(xlstm.mlstm_scan))
        return out
    pm = seeded_zero_leaves(torch, map_tree(lambda _, a: a[1], params["mamba"]),
                            infos["mamba"], gen, map_tree, iter_leaves)
    check("mamba", f"Mamba2 layer 1, {t // ssm._chunk_len(cfg.ssm, t)} chunks", pm,
          scan_block(ssm.mamba_scan), scan_block(ssm.mamba_scan))
    shared = {"shared": params["shared"],
              "lora": seeded_zero_leaves(torch, params["lora"], infos["lora"], gen, map_tree,
                                         iter_leaves)}

    def shared_card(block, h):
        return hybrid._shared_block(cfg, block["shared"], block["lora"], 1, h, pos, None)[0], None

    def shared_cpu(block, h):
        return hybrid._shared_block(cfg, block["shared"], block["lora"], 1, h, pos.cpu(), None)[0], None

    card = check("shared", "the shared block at invocation 1 with a nonzero LoRA b_q", shared,
                 shared_card, shared_cpu)
    bare = hybrid._shared_block(cfg, params["shared"], params["lora"], 1, x, pos, None)[0]
    moved = float((bare - card).abs().max())
    bound = MODEL_BLOCK_TOL * out["shared"]["out"]["max_abs"]
    if not moved > 2 * bound:
        raise AssertionError(f"[{tag} block] the LoRA term moved the output by {moved} only")
    log(f"[{tag} block] the LoRA term moves the shared block's output by {moved:.4e}, "
        f"> 2 * {bound:.4e}")
    out["shared"]["lora_moved"] = moved
    return out


def carried_diff(torch, model, prompts, whole, first, max_len, tag) -> dict:
    """The last logits of ``model``'s prefill over ``whole`` (the prompts
    and their first greedy token ``first``) against its prefill over the
    prompts and one decode step of ``first``: max |diff|, max |logit|,
    whether the greedy tokens agree, the prefill's CUDA-event ms."""
    import numpy as np

    b, t = prompts.shape
    logits, cache = model.prefill({"tokens": prompts}, model.init_cache(b, max_len))
    stepped, _ = model.decode_step(first[:, None], cache, np.full((b, 1), t, np.int32))
    del logits, cache
    (longer, _), ms = cuda_timed(
        torch, lambda: model.prefill({"tokens": whole}, model.init_cache(b, max_len)))
    stepped, longer = stepped.float(), longer.float()
    if not bool(torch.isfinite(longer).all() and torch.isfinite(stepped).all()):
        raise AssertionError(f"[{tag} carried] logits not finite")
    err, top = float((stepped - longer).abs().max()), float(longer.abs().max())
    same = bool((stepped[:, -1].argmax(-1) == longer[:, -1].argmax(-1)).all())
    dtype = model.cfg.compute_dtype
    log(f"[{tag} carried] {dtype}: the last logits of a prefill over {t + 1} tokens ({ms:.3f} "
        f"ms) against a prefill over {t} and one decode step: max |diff| {err:.4e}, max |logit| "
        f"{top:.4e} (ratio {err / top:.3e}, tolerance {MODEL_BLOCK_TOL} at float32); the same "
        f"greedy tokens: {same}")
    return {"max_abs_err": err, "max_abs": top, "same_tokens": same, "prefill_ms": ms}


def phase_recurrent(torch, K, tag: str) -> dict:
    """xLSTM-1.3B (``tag="xlstm"``) or Zamba2-2.7B (``"zamba"``) at full
    width and depth on the card through ``launch.serve.main`` in process
    (``RECURRENT_ARGS``, the plain greedy decode; weights from seed 0,
    the launcher's own).  Raises unless the parameters and stored bytes
    are ``RECURRENT_PHASES``'s, every step's logits are finite and of the
    padded vocabulary, and the launcher printed its prefill and decode
    lines; then the block checks (``recurrent_blocks``), the prefill and
    three decode steps again, warm, by CUDA events (each step beside its
    bound: the weights and the cache read and written once at the card's
    memory rate), the state carried on the card (``carried_diff``: in
    bfloat16 recorded; on the same weights at float32 compute the last
    logits of a prefill over the prompt and its first greedy token within
    ``MODEL_BLOCK_TOL`` of their largest of those of the prefill over the
    prompt and one decode step), and the launcher's refusal of
    ``--private-head``.  No TPU kernel runs here: the launch counters are
    the same after the phase as before.  Frees the model before it
    returns."""
    import dataclasses
    import gc
    import math

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import registry
    from repro_torch.models.common import count_params, iter_leaves, map_tree

    arch, want_params, want_bytes, block_t = RECURRENT_PHASES[tag]
    cfg = get_config(arch)
    ra = RECURRENT_ARGS
    b, t = ra["batch"], ra["prompt_len"]
    launches = (dict(K.LAUNCHES), dict(K.LAUNCHES_BY_KERNEL))
    before = torch.cuda.memory_allocated()
    model, text, logits_seen, wall_s, peak = launch_in_process(
        torch, launcher, _launcher_argv(arch, b, t, ra["gen_len"]), tag)
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if (n_params, n_bytes) != (want_params, want_bytes) or n_params != count_params(
            registry.params_abstract(cfg)):
        raise AssertionError(f"[{tag}] {n_params} parameters in {n_bytes} bytes, expected "
                             f"{want_params} in {want_bytes}")
    want = [((b, 1, cfg.padded_vocab), True)] * ra["gen_len"]
    if logits_seen != want:
        raise AssertionError(f"[{tag}] logits (shape, finite) {logits_seen}, expected {want}")
    pre_ms, dec_ms = launcher_lines(text, arch, b, t, tag)
    max_len = t + ra["gen_len"]
    cache_bytes = sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
                      for _, s in iter_leaves(registry.cache_abstract(cfg, b, max_len)))
    log(f"[{tag}] {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads, "
        f"vocab {cfg.vocab_size} (padded {cfg.padded_vocab}): {n_params} parameters, random from "
        f"seed 0 (the launcher's), lm_head and the float32-cast leaves float32, the rest "
        f"{cfg.compute_dtype}: {n_bytes} bytes ({before} allocated before); caches {cache_bytes} "
        f"bytes at batch {b}; prompt {t} x batch {b}, {ra['gen_len'] - 1} decode steps: prefill "
        f"{pre_ms} ms, decode {dec_ms} ms/step, every step's logits finite {list(want[0][0])}; "
        f"launcher wall {wall_s:.2f} s with the weights' draw; peak allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")

    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    blocks = recurrent_blocks(torch, cfg, model, prompts, tag, block_t)

    # warm: the launcher's prefill and three of its decode steps again on
    # the same model and prompts, each timed with CUDA events
    (logits, cache), warm_prefill_ms = cuda_timed(
        torch, lambda: model.prefill({"tokens": prompts}, model.init_cache(b, max_len)))
    first = launcher.argmax_last(logits, cfg.vocab_size)
    tok, steps, warm_step_ms = first, [], []
    for i in range(3):
        pos = np.full((b, 1), t + i, np.int32)
        (logits, cache), ms = cuda_timed(torch, lambda: model.decode_step(tok[:, None], cache, pos))
        steps.append(logits)
        warm_step_ms.append(ms)
        tok = launcher.argmax_last(logits, cfg.vocab_size)
    bound_ms = (n_bytes + 2 * cache_bytes) / HBM_BPS * 1e3
    log(f"[{tag}] warm: prefill {warm_prefill_ms:.3f} ms, decode steps "
        f"{[round(x, 3) for x in warm_step_ms]} ms (CUDA events) against a bound of "
        f"{bound_ms:.3f} ms ({n_bytes} weight bytes + 2 x {cache_bytes} cache bytes at "
        f"{HBM_BPS / 1e12} TB/s)")
    del cache

    # the state carried on the card: the prefill over the prompt and its
    # first greedy token against the prefill over the prompt, then one
    # decode step.  In bfloat16 the two differ by roundings that the
    # random-weight trunk amplifies through its depth (to the size of the
    # logits themselves: recorded, not held); at float32 compute (TF32
    # off) on the same weights they are held within MODEL_BLOCK_TOL
    whole = np.concatenate([prompts, first[:, None]], axis=1)
    carried = {"bfloat16": carried_diff(torch, model, prompts, whole, first, max_len, tag)}
    del logits, steps
    f32 = type(model)(dataclasses.replace(cfg, compute_dtype="float32"),
                      map_tree(lambda _, a: a.float(), model.params()))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"[{tag} carried] TF32 is on")
    carried["float32"] = carried_diff(torch, f32, prompts, whole, first, max_len, tag)
    err, top = carried["float32"]["max_abs_err"], carried["float32"]["max_abs"]
    if err > MODEL_BLOCK_TOL * top:
        raise AssertionError(f"[{tag} carried] float32: max |step - prefill| {err} > "
                             f"{MODEL_BLOCK_TOL} * {top}")
    del f32
    gc.collect()
    torch.cuda.empty_cache()

    refused_private_head(launcher, arch, _refusal(cfg.family), tag)
    if (dict(K.LAUNCHES), dict(K.LAUNCHES_BY_KERNEL)) != launches:
        raise AssertionError(f"[{tag}] a TPU kernel launched: {K.LAUNCHES}")
    log(f"[{tag}] no TPU kernel launched in this phase (the launch counters are unchanged)")
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n_params, "bytes": n_bytes, "cache_bytes": cache_bytes,
            "prefill_ms": pre_ms, "decode_ms": dec_ms, "wall_s": wall_s, "peak": peak,
            "blocks": blocks, "warm_prefill_ms": warm_prefill_ms, "warm_step_ms": warm_step_ms,
            "bound_ms": bound_ms, "carried": carried}


# ----------------------------------------------------------------------
# phase 17: training
# ----------------------------------------------------------------------
TRAIN_ARCH = "minicpm-2b"
TRAIN_LAYERS = 40
TRAIN_PARAMS = 2_725_173_504
# repro_torch.launch.train's full-width run: the reference launcher's
# defaults (4 micro-steps of 2 x 256 tokens, 2048 tokens a step), 4
# steps on the WSD schedule, no checkpoint (params and AdamW moments
# would be 32.7 GB of npz)
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", "4", "--seq-len", "256", "--global-batch", "8",
              "--microbatch-seqs", "2", "--mesh", "1x1", "--log-every", "1"]
TRAIN_TOKENS = 256 * 8
TRAIN_LR = 3e-4
# step 0's loss: near-uniform logits (tied embed init 0.02, logit_scale
# 256/2304) over the 122,753 real tokens
TRAIN_LOSS0_TOL = 0.25
# blocks card against CPU in float32 with TF32 off, of each value's
# largest |cpu| entry
TRAIN_BLOCK_TOL = 2.0**-10
TRAIN_XENT_TOKENS = 64
# the reduced MiniCPM on the card against the CPU (float32 compute)
TRAIN_REDUCED = dict(steps=6, seq_len=32, global_batch=4, microbatch_seqs=2)
TRAIN_REDUCED_RTOL = 1e-4
# the resume check's bar: the reference test's (tests/test_checkpoint.py)
TRAIN_RESUME_TOL = 1e-6
# examples/torch/train_lm.py --profile 100m: the mean of the last 5
# logged losses below the first 5 by the reference test's margin
TRAIN_LM_ARGV = ["--profile", "100m", "--steps", "200"]
TRAIN_LM_MARGIN = 0.25
TRAIN_SAMPLE = 4096  # leading entries of each leaf kept to see the update


def train_in_process(torch, launcher, argv, tag):
    """``launcher.main(argv)`` (``repro_torch.launch.train``) in process on
    the card, its printed lines logged as ``[{tag} launcher]``: (the
    model it built, a sample of each parameter as built, per step the
    metrics and the step's CUDA-event ms, the printed text, peak
    allocated bytes)."""
    import contextlib
    import io

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    built, samples, steps = [], {}, []
    build, build_step = launcher.build_model, launcher.build_train_step

    def keeping(cfg, **kw):
        built.append(build(cfg, **kw))
        for name, p in built[-1].named_parameters():
            samples[name] = p.detach().reshape(-1)[:TRAIN_SAMPLE].clone()
        return built[-1]

    class Timed:
        def __init__(self, step):
            self.step, self.opt_cfg = step, step.opt_cfg

        def __call__(self, params, opt, batch):
            out, ms = cuda_timed(torch, lambda: self.step(params, opt, batch))
            steps.append({"ms": ms, **{k: float(v) for k, v in out[2].items()}})
            return out

    launcher.build_model = keeping
    launcher.build_train_step = lambda *a, **kw: Timed(build_step(*a, **kw))
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            launcher.main(argv)
    finally:
        launcher.build_model, launcher.build_train_step = build, build_step
    peak = torch.cuda.max_memory_allocated()
    text = printed.getvalue()
    for line in text.splitlines():
        log(f"[{tag} launcher] {line}")
    return built[0], samples, steps, text, peak


def grads_close(torch, card: dict, cpu: dict, tol: float, what: str, tag: str) -> dict:
    """max |card - cpu| / max |cpu| of each value; raises past ``tol``."""
    out = {}
    for name, c in card.items():
        c, r = c.float().cpu(), cpu[name].float()
        err, top = float((c - r).abs().max()), float(r.abs().max())
        if not bool(torch.isfinite(c).all()) or err > tol * top:
            raise AssertionError(f"[{tag} block] {what} {name}: max |card - cpu| {err} > "
                                 f"{tol} * {top}")
        out[name] = err / top
    return out


def train_breakdown(torch, cfg, model, tag) -> dict:
    """One micro-step of the full-width run again (the first 2 rows of
    the data's step-0 batch), warm: the loss's forward and its backward
    by CUDA events, the CUDA kernel launches the host issued for them
    (``cudaLaunchKernel`` calls under ``torch.profiler``, which counts
    them on the host even where it loses device activities), and the
    allocator's retries over the whole phase so far."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry

    full = SyntheticLM(DataConfig(cfg.vocab_size, 256, 8)).batch(0)
    micro = {k: v[:2] for k, v in full.items()}
    params = model.params()

    def once():
        loss, _ = registry.loss(cfg, params, micro)
        loss.backward()

    once()
    (loss, _), fwd_ms = cuda_timed(torch, lambda: registry.loss(cfg, params, micro))
    _, bwd_ms = cuda_timed(torch, loss.backward)
    del loss
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        once()
        torch.cuda.synchronize()
    names = {e.key: e.count for e in prof.key_averages()}
    launches = sum(n for k, n in names.items() if k.startswith("cudaLaunchKernel"))
    aten = sum(n for k, n in names.items() if k.startswith("aten::"))
    model.zero_grad(set_to_none=True)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    log(f"[{tag} breakdown] one micro-step (2 x 256 tokens), warm: forward {fwd_ms:.3f} ms, "
        f"backward (with the remat forward) {bwd_ms:.3f} ms (CUDA events); {launches} kernel "
        f"launches and {aten} aten ops (nested ones counted) from the host for one forward "
        f"and backward; allocator retries so far {retries}")
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "launches": launches, "aten_ops": aten,
            "alloc_retries": retries}


def train_blocks(torch, cfg, model, tag) -> dict:
    """Layer 0's forward and backward over 1 x 256 tokens (the embeddings
    of the first 256 of the data's step-0 row; a fixed random cotangent),
    and ``chunked_softmax_xent`` over 64 hidden states against the full
    tied head: every gradient on the card in float32 with TF32 off
    against the CPU in float32, within ``TRAIN_BLOCK_TOL`` of each
    value's largest; layer 0 again with bfloat16 compute on the card
    (recorded, not held)."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import common, lm
    from repro_torch.models.common import map_tree

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"[{tag} block] TF32 is on")
    params = model.params()
    layer0 = map_tree(lambda _, a: a.detach()[0].clone(), params["layers"])
    tokens = SyntheticLM(DataConfig(cfg.vocab_size, 256, 8)).batch(0)["tokens"][:1]
    gen = torch.Generator(device="cpu")
    gen.manual_seed(BLOCK_SEED)
    with torch.no_grad():
        x = lm._embed_tokens(cfg, params, torch.as_tensor(tokens, device="cuda").long(),
                             torch.float32).cpu()
    cot = torch.randn(x.shape, generator=gen)
    pos = torch.arange(x.shape[1]).expand(x.shape[:2])

    def block(c, device):
        # fresh leaves on each side (``to`` returns the tensor itself on
        # its own device)
        leaves = map_tree(lambda _, a: a.detach().to(device).requires_grad_(True), layer0)
        xi = x.detach().to(device).requires_grad_(True)
        out = lm._block_apply(c, leaves, xi.to(lm.compute_dtype(c)), pos.to(device))[0]
        (out.float() * cot.to(device)).sum().backward()
        grads = {f"layers.{n}": a.grad for n, a in common.iter_leaves(leaves)}
        return {"out": out.detach(), "x": xi.grad, **grads}

    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = block(f32, "cpu")
    card, card_ms = cuda_timed(torch, lambda: block(f32, "cuda"))
    errs = grads_close(torch, card, cpu, TRAIN_BLOCK_TOL, "layer 0", tag)
    bf16 = block(dataclasses.replace(cfg, compute_dtype="bfloat16"), "cuda")
    bf16_errs = {n: float((v.float().cpu() - cpu[n]).abs().max() / cpu[n].abs().max())
                 for n, v in bf16.items()}
    log(f"[{tag} block] layer 0 forward and backward over {tuple(x.shape)}, float32, TF32 off: "
        f"card {card_ms:.3f} ms; max |card - cpu| / max |cpu| of the output, the input's and "
        f"every parameter's gradient: worst {max(errs.values()):.3e} <= {TRAIN_BLOCK_TOL} "
        f"({ {k: round(v, 9) for k, v in errs.items()} }); at bfloat16 compute (recorded): worst "
        f"{max(bf16_errs.values()):.3e}")
    del card, bf16

    head_full = params["embed"].detach()
    hidden = torch.randn((1, TRAIN_XENT_TOKENS, cfg.d_model), generator=gen)
    labels = torch.as_tensor(tokens[:, :TRAIN_XENT_TOKENS]).long()

    def xent(device):
        emb = head_full.detach().to(device).clone().requires_grad_(True)
        h = hidden.detach().to(device).requires_grad_(True)
        loss = common.chunked_softmax_xent(h, emb.T, labels.to(device),
                                           logit_scale=cfg.logit_scale, n_vocab=cfg.vocab_size)
        loss.backward()
        return {"loss": loss.detach(), "hidden": h.grad, "head": emb.grad}

    cpu_x = xent("cpu")
    card_x, xent_ms = cuda_timed(torch, lambda: xent("cuda"))
    xerrs = grads_close(torch, card_x, cpu_x, TRAIN_BLOCK_TOL, "chunked_softmax_xent", tag)
    log(f"[{tag} block] chunked_softmax_xent over {TRAIN_XENT_TOKENS} tokens against the tied "
        f"head {list(head_full.T.shape)} (padded columns masked), float32: card {xent_ms:.3f} "
        f"ms; loss {float(cpu_x['loss']):.6f}; max |card - cpu| / max |cpu| {xerrs} <= "
        f"{TRAIN_BLOCK_TOL}")
    return {"layer0": errs, "layer0_bf16": bf16_errs, "xent": xerrs}


def reduced_train(torch, tag) -> dict:
    """The reduced MiniCPM (float32 compute) on the card against the CPU
    from the same weights (drawn on the CPU, carried by ``convert``),
    ``TRAIN_REDUCED['steps']`` train steps each: the losses within
    ``TRAIN_REDUCED_RTOL`` relative.  Then the resume check on the card:
    3 steps, save, restore into a fresh model, 3 steps, against the 6
    straight, within ``TRAIN_RESUME_TOL`` (and whether bit-exact)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import configs, convert
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.common import iter_leaves, map_tree
    from repro_torch.train.optimizer import adamw_init

    r = TRAIN_REDUCED
    cfg = dataclasses.replace(configs.reduced(configs.get_config(TRAIN_ARCH)),
                              compute_dtype="float32")
    weights = map_tree(lambda _, a: a.detach().numpy(),
                       build_model(cfg, seed=0, device="cpu", train=True).params())
    shape = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=r["seq_len"],
                                global_batch=r["global_batch"])
    data = SyntheticLM(DataConfig(cfg.vocab_size, r["seq_len"], r["global_batch"]))

    def fresh(device):
        model = build_model(cfg, seed=1, device=device, train=True)
        model.load_state_dict(convert.decoder_params_from_reference(cfg, weights))
        return model

    def run(device, first, last, model=None, opt=None):
        model = model or fresh(device)
        step = steps.build_train_step(model, None, shape, schedule="wsd", total_steps=r["steps"],
                                      microbatch_seqs=r["microbatch_seqs"])
        params = model.params()
        opt = opt or adamw_init(params, step.opt_cfg)
        losses = []
        for i in range(first, last):
            params, opt, m = step(params, opt, data.batch(i))
            losses.append(float(m["loss"]))
        return model, opt, losses

    t0 = time.perf_counter()
    _, _, cpu_losses = run("cpu", 0, r["steps"])
    straight, straight_opt, card_losses = run("cuda", 0, r["steps"])
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    if rel > TRAIN_REDUCED_RTOL:
        raise AssertionError(f"[{tag} reduced] card losses {card_losses} against the CPU's "
                             f"{cpu_losses}: {rel} > {TRAIN_REDUCED_RTOL}")
    log(f"[{tag} reduced] reduced {TRAIN_ARCH} (float32 compute, TF32 off), {r['steps']} steps of "
        f"{r['global_batch']} x {r['seq_len']} tokens on the card against the CPU: losses "
        f"{[round(x, 6) for x in card_losses]}, worst relative difference {rel:.3e} <= "
        f"{TRAIN_REDUCED_RTOL} ({time.perf_counter() - t0:.1f} s)")

    half = r["steps"] // 2
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        model, opt, _ = run("cuda", 0, half)
        mgr = CheckpointManager(tmp)
        mgr.save(half, {"params": model.params(), "opt": opt._asdict()})
        resumed = fresh("cuda")
        saved_step, resumed_opt = steps.restore_train_state(mgr, resumed.params(), opt)
        resumed, resumed_opt, _ = run("cuda", saved_step, r["steps"], resumed, resumed_opt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diff = max(float((a.detach() - b.detach()).abs().max())
               for (_, a), (_, b) in zip(iter_leaves(straight.params()),
                                         iter_leaves(resumed.params())))
    exact = diff == 0.0 and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(iter_leaves(straight_opt.nu),
                                                    iter_leaves(resumed_opt.nu)))
    if diff > TRAIN_RESUME_TOL:
        raise AssertionError(f"[{tag} resume] {half} + save + restore + {half} steps differ from "
                             f"{r['steps']} straight by {diff} > {TRAIN_RESUME_TOL}")
    log(f"[{tag} resume] {half} steps + save + restore + {half} steps against {r['steps']} "
        f"straight on the card: max |diff| of the parameters {diff:.3e} <= {TRAIN_RESUME_TOL} "
        f"(the reference test's bar; bit-exact, moments too: {exact})")
    return {"losses": card_losses, "cpu_losses": cpu_losses, "rel": rel, "resume_diff": diff,
            "resume_exact": exact}


def run_example(name: str, argv: list, tag: str) -> str:
    """``examples/torch/{name}.py``'s ``main(argv)`` in process on the
    card; its printed lines logged as ``[{tag} {name}]``; the text."""
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  ROOT / "examples" / "torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        module.main(argv)
    text = printed.getvalue()
    for line in text.splitlines():
        log(f"[{tag} {name}] {line}")
    log(f"[{tag} {name}] ran in {time.perf_counter() - t0:.2f} s")
    return text


def train_examples(torch, tag) -> dict:
    """The four examples on the card: ``train_lm.py --profile 100m
    --steps 200`` (checkpoints under a temporary directory of build/; the
    mean of the last 5 logged losses at least ``TRAIN_LM_MARGIN`` below
    the first 5; steps/s), ``quickstart.py`` with its exact asserts,
    ``serve_lm.py`` for minicpm-2b and zamba2-2.7b at the reduced width,
    and ``private_inference.py`` on one NCCL rank (every request served,
    relative error below 0.15: its own asserts)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        text = run_example("train_lm", TRAIN_LM_ARGV + ["--ckpt-dir", tmp], tag)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [float(m[1]) for m in re.finditer(r"loss ([0-9.]+)", text)]
    steps = int(TRAIN_LM_ARGV[TRAIN_LM_ARGV.index("--steps") + 1])
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not (len(losses) >= 10 and last < first - TRAIN_LM_MARGIN):
        raise AssertionError(f"[{tag} train_lm] losses {losses}: the loss did not fall")
    log(f"[{tag} train_lm] {' '.join(TRAIN_LM_ARGV)}: mean of the first 5 logged losses "
        f"{first:.4f}, of the last 5 {last:.4f} (fell {first - last:.4f} >= {TRAIN_LM_MARGIN}); "
        f"{steps / wall:.2f} steps/s over the example's wall ({wall:.2f} s, with the build and "
        f"the checkpoints)")
    run_example("quickstart", [], tag)
    for arch in ("minicpm-2b", "zamba2-2.7b"):
        out = run_example("serve_lm", ["--arch", arch], tag)
        if f"arch={arch}" not in out or "device=cuda" not in out:
            raise AssertionError(f"[{tag} serve_lm] {arch} printed {out!r}")
    out = run_example("private_inference", [], tag)
    if "ranks as workers: 1 (cuda" not in out:
        raise AssertionError(f"[{tag} private_inference] printed {out!r}")
    return {"train_lm_losses": losses, "train_lm_steps_per_s": steps / wall}


def phase_train(torch, K) -> dict:
    """MiniCPM-2B at full width and depth trained through
    ``repro_torch.launch.train.main`` in process (``TRAIN_ARGV``; weights
    from seed 0, the launcher's own; float32 master weights, bfloat16
    compute, full remat).  Raises unless the parameters are
    ``TRAIN_PARAMS`` float32 ones, every step's loss and gradient norm
    are finite, step 0's loss is within ``TRAIN_LOSS0_TOL`` of
    ln(vocab), every step's lr is ``get_schedule("wsd", 3e-4, 4)`` at
    that step, every parameter moved and is finite, and no TPU kernel
    launched.  Prints the warm step ms (CUDA events, steps 1-3) against
    the FLOP bound, tokens/s, the peak, and the AdamW update alone
    against its byte bound.  Then the blocks at full width
    (``train_blocks``), the reduced card-against-CPU and resume checks
    (``reduced_train``) and the examples (``train_examples``).  Frees the
    model before it returns."""
    import gc
    import math

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.models import registry
    from repro_torch.models.common import count_params, iter_leaves, map_tree
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update, get_schedule

    tag = "train"
    phase_t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    launches = (dict(K.LAUNCHES), dict(K.LAUNCHES_BY_KERNEL))
    t0 = time.perf_counter()
    model, samples, steps, text, peak = train_in_process(torch, launcher, TRAIN_ARGV, tag)
    wall_s = time.perf_counter() - t0
    if (dict(K.LAUNCHES), dict(K.LAUNCHES_BY_KERNEL)) != launches:
        raise AssertionError(f"[{tag}] a TPU kernel launched: {K.LAUNCHES}")
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    if (n_params, n_bytes) != (TRAIN_PARAMS, 4 * TRAIN_PARAMS) or n_params != count_params(
            registry.params_abstract(cfg)):
        raise AssertionError(f"[{tag}] {n_params} parameters in {n_bytes} bytes, expected "
                             f"{TRAIN_PARAMS} float32")
    n_steps = int(TRAIN_ARGV[TRAIN_ARGV.index("--steps") + 1])
    schedule = get_schedule("wsd", TRAIN_LR, n_steps)
    want_lr = [float(schedule(torch.tensor(i + 1, dtype=torch.int32))) for i in range(n_steps)]
    if len(steps) != n_steps or "done" not in text or f"training {TRAIN_ARCH} on cuda" not in text:
        raise AssertionError(f"[{tag}] {len(steps)} steps ran; the launcher printed {text!r}")
    for i, m in enumerate(steps):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"[{tag}] step {i}: {m}")
        if abs(m["lr"] - want_lr[i]) > 1e-6 * want_lr[i]:
            raise AssertionError(f"[{tag}] step {i}: lr {m['lr']} != wsd's {want_lr[i]}")
    uniform = math.log(cfg.vocab_size)
    if abs(steps[0]["loss"] - uniform) > TRAIN_LOSS0_TOL:
        raise AssertionError(f"[{tag}] step 0's loss {steps[0]['loss']} is not within "
                             f"{TRAIN_LOSS0_TOL} of ln {cfg.vocab_size} = {uniform}")
    moved = [n for n, p in params.items()
             if not torch.equal(p.detach().reshape(-1)[:TRAIN_SAMPLE], samples[n])]
    finite = all(bool(torch.isfinite(p).all()) for p in params.values())
    if len(moved) != len(params) or not finite:
        raise AssertionError(f"[{tag}] parameters that did not move: "
                             f"{sorted(set(params) - set(moved))}; all finite: {finite}")
    warm = [m["ms"] for m in steps[1:]]
    step_ms = statistics.mean(warm)
    flop_bound_ms = 8 * n_params * TRAIN_TOKENS / FP16_TC_FLOPS * 1e3
    log(f"[{tag}] {TRAIN_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} x {cfg.resolved_head_dim} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} (padded {cfg.padded_vocab}), remat {cfg.remat_policy}: {n_params} "
        f"float32 parameters ({n_bytes} bytes), random from seed 0 (the launcher's); {n_steps} "
        f"steps of {TRAIN_TOKENS} tokens (4 micro-steps of 2 x 256), losses "
        f"{[round(m['loss'], 4) for m in steps]} (step 0 within {TRAIN_LOSS0_TOL} of ln vocab = "
        f"{uniform:.4f}), grad norms {[round(m['grad_norm'], 4) for m in steps]}, lr "
        f"{[m['lr'] for m in steps]} (the wsd schedule's); every parameter moved and finite; no "
        f"TPU kernel launched")
    log(f"[{tag}] step ms (CUDA events) {[round(m['ms'], 3) for m in steps]}: warm (steps 1-"
        f"{n_steps - 1}) {step_ms:.3f} ms, {TRAIN_TOKENS / step_ms * 1e3:.1f} tokens/s, against a "
        f"FLOP bound of {flop_bound_ms:.3f} ms (8 x {n_params} parameters x {TRAIN_TOKENS} tokens: "
        f"forward, backward and the remat forward, at {FP16_TC_FLOPS / 1e12:.0f} TFLOP/s bf16) "
        f"= {flop_bound_ms / step_ms:.3f} of it; launcher wall {wall_s:.2f} s with the weights' "
        f"draw; peak allocated {peak} bytes ({peak / 2**30:.2f} GiB)")

    breakdown = train_breakdown(torch, cfg, model, tag)
    blocks = train_blocks(torch, cfg, model, tag)

    # the AdamW update alone, at full width: fresh moments and a constant
    # gradient (its work does not depend on the values)
    tree = model.params()
    opt_cfg = AdamWConfig(lr=schedule)
    opt = adamw_init(tree, opt_cfg)
    grads = map_tree(lambda _, p: torch.full_like(p, 1e-3), tree)
    with torch.no_grad():
        _, opt, _ = adamw_update(grads, opt, tree, opt_cfg)
        adamw_ms = [cuda_timed(torch, lambda: adamw_update(grads, opt, tree, opt_cfg))[1]
                    for _ in range(3)]
    adamw_bound_ms = 28 * n_params / HBM_BPS * 1e3
    log(f"[{tag}] adamw_update alone over {n_params} float32 parameters: "
        f"{[round(x, 3) for x in adamw_ms]} ms (CUDA events) against a byte bound of "
        f"{adamw_bound_ms:.3f} ms (28 B a parameter: p, g, mu, nu read, p, mu, nu written, at "
        f"{HBM_BPS / 1e12} TB/s) = {adamw_bound_ms / statistics.mean(adamw_ms):.3f} of it")
    del grads, opt, tree, params, model, samples
    gc.collect()
    torch.cuda.empty_cache()

    reduced = reduced_train(torch, tag)
    examples = train_examples(torch, tag)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - phase_t0
    log(f"[{tag}] phase wall {phase_s:.2f} s: the full-width launch, its breakdown, the blocks, "
        f"the AdamW update, the reduced checks and the examples")
    return {"phase_s": phase_s, "params": n_params, "steps": steps, "step_ms": step_ms, "flop_bound_ms": flop_bound_ms,
            "adamw_ms": adamw_ms, "adamw_bound_ms": adamw_bound_ms, "peak": peak,
            "breakdown": breakdown, "blocks": blocks, "reduced": reduced, "examples": examples,
            "wall_s": wall_s}


# ----------------------------------------------------------------------
# phase 15: the sharded Phase 2
# ----------------------------------------------------------------------
SHARDED_MODES = ("all_to_all", "psum", "psum_scatter")
# gloo ranks that share the one card in the d > 1 run (NCCL refuses two
# ranks on one device)
SHARDED_RANKS = 4
SHARDED_SERVE_REQUESTS = 4
X_SITES = ("X1 share A", "X1 share B", "X2 multiply", "X3 decode")
# the split of a sharded call also times the exchange, the host's
# per-worker blinding draw of the edge runtime's mesh path and the device
# decode of run_batched_sharded
SHARDED_SPLIT_TARGETS = SPLIT_TARGETS + (("distributed", "run_phase2_sharded"),
                                         ("scheduler", "run_phase2_sharded"),
                                         ("scheduler", "_sender_noise"),
                                         ("protocol", "_decode_batched"))


def sharded_sites(plan, batch: int, d: int) -> dict:
    """Launch sites of ``run_batched_sharded`` on each of ``d`` ranks: X1
    (the shares, P1's), X2 (the per-shard worker multiply of the rank's
    npad / d workers, the batch folded in) and X3 (the decode, P3's)."""
    sites = site_table(plan, batch)
    npad = plan.n_total + (-plan.n_total) % d
    nloc = npad // d
    bra, bca = plan.shapes.blk_a
    bcb = plan.shapes.blk_b[1]
    return {"X1 share A": sites["P1 share A"], "X1 share B": sites["P1 share B"],
            "X2 multiply": ((nloc * batch, bra, bca), (nloc * batch, bca, bcb)),
            "X3 decode": sites["P3 decode"]}


def dense_phase2(torch, ref, protocol, plan, fa, fb, noise):
    """I of the dense Phase 2 on the same shares and per-worker noise,
    through the plain versions on the card: mix^T H plus vnoise times the
    senders' blinding matrices summed over the senders."""
    plain = ref.PLAIN["int32"]
    dp = protocol.device_plan(plan, fa.device)
    batch = fa.shape[0]
    h = plain(fa, fb, P)  # [batch, n_total, bry, bcy]
    blk = h.shape[-2] * h.shape[-1]
    i_mix = plain(dp.mix_t, h[:, : plan.n_workers].reshape(batch, plan.n_workers, blk), P)
    r_sum = torch.remainder(noise.to(torch.int64).sum(1), P).to(torch.int32)
    i_noise = plain(dp.vnoise, r_sum.reshape(batch, plan.scheme.z, blk), P)
    return torch.remainder(i_mix.to(torch.int64) + i_noise, P).to(torch.int32).reshape(h.shape)


def phase2_operands(torch, gf, protocol, plan, a, b, seed: int):
    """The shares of (a, b) under key ``seed`` and per-worker noise
    [batch, n_workers, z, bry, bcy] from ``seed``, on the card: the same
    bits on every process that asks."""
    fa, fb = protocol.share_batched(plan, a, b, gf.prng_key(seed))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    noise = gf.random_field_device(
        gen, (a.shape[0], plan.n_workers, plan.scheme.z) + plan.shapes.blk_y, P, "cuda")
    return fa, fb, noise


def digest(x) -> str:
    import hashlib

    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]


def phase_sharded(torch, K, ref, protocol, distributed, planner, constructions, runtime,
                  serve, scheduler, layers, gf, args) -> dict:
    """Phase 10 on a one-rank NCCL group, then on SHARDED_RANKS gloo ranks
    sharing the card (``sharded_ranks``)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = distributed.workers_mesh("cuda")
        out = sharded_one_rank(torch, K, ref, protocol, distributed, planner, constructions,
                               runtime, serve, scheduler, layers, gf, mesh, args)
    finally:
        dist.destroy_process_group()
    if SHARDED_RANKS > 1:
        out["ranks"] = sharded_ranks(torch, K, out, args)
    return out


def sharded_one_rank(torch, K, ref, protocol, distributed, planner, constructions, runtime,
                     serve, scheduler, layers, gf, mesh, args) -> dict:
    import numpy as np

    batch, k = args.batch, 5120
    plan, a, b, want = main_operands(torch, planner, constructions, batch, k, args.seed + 11)
    plan20 = planner.get_plan(constructions.build_scheme("age", 2, 2, 2),
                              planner.BlockShapes(k=k, ma=512, mb=4096, s=2, t=2), n_spare=3)
    import torch.distributed as dist

    log(f"[sharded] one-rank {dist.get_backend(mesh.get_group('workers'))} group, mesh "
        f"{mesh.mesh_dim_names} on {mesh.device_type}; AGE s=t=z=2, n_total={plan.n_total} "
        f"(npad {plan.n_total} at d = 1); a [{batch}, {k}, 512], b [{batch}, {k}, 4096]")
    counts: collections.Counter = collections.Counter()
    sites_of: dict = {}  # (compiled, shape) -> (site, a shape, b shape, variant, plan)
    times: dict = {}
    modules = {"protocol": protocol, "scheduler": scheduler, "distributed": distributed}

    def note(tag, sites, names, variant, site_plan, expect=None):
        """The launches since the counts were zeroed, exactly those of the
        sites ``names`` (or ``expect``) of ``site_plan``; added to the
        phase's counts."""
        got = launched_shapes(K)
        expect = expect if expect is not None else expected_shapes(K, sites, names, variant)
        if got != expect:
            raise AssertionError(f"[{tag}] launches {got}, expected {expect}")
        for compiled, shapes in got.items():
            for shape, n in shapes.items():
                counts[(compiled, shape)] += n
        for site in names:
            sa, sb = sites[site]
            shape = geometry(sa, sb)
            sites_of.setdefault((f"{variant}_{K.choose_design(variant, False, *shape)}", shape),
                                (site, sa, sb, variant, site_plan))
        return got

    def check_y(y, y_want, tag):
        y = y if isinstance(y, np.ndarray) else y.cpu().numpy()
        if y.shape != y_want.shape or not np.array_equal(y, y_want):
            raise AssertionError(f"[{tag}] Y differs from the float64 oracle")

    want_h = want.cpu().numpy()
    peaks = {}
    for backend, variant, modes in (("auto", "int32", SHARDED_MODES), ("cuda", "f32", ("all_to_all",))):
        xsites = sharded_sites(plan, batch, 1)
        deep = geometry(*xsites["X2 multiply"])
        wanted = {"int32": "mma", "f32": "wgmma"}[variant]
        if K.choose_design(variant, False, *deep) != wanted:
            raise AssertionError(f"the per-shard multiply {deep} is not sent to {variant}_{wanted}")
        for mode in modes:
            tag = f"sharded {mode} {backend}"
            call = lambda: protocol.run_batched_sharded(  # noqa: E731
                plan, a, b, mesh, mode=mode, seed=args.seed, backend=backend)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            y, _ = call()
            torch.cuda.synchronize()
            peaks[tag] = torch.cuda.max_memory_allocated()
            got = note(tag, xsites, X_SITES, variant, plan)
            check_y(y, want_h, tag)
            del y
            times[tag] = {"median_ms": round(median_event_ms(torch, call, args.reps), 3),
                          "peak_bytes": peaks[tag],
                          "split": split_call(torch, modules, call, SHARDED_SPLIT_TARGETS)}
            log(f"[{tag}] Y exact; launches {json.dumps({n: {str(s): c for s, c in v.items()} for n, v in got.items()})}; "
                f"peak allocated {peaks[tag]} bytes ({peaks[tag] / 2**30:.2f} GiB)")
            log(f"[sharded time] {tag}: " + json.dumps(times[tag]))

    # a Phase-2 sender subset and a Phase-3 responder subset (3 spares)
    tag = "sharded subsets"
    ids2 = np.array([i for i in range(plan20.n_total) if i not in (0, 2)])[: plan20.n_workers]
    ids3 = np.arange(2, 2 + plan20.decode_threshold)
    K.reset_launch_counts()
    y, _ = protocol.run_batched_sharded(plan20, a, b, mesh, mode="psum_scatter", seed=args.seed,
                                        phase2_ids=ids2, phase3_ids=ids3)
    torch.cuda.synchronize()
    note(tag, sharded_sites(plan20, batch, 1), X_SITES, "int32", plan20)
    check_y(y, want_h, tag)
    del y
    log(f"[{tag}] n_total {plan20.n_total}, senders {ids2.tolist()}, responders "
        f"{ids3.tolist()}, psum_scatter: Y exact")

    # the exchange against the dense Phase 2 on the same shares and noise
    fa, fb, noise = phase2_operands(torch, gf, protocol, plan, a, b, args.seed + 12)
    i_dense = dense_phase2(torch, ref, protocol, plan, fa, fb, noise)
    dense_digest = digest(i_dense)
    for mode in SHARDED_MODES:
        i_sh = distributed.run_phase2_sharded(plan, fa, fb, noise, mesh, mode=mode)
        if not torch.equal(i_sh, i_dense):
            raise AssertionError(f"[sharded phase2] {mode}: I differs from the dense Phase 2 "
                                 f"in {int((i_sh != i_dense).sum())} entries")
        del i_sh
    log(f"[sharded phase2] run_phase2_sharded == dense mix^T H + vnoise R_sum (plain versions) "
        f"in {list(SHARDED_MODES)}: I {list(i_dense.shape)}, digest {dense_digest}")
    del fa, fb, noise, i_dense
    torch.cuda.empty_cache()

    # the edge runtime's mesh path: the [edge] pool and trace rule, correct mode
    trace, tseed = edge_trace(runtime, plan20, args.seed)
    tag = "sharded edge batch correct"
    kw = dict(seed=args.seed, decode_mode="correct", verify_extras=1, error_budget=1,
              mesh=mesh, mode="all_to_all")
    call = lambda: runtime.run_batch_over_pool(plan20, a, b, trace, **kw)  # noqa: E731
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    run = call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    esites = {**edge_sites(plan20, batch), **sharded_sites(plan20, batch, 1)}
    note(tag, esites, ("B1 share A", "B1 share B", "X2 multiply"), "int32", plan20)
    check_y(run.y, want_h, tag)
    m = run.metrics
    if 1 not in m.corrected_workers.tolist() or 0 in m.phase2_ids.tolist():
        raise AssertionError(f"[{tag}] corrupt worker 1 not corrected ({m.corrected_workers}) or "
                             f"dropped worker 0 in the Phase-2 set {m.phase2_ids.tolist()}")
    times[tag] = {"wall_ms": round(wall, 3), "runs": 1,
                  "split": split_call(torch, modules, call, SHARDED_SPLIT_TARGETS)}
    log(f"[{tag}] trace seed {tseed} (worker 0 dropped, 1 corrupt): Y exact; phase2 "
        f"{m.phase2_ids.tolist()} corrected {m.corrected_workers.tolist()}")
    log(f"[sharded time] {tag}: " + json.dumps(times[tag]))
    del run

    # a short ServingEngine stream with the mesh
    k_, rows, out = WIDTH
    cfg, traces, w, xs, arrivals = serve_stream(np, runtime, constructions, args.seed, k_, rows, out)
    xs, arrivals = xs[:SHARDED_SERVE_REQUESTS], arrivals[:SHARDED_SERVE_REQUESTS]
    cache = {}
    want_y = [serve_oracle(torch, np, layers, gf, w, x, cache)[0] for x in xs]
    del cache
    tag = "sharded serve"
    eng = serve.ServingEngine(w, traces, cfg, seed=args.seed, mode="continuous", pipe_depth=2,
                              max_batch=SERVE_MAX_BATCH, slo=30.0, decode_mode="hybrid",
                              mesh=mesh, exchange_mode="psum")
    for x, t in zip(xs, arrivals):
        eng.submit(x, float(t))
    K.reset_launch_counts()
    box = {}
    split = split_call(torch, modules, lambda: box.setdefault("report", eng.run()),
                       SHARDED_SPLIT_TARGETS)
    rep = box["report"]
    for r, y in zip(rep.requests, want_y):
        if r.state != "done" or not np.array_equal(r.y, y):
            raise AssertionError(f"[{tag}] request {r.rid} {r.state}: y differs from the card oracle")
    splan = eng._session.plan
    by_kernel = {n: c for n, c in K.LAUNCHES_BY_KERNEL.items() if c}
    if by_kernel != {"int32_mma": rep.replays, "int32_skinny": 2 * rep.replays}:
        raise AssertionError(f"[{tag}] launches {by_kernel} over {rep.replays} replays")
    sizes = sorted(collections.Counter(r.replay for r in rep.requests).values())
    allowed: dict = {}
    for nb in set(sizes):
        ssites = {**serve_sites(splan, nb), **sharded_sites(splan, nb, 1)}
        names = ("S1 share A", "S1 share B", "X2 multiply")
        for compiled, shapes in expected_shapes(K, ssites, names, "int32").items():
            for shape, n in shapes.items():
                allowed.setdefault(compiled, collections.Counter())[shape] += n * sizes.count(nb)
        for site in names:
            shape = geometry(*ssites[site])
            sites_of.setdefault((f"int32_{K.choose_design('int32', False, *shape)}", shape),
                                (f"{site} ({nb} req)", *ssites[site], "int32", splan))
    note(tag, None, (), "int32", splan, expect={n: dict(c) for n, c in allowed.items()})
    split["per_replay_wall_ms"] = round(split["wall_ms"] / rep.replays, 3)
    times[tag] = {"split": split, "replays": rep.replays, "summary": rep.summary()}
    log(f"[{tag}] {len(xs)} requests of [serve] over mesh (psum), replays of {sizes} requests: "
        f"every y exact; " + json.dumps(rep.summary()))
    log(f"[sharded time] {tag}: " + json.dumps(split))
    del eng, rep, box, a, b, want
    torch.cuda.empty_cache()
    return {"counts": counts, "sites": sites_of, "times": times, "peaks": peaks,
            "dense_digest": dense_digest, "plan": plan}


def sharded_rank(rank: int, d: int, src: str, store: str, out: str, seed: int, batch: int,
                 reps: int) -> None:
    """One of ``d`` gloo ranks sharing the card: ``run_batched_sharded`` at
    the [sharded] width in every mode (Y against the float64 oracle, the
    launches of the first call, the median wall of ``reps``), and
    ``run_phase2_sharded`` on the phase's shares and noise (I's digest);
    writes its results as JSON to ``out``."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    from repro_torch.core import constructions, distributed, gf, planner, protocol
    from repro_torch.kernels.modmatmul import kernel as K

    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    res = {"rank": rank, "modes": {}}
    dist.init_process_group("gloo", store=dist.FileStore(store, d), rank=rank, world_size=d)
    try:
        mesh = distributed.workers_mesh("cuda")
        res["backend"] = str(dist.get_backend(mesh.get_group("workers")))
        plan, a, b, want = main_operands(torch, planner, constructions, batch, 5120, seed + 11)
        for mode in SHARDED_MODES:
            K.reset_launch_counts()
            y, _ = protocol.run_batched_sharded(plan, a, b, mesh, mode=mode, seed=seed)
            torch.cuda.synchronize()
            launches = launched_shapes(K)
            exact = bool(torch.equal(y, want))
            del y
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                protocol.run_batched_sharded(plan, a, b, mesh, mode=mode, seed=seed)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            res["modes"][mode] = {
                "exact": exact, "median_wall_ms": round(statistics.median(walls), 3),
                "launches": {n: {str(list(s)): c for s, c in v.items()} for n, v in launches.items()}}
        fa, fb, noise = phase2_operands(torch, gf, protocol, plan, a, b, seed + 12)
        res["phase2_digest"] = {
            mode: digest(distributed.run_phase2_sharded(plan, fa, fb, noise, mesh, mode=mode))
            for mode in SHARDED_MODES}
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def sharded_ranks(torch, K, one_rank: dict, args) -> dict:
    """[sharded] over SHARDED_RANKS gloo ranks on the one card (npad 20:
    three pad workers): every rank's Y exact and its I equal to the dense
    Phase 2's (the one-rank run's digest), X2 at its d > 1 shape.  Every
    process started is joined or killed here."""
    import multiprocessing as mp
    import tempfile

    d = SHARDED_RANKS
    plan, batch = one_rank["plan"], args.batch
    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="sharded_", dir=root)
    ctx = mp.get_context("spawn")
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(d)]
    procs = [ctx.Process(target=sharded_rank,
                         args=(r, d, args.src, os.path.join(tmp, "store"), outs[r], args.seed,
                               batch, 3)) for r in range(d)]
    t0 = time.perf_counter()
    try:
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(300)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    secs = time.perf_counter() - t0
    codes = [proc.exitcode for proc in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"[sharded d={d}] ranks exited {codes}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    x2 = geometry(*sharded_sites(plan, batch, d)["X2 multiply"])
    expect = expected_shapes(K, sharded_sites(plan, batch, d), X_SITES, "int32")
    for res in ranks:
        tag = f"sharded d={d} rank {res['rank']}"
        for mode, m in res["modes"].items():
            got = {n: {tuple(json.loads(s)): c for s, c in v.items()} for n, v in m["launches"].items()}
            if not m["exact"] or got != expect:
                raise AssertionError(f"[{tag}] {mode}: exact {m['exact']}, launches {got}, "
                                     f"expected {expect}")
        if set(res["phase2_digest"].values()) != {one_rank["dense_digest"]}:
            raise AssertionError(f"[{tag}] I digests {res['phase2_digest']} differ from the "
                                 f"dense Phase 2's {one_rank['dense_digest']}")
        log(f"[{tag}] backend {res['backend']}: Y exact in {list(res['modes'])}; I == dense "
            f"Phase 2 in every mode; X2 {list(x2)}; peak {res['peak_bytes']} bytes; median wall ms "
            + json.dumps({mode: m["median_wall_ms"] for mode, m in res["modes"].items()}))
    site = sharded_sites(plan, batch, d)["X2 multiply"]
    key = (f"int32_{K.choose_design('int32', False, *x2)}", x2)
    one_rank["counts"][key] += len(SHARDED_MODES)  # rank 0's counted calls
    one_rank["sites"].setdefault(key, (f"X2 multiply (d={d})", *site, "int32", plan))
    log(f"[sharded d={d}] {d} gloo ranks on one card, n_total {plan.n_total} padded to "
        f"{plan.n_total + (-plan.n_total) % d}: every rank exact, {secs:.1f} s with start-up")
    return {"d": d, "seconds": round(secs, 1), "ranks": ranks}


def sharded_entries(torch, K, ref, protocol, ops, sharded: dict, entries: list, args) -> list:
    """The [sharded] phase's launch shapes on the ``kernels`` line: a shape
    the line already holds (by kernel and counted geometry) is logged with
    its launches; any other is timed and held against its plain version."""
    held = {(e["kernel"], tuple(e["geometry"])) for e in entries}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 13)
    new = []
    for key, n in sorted(sharded["counts"].items()):
        site, sa, sb, variant, plan = sharded["sites"][key]
        if key in held:
            log(f"[sharded sites] {key[0]:14s} {site:24s} {list(sa)}@{list(sb)}: {n} launches "
                "over the phase's counted calls, a shape the kernels line holds")
            continue
        new.append(measure_site(torch, K, ref, gen, f"modmatmul_{variant}", variant, False, site,
                                sa, sb, plan.scheme.z, n, args, blocks=(protocol, ops, plan)))
    return new


# ----------------------------------------------------------------------
# phase 18: the model on a (data, model) mesh
# ----------------------------------------------------------------------
MESH_RANKS = 4
MESH_SHAPE = (2, 2)
# [mesh train], [mesh comm] and [mesh serve] run MiniCPM-2B at full width,
# cut to 2 of its 40 layers, and [mesh serve] decodes 2 steps, not 8: on
# an H100 80GB HBM3 at 700 W a full-depth step of gloo ranks sharing the
# card took 46.9-50.6 s, and with [mesh hybrid] and [dryrun] the script
# took 1121.1 s at 24 layers and 8 steps on one machine, 1255.2 s at 16
# layers and 4 steps on another and 1078.1 s at 4 layers and 2 steps on a
# third, against its 1200 s limit (PERF.md 4).  Two steps, one warm.
MESH_LAYERS = 2
MESH_TRAIN = dict(seq_len=256, global_batch=8, microbatch_seqs=2, steps=2)
MESH_LOSS0_RTOL = 1e-3
MESH_REDUCED = dict(seq_len=32, global_batch=8, microbatch_seqs=2, steps=2)
MESH_REDUCED_TOL = 1e-5
MESH_SERVE = dict(batch=4, prompt_len=256, gen_len=2)
MESH_SERVE_TOL = 2.0**-5  # tests/test_torch_models.py's bf16_tol, of the largest logit
PIPE = dict(stages=4, layers=10, micro=8, tokens=256)
PIPE_TOL = 2.0**-10
PIPE_SEED = 4321
MESH_JOIN_SECONDS = 900
# [mesh hybrid]: Zamba2-2.7B (src/repro/configs/zamba2_2_7b.py, arXiv:2411.15242)
# at full width and depth, served as launch/serve.py --mesh 2x2 serves it
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_SERVE = dict(batch=4, prompt_len=256, gen_len=8)
HYBRID_TOL = 2.0**-5  # of the largest logit, at float32 compute (C12)
# the float32-compute check runs the prefill and the first 4 decode steps
# (the bfloat16 serve runs all 8): a step of either takes 4.4-8.0 s on
# gloo ranks sharing an H100 80GB HBM3 at 700 W, and the script keeps to
# its time limit (PERF.md 4)
HYBRID_CHECK_STEPS = 4


def mesh_rank(rank: int, d: int, src: str, store: str, out: str, nccl: bool, device: str) -> None:
    """One of ``d`` ranks of the mesh phases (NCCL, one card each, or gloo
    ranks sharing card 0): [mesh train] and [mesh comm] at full width on a
    2x2 mesh, [mesh train reduced] against one rank, [mesh serve] against
    the one-device model (rank 0), and [pipeline] over a 4-stage mesh
    against the sequential trunk (rank 0).  ``device == "cpu"``
    rehearses the phases on gloo CPU ranks at the reduced width and short
    sequences.  Writes its lines and numbers as JSON to ``out``."""
    sys.path.insert(0, src)
    import contextlib
    import dataclasses
    import faulthandler
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import comm, staged
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.sharding import activation_rules, batch_shardings, place
    from repro_torch.kernels.modmatmul import kernel as K
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.models import build_model, lm, registry
    from repro_torch.models.common import iter_leaves, materialize
    from repro_torch.train.optimizer import adamw_init

    faulthandler.enable()
    torch.set_num_threads(1)
    card = device == "cuda"
    if card:
        dev = torch.device("cuda", rank if nccl else 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        dev = torch.device("cpu")
    lines, res = [], {"rank": rank}

    def say(text):
        # rank 0 prints as it goes (a run cut short still shows how far it got)
        lines.append(text)
        if rank == 0:
            log(text)

    def sync():
        if card:
            torch.cuda.synchronize()

    def timed(fn):
        if card:
            return cuda_timed(torch, fn)
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3

    def peak():
        return torch.cuda.max_memory_allocated() if card else 0

    def free():
        gc.collect()
        sync()
        if card:
            torch.cuda.empty_cache()
        dist.barrier()

    backend = "nccl" if nccl else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store, d), rank=rank, world_size=d,
                            device_id=dev if nccl else None)
    launches = (dict(K.LAUNCHES), dict(K.LAUNCHES_BY_KERNEL))
    stack = contextlib.ExitStack()
    try:
        if not nccl:  # gloo ranks sharing a card: DTensor's collectives as plain gloo ones
            stack.enter_context(staged.host_collectives())
        mesh = make_mesh(MESH_SHAPE, ("data", "model"), dev.type)
        res["backend"] = dist.get_backend()
        cfg = configs.get_config(TRAIN_ARCH)
        t, sv, pp = dict(MESH_TRAIN), dict(MESH_SERVE), dict(PIPE)
        if not card:
            cfg = dataclasses.replace(configs.reduced(cfg), remat_policy="full")
            t.update(seq_len=32)
            sv.update(prompt_len=16)
            pp.update(tokens=16, layers=2)
        if card:
            cfg = dataclasses.replace(cfg, num_layers=MESH_LAYERS)
        # [mesh train]: the sharded train step at the launcher's defaults
        if card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, seed=0, device=dev, train=True, mesh=mesh)
        build_s = time.perf_counter() - t0
        # the build's peak (each leaf drawn whole, then cut to the shard)
        # apart from the steps'
        build_peak = peak()
        if card:
            torch.cuda.reset_peak_memory_stats()
        shape = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=t["seq_len"],
                                    global_batch=t["global_batch"])
        bundle = tsteps.build_train_step(model, mesh, shape, lr=TRAIN_LR, schedule="wsd",
                                         total_steps=t["steps"],
                                         microbatch_seqs=t["microbatch_seqs"])
        params = model.params()
        opt = adamw_init(params, bundle.opt_cfg)
        data = SyntheticLM(DataConfig(cfg.vocab_size, t["seq_len"], t["global_batch"]))
        metrics = []
        for i in range(t["steps"]):
            (params, opt, m), ms = timed(lambda: bundle(params, opt, data.batch(i)))
            metrics.append({"ms": ms, **{k: float(v) for k, v in m.items()}})
            if rank == 0:
                log(f"[mesh train] step {i}: loss {metrics[-1]['loss']:.4f}, {ms:.1f} ms")
        warm = statistics.mean(m["ms"] for m in metrics[1:])
        tokens = t["seq_len"] * t["global_batch"]
        n_params = sum(p.numel() for _, p in iter_leaves(params))
        res["train"] = {"metrics": metrics, "warm_ms": warm, "tokens_per_s": tokens / warm * 1e3,
                        "layers": cfg.num_layers, "build_peak": build_peak,
                        "peak": peak(), "n_micro": bundle.n_micro,
                        "params": n_params, "build_s": build_s}
        if rank == 0:
            say(f"[mesh train] {TRAIN_ARCH} ({cfg.num_layers} layers, {n_params} float32 "
                f"parameters, seed 0) on {describe(mesh)} ({backend}): {t['steps']} steps of "
                f"{bundle.n_micro} micro-steps x {t['global_batch'] // bundle.n_micro} x "
                f"{t['seq_len']} tokens; losses {[round(m['loss'], 4) for m in metrics]}, grad "
                f"norms {[round(m['grad_norm'], 4) for m in metrics]}; step ms (CUDA events) "
                f"{[round(m['ms'], 1) for m in metrics]}, warm {warm:.1f} ms = "
                f"{tokens / warm * 1e3:.1f} tokens/s; built and sharded in {build_s:.1f} s")

        # [mesh comm]: one warm micro-step's collectives against the design
        mb = dataclasses.replace(shape, global_batch=t["global_batch"] // bundle.n_micro)
        rows = {k: v[: mb.global_batch] for k, v in data.batch(0).items()}
        sync()
        c0 = time.perf_counter()
        with comm.CollectiveLog(sites=True) as rec, tsteps.sharded(activation_rules(mesh)):
            loss, _ = registry.loss(cfg, params, place(rows, batch_shardings(
                model.batch_spec(mb), mesh), mesh))
            loss.backward()
            for p in model.parameters():
                tsteps._as_placed(p.grad, p)
        sync()
        micro_s = time.perf_counter() - c0
        for p in model.parameters():
            p.grad = None
        want = comm.design_collectives(cfg, dict(zip(("data", "model"), MESH_SHAPE)),
                                       mb.global_batch, t["seq_len"])
        res["comm"] = {"counts": dict(rec.counts), "sent": dict(rec.sent), "want": want,
                       "micro_s": micro_s}
        if dict(rec.counts) != want["counts"] or dict(rec.sent) != want["sent"]:
            raise AssertionError(f"[mesh comm] rank {rank}: collectives {dict(rec.counts)}, "
                                 f"sending {dict(rec.sent)} bytes; the design predicts "
                                 f"{want['counts']}, {want['sent']}; by site:\n{rec.report()}")
        if rank == 0:
            say(f"[mesh comm] one micro-step ({mb.global_batch} x {t['seq_len']} tokens, forward, "
                f"remat forward, backward, gradients onto their shards) in {micro_s:.2f} s: "
                f"collectives {dict(rec.counts)} and the bytes a rank sends {dict(rec.sent)} == "
                f"the design's from the spec tables ({want['layer_leaves']} FSDP leaves a "
                f"layer, replicated {want['replicated']}; the lookup's gradient reduce-scattered "
                f"from the rank's vocab rows)")
        n_micro = bundle.n_micro
        del model, params, opt, bundle, loss
        free()
        # step 0's loss on one device, from the same weights and micro-batches
        if rank == 0:
            one = build_model(cfg, seed=0, device=dev, train=True)
            b, rows = t["global_batch"] // n_micro, data.batch(0)
            with torch.no_grad():
                one_loss = statistics.mean(
                    float(registry.loss(cfg, one.params(), {k: v[i * b:(i + 1) * b]
                                                            for k, v in rows.items()})[0])
                    for i in range(n_micro))
            res["train"]["one_device_loss0"] = one_loss
            del one
        free()

        # [mesh train reduced]: float32, the mesh against one rank of the card
        r = MESH_REDUCED
        rcfg = dataclasses.replace(configs.reduced(cfg), num_layers=4, compute_dtype="float32")
        rshape = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=r["seq_len"],
                                     global_batch=r["global_batch"])
        rdata = SyntheticLM(DataConfig(rcfg.vocab_size, r["seq_len"], r["global_batch"]))
        rmodel = build_model(rcfg, seed=0, device=dev, train=True, mesh=mesh)
        rb = tsteps.build_train_step(rmodel, mesh, rshape, microbatch_seqs=r["microbatch_seqs"])
        rp = rmodel.params()
        ro = adamw_init(rp, rb.opt_cfg)
        for i in range(r["steps"]):
            rp, ro, _ = rb(rp, ro, rdata.batch(i))
        mesh_params = {n: p.full_tensor() for n, p in iter_leaves(rp)}
        if rank == 0:
            one = build_model(rcfg, seed=0, device=dev, train=True)
            # the same micro-batches: micro-step i is global rows [i b, (i + 1) b)
            step = tsteps.build_train_step(one, None, rshape, microbatch_seqs=r["global_batch"]
                                           // rb.n_micro)
            op = one.params()
            oo = adamw_init(op, step.opt_cfg)
            for i in range(r["steps"]):
                op, oo, _ = step(op, oo, rdata.batch(i))
            worst = 0.0
            for n, p in iter_leaves(op):
                top = float(p.detach().abs().max())
                err = float((mesh_params[n] - p.detach()).abs().max())
                worst = max(worst, err / top)
                if err > MESH_REDUCED_TOL * top:
                    raise AssertionError(f"[mesh train reduced] {n}: max |mesh - one rank| {err} "
                                         f"> {MESH_REDUCED_TOL} * {top}")
            res["reduced_worst"] = worst
            say(f"[mesh train reduced] reduced {TRAIN_ARCH} at float32 (TF32 off), {r['steps']} "
                f"steps on {describe(mesh)} against one rank of the card from the same seed: "
                f"every parameter within {worst:.3e} of its leaf's largest entry (limit "
                f"{MESH_REDUCED_TOL})")
            del one, op, oo, step
        del rmodel, rp, ro, rb, mesh_params
        free()

        # [mesh serve]: the sharded prefill and decode bundles
        length = sv["prompt_len"] + sv["gen_len"]
        smodel = build_model(cfg, seed=0, device=dev, mesh=mesh)
        if card:
            torch.cuda.reset_peak_memory_stats()
        pre = tsteps.build_prefill_step(smodel, mesh, dataclasses.replace(
            configs.SHAPES["prefill_32k"], seq_len=length, global_batch=sv["batch"]))
        dec = tsteps.build_decode_step(smodel, mesh, dataclasses.replace(
            configs.SHAPES["decode_32k"], seq_len=length, global_batch=sv["batch"]))
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (sv["batch"], sv["prompt_len"])).astype(np.int32)
        cache = smodel.init_cache(sv["batch"], length)
        (lg, cache), pre_ms = timed(lambda: pre(smodel.params(), {"tokens": prompts}, cache))
        logits = [lg.full_tensor()[:, -1, :cfg.vocab_size].float().cpu()]
        toks = [logits[-1].argmax(-1).to(torch.int32)]
        dec_ms = []
        for i in range(sv["gen_len"]):
            pos = np.full((sv["batch"], 1), sv["prompt_len"] + i, np.int32)
            (lg, cache), ms = timed(lambda: dec(smodel.params(), cache,
                                                toks[-1].numpy()[:, None], pos))
            dec_ms.append(ms)
            logits.append(lg.full_tensor()[:, -1, :cfg.vocab_size].float().cpu())
            toks.append(logits[-1].argmax(-1).to(torch.int32))
        res["serve"] = {"prefill_ms": pre_ms, "decode_ms": dec_ms, "peak": peak()}
        del smodel, cache, lg, pre, dec
        free()
        if rank == 0:
            one = build_model(cfg, seed=0, device=dev)
            cache = one.init_cache(sv["batch"], length)
            lg, cache = one.prefill({"tokens": prompts}, cache)
            ref = [lg[:, -1, :cfg.vocab_size].float().cpu()]
            for i in range(sv["gen_len"]):
                pos = np.full((sv["batch"], 1), sv["prompt_len"] + i, np.int32)
                lg, cache = one.decode_step(toks[i].numpy()[:, None], cache, pos)
                ref.append(lg[:, -1, :cfg.vocab_size].float().cpu())
            worst, agree, decided = 0.0, 0, 0
            for i, (a, b) in enumerate(zip(logits, ref)):
                tol = MESH_SERVE_TOL * float(b.abs().max())
                err = float((a - b).abs().max())
                worst = max(worst, err / float(b.abs().max()))
                if not bool(torch.isfinite(a).all()) or err > tol:
                    raise AssertionError(f"[mesh serve] step {i}: max |mesh - one device| {err} > "
                                         f"{tol}")
                top2 = b.topk(2, dim=-1).values
                clear = (top2[:, 0] - top2[:, 1]) > tol
                same = a.argmax(-1) == b.argmax(-1)
                if bool((clear & ~same).any()):
                    raise AssertionError(f"[mesh serve] step {i}: a greedy token differs where "
                                         f"the top-2 margin exceeds {tol}")
                decided += int(clear.sum())
                agree += int((same & clear).sum())
            res["serve"]["worst"] = worst
            say(f"[mesh serve] {TRAIN_ARCH} (bfloat16 trunk) on {describe(mesh)}: the sharded "
                f"prefill ({sv['batch']} x {sv['prompt_len']}) in {pre_ms:.1f} ms and "
                f"{sv['gen_len']} decode steps, ms {[round(x, 1) for x in dec_ms]} (CUDA events); "
                f"last logits of every step within {worst:.3e} of the largest against the "
                f"one-device model (limit {MESH_SERVE_TOL}); greedy tokens equal at all "
                f"{decided} positions whose top-2 margin exceeds it ({agree} of them)")
            del one, cache, lg
        free()

        # [pipeline]: 4 stages of MiniCPM blocks at float32, forward only
        pcfg = dataclasses.replace(cfg, compute_dtype="float32")
        smesh = make_mesh((pp["stages"],), ("stage",), dev.type)
        infos = lm.stack_infos(lm._block_infos(pcfg, moe_layer=False), pp["layers"])

        def stage_params(s):
            gen = torch.Generator(device=dev)
            gen.manual_seed(PIPE_SEED + s)
            return materialize(infos, gen, dev)

        positions = torch.arange(pp["tokens"], device=dev)[None]

        @torch.no_grad()
        def stage_fn(p, x):
            for pl in lm._layers(p):
                x = lm._block_apply(pcfg, pl, x, positions)[0]
            return x

        gen = torch.Generator(device=dev)
        gen.manual_seed(PIPE_SEED)
        x = torch.randn((pp["micro"], 1, pp["tokens"], pcfg.d_model), generator=gen, device=dev)
        s = smesh.get_local_rank(0)
        mine = stage_params(s)
        # a leading [S] axis of which this rank holds only its own row
        stacked = _stage_view(mine, pp["stages"])
        pipeline_forward(stage_fn, stacked, x[:1], smesh)  # warm
        piped, pipe_ms = timed(lambda: pipeline_forward(stage_fn, stacked, x, smesh))
        res["pipeline"] = {"ms": pipe_ms, "bubble": (pp["stages"] - 1) / (pp["stages"] - 1
                                                                          + pp["micro"])}
        del mine, stacked
        free()
        if rank == 0:
            h = x
            for st in range(pp["stages"]):
                p = stage_params(st)
                h = torch.stack([stage_fn(p, h[j]) for j in range(pp["micro"])])
                del p
            top = float(h.abs().max())
            err = float((piped - h).abs().max())
            if not bool(torch.isfinite(piped).all()) or err > PIPE_TOL * top:
                raise AssertionError(f"[pipeline] max |pipeline - sequential| {err} > {PIPE_TOL} "
                                     f"* {top}")
            res["pipeline"]["err"] = err / top
            say(f"[pipeline] pipeline_forward over {pp['stages']} stages of {pp['layers']} "
                f"{TRAIN_ARCH} blocks (float32, d_model {pcfg.d_model}), M = {pp['micro']} "
                f"micro-batches of 1 x {pp['tokens']} tokens, forward: {pipe_ms:.1f} ms (CUDA "
                f"events, rank 0), bubble (S-1)/(S-1+M) = {res['pipeline']['bubble']:.4f}; "
                f"within {err / top:.3e} of the sequential trunk's largest hidden value on "
                f"one rank (limit {PIPE_TOL})")
            del h
        del piped
        free()

        res["hybrid"] = mesh_hybrid(torch, np, mesh, dev, card, rank, say, timed, peak, free)
        if (dict(K.LAUNCHES), dict(K.LAUNCHES_BY_KERNEL)) != launches:
            raise AssertionError(f"[mesh] rank {rank}: a TPU kernel launched: {K.LAUNCHES}")
        res["lines"] = lines
    finally:
        stack.close()
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def mesh_hybrid(torch, np, mesh, dev, card: bool, rank: int, say, timed, peak, free) -> dict:
    """[mesh hybrid], inside ``mesh_rank``: Zamba2-2.7B drawn from seed 0
    and sharded as it is drawn (bfloat16 weights), served on ``mesh``
    through the sharded prefill and decode bundles (``HYBRID_SERVE``), the
    greedy tokens the mesh's own; then the same weights at float32
    compute over the prefill and ``HYBRID_CHECK_STEPS`` decode steps.
    Rank 0 checks each run's last logits against the one-device
    model's on the same tokens: at float32 within ``HYBRID_TOL`` of the
    largest, in bfloat16 recorded.  ``card`` false: the reduced config
    on the CPU ranks."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.distributed import comm
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import describe
    from repro_torch.models import build_model
    from repro_torch.models.common import iter_leaves

    cfg = configs.get_config(HYBRID_ARCH)
    hv = dict(HYBRID_SERVE)
    if not card:
        cfg = configs.reduced(cfg)
        hv.update(prompt_len=16)
    b, t = hv["batch"], hv["prompt_len"]
    length = t + hv["gen_len"]
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, device=dev, mesh=mesh)
    build_s = time.perf_counter() - t0
    shard_bytes = sum(p.to_local().numel() * p.to_local().element_size()
                      for _, p in iter_leaves(model.params()))
    out = {"build_s": build_s, "shard_bytes": shard_bytes}
    for dtype, n_steps in (("bfloat16", hv["gen_len"]), ("float32", HYBRID_CHECK_STEPS)):
        if dtype == "float32":
            # the same weights at float32 compute: every use casts a weight
            # to the compute dtype (exactly, from bfloat16), so they stay
            # stored, and gathered, in bfloat16
            model = type(model)(dataclasses.replace(cfg, compute_dtype="float32"),
                                model.params())
        if card:
            torch.cuda.reset_peak_memory_stats()
        shape = lambda kind: dataclasses.replace(  # noqa: E731
            configs.SHAPES["decode_32k"], kind=kind, seq_len=length, global_batch=b)
        pre = tsteps.build_prefill_step(model, mesh, shape("prefill"))
        dec = tsteps.build_decode_step(model, mesh, shape("decode"))
        cache = model.init_cache(b, length)
        (lg, cache), pre_ms = timed(lambda: pre(model.params(), {"tokens": prompts}, cache))
        logits = [lg.full_tensor()[:, -1, :cfg.vocab_size].float().cpu()]
        toks = [logits[-1].argmax(-1).to(torch.int32)]
        dec_ms, counts = [], None
        for i in range(n_steps):
            pos = np.full((b, 1), t + i, np.int32)
            with comm.CollectiveLog() as log:
                (lg, cache), ms = timed(lambda: dec(model.params(), cache,
                                                    toks[-1].numpy()[:, None], pos))
            counts = counts or {"counts": dict(log.counts), "sent": dict(log.sent)}
            dec_ms.append(ms)
            logits.append(lg.full_tensor()[:, -1, :cfg.vocab_size].float().cpu())
            toks.append(logits[-1].argmax(-1).to(torch.int32))
        out[dtype] = {"prefill_ms": pre_ms, "decode_ms": dec_ms, "peak": peak(),
                      "step_collectives": counts, "logits": logits, "tokens": toks}
        del cache, lg, pre, dec
        free()
    del model
    free()
    if rank == 0:
        one = build_model(cfg, seed=0, device=dev)
        for dtype in ("bfloat16", "float32"):
            if dtype == "float32":  # the same weights at float32 compute, as on the mesh
                one = type(one)(dataclasses.replace(cfg, compute_dtype="float32"), one.params())
            run = out[dtype]
            cache = one.init_cache(b, length)
            lg, cache = one.prefill({"tokens": prompts}, cache)
            ref = [lg[:, -1, :cfg.vocab_size].float().cpu()]
            for i in range(len(run["decode_ms"])):
                pos = np.full((b, 1), t + i, np.int32)
                lg, cache = one.decode_step(run["tokens"][i].numpy()[:, None], cache, pos)
                ref.append(lg[:, -1, :cfg.vocab_size].float().cpu())
            worst = 0.0
            for i, (a, r) in enumerate(zip(run["logits"], ref)):
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"[mesh hybrid] {dtype} step {i}: logits not finite")
                worst = max(worst, float((a - r).abs().max()) / float(r.abs().max()))
            run["worst"] = worst
            if dtype == "float32" and worst > HYBRID_TOL:
                raise AssertionError(f"[mesh hybrid] float32: max |mesh - one device| is "
                                     f"{worst} of the largest logit > {HYBRID_TOL}")
            del cache, lg
        del one
        if card:
            torch.cuda.empty_cache()
        f, h = out["float32"], out["bfloat16"]
        say(f"[mesh hybrid] {HYBRID_ARCH} ({cfg.num_layers} Mamba2 layers, d_model "
            f"{cfg.d_model}, the shared block every {cfg.hybrid.shared_attn_every}; seed 0, "
            f"{shard_bytes} bytes of bfloat16 shards a rank, built in {build_s:.1f} s) served on "
            f"{describe(mesh)}: the sharded prefill ({b} x {t}) and {hv['gen_len']} decode steps. "
            f"bfloat16: prefill {h['prefill_ms']:.1f} ms, decode ms "
            f"{[round(x, 1) for x in h['decode_ms']]} (CUDA events); last logits within "
            f"{h['worst']:.3e} of the largest against the one-device model (recorded). float32 "
            f"compute on the same weights, the prefill and {len(f['decode_ms'])} of the steps: "
            f"prefill {f['prefill_ms']:.1f} ms, decode ms "
            f"{[round(x, 1) for x in f['decode_ms']]}; last logits within {f['worst']:.3e} of "
            f"the largest against the one-device model at float32 compute (limit "
            f"{HYBRID_TOL}); one bfloat16 decode step's collectives "
            f"{h['step_collectives']['counts']}, bytes a rank sends "
            f"{h['step_collectives']['sent']}")
    free()
    for dtype in ("bfloat16", "float32"):
        out[dtype].pop("logits")
        out[dtype]["tokens"] = [x.tolist() for x in out[dtype]["tokens"]]
    return out


def _stage_view(tree: dict, n: int) -> dict:
    """``tree``'s leaves as ``[n, ...]`` leaves that hold only the one row
    (an expand costs no memory): ``pipeline_forward`` takes its own
    stage's row."""
    from repro_torch.models.common import map_tree

    return map_tree(lambda _, a: a.unsqueeze(0).expand((n,) + tuple(a.shape)), tree)


def phase_mesh(torch, K, loss0: float, args, device: str = "cuda") -> dict:
    """[mesh train], [mesh comm], [mesh train reduced], [mesh serve] and
    [pipeline] over MESH_RANKS spawned ranks: one NCCL rank per card with
    four cards or more, else gloo ranks sharing card 0.  Step 0's loss is
    held within MESH_LOSS0_RTOL of ``loss0`` ([train]'s one-device step 0
    on the same seed and batch) and every step's loss must be finite.
    ``device="cpu"`` rehearses them on gloo CPU ranks (``mesh_rank``).
    Every process started is joined or killed here."""
    import multiprocessing as mp
    import tempfile

    d = MESH_RANKS
    nccl = device == "cuda" and torch.cuda.device_count() >= d
    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=root)
    ctx = mp.get_context("spawn")
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(d)]
    procs = [ctx.Process(target=mesh_rank, args=(r, d, args.src, os.path.join(tmp, "store"),
                                                 outs[r], nccl, device))
             for r in range(d)]
    where = "on the card" if device == "cuda" else "on the CPU (rehearsal)"
    log(f"[mesh] {d} ranks: {'nccl, one card each' if nccl else 'gloo, sharing card 0'} "
        f"({torch.cuda.device_count()} card(s)); every tensor {where}")
    t0 = time.perf_counter()
    try:
        for proc in procs:
            proc.start()
        # a rank that fails leaves the others waiting in a collective: stop
        # them all as soon as one fails
        while time.perf_counter() - t0 < MESH_JOIN_SECONDS and any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
    secs = time.perf_counter() - t0
    codes = [proc.exitcode for proc in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"[mesh] ranks exited {codes} after {secs:.1f} s")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    train = ranks[0]["train"]
    first, one = train["metrics"][0]["loss"], train["one_device_loss0"]
    if not all(math.isfinite(m["loss"]) for r in ranks for m in r["train"]["metrics"]):
        raise AssertionError("[mesh train] a loss is not finite")
    # at full depth the one-device step 0 is [train]'s own (``loss0``)
    full = loss0 is not None and train["layers"] == TRAIN_LAYERS
    for what, want in (("one device", one), ("[train]", loss0 if full else None)):
        if want is not None and abs(first - want) > MESH_LOSS0_RTOL * abs(want):
            raise AssertionError(f"[mesh train] step 0's loss {first} is not within "
                                 f"{MESH_LOSS0_RTOL} relative of {what}'s {want}")
    log(f"[mesh train] step 0's loss {first:.4f} against the one-device model's {one:.4f} at "
        f"{train['layers']} layers from the same weights and rows (limit {MESH_LOSS0_RTOL} "
        f"relative; [train]'s at all {TRAIN_LAYERS}: {loss0}); backend {ranks[0]['backend']}; "
        f"peak per rank "
        f"{[r['train']['peak'] for r in ranks]} bytes in training (building and sharding the "
        f"model: {[r['train']['build_peak'] for r in ranks]}), "
        f"{[r['serve']['peak'] for r in ranks]} serving; no TPU kernel launched on any rank")
    hyb = [r["hybrid"] for r in ranks]
    log(f"[mesh hybrid] peak per rank {[h['bfloat16']['peak'] for h in hyb]} bytes serving in "
        f"bfloat16, {[h['float32']['peak'] for h in hyb]} at float32 compute; shards "
        f"{[h['shard_bytes'] for h in hyb]} bytes; no TPU kernel launched on any rank")
    log(f"[mesh] phase wall {secs:.1f} s with the ranks' start-up")
    return {"seconds": secs, "ranks": ranks, "nccl": nccl}


# ----------------------------------------------------------------------
# phase 19: the dry-run on fake tensors
# ----------------------------------------------------------------------
DRYRUN_JOIN_SECONDS = 600
# the production cells are traced at 1 and 2 layers and extrapolated to
# all 40 (dryrun.extrapolated; exactly the full trace's record on the CPU,
# where the full traces take ~47 s each): traced whole, they took 105-113
# s each on the chip machine's host, and at 2 and 4 layers 21 s
DRYRUN_LAYERS = (1, 2)


def dryrun_cells(src: str, out: str) -> None:
    """In a spawned process (a fake process group of its own): the torch
    dry-run of ``[mesh train]``'s configuration on 2x2 (MiniCPM-2B at
    ``MESH_LAYERS``, ``MESH_TRAIN``'s batch), then ``minicpm-2b x
    train_4k`` on the production meshes (extrapolated from
    ``DRYRUN_LAYERS``).  Writes the records as JSON."""
    sys.path.insert(0, src)
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import dryrun


    torch_cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH), num_layers=MESH_LAYERS)
    t = MESH_TRAIN
    shape = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=t["seq_len"],
                                global_batch=t["global_batch"])
    recs = {"mesh": dryrun.run_cell(TRAIN_ARCH, "train_4k", "single", verbose=False,
                                    cfg=torch_cfg, shape=shape,
                                    mesh_dims=(MESH_SHAPE, ("data", "model")))}
    for kind in ("single", "multi"):
        recs[kind] = dryrun.run_cell(TRAIN_ARCH, "train_4k", kind, verbose=False,
                                     layers=DRYRUN_LAYERS)
    with open(out, "w") as f:
        json.dump(recs, f)


def phase_dryrun(torch, args, mesh_run=None) -> dict:
    """[dryrun]: ``dryrun_cells`` in a spawned process (a fake process
    group of its own; it needs no card), joined or killed here.  With
    ``mesh_run`` (``phase_mesh``'s result), the 2x2 record's micro-step
    collectives must equal ``[mesh comm]``'s measured counts and bytes on
    every rank, and its predicted peak is printed beside the measured
    training peak."""
    import multiprocessing as mp
    import tempfile

    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    out = os.path.join(tempfile.mkdtemp(prefix="dryrun_", dir=root), "cells.json")
    proc = mp.get_context("spawn").Process(target=dryrun_cells, args=(args.src, out))
    t0 = time.perf_counter()
    proc.start()
    try:
        proc.join(DRYRUN_JOIN_SECONDS)
    finally:
        if proc.is_alive():
            proc.kill()
        proc.join()
    secs = time.perf_counter() - t0
    if proc.exitcode != 0:
        raise AssertionError(f"[dryrun] exited {proc.exitcode} after {secs:.1f} s")
    with open(out) as f:
        recs = json.load(f)
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    mesh = recs["mesh"]
    micro = mesh["micro_step"]
    log(f"[dryrun] {TRAIN_ARCH} at {MESH_LAYERS} layers on a fake 2x2 (data, model) group, "
        f"[mesh train]'s step traced on fake tensors in {mesh['trace_s']} s: a micro-step's "
        f"collectives {micro['collective_counts']}, bytes a rank sends "
        f"{micro['collective_bytes']}; arguments {mesh['memory']['argument_size_in_bytes']} "
        f"bytes a rank, predicted peak {mesh['memory']['peak_live_bytes']} bytes "
        f"({mesh['memory']['peak_live_bytes'] / 2**30:.2f} GiB); {mesh['cost']['flops']:.6g} "
        f"FLOPs a rank a step ({mesh['n_micro']} micro-steps, one traced)")
    if mesh_run is not None:
        measured = [r["train"]["peak"] for r in mesh_run["ranks"]]
        for r in mesh_run["ranks"]:
            got = (r["comm"]["counts"], r["comm"]["sent"])
            if got != (micro["collective_counts"], micro["collective_bytes"]):
                raise AssertionError(f"[dryrun] rank {r['rank']}'s measured micro-step "
                                     f"collectives {got} differ from the dry-run's "
                                     f"{micro['collective_counts']}, {micro['collective_bytes']}")
        log(f"[dryrun] == [mesh comm]'s measured counts and bytes on every rank; predicted peak "
            f"{mesh['memory']['peak_live_bytes'] / 2**30:.2f} GiB a rank against the measured "
            f"{[round(x / 2**30, 2) for x in measured]} GiB in [mesh train]")
    for kind in ("single", "multi"):
        r = recs[kind]
        log(f"[dryrun] {TRAIN_ARCH} x train_4k x {kind} ({r['n_devices']} ranks, fake group; "
            f"traced at {r['layers_traced']} layers, extrapolated to all 40): "
            f"arguments {r['memory']['argument_size_in_bytes']} bytes a rank, peak "
            f"{r['memory']['peak_live_bytes']} ({r['memory']['peak_live_bytes'] / 2**30:.2f} "
            f"GiB), {r['cost']['flops']:.6g} FLOPs a rank a step ({r['n_micro']} micro-steps, "
            f"one traced), collectives {r['collective_counts']}, bytes a rank sends "
            f"{r['collective_bytes']}; traced in {r['trace_s']} s")
    log(f"[dryrun] phase wall {secs:.1f} s with the process's start-up")
    return {"seconds": secs, "cells": recs}


# ----------------------------------------------------------------------
# --only staging: the forms of a gloo collective on ranks sharing a card
# ----------------------------------------------------------------------
STAGING_MB = (5, 13, 283)  # a layer's smaller and larger FSDP shards, the embedding's
STAGING_REPS = 3


def staging_rank(rank: int, d: int, store: str, out: str) -> None:
    """One of ``d`` gloo ranks on card 0, in pairs (the data groups of a
    2x2 mesh): the all-gather and the reduce-scatter of shards of
    ``STAGING_MB`` MB, as plain c10d collectives on the card tensors
    (gloo stages them through pinned host memory itself;
    ``distributed.staged``) and as a copy to pageable host memory, a
    host collective and a copy back; ms each, mean of ``STAGING_REPS``,
    both forms equal.  Writes JSON to ``out``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, d), rank=rank, world_size=d)
    groups = [dist.new_group(list(range(i, i + 2))) for i in range(0, d, 2)]
    g = groups[rank // 2]
    res = {}

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(STAGING_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / STAGING_REPS * 1e3

    try:
        for mb in STAGING_MB:
            x = torch.randn(mb * 2**18, device=dev)
            full = torch.randn(2 * x.numel(), device=dev)

            def gather_card():
                o = torch.empty(2 * x.numel(), device=dev)
                dist.all_gather_into_tensor(o, x, group=g)
                return o

            def gather_host():
                o = torch.empty(2 * x.numel())
                dist.all_gather_into_tensor(o, x.cpu(), group=g)
                return o.to(dev)

            def scatter_card():
                o = torch.empty(x.numel(), device=dev)
                dist.reduce_scatter_tensor(o, full, group=g)
                return o

            def scatter_host():
                o = torch.empty(x.numel())
                dist.reduce_scatter_tensor(o, full.cpu(), group=g)
                return o.to(dev)

            if not (torch.equal(gather_card(), gather_host())
                    and torch.equal(scatter_card(), scatter_host())):
                raise AssertionError(f"[staging] rank {rank}: the two forms differ at {mb} MB")
            res[f"{mb}MB"] = {"all_gather_card": ms(gather_card), "all_gather_host": ms(gather_host),
                              "reduce_scatter_card": ms(scatter_card),
                              "reduce_scatter_host": ms(scatter_host)}
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def phase_staging() -> dict:
    """``--only staging``: ``staging_rank`` on 4 spawned gloo ranks sharing
    card 0; rank 0's ms by shard size.  Every process is joined or
    killed here."""
    import multiprocessing as mp
    import tempfile

    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="staging_", dir=root)
    ctx = mp.get_context("spawn")
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(MESH_RANKS)]
    procs = [ctx.Process(target=staging_rank, args=(r, MESH_RANKS, os.path.join(tmp, "store"),
                                                    outs[r])) for r in range(MESH_RANKS)]
    try:
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(MESH_JOIN_SECONDS)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
    if any(proc.exitcode != 0 for proc in procs):
        raise AssertionError(f"[staging] ranks exited {[proc.exitcode for proc in procs]}")
    with open(outs[0]) as f:
        res = json.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


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
    ap.add_argument("--only", choices=("train", "mesh", "staging", "dryrun"),
                    help="run only [train]'s launcher steps, only the mesh phases (and the "
                         "dry-run against them), only the staging comparison or only the "
                         "dry-run, and print one JSON line")
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2

    from repro_torch import runtime, serve
    from repro_torch.core import constructions, distributed, gf, layers, planner, protocol
    from repro_torch.kernels.modmatmul import fuzz
    from repro_torch.kernels.modmatmul import kernel as K
    from repro_torch.kernels.modmatmul import ops, ref
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
    if args.only == "train":
        from repro_torch.launch import train as launcher

        _, _, steps, _, peak = train_in_process(torch, launcher, TRAIN_ARGV, "train")
        print(json.dumps({"src": args.src, "step_ms": [m["ms"] for m in steps],
                          "loss": [m["loss"] for m in steps], "peak": peak, "device": smi}))
        return 0
    if args.only == "mesh":
        run = phase_mesh(torch, K, None, args)
        dry = phase_dryrun(torch, args, run)
        print(json.dumps({"seconds": run["seconds"], "nccl": run["nccl"],
                          "ranks": [{k: v for k, v in r.items() if k != "lines"}
                                    for r in run["ranks"]], "dryrun": dry, "device": smi}))
        return 0
    if args.only == "dryrun":
        print(json.dumps({"dryrun": phase_dryrun(torch, args), "device": smi}))
        return 0
    if args.only == "staging":
        print(json.dumps({"ms": phase_staging(), "device": smi}))
        return 0

    t0 = time.perf_counter()
    walls = {}

    def timed_phase(name, fn, *a, **kw):
        # each phase's wall, for PERF.md's account of where the time goes
        w0 = time.perf_counter()
        out = fn(*a, **kw)
        walls[name] = round(time.perf_counter() - w0, 1)
        log(f"[time] {name} {walls[name]} s (script at {time.perf_counter() - t0:.1f} s)")
        return out

    timed_phase("build", phase_build, K)
    timed_phase("kernels", phase_kernels, torch, K, ref, args.seed)
    timed_phase("wgmma_masked", time_wgmma_masked, torch, K, ref, args)
    main_run = timed_phase("main", phase_main, torch, K, protocol, layers, planner, constructions,
                           args)
    f32_run = timed_phase("f32", phase_f32, torch, K, protocol, planner, constructions, args)
    edge_run = timed_phase("edge", phase_edge, torch, K, protocol, planner, constructions,
                           runtime, scheduler, args)
    serve_run = timed_phase("serve", phase_serve, torch, K, serve, runtime, constructions, layers,
                            gf, protocol, scheduler, args)
    crt_run = timed_phase("crt", phase_crt, torch, K, layers, protocol, planner, constructions, gf,
                          ops, args)
    fuzz_run = timed_phase("fuzz", phase_fuzz, K, fuzz, args)
    model_run, moe_run, vlm_run = (
        timed_phase(tag, phase_model, torch, K, ref, ops, serve, layers, gf, protocol, scheduler,
                    args, tag=tag) for tag in ("model", "moe", "vlm"))
    encdec_run = timed_phase("encdec", phase_encdec, torch, args)
    xlstm_run = timed_phase("xlstm", phase_recurrent, torch, K, "xlstm")
    zamba_run = timed_phase("zamba", phase_recurrent, torch, K, "zamba")
    sharded_run = timed_phase("sharded", phase_sharded, torch, K, ref, protocol, distributed,
                              planner, constructions, runtime, serve, scheduler, layers, gf, args)
    train_run = timed_phase("train", phase_train, torch, K)
    mesh_run = timed_phase("mesh", phase_mesh, torch, K, train_run["steps"][0]["loss"], args)
    dryrun_run = timed_phase("dryrun", phase_dryrun, torch, args, mesh_run)
    entries = site_entries(torch, K, ref, protocol, ops, main_run, "int32", args)
    entries += site_entries(torch, K, ref, protocol, ops, f32_run, "f32", args)
    entries += edge_entries(torch, K, ref, protocol, ops, edge_run, args)
    entries += serve_entries(torch, K, ref, protocol, ops, serve_run, args)
    entries += model_entries(torch, K, ref, protocol, ops, model_run, args)
    entries += model_entries(torch, K, ref, protocol, ops, moe_run, args)
    entries += model_entries(torch, K, ref, protocol, ops, vlm_run, args)
    entries += sharded_entries(torch, K, ref, protocol, ops, sharded_run, entries, args)
    for name in K.KERNEL_NAMES:
        if not any(e["name"] == name and e["launches"] > 0 for e in entries):
            raise AssertionError(f"kernel {name} was not launched on its path")
    on_path = {n for by in (MAIN_BY_KERNEL, F32_BY_KERNEL) for d in by.values() for n in d}
    on_path |= {n for counts in edge_run["counts"].values() for n in counts}
    on_path |= {n for run in serve_run["runs"].values() for n in run["counts"]}
    on_path |= {n for run in crt_run.values() for n in run["launches"]}
    on_path |= set(model_run["counts"]) | set(moe_run["counts"]) | set(vlm_run["counts"])
    on_path |= {compiled for compiled, _ in sharded_run["counts"]}
    for name in on_path:
        if not any(e["kernel"] == name and e["launches"] > 0 for e in entries):
            raise AssertionError(f"compiled kernel {name} was not launched on its path")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"run_batched ms {main_run['times']}, backend='cuda' {f32_run['times']}, "
        f"peak {main_run['peak']} / {f32_run['peak']} bytes; edge peak {edge_run['peak']} bytes; "
        f"serve peak {serve_run['peak']} bytes; fuzz {fuzz_run['cases']} cases clean; "
        f"model peak {model_run['peak']} bytes; moe peak {moe_run['peak']} bytes; vlm peak "
        f"{vlm_run['peak']} bytes; encdec peak {encdec_run['peak']} bytes; xlstm peak "
        f"{xlstm_run['peak']} bytes; zamba peak {zamba_run['peak']} bytes; sharded peak "
        f"{max(sharded_run['peaks'].values())} bytes; train peak {train_run['peak']} bytes, "
        f"step {train_run['step_ms']:.3f} ms, phase {train_run['phase_s']:.1f} s; mesh phase "
        f"{mesh_run['seconds']:.1f} s; dryrun phase {dryrun_run['seconds']:.1f} s; phase walls "
        f"{walls}")
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
