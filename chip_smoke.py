#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port of the coded-MPC engine on one GPU.

    python3 chip_smoke.py [--seed 0] [--batch 4] [--reps 5]

Phases (each raises on failure; the exit code is then not 0):

1. build   — compile ``src/repro_torch/csrc/modmatmul.cu`` with nvcc and
             print the build time, the compiler's register report and
             the card's name and power limit;
2. kernels — every kernel (int32 and f32-limb, plain and fused-mask)
             against its plain PyTorch version on the card, on ragged,
             shared-operand, deep and adversarial shapes: exact equality;
3. main    — ``run_batched`` (AGE, s = t = z = 2) at the width of one
             Mistral-NeMo-12B attention projection: a = X^T for a
             512-token chunk [batch, 5120, 512], b = W_q [batch, 5120,
             4096], unfused and fused, Y checked exactly against a
             float64 matmul mod p; the launch counts prove the kernels
             carried the path; then ``secure_matmul_batched`` once;
4. f32     — ``run_batched(backend="cuda")`` at depth 1024, so the
             f32-limb kernel is proven on the path too;
5. timing  — each kernel at each launch site of its path: time, plain
             version, bound, library call; printed as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.  Without a GPU the
script exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

P = 65521
SOURCE = "src/repro_torch/csrc/modmatmul.cu"
TPU_KERNELS = {
    "modmatmul_int32": "src/repro/kernels/modmatmul/kernel.py:152",
    "modmatmul_f32": "src/repro/kernels/modmatmul/kernel.py:101",
    "modmatmul_int32_masked": "src/repro/kernels/modmatmul/kernel.py:193",
    "modmatmul_f32_masked": "src/repro/kernels/modmatmul/kernel.py:193",
}
# Published peaks of one H100 SXM (dense): HBM bytes/s, int8 tensor-core
# ops/s (the rate the limb dots map onto), 32-bit ALU ops/s outside the
# tensor cores (the threefry mask stream).
HBM_BPS = 3.35e12
INT8_TC_OPS = 1979e12
ALU_OPS = 67e12
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
        if "registers" in line or "spill" in line:
            log("[build]", line.strip())


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


def phase_kernels(torch, K, ref, seed: int) -> int:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    layouts = [
        ((3, 17, 129), (3, 129, 100)),  # batched x batched
        ((17, 6), (4, 6, 1000)),  # 2D x batched (shared LHS)
        ((2, 70, 300), (300, 65)),  # batched x 2D (shared RHS)
        ((5, 7), (7, 3)),  # 2D x 2D
    ]
    ragged = [((2, 33, k), (2, k, 77)) for k in (127, 128, 129, 255, 256, 257)]
    deep = [((1, 40, 8192), (1, 8192, 50))]
    cases = [(sa, sb, mode) for sa, sb in layouts + ragged + deep
             for mode in ("uniform", "maximal", "high_limb")]
    # one fold of the int32 accumulators is 33024 deep: cross it twice
    cases.append(((3, 70000), (70000, 5), "maximal"))
    n = 0
    for variant in ("int32", "f32"):
        for sa, sb, mode in cases:
            a, b = draw(torch, gen, sa, mode), draw(torch, gen, sb, mode)
            # z = 3 and z = 6: within and across one 4-row pass of the
            # epilogue's mask generation
            v = draw(torch, gen, (sa[-2], 3 if n % 4 else 6), mode)
            key = (seed + 1, 1000 + n)
            got = K.modmatmul_cuda(a, b, P, variant)
            want = ref.PLAIN[variant](a, b, P)
            gotm = K.modmatmul_masked_cuda(a, b, v, key, P, variant)
            wantm = ref.modmatmul_masked_plain(a, b, v, key, P, variant)
            torch.cuda.synchronize()
            for tag, g_, w_ in (("plain", got, want), ("masked", gotm, wantm)):
                if g_.shape != w_.shape or not torch.equal(g_, w_):
                    raise AssertionError(
                        f"{variant} {tag} kernel != plain version at {sa} @ {sb} ({mode})"
                    )
            n += 2
    log(f"[kernels] {n} kernel launches equal their plain versions exactly")
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


def drive(torch, K, protocol, plan, a, b, want, *, backend, fused, tag, seed):
    """One run_batched with the counts zeroed just before and read just
    after; checks Y exactly.  Returns {kernel: Counter of shapes}."""
    K.reset_launch_counts()
    y, _ = protocol.run_batched(plan, a, b, seed=seed, backend=backend, fused_masks=fused)
    torch.cuda.synchronize()
    counts = {name: dict(K.LAUNCH_SHAPES[name]) for name in K.KERNEL_NAMES}
    totals = {name: K.LAUNCHES[name] for name in K.KERNEL_NAMES}
    if y.shape != want.shape or not torch.equal(y, want):
        bad = int((y != want).sum()) if y.shape == want.shape else -1
        raise AssertionError(f"[{tag}] Y differs from the float64 oracle in {bad} entries")
    log(f"[{tag}] Y exact {tuple(y.shape)}; launches {totals}")
    return counts, totals


def expect_launches(totals, kernel, masked_kernel, fused: bool, tag: str) -> None:
    want = {kernel: 2, masked_kernel: 3} if fused else {kernel: 6, masked_kernel: 0}
    got = {k: totals[k] for k in want}
    others = {k: v for k, v in totals.items() if k not in want and v}
    if got != want or others:
        raise AssertionError(f"[{tag}] launches {totals}, expected {want}")


def phase_main(torch, K, protocol, layers, planner, constructions, args) -> dict:
    scheme = constructions.build_scheme("age", 2, 2, 2)
    batch, k, ma, mb = args.batch, 5120, 512, 4096
    plan = planner.get_plan(scheme, planner.BlockShapes(k=k, ma=ma, mb=mb, s=2, t=2))
    log(f"[main] AGE s=t=z=2: n_total={plan.n_total} thr={plan.decode_threshold}; "
        f"a [{batch}, {k}, {ma}] (X^T, 512 tokens x d_model 5120), "
        f"b [{batch}, {k}, {mb}] (W_q, 5120 x 32*128)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    a = torch.randint(0, P, (batch, k, ma), generator=gen, device="cuda", dtype=torch.int32)
    b = torch.randint(0, P, (batch, k, mb), generator=gen, device="cuda", dtype=torch.int32)
    want = oracle_y(torch, a, b)

    torch.cuda.reset_peak_memory_stats()
    counts = {}
    for fused in (False, True):
        tag = "main fused" if fused else "main unfused"
        c, totals = drive(torch, K, protocol, plan, a, b, want,
                          backend="auto", fused=fused, tag=tag, seed=args.seed)
        expect_launches(totals, "modmatmul_int32", "modmatmul_int32_masked", fused, tag)
        counts[fused] = c
    peak = torch.cuda.max_memory_allocated()

    times = {}
    for fused in (False, True):
        ms = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            protocol.run_batched(plan, a, b, seed=args.seed, fused_masks=fused)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        times["fused" if fused else "unfused"] = statistics.median(ms)
    log(f"[main] run_batched median ms over {args.reps}: {times}; "
        f"peak allocated {peak / 2**30:.2f} GiB")

    # the float API once, same shapes; exact against the quantized oracle
    gf = torch.Generator(device="cuda")
    gf.manual_seed(args.seed + 1)
    af = torch.randn((batch, k, ma), generator=gf, device="cuda", dtype=torch.float64)
    bf = torch.randn((batch, k, mb), generator=gf, device="cuda", dtype=torch.float64) * 0.02
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
    scheme = constructions.build_scheme("age", 2, 2, 2)
    batch, k, ma, mb = args.batch, 1024, 512, 4096
    plan = planner.get_plan(scheme, planner.BlockShapes(k=k, ma=ma, mb=mb, s=2, t=2))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 2)
    a = torch.randint(0, P, (batch, k, ma), generator=gen, device="cuda", dtype=torch.int32)
    b = torch.randint(0, P, (batch, k, mb), generator=gen, device="cuda", dtype=torch.int32)
    want = oracle_y(torch, a, b)
    counts = {}
    for fused in (False, True):
        tag = "f32 fused" if fused else "f32 unfused"
        c, totals = drive(torch, K, protocol, plan, a, b, want,
                          backend="cuda", fused=fused, tag=tag, seed=args.seed)
        expect_launches(totals, "modmatmul_f32", "modmatmul_f32_masked", fused, tag)
        counts[fused] = c
    return {"plan": plan, "counts": counts, "batch": batch}


# ----------------------------------------------------------------------
# phase 5: per-site timing and the kernels line
# ----------------------------------------------------------------------
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
            n_launch = run["counts"][fused][name].get(shape, 0)
            if n_launch < 1:
                raise AssertionError(f"{name} never launched at {site} {shape}")
            key = (name, site)
            if key in seen:  # the same site in the other run: add its launches
                seen[key]["launches"] += n_launch
                continue
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
            plain_ms = cuda_ms(torch, plain, reps)
            library_ms = None
            if not masked:  # float64 matmul + remainder: exact while K*(p-1)**2 < 2**53
                a64, b64 = a.double(), b.double()
                library_ms = cuda_ms(
                    torch, lambda: torch.remainder(torch.matmul(a64, b64), P), reps
                )
                del a64, b64
            B, M, Kd, N = shape
            nbytes = 4 * (a.numel() + b.numel() + B * M * N + (v.numel() if masked else 0))
            tc_ops = 8 * B * M * (Kd + (z if masked else 0)) * N
            alu_ops = (B * z * N * THREEFRY_OPS + B * M * N * z * MASK_TERM_OPS) if masked else 0
            t_bytes = nbytes / HBM_BPS * 1e3
            t_ops = (tc_ops / INT8_TC_OPS + alu_ops / ALU_OPS) * 1e3
            entry = {
                "name": name,
                "site": site,
                "shape": f"{list(sa)}@{list(sb)}" + (f"+v{[sa[-2], z]}" if masked else ""),
                "route": "cuda",
                "source": SOURCE,
                "replaces": TPU_KERNELS[name],
                "launches": n_launch,
                "max_abs_err": err,
                "ms": round(ms, 4),
                "plain_ms": round(plain_ms, 4),
                "bound_ms": round(max(t_bytes, t_ops), 4),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None if library_ms is None else round(library_ms, 4),
            }
            seen[key] = entry
            entries.append(entry)
            log(f"[timing] {name:24s} {site:12s} {entry['shape']:44s} "
                f"{ms:9.3f} ms  plain {plain_ms:9.3f}  bound {entry['bound_ms']:7.3f} "
                f"({entry['bound_by']})  library {library_ms}")
            del a, b, v
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2

    from repro_torch.core import constructions, layers, planner, protocol
    from repro_torch.kernels.modmatmul import kernel as K
    from repro_torch.kernels.modmatmul import ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")

    t0 = time.perf_counter()
    phase_build(K)
    phase_kernels(torch, K, ref, args.seed)
    main_run = phase_main(torch, K, protocol, layers, planner, constructions, args)
    f32_run = phase_f32(torch, K, protocol, planner, constructions, args)
    entries = site_entries(torch, K, ref, main_run, "int32", args)
    entries += site_entries(torch, K, ref, f32_run, "f32", args)
    for name in K.KERNEL_NAMES:
        if not any(e["name"] == name and e["launches"] > 0 for e in entries):
            raise AssertionError(f"kernel {name} was not launched on its path")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"run_batched ms {main_run['times']}, peak {main_run['peak']} bytes")
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
