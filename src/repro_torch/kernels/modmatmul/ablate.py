"""Ablation timing of the GF(p) matmul kernels on one GPU.

    PYTHONPATH=src python3 -m repro_torch.kernels.modmatmul.ablate [--reps 10]

Builds patched copies of ``repro_torch/csrc/`` side by side (one nvcc
each, all started together, under ``build/ablate/``), each with one part
of a kernel taken out, and times every copy at the main path's shapes
with the same inputs: what is left says what the removed part cost.
The patched copies compute wrong results by design; only the unpatched
build is checked against the plain version.  Prints one JSON line with
the card's name and power limit.  Needs a CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import kernel as K
from . import ref

P = 65521
_LOAD = "      if (ahead < ntiles) load_tile<VEC>(slot(ahead), a, b, m0, n0, ahead * BK, M, N, K, tid);\n"
_SPLIT = "      if (kt + 1 < ntiles) split_tile(slot(kt + 1), plane(kt + 1), tid);\n"
_PRODUCTS = "      products(plane(kt));\n"
_ACCUMULATE = "      if (k0 + kk < KB) accumulate(k0 + kk, x[kk]);"
_W1 = "#pragma unroll\n        for (int kk = 0; kk < 2 * BK / 16; ++kk) wgmma_f16(w1, d1 + 2 * kk, db + 2 * kk);\n"
_W0 = "#pragma unroll\n        for (int kk = 0; kk < 2 * BK / 16; ++kk) wgmma_f16(w0, d0 + 2 * kk, db + 2 * kk);\n"
_F32_LOAD = "      if (kt + AHEAD < ntiles) load_b(kt + AHEAD);\n"
_F32_SPLIT_B = "      split_b(ring + (kt % RING_STAGES) * SLOT_BYTES, b_planes + s * PLANE_B_BYTES);\n"
_F32_LOAD_A = "        if (kt + A_STAGES - 1 < ntiles) load_a(kt + A_STAGES - 1);\n"
_F32_PREPASS = "    split_a_planes<VEC><<<pgrid, 128, 0, stream>>>(P, a_split, ntiles);\n"
_F32_FOLD = "        w1[e] = fold_f(w1[e], P.pf, P.inv_p);\n        w0[e] = fold_f(w0[e], P.pf, P.inv_p);\n"
# name -> [(source file, text, replacement)]; the name's prefix before
# ":" is the design it patches (see DESIGN_OF)
VARIANTS = {
    "as built": [],
    "mma: staging only (no products)": [("int32_mma.cuh", _PRODUCTS, "")],
    "mma: products only (no loads, no split)": [("int32_mma.cuh", _LOAD, ""), ("int32_mma.cuh", _SPLIT, "")],
    "mma: load addresses not unrolled": [
        ("int32_mma.cuh", f"#pragma unroll\n    for (int l = 0; l < {n} / 4 / THREADS; ++l) {{",
         f"#pragma unroll 1\n    for (int l = 0; l < {n} / 4 / THREADS; ++l) {{")
        for n in ("TILE_A_INTS", "STAGE_B_INTS")
    ],
    "skinny: loads and stores only": [  # keeps the loads alive, drops the arithmetic
        ("skinny.cuh", _ACCUMULATE,
         '      if (k0 + kk < KB) asm volatile("" ::"r"(x[kk][0] ^ x[kk][COLS - 1]));')
    ],
    "skinny: f32 long finish only": [  # two mod_f per output at every T, not only past 64
        ("skinny.cuh", "const bool short_sum = T <= SKINNY_F32_SHORT_TERMS;", "const bool short_sum = false;")],
    "f32_wgmma: staging only (no products)": [("f32_wgmma.cuh", _W1, ""), ("f32_wgmma.cuh", _W0, "")],
    "f32_wgmma: products only (no loads, no split)": [
        ("f32_wgmma.cuh", x, "") for x in (_F32_LOAD, _F32_SPLIT_B, _F32_LOAD_A, _F32_PREPASS)],
    "f32_wgmma: no fold": [("f32_wgmma.cuh", _F32_FOLD, "")],
    "f32_wgmma: no A copies": [("f32_wgmma.cuh", _F32_LOAD_A, "")],
    "f32_wgmma: main kernel only (no A split pre-pass)": [("f32_wgmma.cuh", _F32_PREPASS, "")],
    "f32_wgmma: 1 producer warpgroup": [
        ("f32_wgmma.cuh", "constexpr int PRODUCERS = 2;", "constexpr int PRODUCERS = 1;"),
        ("f32_wgmma.cuh", "constexpr int PRODUCER_REGS = 40;", "constexpr int PRODUCER_REGS = 56;"),
        ("f32_wgmma.cuh", "constexpr int CONSUMER_REGS = 216;", "constexpr int CONSUMER_REGS = 224;")],
    "f32_wgmma: no B split": [("f32_wgmma.cuh", _F32_SPLIT_B, "")],
    "f32_wgmma: 2 B plane buffers": [
        ("f32_wgmma.cuh", "constexpr int PLANE_STAGES = 3;", "constexpr int PLANE_STAGES = 2;")],
}
# compiled design -> the prefix of the variants that patch it
DESIGN_OF = {"int32_mma": "mma:", "int32_skinny": "skinny:", "f32_wgmma": "f32_wgmma:",
             "f32_skinny": "skinny:"}
# site -> (compiled design, a shape, b shape)
SITES = {
    "P2 multiply": ("int32_mma", (68, 256, 2560), (68, 2560, 2048)),
    "P1 share B": ("int32_skinny", (17, 6), (4, 6, 5242880)),
    "P2 mix": ("int32_skinny", (17, 17), (4, 17, 524288)),
    "P2 multiply f32": ("f32_wgmma", (68, 256, 2560), (68, 2560, 2048)),
    "P1 share B f32": ("f32_skinny", (17, 6), (4, 6, 5242880)),
    "P2 mix f32": ("f32_skinny", (17, 17), (4, 17, 524288)),
}


def build(name: str, patches, root: Path):
    d = root / re.sub(r"\W+", "_", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(K.CSRC, d)
    for fname, old, new in patches:
        text = (d / fname).read_text()
        if old not in text:
            raise ValueError(f"{name}: the text to patch is not in {fname} any more: {old!r}")
        (d / fname).write_text(text.replace(old, new))
    log = K.compile_library(d / K.SOURCE.name, d / "lib.so")
    spills = [ln.strip() for ln in log.splitlines() if "spill" in ln and "0 bytes spill stores" not in ln]
    return K.bind(d / "lib.so"), spills


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA GPU")
    root = K.build_dir().parent / "ablate"
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv, root), VARIANTS.items())))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    result = {}
    for site, (design, sa, sb) in SITES.items():
        a = torch.randint(0, P, sa, generator=gen, device="cuda", dtype=torch.int32)
        b = torch.randint(0, P, sb, generator=gen, device="cuda", dtype=torch.int32)
        batch, m, _, n = K._geometry(a, b)
        out = torch.empty((batch, m, n), dtype=torch.int32, device="cuda")
        for name, (lib, _) in built.items():
            if name != "as built" and not name.startswith(DESIGN_OF[design]):
                continue  # a patch of another kernel
            if K.launch_into(lib, design, a, b, out, P):
                raise RuntimeError(f"{name} at {site}: launch failed")
            torch.cuda.synchronize()
            variant = design.split("_")[0]
            if name == "as built" and not torch.equal(out, ref.PLAIN[variant](a, b, P)):
                raise AssertionError(f"the unpatched {design} kernel is wrong at {site}")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                K.launch_into(lib, design, a, b, out, P)
            end.record()
            end.synchronize()
            result.setdefault(site, {})[name] = round(start.elapsed_time(end) / args.reps, 4)
        del a, b, out
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    spills = {name: s for name, (_, s) in built.items() if s}
    print(json.dumps({"device": smi, "ms": result, "spills": spills}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
