"""Differential fuzzing library for the GF(p) matmul backends.

The counterpart of ``repro.kernels.modmatmul.fuzz``.  Every backend must
agree bit-for-bit with the host oracle — an object-dtype
(arbitrary-precision) integer matmul reduced mod p — on every shape,
prime, and operand distribution.  This module generates the cases and
runs the comparison.

Case space (the reference's: the same seed gives the same ``Case`` and
the same operand arrays):

* engines — the plain versions on CPU tensors (``f32limb``, ``int32``),
  the Hopper kernels on CUDA tensors (``cuda``, ``cuda_int32``: the
  counterparts of the reference's ``pallas`` / ``pallas_int32``), and
  the dual-prime ``crt`` route (checked against the oracle mod p1*p2);
  besides, the same product through ``mod_matmul_rows_plus`` (the
  degree reduction's form, the skinny kernel's loaded-rows launch on the
  card: ``cuda_rows_plus``, ``cuda_int32_rows_plus``; its plain route
  on the CPU: ``int32_rows_plus``), on operands rearranged so that the
  form's result is a @ b (``rows_plus_operands``), and through
  ``mod_matmul_blocks_plus`` (the Phase-1 share's form, B's rows laid
  out as blocks of a larger x: ``cuda_blocks_plus``,
  ``cuda_int32_blocks_plus`` where ``skinny_fuses`` holds, the plain
  version elsewhere and in ``int32_blocks_plus``;
  ``blocks_plus_operands``),
* layouts — both operands batched, either side 2D (read with batch
  stride 0 by the kernels), both 2D,
* primes — small, mid, and the adjacent 16-bit maximals 65519/65521,
* operand modes — ``uniform`` draws; ``high_limb`` (both 8-bit limbs
  dense-high, maximizing every partial product); ``near_p`` (values
  within 8 of p, the Barrett conditional-subtract edge); ``maximal``
  (all p-1, the worst-case accumulator drive); ``sparse`` (mostly
  zeros).

Shapes are deliberately unaligned (primes, tile-boundary +/- 1), and
M, K = 31/33 straddle the skinny/tensor-core boundary of
``kernel.choose_design``; a slice of deep-K shapes (> 256) crosses the
plain int32 path's chunk boundary.

Engines take ``(a, b, p, device)``: the kernel engines need a CUDA
``device`` (default: the GPU) and raise on any other, and ``crt`` runs
its residues on ``device``; the plain engines always run on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .ops import (
    mod_matmul,
    mod_matmul_blocks_plus,
    mod_matmul_crt,
    mod_matmul_rows_plus,
    skinny_fuses,
)
from .ref import modmatmul_blocks_plus_plain

PRIMES = (3, 251, 257, 4093, 40961, 65519, 65521)
CRT_PRIMES = (65521, 65519)
MODES = ("uniform", "high_limb", "near_p", "maximal", "sparse")
LAYOUTS = ("batched", "lhs2d", "rhs2d", "2d")


def _engine_device(backend: str, kernel: bool, device) -> torch.device:
    if not kernel:
        return torch.device("cpu")
    from ...core.protocol import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(
            f"engine {backend!r} runs the CUDA kernels and needs a CUDA "
            f"device, got {device}"
        )
    return device


def _engine(backend: str, kernel: bool) -> Callable:
    def run(a, b, p, device=None):
        device = _engine_device(backend, kernel, device)
        out = mod_matmul(
            torch.as_tensor(a, dtype=torch.int32, device=device),
            torch.as_tensor(b, dtype=torch.int32, device=device),
            p=p, backend=backend,
        )
        return out.cpu().numpy().astype(np.int64)

    return run


def rows_plus_operands(a: np.ndarray, b: np.ndarray, p: int) -> tuple:
    """(a', h, rows, v, r) with a' @ h[..., rows, :] + v @ r == a @ b (mod p).

    b's first K' rows sit in a taller h among 3 rows of junk, in a
    shuffled order.  Where a is 2D and K >= 2, the last min(4, K - 1)
    terms of the contraction become v @ r (v = a's last columns, r = b's
    last rows); otherwise v @ r is a pair that cancels (coefficients c
    and p - c against one random row twice).  Drawn from a generator
    seeded by the shapes and p, so a case always rearranges the same
    way."""
    rng = np.random.default_rng([p, *a.shape, *b.shape])
    a1, v, r = _loaded_terms(a, b, p, rng)
    kk = a1.shape[-1]
    perm = rng.permutation(kk + 3)
    h = rng.integers(0, p, b.shape[:-2] + (kk + 3, b.shape[-1]), dtype=np.int64)
    h[..., perm[:kk], :] = b[..., :kk, :]
    return a1, h, perm[:kk], v, r


def _loaded_terms(a: np.ndarray, b: np.ndarray, p: int, rng: np.random.Generator) -> tuple:
    """(a', v, r) of a contraction split into the kernel's K' data terms
    and its z loaded rows: where a is 2D and K >= 2, the last min(4, K -
    1) terms move to v @ r; otherwise v @ r is a pair that cancels."""
    k = a.shape[-1]
    moved = min(4, k - 1) if a.ndim == 2 else 0
    if moved:
        kk = k - moved
        return a[:, :kk], a[:, kk:], b[..., kk:, :]
    c = rng.integers(1, p, (a.shape[-2], 1), dtype=np.int64)
    row = rng.integers(0, p, b.shape[:-2] + (1, b.shape[-1]), dtype=np.int64)
    return a, np.concatenate([c, p - c], axis=1), np.concatenate([row, row], axis=-2)


def blocks_plus_operands(a: np.ndarray, b: np.ndarray, p: int) -> tuple:
    """(a', x, offsets, bc, ld, v, r) with a' @ blocks(x) + v @ r == a @ b
    (mod p), ``blocks`` as ``mod_matmul_blocks_plus`` reads them.

    Each of b's first K' rows becomes an [N / bc, bc] block (bc a divisor
    of N), its rows ld >= bc apart, in a slot of x among one slot of
    junk, the slots in a shuffled order and each block shifted inside
    its slot.  v and r as in ``rows_plus_operands``; drawn from a
    generator seeded by the shapes and p."""
    rng = np.random.default_rng([p, 7, *a.shape, *b.shape])
    a1, v, r = _loaded_terms(a, b, p, rng)
    kk, n = a1.shape[-1], b.shape[-1]
    bc = int(rng.choice([d for d in range(1, n + 1) if n % d == 0]))
    nr, ld = n // bc, bc + int(rng.integers(0, 4))
    slot = nr * ld + int(rng.integers(0, 3))
    perm = rng.permutation(kk + 1)
    shift = rng.integers(0, slot - (nr - 1) * ld - bc + 1, kk)
    offsets = perm[:kk] * slot + shift
    x = rng.integers(0, p, b.shape[:-2] + ((kk + 1) * slot,), dtype=np.int64)
    cols = np.arange(n)
    idx = offsets[:, None] + (cols // bc) * ld + cols % bc
    x[..., idx] = b[..., :kk, :]
    return a1, x.reshape(b.shape[:-2] + (kk + 1, slot)), offsets, bc, ld, v, r


def _engine_rows_plus(backend: str, kernel: bool) -> Callable:
    def run(a, b, p, device=None):
        device = _engine_device(backend, kernel, device)
        a1, h, rows, v, r = (torch.as_tensor(x, dtype=torch.int32, device=device)
                             for x in rows_plus_operands(a, b, p))
        out = mod_matmul_rows_plus(a1, h, rows.to(torch.int64), v, r, p=p, backend=backend)
        return out.cpu().numpy().astype(np.int64)

    return run


def _engine_blocks_plus(backend: str, kernel: bool) -> Callable:
    def run(a, b, p, device=None):
        device = _engine_device(backend, kernel, device)
        a1, x, offsets, bc, ld, v, r = blocks_plus_operands(a, b, p)
        a1, x, v, r = (torch.as_tensor(t, dtype=torch.int32, device=device) for t in (a1, x, v, r))
        offsets = torch.as_tensor(offsets, dtype=torch.int64, device=device)
        if kernel and skinny_fuses(backend, device, *a1.shape[-2:], v.shape[-1]):
            out = mod_matmul_blocks_plus(a1, x, offsets, bc, ld, v, r, p=p, backend=backend)
        else:  # the form launches only inside the rule
            out = modmatmul_blocks_plus_plain(a1, x, offsets, bc, ld, v, r, p)
        return out.cpu().numpy().astype(np.int64)

    return run


def _engine_crt(a, b, p, device=None):
    # p is ignored: the CRT route is checked mod prod(CRT_PRIMES)
    return np.asarray(mod_matmul_crt(a, b, primes=CRT_PRIMES, device=device), np.int64)


ENGINES: Dict[str, Callable] = {
    "f32limb": _engine("f32limb", kernel=False),
    "int32": _engine("int32", kernel=False),
    "cuda": _engine("cuda", kernel=True),
    "cuda_int32": _engine("cuda_int32", kernel=True),
    "crt": _engine_crt,
    "int32_rows_plus": _engine_rows_plus("int32", kernel=False),
    "cuda_rows_plus": _engine_rows_plus("cuda", kernel=True),
    "cuda_int32_rows_plus": _engine_rows_plus("cuda_int32", kernel=True),
    "int32_blocks_plus": _engine_blocks_plus("int32", kernel=False),
    "cuda_blocks_plus": _engine_blocks_plus("cuda", kernel=True),
    "cuda_int32_blocks_plus": _engine_blocks_plus("cuda_int32", kernel=True),
}


@dataclasses.dataclass(frozen=True)
class Case:
    """One differential-fuzz case: a (shape, prime, distribution) point."""

    batch: int
    m: int
    k: int
    n: int
    p: int
    mode: str
    layout: str
    seed: int

    def describe(self) -> str:
        return (
            f"B={self.batch} M={self.m} K={self.k} N={self.n} p={self.p} "
            f"mode={self.mode} layout={self.layout} seed={self.seed}"
        )


@dataclasses.dataclass
class Mismatch:
    case: Case
    engine: str
    n_bad: int
    first_bad: tuple
    got: int
    want: int

    def describe(self) -> str:
        return (
            f"{self.engine}: {self.n_bad} wrong elements, first at "
            f"{self.first_bad} (got {self.got}, want {self.want}) "
            f"[{self.case.describe()}]"
        )


def sample_case(rng: np.random.Generator, deep_k: bool = False) -> Case:
    """Draw one case; ``deep_k`` steers K past the 256-chunk boundary."""
    # unaligned by construction: primes and tile-boundary neighbours
    dims = (1, 2, 3, 5, 7, 9, 13, 17, 31, 33, 40)
    kdims = (257, 260, 300, 511, 513) if deep_k else dims + (127, 128, 129)
    return Case(
        batch=int(rng.choice((1, 2, 3))),
        m=int(rng.choice(dims)),
        k=int(rng.choice(kdims)),
        n=int(rng.choice(dims)),
        p=int(rng.choice(PRIMES)),
        mode=str(rng.choice(MODES)),
        layout=str(rng.choice(LAYOUTS)),
        seed=int(rng.integers(0, 2**31)),
    )


def operands(case: Case) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize the adversarial operand pair for a case (int64 host
    arrays in [0, p), shaped per the case layout)."""
    rng = np.random.default_rng(case.seed)
    p = case.p
    sa: tuple = (case.batch, case.m, case.k)
    sb: tuple = (case.batch, case.k, case.n)
    if case.layout in ("lhs2d", "2d"):
        sa = sa[1:]
    if case.layout in ("rhs2d", "2d"):
        sb = sb[1:]

    def draw(shape):
        if case.mode == "uniform":
            return rng.integers(0, p, shape, dtype=np.int64)
        if case.mode == "maximal":
            return np.full(shape, p - 1, np.int64)
        if case.mode == "near_p":
            return p - 1 - rng.integers(0, min(8, p - 1) + 1, shape, dtype=np.int64)
        if case.mode == "high_limb":
            # both 8-bit limbs dense-high: maximal limb products without
            # leaving [0, p)
            hi = rng.integers(192, 256, shape, dtype=np.int64)
            lo = rng.integers(192, 256, shape, dtype=np.int64)
            return np.minimum(hi * 256 + lo, p - 1)
        if case.mode == "sparse":
            x = rng.integers(0, p, shape, dtype=np.int64)
            return np.where(rng.random(shape) < 0.9, 0, x)
        raise ValueError(f"unknown mode {case.mode}")

    return draw(sa), draw(sb)


def oracle(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """Exact host reference: arbitrary-precision integer matmul mod p."""
    prod = np.asarray(a, np.object_) @ np.asarray(b, np.object_)
    return (prod % p).astype(np.int64)


def check_case(
    case: Case, engines: Optional[List[str]] = None, device=None
) -> List[Mismatch]:
    """Run one case through the selected engines; return all mismatches."""
    a, b = operands(case)
    want = oracle(a, b, case.p)
    pbig = 1
    for q in CRT_PRIMES:
        pbig *= q
    want_crt = oracle(a, b, pbig)
    out = []
    for name in engines or list(ENGINES):
        got = ENGINES[name](a, b, case.p, device)
        ref = want_crt if name == "crt" else want
        if got.shape != ref.shape:
            out.append(Mismatch(case, name, -1, ("shape",), 0, 0))
            continue
        bad = got != ref
        if bad.any():
            idx = tuple(int(i) for i in np.argwhere(bad)[0])
            out.append(
                Mismatch(
                    case, name, int(bad.sum()), idx,
                    int(got[idx]), int(ref[idx]),
                )
            )
    return out


def run_fuzz(
    examples: int = 24,
    seed: int = 0,
    engines: Optional[List[str]] = None,
    deep_every: int = 4,
    verbose: bool = False,
    device=None,
) -> List[Mismatch]:
    """The harness: ``examples`` random cases (every ``deep_every``-th
    steered deep-K), all engines differentially checked per case.
    Deterministic per seed.  Returns the accumulated mismatches."""
    rng = np.random.default_rng(seed)
    mismatches: List[Mismatch] = []
    for i in range(examples):
        case = sample_case(rng, deep_k=deep_every > 0 and i % deep_every == 0)
        found = check_case(case, engines=engines, device=device)
        mismatches.extend(found)
        if verbose:
            status = "MISMATCH" if found else "ok"
            print(f"[{i + 1}/{examples}] {status}  {case.describe()}")
    return mismatches
