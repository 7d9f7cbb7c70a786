"""Finite-field GF(p) arithmetic for coded MPC, in PyTorch.

Two halves, as in the JAX package's ``repro.core.gf``:

* **Host** (numpy ``int64``): :class:`Field`, the exact reference
  arithmetic behind planning (Vandermonde inverses, Lagrange
  coefficients) and the test oracle.  Copied unchanged.
* **Device** (torch): the plain versions of the GF(p) matmul kernels
  (:func:`mod_matmul_f32`, :func:`mod_matmul_int32`), the uint32
  Barrett helpers, and the counter-based threefry2x32 mask stream.
  These run on any device; the CUDA kernels in
  ``repro_torch.kernels.modmatmul`` are checked against them.

Two facts of PyTorch shape the device half:

* ``uint32`` tensors support only ``*``, ``^`` and ``&``; ``+``,
  shifts, comparisons and ``%`` raise.  Every uint32 quantity here is
  therefore an ``int64`` tensor holding a value in [0, 2**32), with the
  32-bit wrap written out as ``& 0xFFFFFFFF``.
* There is no integer matmul on CUDA.  The limb dots run in float32,
  which is exact while every partial sum stays below 2**24 — the same
  256-deep chunk rule as the JAX code.  A TF32 matmul would round the
  8-bit limbs' products, so TF32 is switched off below.

Keys: a PRNG key is a pair of 32-bit words ``(k0, k1)`` held as Python
ints.  :func:`prng_key`, :func:`split` and :func:`fold_in` reproduce
``jax.random.PRNGKey``/``split``/``fold_in`` (threefry, partitionable
mode), which makes the fused-mask shares bit-identical to the JAX
package's for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

# The plain limb dots need exact float32 products of 8-bit limbs; TF32
# keeps a 10-bit mantissa and would round them.  This is also
# PyTorch's default, stated here because exactness depends on it.
torch.backends.cuda.matmul.allow_tf32 = False

# Largest 16-bit prime: elements fit in two 8-bit limbs exactly.
P_DEFAULT = 65521

# Inner-dimension chunk depth for exact f32 limb accumulation:
# 255*255*256 = 16_646_400 < 2**24.
CHUNK_K = 256

# Lazy-reduction depth of the f32-limb kernel: the two cross-limb dots
# may be summed raw before one reduction iff 2 * depth * 255**2 < 2**24,
# and at depth <= 128 the raw low-limb dot and the running accumulator
# fold into the final reduction: 3*(p-1) + 128*255**2 < 2**24.
LAZY_K = 128

LIMB = 256  # limb base

# Contraction-depth bound of the plain int32 path: raw per-chunk limb
# dots sum across chunks in uint32 without intermediate reductions; the
# summed cross-limb dot adds at most 2 * 256 * 255**2 per chunk, and 129
# chunks stay under 2**32 while 130 would wrap.
INT32_ACC_CHUNKS = 129
INT32_ACC_K = INT32_ACC_CHUNKS * CHUNK_K  # 33024

U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Field:
    """A prime field GF(p)."""

    p: int = P_DEFAULT

    def __post_init__(self):
        if self.p < 3:
            raise ValueError("p must be an odd prime")

    @property
    def elem_bytes(self) -> int:
        """Wire width of one field element (bytes-level Trace views)."""
        return (self.p.bit_length() + 7) // 8

    # ------------------------------------------------------------------
    # host (numpy int64) reference arithmetic
    # ------------------------------------------------------------------
    def asarray(self, x) -> np.ndarray:
        return np.asarray(x, dtype=np.int64) % self.p

    def add(self, a, b):
        return (np.asarray(a, np.int64) + np.asarray(b, np.int64)) % self.p

    def sub(self, a, b):
        return (np.asarray(a, np.int64) - np.asarray(b, np.int64)) % self.p

    def mul(self, a, b):
        return (np.asarray(a, np.int64) * np.asarray(b, np.int64)) % self.p

    def matmul(self, a, b) -> np.ndarray:
        """Exact (mod p) matmul on the host; chunked to avoid int64 overflow."""
        a = self.asarray(a)
        b = self.asarray(b)
        k = a.shape[-1]
        # (p-1)^2 * chunk must stay < 2**63; p < 2**31 -> chunk >= 2 always ok.
        chunk = max(1, int((2**62) // (int(self.p - 1) ** 2)))
        out = np.zeros(a.shape[:-1] + b.shape[1:], dtype=np.int64)
        for s in range(0, k, chunk):
            out = (out + a[..., s : s + chunk] @ b[s : s + chunk]) % self.p
        return out

    def pow(self, a, e: int):
        a = int(a) % self.p
        return pow(a, int(e), self.p)

    def inv(self, a):
        a = int(a) % self.p
        if a == 0:
            raise ZeroDivisionError("0 has no inverse in GF(p)")
        return pow(a, self.p - 2, self.p)

    def neg(self, a):
        return (-np.asarray(a, np.int64)) % self.p

    def random(self, rng: np.random.Generator, shape) -> np.ndarray:
        return rng.integers(0, self.p, size=shape, dtype=np.int64)

    # ------------------------------------------------------------------
    # structured host helpers
    # ------------------------------------------------------------------
    def _pow_table(self, base: np.ndarray, exps: np.ndarray) -> np.ndarray:
        """T[n, j] = base[n] ** exps[j] (mod p) by column-wise repeated
        squaring: one vectorized squaring pass per exponent bit instead
        of a scalar ``pow`` per element.  exps must be non-negative."""
        out = np.ones((base.size, exps.size), np.int64)
        sq = base % self.p
        e = exps.astype(np.int64).copy()
        while e.any():
            mask = (e & 1).astype(bool)
            if mask.any():
                # (p-1)**2 < 2**62 for p < 2**31: int64-exact.
                out[:, mask] = (out[:, mask] * sq[:, None]) % self.p
            e >>= 1
            sq = (sq * sq) % self.p
        return out

    def vandermonde(self, points, powers) -> np.ndarray:
        """V[n, j] = points[n] ** powers[j]  (mod p)."""
        points = np.atleast_1d(np.asarray(points, np.int64)) % self.p
        exps = np.asarray([int(u) for u in powers], np.int64)
        out = np.ones((points.size, exps.size), np.int64)
        if exps.size == 0:
            return out
        pos = exps >= 0
        if pos.any():
            out[:, pos] = self._pow_table(points, exps[pos])
        if (~pos).any():
            if np.any(points == 0):
                raise ZeroDivisionError("0 has no inverse in GF(p)")
            inv_pts = self._pow_table(points, np.array([self.p - 2]))[:, 0]
            out[:, ~pos] = self._pow_table(inv_pts, -exps[~pos])
        return out

    def solve(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Solve a @ x = b (mod p) by Gauss-Jordan elimination."""
        a = self.asarray(a).copy()
        b = self.asarray(b).copy()
        n = a.shape[0]
        if a.shape[1] != n:
            raise ValueError("square system required")
        if b.ndim == 1:
            b = b[:, None]
            squeeze = True
        else:
            squeeze = False
        for col in range(n):
            piv = None
            for r in range(col, n):
                if a[r, col] != 0:
                    piv = r
                    break
            if piv is None:
                raise ZeroDivisionError("singular matrix mod p")
            if piv != col:
                a[[col, piv]] = a[[piv, col]]
                b[[col, piv]] = b[[piv, col]]
            inv = self.inv(a[col, col])
            a[col] = (a[col] * inv) % self.p
            b[col] = (b[col] * inv) % self.p
            for r in range(n):
                if r != col and a[r, col] != 0:
                    f = a[r, col]
                    a[r] = (a[r] - f * a[col]) % self.p
                    b[r] = (b[r] - f * b[col]) % self.p
        x = b % self.p
        return x[:, 0] if squeeze else x

    def inv_matrix(self, a: np.ndarray) -> np.ndarray:
        return self.solve(a, np.eye(a.shape[0], dtype=np.int64))

    def solve_any(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """One solution of a @ x = b (mod p) for a general [m, n] system.

        Unlike :meth:`solve`, ``a`` may be rectangular or rank-deficient:
        Gauss-Jordan runs column by column, free variables are pinned to
        zero, and a zero row of the reduced ``a`` with a nonzero reduced
        ``b`` raises ``ValueError`` (inconsistent system).  This is what
        the Berlekamp-Welch decoder needs — its key system is
        deliberately overdetermined (``thr + 2e`` unknowns, more
        equations) and singular whenever fewer than ``e`` errors actually
        occurred, where *any* particular solution is a valid decode.
        """
        a = self.asarray(a).copy()
        b = self.asarray(b).copy()
        m, n = a.shape
        if b.ndim == 1:
            b = b[:, None]
            squeeze = True
        else:
            squeeze = False
        if b.shape[0] != m:
            raise ValueError(f"rhs has {b.shape[0]} rows, lhs has {m}")
        pivots = []
        row = 0
        for col in range(n):
            if row >= m:
                break
            piv = None
            for r in range(row, m):
                if a[r, col] != 0:
                    piv = r
                    break
            if piv is None:
                continue  # free column
            if piv != row:
                a[[row, piv]] = a[[piv, row]]
                b[[row, piv]] = b[[piv, row]]
            inv = self.inv(a[row, col])
            a[row] = (a[row] * inv) % self.p
            b[row] = (b[row] * inv) % self.p
            for r in range(m):
                if r != row and a[r, col] != 0:
                    f = a[r, col]
                    a[r] = (a[r] - f * a[row]) % self.p
                    b[r] = (b[r] - f * b[row]) % self.p
            pivots.append(col)
            row += 1
        if row < m and np.any(b[row:] != 0):
            raise ValueError("inconsistent linear system mod p")
        x = np.zeros((n, b.shape[1]), np.int64)
        if pivots:
            x[np.asarray(pivots)] = b[: len(pivots)]
        return x[:, 0] if squeeze else x

    def poly_divmod(
        self, num: np.ndarray, den: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Polynomial division mod p on ascending coefficient vectors.

        Returns (quotient, remainder) with ``num = quotient * den +
        remainder`` and ``deg(remainder) < deg(den)``.  ``den`` need not
        be monic (its leading coefficient is inverted once).
        """
        num = self.asarray(num).copy()
        den = self.asarray(den)
        d = int(den.size) - 1
        while d > 0 and den[d] == 0:
            d -= 1
        if den[d] == 0:
            raise ZeroDivisionError("division by the zero polynomial")
        lead_inv = self.inv(den[d])
        n = int(num.size) - 1
        if n < d:
            return np.zeros(1, np.int64), num
        quo = np.zeros(n - d + 1, np.int64)
        for k in range(n - d, -1, -1):
            c = (num[k + d] * lead_inv) % self.p
            if c:
                quo[k] = c
                num[k : k + d + 1] = (num[k : k + d + 1] - c * den[: d + 1]) % self.p
        rem = num[:d] if d > 0 else np.zeros(1, np.int64)
        return quo, rem

    def poly_eval(self, coeffs: np.ndarray, xs: np.ndarray) -> np.ndarray:
        """Evaluate an ascending-coefficient polynomial at points xs
        (Horner, vectorized over the points)."""
        coeffs = self.asarray(coeffs)
        xs = self.asarray(xs)
        out = np.zeros_like(xs)
        for c in coeffs[::-1]:
            out = (out * xs + c) % self.p
        return out

    # ------------------------------------------------------------------
    # fixed-point quantisation (real <-> field)
    # ------------------------------------------------------------------
    def encode(self, x: np.ndarray, scale: int) -> np.ndarray:
        """Quantise reals into the field with a centered lift."""
        q = np.rint(np.asarray(x, np.float64) * scale).astype(np.int64)
        half = (self.p - 1) // 2
        if np.any(np.abs(q) > half):
            raise OverflowError("value out of field range at this scale")
        return q % self.p

    def decode(self, x: np.ndarray, scale: int) -> np.ndarray:
        """Centered lift back to signed reals."""
        x = self.asarray(x)
        half = (self.p - 1) // 2
        signed = np.where(x > half, x - self.p, x)
        return signed.astype(np.float64) / scale


# ----------------------------------------------------------------------
# device path: exact f32 limb arithmetic (p < 2**16)
# ----------------------------------------------------------------------
def _check_limb_prime(p: int):
    if p >= 1 << 16:
        raise ValueError("f32 limb path requires p < 2**16")


def _limbs_f32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 8-bit limbs of int32 x in [0, 2**16), as float32."""
    return (x >> 8).to(torch.float32), (x & 255).to(torch.float32)


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() < 2 or b.dim() < 2:
        raise ValueError(f"operands must be at least 2D, got {tuple(a.shape)} {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dims disagree: {tuple(a.shape)} @ {tuple(b.shape)}")


def _k_chunks(k: int):
    """CHUNK_K-deep slices of a contraction of depth k."""
    return [slice(s, min(s + CHUNK_K, k)) for s in range(0, max(k, 1), CHUNK_K)]


def _limb_dots(a_hi, a_lo, b_hi, b_lo, sl: slice):
    """Raw (hh, mid, ll) of one <= CHUNK_K-deep chunk as int64 holding
    uint32 values: every float32 dot is an integer below 2**24, so the
    conversion is exact."""
    ah, al = a_hi[..., sl], a_lo[..., sl]
    bh, bl = b_hi[..., sl, :], b_lo[..., sl, :]

    def dot(x, y):
        return torch.matmul(x, y).to(torch.int64)

    return dot(ah, bh), dot(ah, bl) + dot(al, bh), dot(al, bl)


def mod_matmul_f32(a: torch.Tensor, b: torch.Tensor, p: int = P_DEFAULT) -> torch.Tensor:
    """Exact GF(p) matmul via 8-bit limb decomposition in float32.

    a: [..., M, K] @ b: [..., K, N] (int32 in [0, p)) with
    torch.matmul's broadcasting over leading batch dims; either side
    may be a 2D constant.  Returns int32 [..., M, N] = a @ b mod p.

    The plain version of the f32-limb kernel: four float32 limb dots per
    CHUNK_K-deep chunk (each exact below 2**24), recombined with
    (2**16 mod p) and (2**8 mod p) and reduced once per chunk.
    """
    _check_limb_prime(p)
    _check_operands(a, b)
    f_hihi = (LIMB * LIMB) % p
    f_mid = LIMB % p
    a_hi, a_lo = _limbs_f32(a)
    b_hi, b_lo = _limbs_f32(b)
    acc = None
    for sl in _k_chunks(a.shape[-1]):
        hh, mid, ll = _limb_dots(a_hi, a_lo, b_hi, b_lo, sl)
        # hh < 2**24, mid < 2**25: the products stay far below 2**63
        tile = (hh * f_hihi) % p + (mid * f_mid) % p + ll
        if acc is not None:
            tile = tile + acc
        acc = tile % p
    return acc.to(torch.int32)


# ----------------------------------------------------------------------
# native-integer path: Barrett reduction in uint32
# ----------------------------------------------------------------------
def barrett_reduce_u32(x: torch.Tensor, p: int) -> torch.Tensor:
    """x mod p for uint32 x (an int64 tensor in [0, 2**32)).

    Barrett with mu = floor(2**32 / p): the quotient estimate
    q = floor(x * mu / 2**32) satisfies floor(x/p) - q in {0, 1}, so one
    conditional subtract finishes the reduction.  x * mu < 2**63 for
    p >= 3, so int64 forms the product directly; q is the high word a
    CUDA kernel gets from ``__umulhi(x, mu)``, and the same value the JAX
    package assembles from 16-bit limb products.  Requires 1 < p < 2**16.
    """
    if not 1 < p < (1 << 16):
        raise ValueError(f"barrett_reduce_u32 requires 1 < p < 2**16, got {p}")
    mu = (1 << 32) // p
    x = x.to(torch.int64) & U32
    q = (x * mu) >> 32
    r = x - q * p
    return torch.where(r >= p, r - p, r)


def _barrett_recombine(hh, mid, ll, p: int) -> torch.Tensor:
    """Recombine raw uint32 limb-dot accumulators into [0, p).

    hh/mid/ll are the hi*hi / cross / lo*lo contraction sums (int64
    tensors holding uint32 values).  Each is Barrett-reduced before the
    16-bit recombination constant is applied, so every intermediate
    stays below p * 2**16 < 2**32.
    """
    f_hihi = (1 << 16) % p
    f_mid = LIMB % p

    def mulc(x, c):
        if c == 0:
            return torch.zeros_like(x)
        return barrett_reduce_u32(barrett_reduce_u32(x, p) * c, p)

    out = mulc(hh, f_hihi) + mulc(mid, f_mid) + barrett_reduce_u32(ll, p)
    return barrett_reduce_u32(out, p)  # sum of three residues < 3p


def mod_matmul_int32(a: torch.Tensor, b: torch.Tensor, p: int = P_DEFAULT) -> torch.Tensor:
    """Exact GF(p) matmul on the native-integer tier (uint32 + Barrett).

    Same operand contract as :func:`mod_matmul_f32`.  The limb dots run
    in float32 per CHUNK_K-deep chunk (torch has no integer matmul on
    CUDA); the raw chunk sums accumulate across chunks in uint32 with no
    reduction, and one Barrett recombination finishes.  The plain
    version of the int32 kernel.  Past ``INT32_ACC_K`` the uint32
    accumulator would wrap, so a deeper contraction raises.
    """
    _check_limb_prime(p)
    _check_operands(a, b)
    k = a.shape[-1]
    kpad = -(-k // CHUNK_K) * CHUNK_K
    if kpad > INT32_ACC_K:
        raise ValueError(
            f"int32 backend: padded contraction depth {kpad} exceeds the "
            f"uint32 accumulator bound INT32_ACC_K={INT32_ACC_K} "
            f"({INT32_ACC_CHUNKS} raw chunks; deeper sums would wrap "
            f"silently) — split the contraction or use the f32limb backend"
        )
    a_hi, a_lo = _limbs_f32(a)
    b_hi, b_lo = _limbs_f32(b)
    hh = mid = ll = 0
    for sl in _k_chunks(k):
        dh, dm, dl = _limb_dots(a_hi, a_lo, b_hi, b_lo, sl)
        # uint32 sums; the depth bound above keeps them below 2**32
        hh, mid, ll = hh + dh, mid + dm, ll + dl
    return _barrett_recombine(hh, mid, ll, p).to(torch.int32)


# ----------------------------------------------------------------------
# counter-based PRNG: threefry2x32
# ----------------------------------------------------------------------
_THREEFRY_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_THREEFRY_PARITY = 0x1BD11BDA


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & U32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor):
    """Threefry-2x32, 20 rounds (the Random123 / JAX PRNG block cipher).

    ``k0``/``k1`` are the key words (ints); ``c0``/``c1`` are counter
    tensors.  The word arithmetic is uint32 written out in int64 with an
    explicit 32-bit wrap.  The 5 x 4 round structure injects the
    extended key (k0, k1, k0^k1^parity) after every group of four
    rounds, per the Skein key schedule.  Returns the two output words as
    int64 tensors in [0, 2**32).
    """
    k0 = int(k0) & U32
    k1 = int(k1) & U32
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (c0.to(torch.int64) + ks[0]) & U32
    x1 = (c1.to(torch.int64) + ks[1]) & U32
    for g in range(1, 6):
        rots = _THREEFRY_ROT[:4] if g % 2 else _THREEFRY_ROT[4:]
        for r in rots:
            x0 = (x0 + x1) & U32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[g % 3]) & U32
        x1 = (x1 + ks[(g + 1) % 3] + g) & U32
    return x0, x1


Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """The key ``jax.random.PRNGKey(seed)`` makes (64-bit mode off):
    the word pair (0, seed mod 2**32)."""
    return (0, int(seed) & U32)


def split(key: Key, n: int = 2) -> List[Key]:
    """``jax.random.split(key, n)`` under threefry's partitionable mode:
    subkey i is the output word pair of threefry2x32(key, (0, i))."""
    ctr = torch.arange(n, dtype=torch.int64)
    x0, x1 = threefry2x32(key[0], key[1], torch.zeros_like(ctr), ctr)
    return [(int(w0), int(w1)) for w0, w1 in zip(x0.tolist(), x1.tolist())]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` under threefry: the output word
    pair of threefry2x32(key, (0, data mod 2**32))."""
    x0, x1 = threefry2x32(
        key[0], key[1], torch.zeros(1, dtype=torch.int64),
        torch.tensor([int(data) & U32], dtype=torch.int64),
    )
    return (int(x0[0]), int(x1[0]))


def field_mask(key: Key, shape: tuple, p: int = P_DEFAULT, device="cpu") -> torch.Tensor:
    """Counter-based uniform GF(p) mask: the materialized stream that
    the fused-mask kernel epilogue generates in registers.

    Element at row-major flat index i is
    ``threefry2x32(key, (i, 0))[0] mod p``: a pure function of (key,
    position), bit-identical to ``repro.core.gf.field_mask``.
    """
    _check_limb_prime(p)
    total = 1
    for d in shape:
        total *= int(d)
    if total >= 1 << 32:
        raise ValueError(
            f"field_mask counter space exhausted: prod{tuple(shape)} = "
            f"{total} >= 2**32 — counters would wrap and reuse mask values"
        )
    ctr = torch.arange(total, dtype=torch.int64, device=device)
    x0, _ = threefry2x32(key[0], key[1], ctr, torch.zeros_like(ctr))
    return barrett_reduce_u32(x0, p).to(torch.int32).reshape(tuple(shape))


def mod_mul(a: torch.Tensor, b: torch.Tensor, p: int = P_DEFAULT) -> torch.Tensor:
    """Elementwise a*b mod p (the uint32 product of the JAX package)."""
    _check_limb_prime(p)
    prod = ((a.to(torch.int64) & U32) * (b.to(torch.int64) & U32)) & U32
    return (prod % p).to(torch.int32)


def mod_add(a: torch.Tensor, b: torch.Tensor, p: int = P_DEFAULT) -> torch.Tensor:
    """Elementwise a+b mod p (the uint32 sum of the JAX package)."""
    s = ((a.to(torch.int64) & U32) + (b.to(torch.int64) & U32)) & U32
    return (s % p).to(torch.int32)


def random_field_device(
    generator: torch.Generator, shape, p: int = P_DEFAULT, device="cpu"
) -> torch.Tensor:
    """Uniform GF(p) elements drawn on ``device`` from ``generator``
    (which must live on that device).  Returns int32 in [0, p)."""
    return torch.randint(
        0, p, tuple(shape), generator=generator, dtype=torch.int32, device=device
    )


def powers_matrix(points: np.ndarray, powers, p: int = P_DEFAULT) -> np.ndarray:
    """Host-side Vandermonde with arbitrary power support; int64 -> int32-safe."""
    f = Field(p)
    return f.vandermonde(points, powers).astype(np.int64)
