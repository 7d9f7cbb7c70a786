"""The arithmetic of the f32-limb CUDA kernels, emulated in float32 on the CPU.

``f32_wgmma.cuh`` and the float form of ``skinny.cuh`` run only on the
card.  Their exactness rests on a schedule: every float accumulator is
an exact integer below 2**24 whenever it is read or added to.  These
tests replay each schedule step by step with float32 tensors, with the
kernels' constants read from the wrapper (which checks them against the
compiled library), assert the bound after every step, and compare the
result with the host oracle.  Every limb term is non-negative, so a
bound on each running sum bounds every partial sum in whatever order
the tensor cores add them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.modmatmul import kernel as K
from repro_torch.kernels.modmatmul import ref

P = 65521
TWO24 = 2.0**24
ROUND_MAGIC = 12582912.0  # common.cuh: 1.5 * 2**23


def _fold_f(x: torch.Tensor, p: int) -> torch.Tensor:
    """common.cuh's fold_f in float32: the quotient from the rounded
    reciprocal, rounded by the magic add (one FFMA: the exact product
    plus the magic, rounded once to float32), and x - q*p (exact: an FFMA
    of integers), in (-p, p)."""
    inv_p = torch.tensor(1.0, dtype=torch.float32) / p
    q = (x.double() * inv_p.double() + ROUND_MAGIC).float() - ROUND_MAGIC
    r = (x.double() - q.double() * p).float()
    assert float(r.abs().max()) < p
    return r


def _mod_f(x: torch.Tensor, p: int) -> torch.Tensor:
    """common.cuh's mod_f: fold_f and two corrections, into [0, p)."""
    r = _fold_f(x, p)
    r = torch.where(r < 0, r + p, r)
    return torch.where(r >= p, r - p, r)


def _check_exact(acc: torch.Tensor) -> None:
    assert acc.dtype == torch.float32
    assert float(acc.abs().max()) < TWO24, float(acc.abs().max())
    assert bool((acc == torch.round(acc)).all())


def _limbs(x: torch.Tensor):
    return (x >> 8).float(), (x & 255).float()


def emulate_f32_wgmma(a: np.ndarray, b: np.ndarray, p: int, first_period: int) -> np.ndarray:
    """[M, K] @ [K, N] mod p as one consumer warpgroup of f32_wgmma
    computes it: sets W1 = [a'_hi | a_hi] . [b_hi ; b_lo] and W0 = [a'_lo |
    a_lo] . [b_hi ; b_lo] with a' = 256a mod p, folded in place into
    (-p, p) after ``first_period`` K and then every WGMMA_FOLD_K, reduced
    into [0, p) and recombined once."""
    at, bt = torch.as_tensor(a, dtype=torch.int64), torch.as_tensor(b, dtype=torch.int64)
    a_hi, a_lo = _limbs(at)
    ap_hi, ap_lo = _limbs((at * 256) % p)
    b_hi, b_lo = _limbs(bt)
    m, k = a.shape
    n = b.shape[1]
    w1 = torch.zeros((m, n), dtype=torch.float32)
    w0 = torch.zeros((m, n), dtype=torch.float32)
    bounds = list(range(first_period, k, K.WGMMA_FOLD_K)) + [k]
    start = 0
    for end in bounds:
        for kk in range(start, end):
            w1 = w1 + torch.outer(ap_hi[:, kk], b_hi[kk]) + torch.outer(a_hi[:, kk], b_lo[kk])
            w0 = w0 + torch.outer(ap_lo[:, kk], b_hi[kk]) + torch.outer(a_lo[:, kk], b_lo[kk])
            _check_exact(w1)
            _check_exact(w0)
        w1, w0 = _fold_f(w1, p), _fold_f(w0, p)
        start = end
    w1, w0 = _mod_f(w1, p), _mod_f(w0, p)
    assert float(w1.min()) >= 0 and float(w1.max()) < p
    return ((w1.to(torch.int64) * 256 + w0.to(torch.int64)) % p).numpy()


def _short_terms() -> int:
    import re

    found = re.findall(r"constexpr int SKINNY_F32_SHORT_TERMS = (\d+);", (K.CSRC / "skinny.cuh").read_text())
    assert len(found) == 1
    return int(found[0])


def emulate_f32_skinny(c: np.ndarray, x: np.ndarray, p: int) -> np.ndarray:
    """[M, T] @ [T, N] mod p as f32_skinny computes it, T = K + z terms (A
    and v side by side, B and the mask words stacked): two float32
    accumulators, 4 FFMA a term, one reduction at the end (for a short
    sum, the two floats converted directly, as they are below 2**23)."""
    ct, xt = torch.as_tensor(c, dtype=torch.int64), torch.as_tensor(x, dtype=torch.int64)
    c_hi, c_lo = _limbs(ct)
    cp_hi, cp_lo = _limbs((ct * 256) % p)
    x_hi, x_lo = _limbs(xt)
    w1 = torch.zeros((c.shape[0], x.shape[1]), dtype=torch.float32)
    w0 = torch.zeros_like(w1)
    for t in range(c.shape[1]):
        w1 = w1 + torch.outer(cp_hi[:, t], x_hi[t])
        w1 = w1 + torch.outer(c_hi[:, t], x_lo[t])
        w0 = w0 + torch.outer(cp_lo[:, t], x_hi[t])
        w0 = w0 + torch.outer(c_lo[:, t], x_lo[t])
        _check_exact(w1)
        _check_exact(w0)
    if c.shape[1] <= _short_terms():
        assert float(w1.max()) < 2**23 and float(w0.max()) < 2**23
    else:
        w1, w0 = _mod_f(w1, p), _mod_f(w0, p)
    return ((w1.to(torch.int64) * 256 + w0.to(torch.int64)) % p).numpy()


def _draw(rng, shape, mode, p=P):
    if mode == "maximal":
        return np.full(shape, p - 1, np.int64)
    if mode == "high_limb":  # both 8-bit limbs dense-high, clipped below p
        return np.minimum(rng.integers(192, 256, shape) * 256 + rng.integers(192, 256, shape), p - 1)
    return rng.integers(0, p, shape)


@pytest.mark.parametrize("mode", ["maximal", "high_limb", "uniform"])
@pytest.mark.parametrize("k", [127, 128, 129, 257, 4 * 128 + 1])
def test_f32_wgmma_schedule_is_exact(k, mode):
    rng = np.random.default_rng(k)
    a, b = _draw(rng, (3, k), mode), _draw(rng, (k, 4), mode)
    want = ref.modmatmul_ref(a, b, P)
    # the first consumer folds every 128 K; the second first after 64
    for first in (K.WGMMA_FOLD_K, K.WGMMA_FOLD_K // 2):
        np.testing.assert_array_equal(emulate_f32_wgmma(a, b, P, first), want)


def test_f32_wgmma_fold_period_is_the_largest_that_stays_exact():
    # one period more of all-(p-1) limb products would leave 2**24
    k = 2 * K.WGMMA_FOLD_K
    a = np.full((1, k), P - 1)
    b = np.full((k, 1), P - 1)
    with pytest.raises(AssertionError):
        emulate_f32_wgmma(a, b, P, first_period=k)


@pytest.mark.parametrize("mode", ["maximal", "high_limb", "uniform"])
@pytest.mark.parametrize("k,z", [(6, 0), (32, 0), (6, 2), (17, 2), (32, 32), (32, 33), (32, 96), (1, 127)])
def test_f32_skinny_schedule_is_exact(k, z, mode):
    assert k + z <= K.SKINNY_MAX_TERMS
    rng = np.random.default_rng(100 * k + z)
    a, b = _draw(rng, (17, k), mode), _draw(rng, (k, 5), mode)
    v, r = _draw(rng, (17, z), mode), _draw(rng, (z, 5), mode)  # r: the mask words
    want = (ref.modmatmul_ref(a, b, P) + ref.modmatmul_ref(v, r, P)) % P
    got = emulate_f32_skinny(np.concatenate([a, v], 1), np.concatenate([b, r], 0), P)
    np.testing.assert_array_equal(got, want)


def test_mod_f_takes_every_exact_float_below_two_to_the_24():
    # the whole input range at a stride, the ends of every p-period, and
    # the negative side a fold leaves
    xs = np.concatenate([np.arange(0, 2**24, 997), np.arange(2**24 - 3 * P, 2**24),
                         np.arange(0, 256) * P, np.arange(0, 256) * P - 1, -np.arange(0, P, 7)])
    xs = xs[(xs > -(2**24)) & (xs < 2**24)]
    for p in (P, 65519, 4093, 257):
        got = _mod_f(torch.as_tensor(xs, dtype=torch.float32), p)
        np.testing.assert_array_equal(got.to(torch.int64).numpy(), xs % p)
