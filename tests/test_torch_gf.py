"""The port's GF(p) layer against the JAX package's, on the same inputs.

Every quantity is an integer, so parity is exact equality: threefry
words (Random123 known answers and JAX's own implementation), the
materialized mask stream, the PRNG key derivation, Barrett reduction,
and the plain limb matmuls in every operand mode of the reference's
differential fuzz harness.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import gf as rgf
from repro.kernels.modmatmul import fuzz as rfuzz
from repro_torch.core import gf

P = gf.P_DEFAULT


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int64))


def test_constants_match_reference():
    for name in ("P_DEFAULT", "CHUNK_K", "LAZY_K", "LIMB", "INT32_ACC_CHUNKS", "INT32_ACC_K"):
        assert getattr(gf, name) == getattr(rgf, name), name


def test_threefry_known_answer_vectors():
    """Random123 KATs for threefry2x32 (20 rounds)."""
    kats = [
        ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
    ]
    for (k0, k1), (c0, c1), (e0, e1) in kats:
        x0, x1 = gf.threefry2x32(k0, k1, _t([c0]), _t([c1]))
        assert (int(x0[0]), int(x1[0])) == (e0, e1)


def test_threefry_matches_jax_internal_and_reference():
    jax_prng = pytest.importorskip("jax._src.prng")
    rng = np.random.default_rng(0)
    key = (12345, 67890)
    c0 = rng.integers(0, 2**32, 256, dtype=np.int64)
    c1 = rng.integers(0, 2**32, 256, dtype=np.int64)
    ours = gf.threefry2x32(key[0], key[1], _t(c0), _t(c1))
    jc0, jc1 = jnp.asarray(c0, jnp.uint32), jnp.asarray(c1, jnp.uint32)
    theirs = jax_prng.threefry_2x32(jnp.asarray(key, jnp.uint32), jnp.stack([jc0, jc1]))
    ref = rgf.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]), jc0, jc1)
    for w in range(2):
        np.testing.assert_array_equal(ours[w].numpy(), np.asarray(theirs[w], np.int64))
        np.testing.assert_array_equal(ours[w].numpy(), np.asarray(ref[w], np.int64))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**32 - 1, 2**31])
def test_prng_key_and_split_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert gf.prng_key(seed) == tuple(int(w) for w in np.asarray(key))
    for n in (2, 3):
        want = [tuple(int(w) for w in row) for row in np.asarray(jax.random.split(key, n))]
        assert gf.split(gf.prng_key(seed), n) == want
    # nested split, as the batched engine derives its share keys
    kshare, _ = jax.random.split(key)
    want = [tuple(int(w) for w in row) for row in np.asarray(jax.random.split(kshare))]
    assert gf.split(gf.split(gf.prng_key(seed))[0]) == want


@pytest.mark.parametrize("shape", [(64, 64), (2, 3, 100), (7,)])
def test_field_mask_bit_identical_to_reference(shape):
    for key in ((5, 6), (0xDEADBEEF, 0x12345678)):
        want = np.asarray(rgf.field_mask(jnp.asarray(key, jnp.uint32), shape, P))
        got = gf.field_mask(key, shape, P)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [3, 251, 257, 4093, 40961, 65519, 65521])
def test_barrett_matches_reference(p):
    rng = np.random.default_rng(p)
    edges = np.array([0, 1, p - 1, p, p + 1, 2 * p - 1, 2**16, 2**31, 2**32 - 1], np.int64)
    x = np.concatenate([edges, rng.integers(0, 2**32, 4096, dtype=np.int64)])
    got = gf.barrett_reduce_u32(_t(x), p).numpy()
    np.testing.assert_array_equal(got, x % p)
    ref = rgf.barrett_reduce_u32(jnp.asarray(x, jnp.uint32), p)
    np.testing.assert_array_equal(got, np.asarray(ref, np.int64))
    hh, mid, ll = (rng.integers(0, 2**32, 512, dtype=np.int64) for _ in range(3))
    got = gf._barrett_recombine(_t(hh), _t(mid), _t(ll), p).numpy()
    ref = rgf._barrett_recombine(
        *(jnp.asarray(v, jnp.uint32) for v in (hh, mid, ll)), p
    )
    np.testing.assert_array_equal(got, np.asarray(ref, np.int64))


def test_mod_add_mod_mul_match_reference():
    rng = np.random.default_rng(3)
    a = rng.integers(0, P, 1000).astype(np.int32)
    b = rng.integers(0, P, 1000).astype(np.int32)
    for ours, theirs in ((gf.mod_add, rgf.mod_add), (gf.mod_mul, rgf.mod_mul)):
        got = ours(torch.from_numpy(a), torch.from_numpy(b), P).numpy()
        np.testing.assert_array_equal(got, np.asarray(theirs(jnp.asarray(a), jnp.asarray(b), P)))


# the reference fuzz harness's operand modes and layouts, deep-K included
_CASES = [
    rfuzz.Case(batch=2, m=9, k=33, n=13, p=65521, mode="uniform", layout="batched", seed=1),
    rfuzz.Case(batch=3, m=5, k=129, n=7, p=65519, mode="high_limb", layout="lhs2d", seed=2),
    rfuzz.Case(batch=2, m=17, k=128, n=3, p=4093, mode="near_p", layout="rhs2d", seed=3),
    rfuzz.Case(batch=1, m=7, k=300, n=9, p=65521, mode="maximal", layout="2d", seed=4),
    rfuzz.Case(batch=2, m=4, k=513, n=5, p=257, mode="sparse", layout="batched", seed=5),
    rfuzz.Case(batch=2, m=3, k=257, n=31, p=65521, mode="high_limb", layout="batched", seed=6),
]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"{c.mode}-{c.layout}-k{c.k}")
def test_plain_matmuls_exact_against_reference(case):
    a, b = rfuzz.operands(case)
    want = rfuzz.oracle(a, b, case.p)
    ta, tb = torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32))
    ja, jb = jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32)
    for ours, theirs in ((gf.mod_matmul_f32, rgf.mod_matmul_f32), (gf.mod_matmul_int32, rgf.mod_matmul_int32)):
        got = ours(ta, tb, case.p)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(theirs(ja, jb, case.p)))


def test_int32_exact_at_the_accumulator_bound():
    """Maximal operands at the exact accumulator limit must not wrap."""
    a = torch.full((1, gf.INT32_ACC_K), P - 1, dtype=torch.int32)
    b = torch.full((gf.INT32_ACC_K, 1), P - 1, dtype=torch.int32)
    assert int(gf.mod_matmul_int32(a, b, P)[0, 0]) == (gf.INT32_ACC_K * (P - 1) ** 2) % P


def test_loud_errors_at_the_bounds():
    with pytest.raises(ValueError, match="wrap silently"):
        gf.mod_matmul_int32(
            torch.zeros((2, gf.INT32_ACC_K + 1), dtype=torch.int32),
            torch.zeros((gf.INT32_ACC_K + 1, 2), dtype=torch.int32),
        )
    z = torch.zeros((8, 8), dtype=torch.int32)
    for fn in (gf.mod_matmul_f32, gf.mod_matmul_int32):
        with pytest.raises(ValueError, match="2\\*\\*16"):
            fn(z, z, 65537)
    with pytest.raises(ValueError):
        gf.barrett_reduce_u32(_t([1]), 65537)
    with pytest.raises(ValueError, match="counter space"):
        gf.field_mask((0, 0), (1 << 16, 1 << 16), P)


def test_random_field_device_is_seeded_and_in_range():
    g1 = torch.Generator().manual_seed(9)
    g2 = torch.Generator().manual_seed(9)
    x1 = gf.random_field_device(g1, (4, 50), P)
    x2 = gf.random_field_device(g2, (4, 50), P)
    assert torch.equal(x1, x2) and x1.dtype == torch.int32
    assert int(x1.min()) >= 0 and int(x1.max()) < P


def test_field_host_half_matches_reference():
    f, rf = gf.Field(P), rgf.Field(P)
    rng = np.random.default_rng(1)
    pts = rng.integers(1, P, 6)
    v = f.vandermonde(pts, range(6))
    np.testing.assert_array_equal(v, rf.vandermonde(pts, range(6)))
    np.testing.assert_array_equal(f.inv_matrix(v), rf.inv_matrix(v))
    x = rng.standard_normal(20)
    np.testing.assert_array_equal(f.decode(f.encode(x, 64), 64), rf.decode(rf.encode(x, 64), 64))
