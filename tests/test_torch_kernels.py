"""The port's GF(p) matmul kernels and their dispatch.

On the CPU the kernel wrappers run their plain versions; those are held
against the JAX package's Pallas tile bodies in interpret mode (at the
reference tests' bm=8, bn=128, bk=128) and against the host oracle.  The
CUDA kernels themselves are held against these plain versions on the
card by ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import gf as rgf
from repro.kernels.modmatmul import kernel as rkernel
from repro.kernels.modmatmul import ops as rops
from repro_torch.kernels.modmatmul import kernel as K
from repro_torch.kernels.modmatmul import ops, ref

P = 65521


def _rand(rng, shape, p=P):
    return rng.integers(0, p, shape).astype(np.int32)


# ----------------------------------------------------------------------
# plain versions against the Pallas tile bodies (interpret mode)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["f32", "int32"])
@pytest.mark.parametrize("layout", ["batched", "lhs2d", "rhs2d"])
def test_plain_version_matches_pallas_interpret(variant, layout):
    rng = np.random.default_rng(1)
    sa = (2, 16, 256) if layout != "lhs2d" else (16, 256)
    sb = (2, 256, 128) if layout != "rhs2d" else (256, 128)
    a, b = _rand(rng, sa), _rand(rng, sb)
    want = rkernel.modmatmul_pallas(
        jnp.asarray(a), jnp.asarray(b), p=P, bm=8, bn=128, bk=128,
        interpret=True, variant=variant,
    )
    got = K.modmatmul_cuda(torch.from_numpy(a), torch.from_numpy(b), P, variant)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), ref.modmatmul_ref(a, b, P))


@pytest.mark.parametrize("variant", ["f32", "int32"])
@pytest.mark.parametrize("batched", [False, True])
def test_masked_plain_version_matches_pallas_interpret(variant, batched):
    rng = np.random.default_rng(11)
    z, ncols = 3, 100
    sa = (2, 16, 256) if batched else (16, 256)
    sb = (2, 256, 128) if batched else (256, 128)
    a, b = _rand(rng, sa), _rand(rng, sb)
    v = _rand(rng, (16, z))
    key = (99, 100)
    want = rkernel.modmatmul_masked_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(v), jnp.asarray(key, jnp.uint32),
        p=P, ncols=ncols, bm=8, bn=128, bk=128, interpret=True, variant=variant,
    )
    # the Pallas kernel pads N to the tile; the port's logical width is N
    got = K.modmatmul_masked_cuda(
        torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b[..., :ncols])),
        torch.from_numpy(v), key, P, variant,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[..., :ncols])


def test_int32_plain_version_folds_past_the_accumulator_bound():
    """The int32 kernel folds its raw sums every INT32_ACC_K of depth and
    so has no depth limit; its plain version folds the same way."""
    k = 2 * rgf.INT32_ACC_K + 5
    a = torch.full((2, k), P - 1, dtype=torch.int32)
    b = torch.full((k, 3), P - 1, dtype=torch.int32)
    got = ref.modmatmul_int32_plain(a, b, P)
    assert bool((got == (k * (P - 1) ** 2) % P).all())


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(_rand(rng, (3, 5, 7)))
    b = torch.from_numpy(_rand(rng, (7, 9)))
    v = torch.from_numpy(_rand(rng, (5, 2)))
    before = dict(K.LAUNCHES)
    assert torch.equal(K.modmatmul_cuda(a, b, P, "int32"), ref.modmatmul_int32_plain(a, b, P))
    assert torch.equal(
        K.modmatmul_masked_cuda(a, b, v, (1, 2), P, "f32"),
        ref.modmatmul_masked_plain(a, b, v, (1, 2), P, "f32"),
    )
    assert K.LAUNCHES == before


# ----------------------------------------------------------------------
# dispatch (ops.py) against the reference's ops
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 128, 256, 257, rgf.INT32_ACC_K, rgf.INT32_ACC_K + 1])
def test_auto_follows_the_reference_cpu_rule_and_picks_int32_on_cuda(k):
    assert ops._resolve_auto(k, torch.device("cpu")) == rops._resolve_auto(k)
    assert ops._resolve_auto(k, torch.device("cuda")) == "cuda_int32"


@pytest.mark.parametrize("backend", ["auto", "f32limb", "int32", "cuda", "cuda_int32"])
def test_mod_matmul_backends_match_reference(backend):
    rng = np.random.default_rng(3)
    a, b = _rand(rng, (2, 3, 9, 300)), _rand(rng, (300, 40))
    want = np.asarray(rops.mod_matmul(jnp.asarray(a), jnp.asarray(b), p=P, backend="f32limb"))
    got = ops.mod_matmul(torch.from_numpy(a), torch.from_numpy(b), p=P, backend=backend)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", ["f32limb", "int32", "cuda", "cuda_int32"])
def test_mod_matmul_masked_backends_match_reference(backend):
    rng = np.random.default_rng(12)
    a, b = _rand(rng, (3, 9, 300)), _rand(rng, (3, 300, 40))
    v = _rand(rng, (9, 2))
    key = (4, 8)
    want = rops.mod_matmul_masked(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(v), jnp.asarray(key, jnp.uint32),
        p=P, backend="int32",
    )
    got = ops.mod_matmul_masked(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(v), key, p=P, backend=backend
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_polyeval_and_masked_match_reference():
    rng = np.random.default_rng(4)
    vander, coeffs = _rand(rng, (7, 5)), _rand(rng, (2, 5, 3, 4))
    coeffs[:, [1, 3]] = 0  # secret rows carry zeros in the masked form
    vs = vander[:, [1, 3]]
    want = rops.polyeval(jnp.asarray(vander), jnp.asarray(coeffs), p=P)
    got = ops.polyeval(torch.from_numpy(vander), torch.from_numpy(coeffs), p=P)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = (3, 5)
    want = rops.polyeval_masked(
        jnp.asarray(vander), jnp.asarray(coeffs), jnp.asarray(vs),
        jnp.asarray(key, jnp.uint32), p=P,
    )
    got = ops.polyeval_masked(
        torch.from_numpy(vander), torch.from_numpy(coeffs), torch.from_numpy(vs), key, p=P
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_backend_refuses_device_tensors():
    a = torch.empty((4, 4), dtype=torch.int32, device="meta")
    for backend in ("f32limb", "int32"):
        with pytest.raises(ValueError, match="CPU tensors only"):
            ops.mod_matmul(a, a, backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.mod_matmul(torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int32), backend="pallas")


def test_flatten_batch_keeps_a_shared_operand_2d():
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert ops._flatten_batch(x, (5,)).data_ptr() == x.data_ptr()
    assert tuple(ops._flatten_batch(x[None, None], (2, 5)).shape) == (3, 4)
    y = torch.zeros((2, 1, 3, 4), dtype=torch.int32)
    assert tuple(ops._flatten_batch(y, (2, 5)).shape) == (10, 3, 4)


def test_tiles_and_padding_accounting():
    assert ops.pick_tiles(17, 6, 1000, backend="cuda_int32") == K.KERNEL_TILES
    assert ops.padded_shape(17, 6, 1000, (64, 64, 32)) == (64, 32, 1024)
    assert ops.padding_waste(64, 32, 64, (64, 64, 32)) == 0.0
    assert 0.0 < ops.padding_waste(17, 6, 1000, (64, 64, 32)) < 1.0
    ops.register_tile_chooser("cuda", lambda m, k, n: (16, 64, 32))
    try:
        with pytest.raises(ValueError, match="not compiled"):
            ops.mod_matmul(
                torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int32),
                backend="cuda",
            )
    finally:
        ops.register_tile_chooser("cuda", ops._pick_tiles_cuda)


def test_wrapper_checks_shapes_and_mask_counter_space():
    z = torch.zeros((4, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="inner dims"):
        K.modmatmul_cuda(z, z, P)
    with pytest.raises(ValueError, match="counter space"):
        K.modmatmul_masked_cuda(
            torch.zeros((2, 1), dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32).expand(1, 1 << 31),
            torch.zeros((2, 2), dtype=torch.int32), (0, 0), P,
        )
