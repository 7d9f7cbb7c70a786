"""The port on the card: each CUDA kernel against its plain version, and
the batched engine through the kernels against the same engine on the CPU.

Every test here needs a CUDA GPU and skips without one.  The file
imports torch, numpy and the port only, so it runs on a machine without
JAX:  ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import constructions, gf, planner, protocol
from repro_torch.kernels.modmatmul import kernel as K
from repro_torch.kernels.modmatmul import ops, ref

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


# (a shape, b shape, p, mode): shared operands on either side, ragged
# M/N/K around the tile and lazy-reduction edges, a deep K
_CASES = [
    ((3, 17, 129), (3, 129, 100), 65521, "uniform"),
    ((17, 6), (4, 6, 1000), 65521, "maximal"),
    ((2, 70, 257), (257, 65), 65519, "high_limb"),
    ((2, 33, 128), (2, 128, 77), 4093, "near_p"),
    ((40, 8192), (8192, 50), 65521, "high_limb"),
]


@pytest.mark.parametrize("variant", ["int32", "f32"])
@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"{c[0]}@{c[1]}-{c[3]}")
def test_kernel_matches_plain_version(cuda, variant, case):
    sa, sb, p, mode = case
    rng = np.random.default_rng(len(sa) * 1000 + sa[-1])
    a, b = (torch.as_tensor(_draw(rng, s, mode, p), dtype=torch.int32, device=cuda) for s in (sa, sb))
    # z = 5 crosses one 4-row pass of the epilogue's mask generation
    v = torch.as_tensor(_draw(rng, (sa[-2], 5), mode, p), dtype=torch.int32, device=cuda)
    K.reset_launch_counts()
    got = K.modmatmul_cuda(a, b, p, variant)
    gotm = K.modmatmul_masked_cuda(a, b, v, (5, 6), p, variant)
    torch.cuda.synchronize()
    assert K.LAUNCHES[f"modmatmul_{variant}"] == 1
    assert K.LAUNCHES[f"modmatmul_{variant}_masked"] == 1
    assert torch.equal(got, ref.PLAIN[variant](a, b, p))
    assert torch.equal(gotm, ref.modmatmul_masked_plain(a, b, v, (5, 6), p, variant))
    np.testing.assert_array_equal(got.cpu().numpy(), ref.modmatmul_ref(a.cpu(), b.cpu(), p))


def test_int32_kernel_folds_past_the_raw_accumulator_bound(cuda):
    k = 2 * gf.INT32_ACC_K + 5
    a = torch.full((3, k), P - 1, dtype=torch.int32, device=cuda)
    b = torch.full((k, 5), P - 1, dtype=torch.int32, device=cuda)
    got = K.modmatmul_cuda(a, b, P, "int32")
    assert bool((got == (k * (P - 1) ** 2) % P).all())


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    a = torch.ones((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.modmatmul_cuda(a.t(), a, P)
    with pytest.raises(ValueError, match="int32"):
        K.modmatmul_cuda(a.long(), a.t().contiguous().long(), P)
    with pytest.raises(ValueError, match="CPU tensors only"):
        ops.mod_matmul(a, a.t().contiguous(), backend="int32")


@pytest.mark.parametrize("fused", [False, True])
def test_run_batched_on_the_card_equals_the_cpu_run(cuda, fused):
    plan = planner.get_plan(
        constructions.build_scheme("age", 2, 2, 2),
        planner.BlockShapes(k=64, ma=32, mb=48, s=2, t=2),
    )
    rng = np.random.default_rng(5)
    a = rng.integers(0, P, (3, 64, 32))
    b = rng.integers(0, P, (3, 64, 48))
    want, _ = protocol.run_batched(plan, a, b, seed=2, fused_masks=fused, device="cpu")
    K.reset_launch_counts()
    got, _ = protocol.run_batched(plan, a, b, seed=2, fused_masks=fused)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    expect = {"modmatmul_int32": 2, "modmatmul_int32_masked": 3} if fused else {"modmatmul_int32": 6}
    assert {k: v for k, v in K.LAUNCHES.items() if v} == expect
    if fused:  # the in-kernel mask stream: shares bit-identical to the CPU's
        key = gf.prng_key(9)
        for x, y in zip(
            protocol.share_batched(plan, a, b, key, fused_masks=True),
            protocol.share_batched(plan, a, b, key, fused_masks=True, device="cpu"),
        ):
            assert torch.equal(x.cpu(), y)
