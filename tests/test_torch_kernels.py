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
from repro_torch.kernels.modmatmul import ablate, ops, ref
from repro_torch.kernels.modmatmul import kernel as K

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
    # the skinny design covers all M rows and all of K, 2 columns a thread
    assert ops.pick_tiles(17, 6, 1000, backend="cuda_int32") == (17, 512, 6)
    assert ops.pick_tiles(17, 6, 1000, backend="cuda") == (17, 512, 6)
    assert ops.pick_tiles(256, 2560, 2048, backend="cuda") == K.WGMMA_TILES
    assert ops.pick_tiles(256, 2560, 2048, backend="cuda_int32") == K.MMA_TILES
    assert ops.padded_shape(17, 6, 1000, (17, 512, 6)) == (17, 6, 1024)
    assert ops.padded_shape(17, 6, 1000, (64, 64, 32)) == (64, 32, 1024)
    assert ops.padding_waste(64, 32, 64, (64, 64, 32)) == 0.0
    assert ops.padding_waste(256, 2560, 2048, K.MMA_TILES) == 0.0
    assert 0.0 < ops.padding_waste(17, 6, 1000, (17, 512, 6)) < ops.padding_waste(
        17, 6, 1000, (64, 64, 32)) < 1.0
    ops.register_tile_chooser("cuda", lambda m, k, n, z=0: (16, 64, 32))
    try:
        with pytest.raises(ValueError, match="not compiled"):
            ops.mod_matmul(
                torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int32),
                backend="cuda",
            )
    finally:
        ops.register_tile_chooser("cuda", ops._pick_tiles_f32)


# ----------------------------------------------------------------------
# the shape rule that picks a compiled design
# ----------------------------------------------------------------------
# the six int32 products of run_batched at Mistral-NeMo q-projection
# width (AGE s = t = z = 2, batch 4): (batch, M, K, N)
_MAIN_SITES = {
    "P1 share A": (4, 17, 6, 655360),
    "P1 share B": (4, 17, 6, 5242880),
    "P2 multiply": (68, 256, 2560, 2048),
    "P2 mix": (4, 17, 17, 524288),
    "P2 noise": (4, 17, 2, 524288),
    "P3 decode": (4, 6, 6, 524288),
}


def test_main_path_sites_come_from_the_plan():
    from repro_torch.core import constructions, planner

    plan = planner.get_plan(
        constructions.build_scheme("age", 2, 2, 2),
        planner.BlockShapes(k=5120, ma=512, mb=4096, s=2, t=2),
    )
    sh, n = plan.shapes, plan.n_total
    na, nb = len(plan.scheme.fa_powers), len(plan.scheme.fb_powers)
    blk = sh.blk_y[0] * sh.blk_y[1]
    assert _MAIN_SITES == {
        "P1 share A": (4, n, na, sh.blk_a[0] * sh.blk_a[1]),
        "P1 share B": (4, n, nb, sh.blk_b[0] * sh.blk_b[1]),
        "P2 multiply": (4 * n, sh.blk_a[0], sh.blk_a[1], sh.blk_b[1]),
        "P2 mix": (4, n, plan.n_workers, blk),
        "P2 noise": (4, n, plan.scheme.z, blk),
        "P3 decode": (4, plan.decode_threshold, plan.decode_threshold, blk),
    }


@pytest.mark.parametrize("site", sorted(_MAIN_SITES))
@pytest.mark.parametrize("masked", [False, True])
def test_main_path_sites_dispatch_to_their_design(site, masked):
    batch, m, k, n = _MAIN_SITES[site]
    z = 2 if masked else 0
    deep = site == "P2 multiply"
    assert K.choose_design("int32", masked, batch, m, k, n, z) == ("mma" if deep else "skinny")
    assert K.choose_design("f32", masked, batch, m, k, n, z) == ("wgmma" if deep else "skinny")


@pytest.mark.parametrize(
    "m,k,z,want",
    [
        (32, 32, 0, "skinny"), (33, 32, 0, "mma"), (32, 33, 0, "mma"), (1, 1, 0, "skinny"),
        (32, 32, 96, "skinny"), (32, 32, 97, "mma"), (8, 2, 126, "skinny"), (8, 2, 127, "mma"),
    ],
)
def test_skinny_cap_edges(m, k, z, want):
    assert K.choose_design("int32", z > 0, 3, m, k, 1000, z) == want
    assert K.design_tiles(want, m, k)[0] == (m if want == "skinny" else K.MMA_TILES[0])
    # the f32 variant has the same cap: its skinny accumulators stay below 2**24
    f32 = "skinny" if want == "skinny" else "wgmma"
    assert K.choose_design("f32", z > 0, 3, m, k, 1000, z) == f32
    assert K.design_tiles(f32, m, k)[0] == (m if f32 == "skinny" else K.WGMMA_TILES[0])


# (M, N, whether each design's grid takes it): N tiles are unbounded on
# grid.x for every design; f32_wgmma's M tiles are on grid.y (65535) and
# its A split strides over M; int32_mma's M x N tiles share grid.x.
_WIDE = 65535 * 128 + 1  # one M tile past grid.y


@pytest.mark.parametrize(
    "m,n,mma_ok,wgmma_ok",
    [
        (40, 10_000_000, True, True), (70_000, 8, True, True),
        (70_000, 10_000_000, True, True), (_WIDE, 8, True, False),
        (_WIDE, 5_000_000, False, False),
    ],
)
def test_grid_limits_of_the_tensor_core_designs(m, n, mma_ok, wgmma_ok):
    assert K.choose_design("int32", False, 1, m, 40, n) == "mma"
    assert K.choose_design("f32", False, 1, m, 40, n) == "wgmma"
    assert K._grid_ok("mma", 1, m, n) is mma_ok
    assert K._grid_ok("wgmma", 1, m, n) is wgmma_ok
    assert K._grid_ok("wgmma", 65535, m, n) is wgmma_ok
    assert not K._grid_ok("wgmma", 65536, m, n)


def _compiled_constant(source: str, name: str) -> int:
    import re

    text = (K.CSRC / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, (source, name, found)
    return int(found[0])


def test_fold_and_cap_constants_match_the_source_and_their_bounds():
    mma_src, skinny_src, wgmma_src = "int32_mma.cuh", "skinny.cuh", "f32_wgmma.cuh"
    assert K.MMA_TILES == tuple(_compiled_constant(mma_src, x) for x in ("BM", "BN", "BK"))
    assert K.MMA_FOLD_K == _compiled_constant(mma_src, "FOLD_K")
    assert (K.SKINNY_MAX_M, K.SKINNY_MAX_K, K.SKINNY_MAX_TERMS, K.SKINNY_THREADS) == tuple(
        _compiled_constant(skinny_src, x)
        for x in ("SKINNY_MAX_M", "SKINNY_MAX_K", "SKINNY_MAX_TERMS", "SKINNY_THREADS")
    )
    assert K.WGMMA_TILES == tuple(_compiled_constant(wgmma_src, x) for x in ("BM", "BN", "BK"))
    assert K.WGMMA_FOLD_K == _compiled_constant(wgmma_src, "FOLD_K")
    # mma: the merged cross accumulator gains 2 * 255**2 per K step and
    # must stay below 2**31 (s32) between folds; ll also carries a residue
    assert K.MMA_FOLD_K * 2 * 255**2 < 2**31
    assert K.MMA_FOLD_K * 255**2 + (P - 1) < 2**31
    assert K.MMA_FOLD_K % K.MMA_TILES[2] == 0
    # skinny: each of K + z terms adds (256c mod p) * bh + c * bl
    assert K.SKINNY_MAX_TERMS * 2 * (P - 1) * 255 < 2**32
    assert K.SKINNY_MAX_TERMS >= K.SKINNY_MAX_K + 2  # the protocol's z = 2 fits at any skinny K
    # f32 skinny: each term adds at most 2 * 255**2 to each float
    # accumulator, which must stay an exact integer below 2**24
    assert K.SKINNY_MAX_TERMS * 2 * 255**2 < 2**24
    # f32_wgmma: a set holds its residue (< p) plus one fold period of
    # 2 * 255**2 per K below 2**24; the period is whole K tiles, an even
    # count so the second consumer can fold half a period early
    assert K.WGMMA_FOLD_K * 2 * 255**2 + (P - 1) < 2**24
    assert (K.WGMMA_FOLD_K * 2) * 2 * 255**2 >= 2**24  # 128 is the largest power of two
    assert K.WGMMA_FOLD_K % (2 * K.WGMMA_TILES[2]) == 0


def test_build_hash_covers_every_source():
    names = {p.name for p in K.CSRC.glob("*.cu*")}
    assert {"modmatmul.cu", "common.cuh", "int32_mma.cuh", "f32_wgmma.cuh", "skinny.cuh"} <= names
    text = K.SOURCE.read_text()
    for name in names - {"modmatmul.cu"}:
        assert f'#include "{name}"' in text


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


@pytest.mark.parametrize("variant", sorted(ablate.VARIANTS))
def test_ablation_patches_still_apply_to_the_sources(variant):
    for fname, old, _ in ablate.VARIANTS[variant]:
        assert (K.CSRC / fname).read_text().count(old) == 1, (variant, fname, old)
