"""The Phase-1 share as one product per operand, ``a @ blocks(x) + v @ r`` (CPU).

``ops.mod_matmul_blocks_plus`` runs the skinny kernel's blocks form on
the card where ``ops.skinny_fuses`` holds and refuses elsewhere;
``protocol._share`` takes it for each operand where the rule holds and
keeps its coefficient-stack path elsewhere.  Here: the dispatch rule,
the kernel wrapper's plain route against an integer oracle at odd
geometries, its shape checks, the shares it assembles against the stack
path bit for bit, the ``protocol.share.*`` counters and, on a fake card
(every launch replaced by its plain version, counted as the wrapper
counts it), the launches one call records.  The kernel itself is held
against the same arithmetic in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import constructions, gf, planner, protocol
from repro_torch.kernels.modmatmul import fuzz, ops, ref
from repro_torch.kernels.modmatmul import kernel as K
from repro_torch.obs.metrics import REGISTRY

P = 65521
CUDA = torch.device("cuda")  # a device value only: nothing is allocated on it


@pytest.mark.parametrize(
    "m,k,z,fuses",
    [(17, 4, 2, True), (16, 4, 1, True), (23, 6, 2, True), (1, 1, 0, True), (32, 32, 96, True),
     (33, 4, 2, False), (17, 33, 2, False), (32, 32, 97, False), (35, 8, 4, False)],
)
def test_share_fuses_on_the_card_inside_the_skinny_rule(m, k, z, fuses):
    for backend in ("auto", "cuda_int32", "cuda"):
        assert ops.skinny_fuses(backend, CUDA, m, k, z) is fuses
        assert ops.skinny_fuses(backend, "cpu", m, k, z) is False
    for backend in ("int32", "f32limb"):
        assert ops.skinny_fuses(backend, CUDA, m, k, z) is False


def _oracle(a, x, offsets, bc, ld, v, r, p=P):
    """a @ blocks + v @ r over Python integers, the blocks picked element
    by element."""
    obj = lambda t: np.asarray(t, np.int64).astype(object)  # noqa: E731
    n = r.shape[-1]
    flat = obj(x).reshape(tuple(x.shape[:-2]) + (-1,))
    idx = np.array([[int(o) + (j // bc) * ld + j % bc for j in range(n)] for o in offsets])
    return ((obj(a) @ flat[..., idx] + obj(v) @ obj(r)) % p).astype(np.int64)


def _operands(seed, batch, m, k, z, bc, n_rows, ld, offsets, x_shape, shared_x=False):
    """a [batch, m, k], x [batch, *x_shape] (a broadcast view of one batch
    element when ``shared_x``: batch stride 0), offsets [k], v [m, z],
    r [batch, z, n_rows * bc]."""
    rng = np.random.default_rng(seed)
    draw = lambda shape: torch.as_tensor(rng.integers(0, P, shape), dtype=torch.int32)  # noqa: E731
    a = draw((batch, m, k))
    x = draw((1,) + x_shape).expand(batch, *x_shape) if shared_x else draw((batch,) + x_shape)
    return (a, x, torch.as_tensor(offsets, dtype=torch.int64), bc, ld, draw((m, z)),
            draw((batch, z, n_rows * bc)))


# (batch, m, k, z, bc, block rows, ld, offsets, x shape, shared x)
_CASES = [
    # A^T [8, 12] in 2 x 2 blocks of [4, 6], rows 12 apart (the share's A)
    (2, 17, 4, 2, 6, 4, 12, [0, 6, 48, 54], (8, 12), False),
    # bc = 3 and 5: not a multiple of 4, so a column group crosses block rows
    (3, 16, 4, 1, 3, 5, 7, [0, 3, 35, 38], (10, 7), False),
    (1, 9, 3, 0, 5, 2, 11, [13, 0, 28], (4, 11), False),
    # offsets out of order and overlapping, ld much larger than bc
    (2, 5, 5, 2, 4, 3, 40, [36, 4, 31, 0, 4], (3, 40), False),
    # x a broadcast view: batch stride 0
    (4, 17, 4, 2, 8, 2, 16, [16, 8, 0, 24], (4, 16), True),
    # bc = 1: every column its own block row
    (2, 6, 2, 1, 1, 9, 3, [2, 0], (9, 3), False),
    # a single block row (bc = N), z = 0
    (2, 23, 6, 0, 10, 1, 10, [50, 40, 30, 20, 10, 0], (6, 10), False),
]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: "b{}-m{}-k{}-z{}-bc{}-ld{}".format(*c[:5], c[6]))
@pytest.mark.parametrize("variant", ["int32", "f32"])
def test_plain_route_equals_the_integer_oracle(case, variant):
    a, x, offsets, bc, ld, v, r = _operands(len(_CASES) + case[1], *case)
    want = torch.as_tensor(_oracle(a, x, offsets, bc, ld, v, r), dtype=torch.int32)
    # the kernel wrapper on CPU tensors: its plain version
    got = K.modmatmul_blocks_plus_cuda(a, x, offsets, bc, ld, v, r, P, variant)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(ref.modmatmul_blocks_plus_plain(a, x, offsets, bc, ld, v, r, P, variant), want)
    # the ops entry launches the form or refuses: never on the CPU
    for backend in ("auto", "int32", "f32limb", "cuda_int32"):
        with pytest.raises(ValueError, match="runs on the card"):
            ops.mod_matmul_blocks_plus(a, x, offsets, bc, ld, v, r, p=P, backend=backend)


def test_plain_route_takes_2d_operands():
    a, x, offsets, bc, ld, v, r = _operands(3, *_CASES[0])
    got = K.modmatmul_blocks_plus_cuda(a[0], x[0], offsets, bc, ld, v, r[0])
    assert got.shape == (17, 24)
    assert torch.equal(got, torch.as_tensor(_oracle(a[0], x[0], offsets, bc, ld, v, r[0]), dtype=torch.int32))
    # a shared a against batched x and r, and a batched a against a shared x
    got = K.modmatmul_blocks_plus_cuda(a[0], x, offsets, bc, ld, v, r)
    assert torch.equal(got, torch.as_tensor(_oracle(a[0], x, offsets, bc, ld, v, r), dtype=torch.int32))
    got = K.modmatmul_blocks_plus_cuda(a, x[0], offsets, bc, ld, v, r)
    assert torch.equal(got, torch.as_tensor(_oracle(a, x[0], offsets, bc, ld, v, r), dtype=torch.int32))


def test_blocks_plus_wrapper_refuses_bad_shapes():
    a, x, offsets, bc, ld, v, r = _operands(4, *_CASES[0])
    with pytest.raises(ValueError, match="offsets must be"):
        K.modmatmul_blocks_plus_cuda(a, x, offsets[:3], bc, ld, v, r)
    with pytest.raises(ValueError, match="v must be"):
        K.modmatmul_blocks_plus_cuda(a, x, offsets, bc, ld, v[:4], r)
    with pytest.raises(ValueError, match="r must be"):
        K.modmatmul_blocks_plus_cuda(a, x, offsets, bc, ld, v, r[:, :1])
    with pytest.raises(ValueError, match="batch dims disagree"):
        K.modmatmul_blocks_plus_cuda(a, x, offsets, bc, ld, v, r[:1])
    for bad_bc, bad_ld in ((5, ld), (0, ld), (48, 48), (bc, bc - 1)):  # 24 columns
        with pytest.raises(ValueError, match="cannot make N"):
            K.modmatmul_blocks_plus_cuda(a, x, offsets, bad_bc, bad_ld, v, r)
    with pytest.raises(ValueError, match="outside x"):
        K.modmatmul_blocks_plus_cuda(a, x, offsets + 1, bc, ld, v, r)
    with pytest.raises(ValueError, match="outside x"):
        K.modmatmul_blocks_plus_cuda(a, x, offsets - 1, bc, ld, v, r)
    # a block's span longer than x's batch element: refused from the shapes
    # alone, before any offset is read
    with pytest.raises(ValueError, match="reads outside x"):
        K.modmatmul_blocks_plus_cuda(a, x, offsets * 0, bc, 40, v, r)


def test_blocks_plus_fuzz_engines():
    found = fuzz.run_fuzz(examples=24, seed=6, engines=["int32_blocks_plus"], device="cpu")
    assert found == [], "\n".join(m.describe() for m in found)
    case = fuzz.Case(batch=2, m=3, k=5, n=12, p=251, mode="uniform", layout="2d", seed=7)
    a, b = fuzz.operands(case)
    a1, x, offsets, bc, ld, v, r = fuzz.blocks_plus_operands(a, b, case.p)
    assert a1.shape == (3, 1) and v.shape == (3, 4) and len(offsets) == 1 and 12 % bc == 0
    for engine in ("cuda_blocks_plus", "cuda_int32_blocks_plus"):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            fuzz.check_case(case, engines=[engine], device="cpu")


# ----------------------------------------------------------------------
# the share through the protocol
# ----------------------------------------------------------------------
def _plan(s=2, t=2, z=2, n_spare=0, k=None, ma=None, mb=None):
    return planner.get_plan(
        constructions.build_scheme("age", s, t, z),
        planner.BlockShapes(k=k or 8 * s, ma=ma or 4 * t, mb=mb or 6 * t, s=s, t=t), n_spare=n_spare,
    )


def _inputs(plan, batch=2, seed=1):
    rng = np.random.default_rng(seed)
    sh = plan.shapes
    return rng.integers(0, P, (batch, sh.k, sh.ma)), rng.integers(0, P, (batch, sh.k, sh.mb))


def _oracle_y(a, b):
    return np.einsum("bki,bkj->bij", a.astype(object), b.astype(object)) % P


def _share_counts():
    snap = REGISTRY.snapshot()["counters"]
    return snap.get("protocol.share.fused", 0), snap.get("protocol.share.unfused", 0)


def _treat_cpu_as_card(monkeypatch):
    """The dispatch rule as it reads on the card, for CPU tensors: the
    share's blocks form and the reduce's loaded rows both take it."""
    rule = ops.skinny_fuses

    def on_card(backend, device, m, k, z):
        return rule(backend, CUDA, m, k, z)

    monkeypatch.setattr(ops, "skinny_fuses", on_card)
    monkeypatch.setattr(protocol, "skinny_fuses", on_card)


# AGE (s, t, z): the q-projection's 2/2/2, the head's 2/2/1, s != t both ways
_SCHEMES = [(2, 2, 2), (2, 2, 1), (3, 2, 2), (2, 3, 1)]


@pytest.mark.parametrize("s,t,z", _SCHEMES)
@pytest.mark.parametrize("backend", ["cuda_int32", "cuda"])
def test_blocks_shares_equal_the_stack_path_bit_for_bit(monkeypatch, s, t, z, backend):
    plan = _plan(s, t, z, k=4 * s, ma=6 * t, mb=5 * t)
    assert plan.n_total <= 32
    a, b = _inputs(plan, batch=3, seed=s * 10 + t + z)
    key = gf.prng_key(9)
    want = protocol.share_batched(plan, a, b, key, backend=backend, device="cpu")
    _treat_cpu_as_card(monkeypatch)
    before = _share_counts()
    got = protocol.share_batched(plan, a, b, key, backend=backend, device="cpu")
    after = _share_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)


def test_share_counts_unfused_once_per_call_on_the_cpu():
    plan = _plan()
    a, b = _inputs(plan)
    before = _share_counts()
    for seed in (1, 2):
        y, _ = protocol.run_batched(plan, a, b, seed=seed, device="cpu")
        np.testing.assert_array_equal(y.numpy(), _oracle_y(a, b).astype(np.int64))
    protocol.run_batched(plan, a, b, seed=3, fused_masks=True, device="cpu")  # no choice to count
    after = _share_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (0, 2)


@pytest.mark.parametrize("n_spare", [0, 3])
def test_share_where_the_rule_holds_counts_fused_and_gives_the_same_y(monkeypatch, n_spare):
    plan = _plan(n_spare=n_spare)
    a, b = _inputs(plan, seed=n_spare)
    kw = dict(seed=5, backend="cuda_int32", device="cpu")
    want, _ = protocol.run_batched(plan, a, b, **kw)
    _treat_cpu_as_card(monkeypatch)
    before = _share_counts()
    got, _ = protocol.run_batched(plan, a, b, **kw)
    protocol.run_batched(plan, a, b, fused_masks=True, **kw)  # the masked stack path: not counted
    after = _share_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), _oracle_y(a, b).astype(np.int64))


def test_share_outside_the_rule_or_without_the_plan_fields_keeps_the_stack(monkeypatch):
    _treat_cpu_as_card(monkeypatch)
    wide = _plan(s=4, t=2, z=4)  # 35 workers: past the skinny designs' 32 rows
    a, b = _inputs(wide)
    before = _share_counts()
    y, _ = protocol.run_batched(wide, a, b, seed=2, backend="cuda_int32", device="cpu")
    np.testing.assert_array_equal(y.numpy(), _oracle_y(a, b).astype(np.int64))
    after = _share_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
    # a DevicePlan carried over from bare arrays lacks the blocks-form fields
    plan = _plan()
    arrays = {k: v for k, v in protocol.device_plan_arrays(plan).items() if k in convert.FIELDS}
    dp = convert.device_plan_from_reference(arrays, P)
    assert dp.va_blocks is None and dp.b_offsets is None
    a, b = (torch.as_tensor(x, dtype=torch.int32) for x in _inputs(plan))
    dims = protocol._plan_dims(plan)
    got = protocol._share(a, b, (3, 4), dp, backend="cuda_int32", fused_masks=False, **dims)
    own = protocol._share(a, b, (3, 4), protocol.device_plan(plan, "cpu"), backend="cuda_int32",
                          fused_masks=False, **dims)
    assert all(torch.equal(g, w) for g, w in zip(got, own))
    assert _share_counts()[1] - after[1] == 1 and _share_counts()[0] - after[0] == 1


def test_device_plan_share_fields_match_the_stack_layout():
    plan = _plan(3, 2, 2, k=12, ma=10, mb=8)
    arrays = protocol.device_plan_arrays(plan)
    sch, sh = plan.scheme, plan.shapes
    np.testing.assert_array_equal(arrays["va_blocks"], arrays["va"][:, arrays["a_pos"]])
    np.testing.assert_array_equal(arrays["vb_secrets"], arrays["vb"][:, arrays["sb_pos"]])
    # every data block and secret has its own row of the stack
    for pos, spos in (("a_pos", "sa_pos"), ("b_pos", "sb_pos")):
        rows = list(arrays[pos]) + list(arrays[spos])
        assert len(set(rows)) == len(rows) == sch.t * sch.s + sch.z
    # block (i, j) of A^T [ma, k] starts at row i * ma/t, column j * k/s
    bra, bca = sh.blk_a
    want = [i * bra * sh.k + j * bca for i in range(sch.t) for j in range(sch.s)]
    assert list(arrays["a_offsets"]) == want
    brb, bcb = sh.blk_b
    want = [k * brb * sh.mb + l * bcb for k in range(sch.s) for l in range(sch.t)]
    assert list(arrays["b_offsets"]) == want


def test_block_offsets_refuse_blocks_that_leave_the_matrix():
    # 2 x 3 blocks [4, 5] of a [8, 15] matrix: the last starts at 4 * 15 + 10
    offs = protocol._block_offsets(2, 3, 4, 5, 15, 8 * 15)
    assert list(offs) == [0, 5, 10, 60, 65, 70]
    assert int(offs[-1]) + 3 * 15 + 5 == 8 * 15
    with pytest.raises(ValueError, match="leave a matrix"):
        protocol._block_offsets(2, 3, 4, 5, 15, 8 * 15 - 1)  # one element short
    with pytest.raises(ValueError, match="leave a matrix"):
        protocol._block_offsets(2, 3, 4, 5, 14, 8 * 15)  # a row narrower than 3 blocks


# ----------------------------------------------------------------------
# the launches one call records, on a fake card
# ----------------------------------------------------------------------
@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors through the kernel wrappers' launch paths: the device
    check passes, each launch writes its plain version's result and is
    counted as on the card, and the share's and the reduce's rules read
    as on the card."""
    variant_of = lambda design: design.split("_")[0]  # noqa: E731
    calls = []

    def launch_into(lib, design, a, b, out, p, v=None, key=(0, 0)):
        variant = variant_of(design)
        out.copy_(ref.PLAIN[variant](a, b, p) if v is None
                  else ref.modmatmul_masked_plain(a, b, v, key, p, variant))
        return 0

    def launch_rows_plus_into(lib, design, a, h, rows, v, r, out, p):
        out.copy_(ref.modmatmul_rows_plus_plain(a, h, rows, v, r, p, variant_of(design)))
        return 0

    def launch_blocks_plus_into(lib, design, a, x, offsets, bc, ld, v, r, out, p):
        calls.append((design, tuple(x.shape), x.stride(), bc, ld))
        out.copy_(ref.modmatmul_blocks_plus_plain(a, x, offsets, bc, ld, v, r, p, variant_of(design)))
        return 0

    monkeypatch.setattr(K, "_check_device", lambda name, *tensors: None)
    monkeypatch.setattr(K, "load_library", lambda: None)
    monkeypatch.setattr(K, "launch_into", launch_into)
    monkeypatch.setattr(K, "launch_rows_plus_into", launch_rows_plus_into)
    monkeypatch.setattr(K, "launch_blocks_plus_into", launch_blocks_plus_into)
    monkeypatch.setattr(ops, "modmatmul_cuda", lambda a, b, p, variant: K._launch(variant, a, b, p))
    monkeypatch.setattr(ops, "modmatmul_rows_plus_cuda",
                        lambda a, h, rows, v, r, p, variant: K._launch_rows_plus(variant, a, h, rows, v, r, p))
    monkeypatch.setattr(ops, "modmatmul_blocks_plus_cuda",
                        lambda a, x, offsets, bc, ld, v, r, p, variant:
                        K._launch_blocks_plus(variant, a, x, offsets, bc, ld, v, r, p))
    _treat_cpu_as_card(monkeypatch)
    K.reset_launch_counts()
    yield calls
    K.reset_launch_counts()


@pytest.mark.parametrize("s,t,z", [(2, 2, 2), (3, 2, 2)])
@pytest.mark.parametrize("variant", ["int32", "f32"])
def test_a_call_records_each_share_once_as_ts_plus_z_rows(fake_card, variant, s, t, z):
    plan = _plan(s, t, z)
    a, b = _inputs(plan, batch=3)
    backend = {"int32": "cuda_int32", "f32": "cuda"}[variant]
    y, _ = protocol.run_batched(plan, a, b, seed=4, backend=backend, device="cpu")
    np.testing.assert_array_equal(y.numpy(), _oracle_y(a, b).astype(np.int64))
    assert {k: c for k, c in K.LAUNCHES.items() if c} == {f"modmatmul_{variant}": 5}
    # every product of this small plan is skinny, the P2 multiply too
    assert {k: c for k, c in K.LAUNCHES_BY_KERNEL.items() if c} == {f"{variant}_skinny": 5}
    sh = plan.shapes
    (bra, bca), (brb, bcb) = sh.blk_a, sh.blk_b
    terms = s * t + z
    shapes = K.LAUNCH_SHAPES_BY_KERNEL[f"{variant}_skinny"]
    assert shapes[(3, plan.n_total, terms, bra * bca)] == 1  # share A
    assert shapes[(3, plan.n_total, terms, brb * bcb)] == 1  # share B
    assert terms == len(plan.scheme.fa_powers)  # the stack path's count, unchanged
    # A^T as one contiguous copy, rows k apart; B read where it lies, rows mb apart
    assert fake_card == [(f"{variant}_skinny", (3, sh.ma, sh.k), (sh.ma * sh.k, sh.k, 1), bca, sh.k),
                         (f"{variant}_skinny", (3, sh.k, sh.mb), (sh.k * sh.mb, sh.mb, 1), bcb, sh.mb)]


def test_blocks_launch_refuses_what_the_skinny_designs_cannot(fake_card):
    a, x, offsets, bc, ld, v, r = _operands(5, *_CASES[0])
    with pytest.raises(ValueError, match="outside the skinny designs"):
        K._launch_blocks_plus("int32", torch.zeros((2, 33, 4), dtype=torch.int32), x, offsets, bc, ld,
                              torch.zeros((33, 2), dtype=torch.int32), r, P)
    with pytest.raises(ValueError, match="int64"):
        K._launch_blocks_plus("int32", a, x, offsets.int(), bc, ld, v, r, P)
    with pytest.raises(ValueError, match="contiguous and N apart"):
        K._launch_blocks_plus("int32", a, x.transpose(1, 2).contiguous().transpose(1, 2), offsets,
                              bc, ld, v, r, P)
    out = K._launch_blocks_plus("f32", a, x, offsets, bc, ld, v, r, P)
    assert torch.equal(out, ref.modmatmul_blocks_plus_plain(a, x, offsets, bc, ld, v, r, P))
    assert dict(K.LAUNCH_SHAPES_BY_KERNEL["f32_skinny"]) == {(2, 17, 6, 24): 1}
