"""The port's private FFN stack (``repro_torch.core.moe``) against the
plain reference ``plain_deepseek_v3_ffn.py``, at a tiny size on the CPU:
DeepSeek-V3's structure (one dense sublayer, then MoE sublayers with
``noaux_tc`` routing over 32 experts in 8 groups, top-4 of the 2 best
groups, one shared expert), this device holding 8 of the experts.
Everything is compared exactly: each element of the residual stream
and each expert id."""
import ast
import itertools
from pathlib import Path

import pytest
import torch

import plain_deepseek_v3_ffn as plain
from repro_torch.core import moe
from repro_torch.models.ffn import route_noaux_tc
from repro_torch.obs.metrics import REGISTRY

P = 65521
D, DENSE_F, F, E, TOP_K, GROUPS, KEPT = 64, 32, 16, 32, 4, 8, 2
HELD = [0, 1, 2, 3, 4, 5, 6, 7]
TOKENS = 32
BUCKET = 4
CPU = torch.device("cpu")
CFG = {"scales": plain.SCALES, "eps": 1e-6, "experts": HELD, "top_k": TOP_K, "n_group": GROUPS,
       "topk_group": KEPT, "scaling": 2.5}


def _residues(gen, *shape):
    return torch.randint(0, P, shape, generator=gen, dtype=torch.int32)


def _weights(seed, n_moe=2, experts=E, bias=None):
    """One dense sublayer and ``n_moe`` MoE sublayers, every routed expert's
    weights drawn (``experts`` of them), the bias in ±2**-7."""
    gen = torch.Generator().manual_seed(seed)
    dense = [{"gate_up": _residues(gen, D, 2 * DENSE_F), "down": _residues(gen, DENSE_F, D)}]
    layers = []
    for _ in range(n_moe):
        b = (torch.randint(0, 1024, (E,), generator=gen) - 512).to(torch.float64) * 2.0 ** -16
        layers.append({"router": _residues(gen, D, E), "bias": b if bias is None else bias.clone(),
                       "gate_up": _residues(gen, experts, D, 2 * F),
                       "down": _residues(gen, experts, F, D),
                       "shared_gate_up": _residues(gen, D, 2 * F),
                       "shared_down": _residues(gen, F, D)})
    return dense, layers


def _held(layer, experts):
    """``layer`` with only ``experts``' weights, in that order."""
    ids = torch.as_tensor(experts, dtype=torch.int64)
    return {**layer, "gate_up": layer["gate_up"][ids], "down": layer["down"][ids]}


def _stack(dense, layers, experts=HELD, z=2):
    products = moe.PrivateProducts(z=z, device=CPU)
    fp = moe.FixedPoint()
    subs = [moe.PrivateFFN(w["gate_up"], w["down"], products, fp) for w in dense]
    subs += [moe.PrivateMoE(w["router"], w["bias"], experts, w["gate_up"], w["down"],
                            w["shared_gate_up"], w["shared_down"], products, top_k=TOP_K,
                            n_group=GROUPS, topk_group=KEPT, scaling=2.5, fp=fp, bucket=BUCKET)
             for w in layers]
    stack = moe.PrivateFFNStack(subs, products)
    stack.prepare(TOKENS)
    return stack


def _counters():
    return {k: v for k, v in REGISTRY.snapshot()["counters"].items() if k.startswith("moe.")}


def _grown(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


@pytest.mark.parametrize("seed", [11, 2 ** 33 + 5, 987654321])
def test_the_stack_equals_the_plain_reference(seed):
    dense, full = _weights(seed)
    layers = [_held(w, HELD) for w in full]
    stack = _stack(dense, layers)
    hidden = _residues(torch.Generator().manual_seed(seed + 1), TOKENS, D)
    before = _counters()
    x, ids = stack(hidden, seed=7)
    grown = _grown(before, _counters())
    want_x, want_ids = plain.ffn_stack(hidden, dense, layers, CFG, P)
    assert x.dtype == torch.int64 and tuple(ids.shape) == (2, TOKENS, TOP_K)
    assert torch.equal(x, want_x)
    assert torch.equal(ids, want_ids)
    # the route drops no pair: every pair on a held expert was computed
    assert grown["moe.routed_pairs"] == int(torch.isin(want_ids, torch.tensor(HELD)).sum()) > 0
    # one load read a MoE sublayer, and no plan built
    assert grown["moe.host_syncs"] == 2 and grown.get("moe.plans_built", 0) == 0
    assert grown["moe.padded_rows"] >= 0 and grown["moe.max_load"] > 0


def test_the_protocol_seeds_do_not_move_the_answer():
    dense, full = _weights(5)
    layers = [_held(w, HELD) for w in full]
    stack = _stack(dense, layers)
    hidden = _residues(torch.Generator().manual_seed(6), TOKENS, D)
    x0, ids0 = stack(hidden, seed=0)
    x1, ids1 = stack(hidden, seed=12345)
    assert torch.equal(x0, x1) and torch.equal(ids0, ids1)


def _route_by_hand(logits, bias, k, n_group, topk_group, scaling):
    """The route one token at a time, sorting (−score, id) pairs."""
    scores = torch.sigmoid(logits)
    biased = scores + bias
    e = biased.shape[-1]
    per = e // n_group
    gates, ids = [], []
    for row, srow in zip(biased.tolist(), scores.tolist()):
        group_score = [sum(sorted(row[g * per:(g + 1) * per], reverse=True)[:2])
                       for g in range(n_group)]
        kept = sorted(range(n_group), key=lambda g: (-group_score[g], g))[:topk_group]
        cands = [i for g in kept for i in range(g * per, (g + 1) * per)]
        chosen = sorted(sorted(cands, key=lambda i: (-row[i], i))[:k])
        den = 0.0
        for i in chosen:
            den = den + srow[i]
        ids.append(chosen)
        gates.append([srow[i] / den * scaling for i in chosen])
    return torch.tensor(gates, dtype=torch.float64), torch.tensor(ids)


@pytest.mark.parametrize("case", ["ties", "uniform", "group_ties"])
def test_the_route_against_the_references_with_ties_to_the_lower_id(case):
    gen = torch.Generator().manual_seed(3)
    if case == "ties":  # few distinct logits, no bias: ties everywhere
        logits = torch.randint(-2, 3, (64, E), generator=gen).to(torch.float64)
        bias = torch.zeros(E, dtype=torch.float64)
    elif case == "group_ties":  # every group alike: the lower groups are kept
        logits = torch.randint(-3, 4, (64, E // GROUPS), generator=gen).to(torch.float64)
        logits = logits.repeat(1, GROUPS)
        bias = torch.zeros(E, dtype=torch.float64)
    else:
        logits = torch.randint(-32760, 32761, (64, E), generator=gen).to(torch.float64) / 2.0 ** 13
        bias = (torch.randint(0, 1024, (E,), generator=gen) - 512).to(torch.float64) * 2.0 ** -16
    gates, ids = route_noaux_tc(logits, bias, TOP_K, GROUPS, KEPT, 2.5)
    want_gates, want_ids = plain.route(logits, bias, TOP_K, GROUPS, KEPT, 2.5)
    hand_gates, hand_ids = _route_by_hand(logits, bias, TOP_K, GROUPS, KEPT, 2.5)
    assert torch.equal(ids, want_ids) and torch.equal(ids, hand_ids)
    assert torch.equal(gates, want_gates) and torch.equal(gates, hand_gates)
    if case == "group_ties":
        assert bool((ids < KEPT * (E // GROUPS)).all())


def test_the_route_is_the_published_one():
    """Against the published ``noaux_tc`` form (``torch.topk``, the
    denominator summed in top-k order) on scores without ties: the same
    experts, and gates within a few float64 ulps."""
    gen = torch.Generator().manual_seed(4)
    logits = torch.randn(128, 256, generator=gen, dtype=torch.float64) * 2
    bias = torch.rand(256, generator=gen, dtype=torch.float64) * 0.01
    scores = logits.sigmoid()
    biased = scores + bias
    group_scores = biased.view(128, 8, -1).topk(2, dim=-1)[0].sum(dim=-1)
    group_idx = torch.topk(group_scores, k=4, dim=-1, sorted=False)[1]
    mask = torch.zeros_like(group_scores).scatter_(1, group_idx, 1)
    score_mask = mask.unsqueeze(-1).expand(128, 8, 32).reshape(128, -1)
    tmp = biased.masked_fill(~score_mask.bool(), 0.0)
    topk_idx = torch.topk(tmp, k=8, dim=-1, sorted=False)[1]
    w = scores.gather(1, topk_idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * 2.5
    order = topk_idx.argsort(dim=-1)
    gates, ids = route_noaux_tc(logits, bias, 8, 8, 4, 2.5)
    assert torch.equal(ids, topk_idx.gather(1, order))
    torch.testing.assert_close(gates, w.gather(1, order), rtol=1e-14, atol=0)


@pytest.mark.parametrize("load", ["all_to_one_expert", "none_held"])
def test_dropless_at_extreme_loads(load):
    bias = torch.zeros(E, dtype=torch.float64)
    if load == "all_to_one_expert":
        bias[3] = 8.0  # expert 3 wins every token, and its group with it
    else:
        bias[:len(HELD)] = -8.0  # groups 0 and 1, every held expert, are never kept
    dense, full = _weights(21, bias=bias)
    layers = [_held(w, HELD) for w in full]
    stack = _stack(dense, layers)
    hidden = _residues(torch.Generator().manual_seed(22), TOKENS, D)
    before = _counters()
    x, ids = stack(hidden, seed=1)
    grown = _grown(before, _counters())
    want_x, want_ids = plain.ffn_stack(hidden, dense, layers, CFG, P)
    assert torch.equal(x, want_x) and torch.equal(ids, want_ids)
    held = int(torch.isin(want_ids, torch.tensor(HELD)).sum())
    assert grown["moe.routed_pairs"] == held
    if load == "all_to_one_expert":
        assert bool((ids == 3).any(-1).all())
        assert grown["moe.max_load"] == 2 * TOKENS  # two layers, every token on expert 3
        assert grown["moe.padded_rows"] == 2 * len(HELD) * TOKENS - held
    else:  # no held expert runs
        assert held == 0 and grown["moe.max_load"] == 0 and grown["moe.padded_rows"] == 0
    assert grown["moe.host_syncs"] == 2
    assert grown.get("moe.plans_built", 0) == 0


def test_four_disjoint_shares_add_up_to_the_uncut_layer():
    """Each of four devices holds 8 of the 32 experts (a permutation of
    them); their layers' additions before rounding, with the shared
    expert counted once, are the uncut layer's."""
    _, full = _weights(31, n_moe=1)
    layer = full[0]
    shares = [list(s) for s in torch.randperm(E, generator=torch.Generator().manual_seed(32))
              .reshape(4, 8).tolist()]
    x = plain.lift(_residues(torch.Generator().manual_seed(33), TOKENS, D), P)
    products = moe.PrivateProducts(z=2, device=CPU)
    parts, routes = [], []
    for share in shares:
        w = _held(layer, share)
        sub = moe.PrivateMoE(w["router"], w["bias"], share, w["gate_up"], w["down"],
                             w["shared_gate_up"], w["shared_down"], products, top_k=TOP_K,
                             n_group=GROUPS, topk_group=KEPT, scaling=2.5, bucket=BUCKET)
        num, ids = sub.delta(x, seed=5)
        parts.append(num)
        routes.append(ids)
    shared_only, _ = plain.moe_delta(x, _held(layer, []), {**CFG, "experts": []}, P)
    whole, whole_ids = plain.moe_delta(x, layer, {**CFG, "experts": list(range(E))}, P)
    assert all(torch.equal(r, whole_ids) for r in routes)
    assert torch.equal(sum(parts) - 3 * shared_only, whole)
    # and each share's part is the reference's for that share
    for share, num in zip(shares, parts):
        want, _ = plain.moe_delta(x, _held(layer, share), {**CFG, "experts": share}, P)
        assert torch.equal(num, want)


def test_no_plan_is_built_after_prepare():
    bias = torch.zeros(E, dtype=torch.float64)
    bias[0] = 8.0
    dense, full = _weights(41, bias=bias)
    layers = [_held(w, HELD) for w in full]
    stack = _stack(dense, layers)
    # the dense pair, the router, the shared pair, and a pair a bucket
    buckets = range(BUCKET, TOKENS + 1, BUCKET)
    shapes = {(D, TOKENS, 2 * DENSE_F), (DENSE_F, TOKENS, D), (D, TOKENS, E), (D, TOKENS, 2 * F),
              (F, TOKENS, D)} | {(D, m, 2 * F) for m in buckets} | {(F, m, D) for m in buckets}
    assert set(stack.products.plans) == shapes
    before = _counters()
    for seed in range(3):
        hidden = _residues(torch.Generator().manual_seed(seed), TOKENS, D)
        stack(hidden, seed=seed)
    grown = _grown(before, _counters())
    assert grown.get("moe.plans_built", 0) == 0 and grown["moe.max_load"] == 6 * TOKENS


def test_a_load_pads_to_the_bucket():
    _, full = _weights(51, n_moe=1)
    w = _held(full[0], HELD)

    def layer(bucket):
        return moe.PrivateMoE(w["router"], w["bias"], HELD, w["gate_up"], w["down"],
                              w["shared_gate_up"], w["shared_down"],
                              moe.PrivateProducts(device=CPU), top_k=TOP_K, n_group=GROUPS,
                              topk_group=KEPT, scaling=2.5, bucket=bucket)

    sub = layer(16)
    assert [sub.padded(n) for n in (0, 1, 16, 17, 1024)] == [0, 16, 16, 32, 1024]
    sub.prepare(1024)
    assert {m for _, m, mb in sub.products.plans if mb == 2 * F} == set(range(16, 1025, 16))
    with pytest.raises(ValueError, match="bucket"):
        layer(5)
    with pytest.raises(ValueError, match="distinct"):
        moe.PrivateMoE(w["router"], w["bias"], [0, 0, 1, 2, 3, 4, 5, 6], w["gate_up"], w["down"],
                       w["shared_gate_up"], w["shared_down"], moe.PrivateProducts(device=CPU),
                       top_k=TOP_K, n_group=GROUPS, topk_group=KEPT, scaling=2.5)


def test_the_encodings_keep_many_residues_and_stay_in_range():
    """The re-encoded hidden states of uniform residues do not collapse to
    a few residues, and SiLU·up at the largest inputs stays within p/2."""
    gen = torch.Generator().manual_seed(61)
    fp = moe.FixedPoint()
    x = moe.centered(_residues(gen, 64, 512), P)
    a = moe.rms_encode(x, fp, P)
    assert torch.unique(a).numel() > 5000
    assert torch.equal(a.to(torch.int64), plain.rms_encode(x, plain.SCALES, 1e-6, P))
    y = _residues(gen, 64, 512)
    h = moe.silu_up_encode(y, fp, P)
    assert torch.unique(h).numel() > 2000
    half = (P - 1) // 2
    ends = torch.tensor([[a, b] for a, b in itertools.product([0, 1, half, half + 1, P - 1],
                                                             repeat=2)], dtype=torch.int32)
    lifted = moe.centered(moe.silu_up_encode(ends, fp, P), P).to(torch.float64)
    c = moe.centered(ends, P).to(torch.float64) / 2.0 ** fp.gate_up_bits
    want = torch.round(torch.nn.functional.silu(c[:, :1]) * c[:, 1:] * 2.0 ** fp.act_bits)
    assert torch.equal(lifted, want) and float(lifted.abs().max()) < half


def test_add_rounded_rounds_half_up_exactly():
    x = torch.zeros(6, dtype=torch.int64)
    num = torch.tensor([-6144, -2048, -1, 2047, 2048, 6144], dtype=torch.int64)
    assert moe.add_rounded(x, num, 12).tolist() == [-1, 0, 0, 0, 1, 2]


def test_the_plain_reference_imports_torch_alone():
    tree = ast.parse(Path(plain.__file__).read_text())
    names = {a.name.partition(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    names |= {(node.module or "").partition(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert names == {"torch"}
