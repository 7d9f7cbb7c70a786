"""A plain reference of DeepSeek-V3's FFN stack as the master and the
model owner compute it privately: dense and MoE sublayers
x + FFN(RMSNorm(x)) on GF(p) residues, with the master's fixed-point
steps between the products.

Plain torch only: no kernel, no plan, no batching of experts.  Each
product is Y = AᵀW mod p exactly (float64 blocks of at most
⌊(2⁵³ − 1)/(p − 1)²⌋ contraction terms, so every partial sum is an exact
integer); the route is worked out from pairwise comparisons; each held
expert runs on its own tokens in turn.  Passing ``product=product_float32``
gives the same stack with its products in float32, which has to come
out wrong.

Numbers (``SCALES``, as powers of two):

* the residual stream X is int64 at 2**x_bits; the input's residues are
  read by their centered lift;
* RMSNorm: r = sqrt(ΣX² / (d·4**x_bits) + eps), ΣX² in int64, and
  A = round(X / 2**x_bits / r · 2**a_bits) mod p (RMSNorm's weight is 1);
* router logits: the lift of AᵀW_r over 2**logit_bits; gate and up: the
  lift over 2**gate_up_bits; h = silu(g)·u encoded at 2**act_bits;
* the route (``topk_method`` noaux_tc): sigmoid scores; the correction
  bias added for the selection only; a group's score is the sum of its
  two best biased scores; the ``topk_group`` best groups are kept and the
  ``top_k`` best biased scores within them chosen; among equal scores the
  lower id wins.  The gates are the chosen unbiased scores over their sum
  (added in ascending expert id) times ``scaling``;
* the combine: Σ_e round(gate_e · 2**gate_bits) · lift(down_e) +
  2**gate_bits · lift(shared down) in int64, added to X over
  2**gate_bits, rounded half up; a dense sublayer adds lift(down).

Only the experts in ``experts`` are computed (a device's share of an
expert-parallel deployment); the absent ones add nothing.  Departures
from the published model: experts outside the kept groups are masked
with −inf (the published code fills 0.0; the two differ only where a
kept biased score is negative), RMSNorm's weight is 1, and the products
are over GF(p) with the fixed-point steps above.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCALES = {"x_bits": 12, "a_bits": 12, "logit_bits": 13, "gate_up_bits": 12, "act_bits": 8,
          "gate_bits": 12}


def product(a, w, p):
    """Y = a w mod p exactly: a [n, k] and w [k, m] residues -> int64 [n, m]."""
    step = (2 ** 53 - 1) // (p - 1) ** 2
    y = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.int64, device=a.device)
    for k0 in range(0, a.shape[1], step):
        part = a[:, k0:k0 + step].to(torch.float64) @ w[k0:k0 + step].to(torch.float64)
        y = torch.remainder(y + torch.remainder(part, p).to(torch.int64), p)
    return y


def product_float32(a, w, p):
    """The same product in float32 (TF32 off): the control."""
    return torch.remainder(a.to(torch.float32) @ w.to(torch.float32), p).to(torch.int64)


def lift(y, p):
    y = y.to(torch.int64)
    return torch.where(y > (p - 1) // 2, y - p, y)


def encode(h, bits, p):
    return torch.remainder(torch.round(h * 2.0 ** bits).to(torch.int64), p)


def rms_encode(x, sc, eps, p):
    ss = (x * x).sum(-1, keepdim=True)
    r = torch.sqrt(ss.to(torch.float64) / (x.shape[-1] * 4.0 ** sc["x_bits"]) + eps)
    return encode(x.to(torch.float64) / 2.0 ** sc["x_bits"] / r, sc["a_bits"], p)


def swiglu(a, w_gate_up, w_down, sc, p, prod):
    """lift((silu(a W_g) · a W_u) W_down) for tokens a [n, d] (residues)."""
    c = lift(prod(a, w_gate_up, p), p).to(torch.float64) / 2.0 ** sc["gate_up_bits"]
    f = w_down.shape[0]
    h = encode(torch.nn.functional.silu(c[:, :f]) * c[:, f:], sc["act_bits"], p)
    return lift(prod(h, w_down, p), p)


def best(values, k):
    """Mask of the k best entries of each row of ``values`` [..., n]: an
    entry is beaten by each entry with a larger value and by each equal
    one of a lower index."""
    n = values.shape[-1]
    idx = torch.arange(n, device=values.device)
    mine, other = values[..., :, None], values[..., None, :]
    beaten = (other > mine) | ((other == mine) & (idx[None, :] < idx[:, None]))
    return beaten.sum(-1) < k


def route(logits, bias, top_k, n_group, topk_group, scaling):
    """(gates, ids) [T, top_k], ids ascending in each row."""
    scores = torch.sigmoid(logits)
    biased = scores + bias
    t, e = biased.shape
    grouped = biased.reshape(t, n_group, e // n_group)
    top2 = torch.where(best(grouped, 2), grouped, torch.zeros_like(grouped))
    group_scores = top2.sum(-1)
    kept = best(group_scores, topk_group).repeat_interleave(e // n_group, dim=-1)
    chosen = best(torch.where(kept, biased, torch.full_like(biased, float("-inf"))), top_k)
    ids = torch.arange(e, device=logits.device).expand(t, e)[chosen].reshape(t, top_k)
    gates = torch.gather(scores, 1, ids)
    den = gates[:, 0]
    for j in range(1, top_k):
        den = den + gates[:, j]
    return gates / den[:, None] * scaling, ids


def dense_ffn(x, layer, cfg, p, prod=product):
    """x + FFN(RMSNorm(x)) with ``layer`` = {"gate_up", "down"}."""
    a = rms_encode(x, cfg["scales"], cfg["eps"], p)
    return x + swiglu(a, layer["gate_up"], layer["down"], cfg["scales"], p, prod)


def moe_delta(x, layer, cfg, p, prod=product):
    """(numerator, ids): the MoE sublayer's addition to x times
    2**gate_bits, before its rounding, from the held experts
    ``cfg["experts"]`` (``layer["gate_up"][i]`` and ``layer["down"][i]``
    are expert ``cfg["experts"][i]``'s) and the shared expert."""
    sc = cfg["scales"]
    a = rms_encode(x, sc, cfg["eps"], p)
    logits = lift(prod(a, layer["router"], p), p).to(torch.float64) / 2.0 ** sc["logit_bits"]
    gates, ids = route(logits, layer["bias"].to(torch.float64), cfg["top_k"], cfg["n_group"],
                       cfg["topk_group"], cfg["scaling"])
    shared = swiglu(a, layer["shared_gate_up"], layer["shared_down"], sc, p, prod)
    num = shared * 2 ** sc["gate_bits"]
    for i, e in sorted(enumerate(cfg["experts"]), key=lambda ie: ie[1]):
        rows, cols = (ids == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        out = swiglu(a[rows], layer["gate_up"][i], layer["down"][i], sc, p, prod)
        q = torch.round(gates[rows, cols] * 2.0 ** sc["gate_bits"]).to(torch.int64)
        num[rows] += q[:, None] * out
    return num, ids


def moe_ffn(x, layer, cfg, p, prod=product):
    """x + MoE(RMSNorm(x)) and the route's expert ids."""
    num, ids = moe_delta(x, layer, cfg, p, prod)
    bits = cfg["scales"]["gate_bits"]
    return x + torch.div(num + (1 << (bits - 1)), 1 << bits, rounding_mode="floor"), ids


def ffn_stack(hidden, dense, moe, cfg, p, prod=product):
    """The dense sublayers, then the MoE sublayers, over the tokens whose
    hidden states are the residues ``hidden`` [T, d].  Returns (X int64
    [T, d], the MoE sublayers' ids int64 [layers, T, top_k])."""
    x = lift(hidden, p)
    for layer in dense:
        x = dense_ffn(x, layer, cfg, p, prod)
    ids = []
    for layer in moe:
        x, e = moe_ffn(x, layer, cfg, p, prod)
        ids.append(e)
    empty = torch.zeros((0, x.shape[0], 0), dtype=torch.int64, device=x.device)
    return x, torch.stack(ids) if ids else empty
