"""The benchmark's side of ``private_moe``: DeepSeek-V3's FFN stack held
private, the dense sublayers and then the MoE sublayers, each
x + FFN(RMSNorm(x)) on GF(p) residues with the master's fixed-point steps
between the products.  The stack is ``tests/plain_deepseek_v3_ffn.py``'s,
copied here so that the benchmark needs nothing outside its directory;
its products are ``reference.y_exact`` (Y = AᵀW mod p exactly) and, in
the control, ``reference.y_float32``.

It reads the configuration's published keys (``hidden_size``,
``intermediate_size``, ``moe_intermediate_size``, ``n_shared_experts``,
``num_experts_per_tok``, ``n_group``, ``topk_group``,
``routed_scaling_factor``, ``rms_norm_eps``, ``num_hidden_layers``,
``first_k_dense_replace``), ``private_moe`` (``router_experts``: the
router's outputs; ``experts_held``: this device's routed experts;
``fixed_point``: the scales as powers of two; ``bias_half_range_log2``
and ``bias_step_log2``: the correction bias's draw) and ``cmpc.p``; and
``tokens`` and ``activations`` of the mix.

Numbers: the residual stream X is int64 at 2**x_bits, the input's
residues read by their centered lift; RMSNorm r = sqrt(ΣX² /
(d·4**x_bits) + eps) with ΣX² in int64, A = round(X / 2**x_bits / r ·
2**a_bits) mod p; router logits lift(AᵀW_r) / 2**logit_bits; gate and up
lift / 2**gate_up_bits, h = silu(g)·u encoded at 2**act_bits; the route
(noaux_tc) sigmoid scores, the bias for the selection only, groups
scored by their two best biased scores, ``topk_group`` groups kept,
``num_experts_per_tok`` experts chosen within them, the lower id first
among equals, gates the chosen unbiased scores over their sum (added in
ascending id) times the scaling factor; the combine Σ_e round(gate_e ·
2**gate_bits) · lift(down_e) + 2**gate_bits · lift(shared down) in int64,
added to X over 2**gate_bits rounded half up; a dense sublayer adds
lift(down).  Only the held experts are computed; the absent ones add
nothing.

The answer of a call is (X after every sublayer, int64 [T, d]; the MoE
sublayers' expert ids, int64 [layers, T, top_k], ascending in each row).
"""
import torch

from cmpcbench import reference, traffic

FIELDS = {"tokens", "activations"}


# ----------------------------------------------------------------------
# the stack (a copy of tests/plain_deepseek_v3_ffn.py)
# ----------------------------------------------------------------------
def _exact(a, w, p):
    return reference.y_exact(a.T[None], w, p)[0]


def _float32(a, w, p):
    return reference.y_float32(a.T[None], w, p)[0]


def _lift(y, p):
    y = y.to(torch.int64)
    return torch.where(y > (p - 1) // 2, y - p, y)


def _encode(h, bits, p):
    return torch.remainder(torch.round(h * 2.0 ** bits).to(torch.int64), p)


def _rms_encode(x, sc, eps, p):
    ss = (x * x).sum(-1, keepdim=True)
    r = torch.sqrt(ss.to(torch.float64) / (x.shape[-1] * 4.0 ** sc["x_bits"]) + eps)
    return _encode(x.to(torch.float64) / 2.0 ** sc["x_bits"] / r, sc["a_bits"], p)


def _swiglu(a, w_gate_up, w_down, sc, p, prod):
    c = _lift(prod(a, w_gate_up, p), p).to(torch.float64) / 2.0 ** sc["gate_up_bits"]
    f = w_down.shape[0]
    h = _encode(torch.nn.functional.silu(c[:, :f]) * c[:, f:], sc["act_bits"], p)
    return _lift(prod(h, w_down, p), p)


def _best(values, k):
    """Mask of the k best entries of each row: an entry is beaten by each
    larger one and by each equal one of a lower index."""
    n = values.shape[-1]
    idx = torch.arange(n, device=values.device)
    mine, other = values[..., :, None], values[..., None, :]
    beaten = (other > mine) | ((other == mine) & (idx[None, :] < idx[:, None]))
    return beaten.sum(-1) < k


def _route(logits, bias, top_k, n_group, topk_group, scaling):
    scores = torch.sigmoid(logits)
    biased = scores + bias
    t, e = biased.shape
    grouped = biased.reshape(t, n_group, e // n_group)
    top2 = torch.where(_best(grouped, 2), grouped, torch.zeros_like(grouped))
    kept = _best(top2.sum(-1), topk_group).repeat_interleave(e // n_group, dim=-1)
    chosen = _best(torch.where(kept, biased, torch.full_like(biased, float("-inf"))), top_k)
    ids = torch.arange(e, device=logits.device).expand(t, e)[chosen].reshape(t, top_k)
    gates = torch.gather(scores, 1, ids)
    den = gates[:, 0]
    for j in range(1, top_k):
        den = den + gates[:, j]
    return gates / den[:, None] * scaling, ids


def _moe(x, layer, cfg, p, prod):
    sc = cfg["scales"]
    a = _rms_encode(x, sc, cfg["eps"], p)
    logits = _lift(prod(a, layer["router"], p), p).to(torch.float64) / 2.0 ** sc["logit_bits"]
    gates, ids = _route(logits, layer["bias"], cfg["top_k"], cfg["n_group"], cfg["topk_group"],
                        cfg["scaling"])
    shared = _swiglu(a, layer["shared_gate_up"], layer["shared_down"], sc, p, prod)
    num = shared * 2 ** sc["gate_bits"]
    for i, e in sorted(enumerate(cfg["experts"]), key=lambda ie: ie[1]):
        rows, cols = (ids == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        out = _swiglu(a[rows], layer["gate_up"][i], layer["down"][i], sc, p, prod)
        q = torch.round(gates[rows, cols] * 2.0 ** sc["gate_bits"]).to(torch.int64)
        num[rows] += q[:, None] * out
    bits = sc["gate_bits"]
    return x + torch.div(num + (1 << (bits - 1)), 1 << bits, rounding_mode="floor"), ids


def _stack(config, fixed, hidden, prod):
    cfg, p = _layer_config(config), config["cmpc"]["p"]
    x = _lift(hidden, p)
    for layer in fixed["dense"]:
        a = _rms_encode(x, cfg["scales"], cfg["eps"], p)
        x = x + _swiglu(a, layer["gate_up"], layer["down"], cfg["scales"], p, prod)
    ids = []
    for layer in fixed["moe"]:
        x, e = _moe(x, layer, cfg, p, prod)
        ids.append(e)
    empty = torch.zeros((0, x.shape[0], 0), dtype=torch.int64, device=x.device)
    return x, torch.stack(ids) if ids else empty


# ----------------------------------------------------------------------
# what the harness calls
# ----------------------------------------------------------------------
def _layer_config(config):
    pm = config["private_moe"]
    return {"scales": pm["fixed_point"], "eps": config["rms_norm_eps"],
            "experts": pm["experts_held"], "top_k": config["num_experts_per_tok"],
            "n_group": config["n_group"], "topk_group": config["topk_group"],
            "scaling": config["routed_scaling_factor"]}


def _widths(config):
    """(d, dense width, expert width, shared width, router outputs, held)."""
    pm = config["private_moe"]
    return (config["hidden_size"], config["intermediate_size"], config["moe_intermediate_size"],
            config["n_shared_experts"] * config["moe_intermediate_size"], pm["router_experts"],
            len(pm["experts_held"]))


def _tokens(mix):
    t = mix["tokens"]
    if not isinstance(t, int) or t < 2 or t % 2:
        raise ValueError("traffic mix: tokens must be an even whole number >= 2")
    return t


def fixed(config, mix, seed, device):
    """The model owner's weights, residues drawn from the seed: each dense
    sublayer's gate/up [d, 2F] (the gate's columns first) and down [F, d];
    each MoE sublayer's router [d, E], correction bias [E] (float64,
    multiples of 2**bias_step_log2 in ±2**bias_half_range_log2), the held
    experts' gate/up [held, d, 2f] and down [held, f, d], and the shared
    expert's gate/up [d, 2f_s] and down [f_s, d]."""
    _tokens(mix)
    pm, p = config["private_moe"], config["cmpc"]["p"]
    d, dense_f, f, fs, n_experts, held = _widths(config)
    n_dense = config["first_k_dense_replace"]
    n_moe = config["num_hidden_layers"] - n_dense
    bias_levels = 2 ** (pm["bias_half_range_log2"] - pm["bias_step_log2"])

    def draw(index, shape, q=p):
        return traffic.residues(seed, traffic.WEIGHT_STREAM, index, shape, q, device)

    dense = [{"gate_up": draw(2 * i, (d, 2 * dense_f)), "down": draw(2 * i + 1, (dense_f, d))}
             for i in range(n_dense)]
    moe = []
    for i in range(n_moe):
        j = 16 * (i + 1)
        bias = (draw(j + 1, (n_experts,), 2 * bias_levels).to(torch.float64) - bias_levels)
        moe.append({"router": draw(j, (d, n_experts)),
                    "bias": bias * 2.0 ** pm["bias_step_log2"],
                    "gate_up": draw(j + 2, (held, d, 2 * f)), "down": draw(j + 3, (held, f, d)),
                    "shared_gate_up": draw(j + 4, (d, 2 * fs)),
                    "shared_down": draw(j + 5, (fs, d))})
    return {"dense": dense, "moe": moe}


def inputs(config, mix, fixed, seed, stream, index, device):
    """A call's hidden states, residues [tokens, d]."""
    return traffic.residues(seed, stream, index, (_tokens(mix), config["hidden_size"]),
                            config["cmpc"]["p"], device)


def work(config, mix, inputs):
    """(tokens, operations) of one call: 2 x the multiply-adds of the dense
    sublayers, the routers, the shared experts and the routed pairs, the
    last at their expected count tokens · top_k · held / router outputs a
    layer (the route decides the real count; the expectation keeps the
    count a function of the shapes)."""
    t = _tokens(mix)
    d, dense_f, f, fs, n_experts, held = _widths(config)
    n_dense = config["first_k_dense_replace"]
    n_moe = config["num_hidden_layers"] - n_dense
    pairs = t * config["num_experts_per_tok"] * held / n_experts
    macs = n_dense * 3 * t * d * dense_f + n_moe * (t * d * n_experts + 3 * t * d * fs
                                                    + pairs * 3 * d * f)
    return t, int(round(2 * macs))


def expect(config, fixed, inputs):
    return _stack(config, fixed, inputs, _exact)


def control(config, fixed, inputs):
    return _stack(config, fixed, inputs, _float32)


def mismatches(output, expected) -> int:
    """Elements of X and expert ids that differ; every element of a part
    whose shape differs, and of both where the output is not a pair."""
    if not isinstance(output, tuple) or len(output) != len(expected):
        return sum(e.numel() for e in expected)
    return sum(e.numel() if tuple(o.shape) != tuple(e.shape)
               else int((o.to(torch.int64) != e).sum()) for o, e in zip(output, expected))

