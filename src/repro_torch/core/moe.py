"""Private FFN sublayers: DeepSeek-V3's dense SiLU-gated FFN and its MoE
FFN, every weight product one ``protocol.run_batched``.

A sublayer is x + FFN(RMSNorm(x)).  The master holds the residual stream
and the tokens' hidden states, the model owner's weights are GF(p)
residues, and each product Y = AᵀW runs the three CMPC phases, so that
no worker learns A or W.  Between two products the master decodes Y,
works at the fixed-point scales of ``FixedPoint`` and encodes again:

* the residual stream X is int64 at scale 2**x_bits (x = X / 2**x_bits);
* RMSNorm: r = sqrt(ΣX² / (d·4**x_bits) + eps), the sum of squares exact
  in int64, then A = round(X / 2**x_bits / r · 2**a_bits) mod p, in float64;
* a product's output is read as its centered lift c in (−p/2, p/2):
  router logits are c / 2**logit_bits, gate and up c / 2**gate_up_bits;
* SiLU·up: h = silu(g)·u in float64, encoded round(h · 2**act_bits) mod p;
* the down product's lift is in X's units.  The combine forms
  Σ_e q_e c_e + 2**gate_bits · c_shared in int64, q_e = round(gate_e ·
  2**gate_bits), and X gains that sum over 2**gate_bits, rounded half
  up; the dense FFN adds its c as it is.

Every float64 step is elementwise, or a reduction that is exact or added
in a fixed order, so the result is the same element for element
whatever the batch layout.

``PrivateMoE`` holds some of the routed experts (``experts``, its share
of an expert-parallel deployment) and routes over all of them with
``models.ffn.route_noaux_tc``.  It computes its own experts' part for
the tokens routed to them, and the shared expert; the absent experts
add nothing here, and that partial sum is what goes on to the next
sublayer.  The route is dropless: each call pads every local expert's
tokens to one M, the largest local load rounded up to a multiple of
``bucket``, which the host reads back once a sublayer (one
device-to-host copy, waited on only after the shared expert is
enqueued, so that the card has work while the host waits).
``prepare(tokens)`` builds every plan a call of that many tokens can
need.

Counters (``obs.metrics.REGISTRY``): ``moe.routed_pairs`` (local
(token, expert) pairs), ``moe.padded_rows`` (rows of the expert batch
that hold no pair), ``moe.max_load`` (the largest local load, summed over
sublayers and calls), ``moe.host_syncs`` (waits on the load read) and
``moe.plans_built``.  Spans (``obs.tracer.TRACER``): ``ffn.dense``,
``moe.layer`` and inside it ``moe.router``, ``moe.route`` (twice: the
scores, the group top-k, the dispatch and the load read's copy, then,
after ``moe.shared``, the wait on it and the expert batch),
``moe.experts.gate_up``, ``moe.act``, ``moe.experts.down`` and
``moe.combine``; each product's ``protocol.run_batched`` spans nest in
the span that calls it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from ..models.ffn import route_noaux_tc
from ..obs.metrics import REGISTRY
from ..obs.tracer import TRACER
from . import protocol
from .constructions import build_scheme
from .gf import Field
from .planner import BlockShapes, CMPCPlan, get_plan

SEEDS_PER_LAYER = 8  # protocol seeds a sublayer may take in one call


@dataclasses.dataclass(frozen=True)
class FixedPoint:
    """The master's fixed-point scales, as powers of two (module docstring)."""

    x_bits: int = 12
    a_bits: int = 12
    logit_bits: int = 13
    gate_up_bits: int = 12
    act_bits: int = 8
    gate_bits: int = 12
    eps: float = 1e-6


def centered(y: torch.Tensor, p: int) -> torch.Tensor:
    """Residues in [0, p) as their centered lift, int64 in (−p/2, p/2]."""
    y = y.to(torch.int64)
    return torch.where(y > (p - 1) // 2, y - p, y)


def _encode(h: torch.Tensor, bits: int, p: int) -> torch.Tensor:
    return torch.remainder(torch.round(h * 2.0 ** bits).to(torch.int64), p).to(torch.int32)


def rms_encode(x: torch.Tensor, fp: FixedPoint, p: int) -> torch.Tensor:
    """RMSNorm of the residual stream x (int64 [T, d]) as residues int32 [T, d]."""
    ss = (x * x).sum(-1, keepdim=True)
    r = torch.sqrt(ss.to(torch.float64) / (x.shape[-1] * 4.0 ** fp.x_bits) + fp.eps)
    return _encode(x.to(torch.float64) / 2.0 ** fp.x_bits / r, fp.a_bits, p)


def silu_up_encode(y: torch.Tensor, fp: FixedPoint, p: int) -> torch.Tensor:
    """SiLU(gate)·up of a gate/up product's output (residues [..., 2f],
    the gate's f columns first) as residues int32 [..., f]."""
    c = centered(y, p).to(torch.float64) / 2.0 ** fp.gate_up_bits
    f = c.shape[-1] // 2
    return _encode(torch.nn.functional.silu(c[..., :f]) * c[..., f:], fp.act_bits, p)


def add_rounded(x: torch.Tensor, num: torch.Tensor, bits: int) -> torch.Tensor:
    """x + num / 2**bits rounded half up, in int64."""
    return x + torch.div(num + (1 << (bits - 1)), 1 << bits, rounding_mode="floor")


class PrivateProducts:
    """The plans and the ``run_batched`` calls of one stack's products: one
    CMPC scheme over one field, on one device and backend.  A plan is
    built the first time its (k, ma, mb) is asked for, with its device
    constants, and counted (``moe.plans_built``)."""

    def __init__(self, method: str = "age", s: int = 2, t: int = 2, z: int = 2,
                 p: int = 65521, backend: str = "auto", device=None):
        self.scheme = build_scheme(method, s, t, z)
        self.field = Field(p)
        self.p = p
        self.backend = backend
        self.device = protocol.resolve_device(device)
        self.plans: Dict[Tuple[int, int, int], CMPCPlan] = {}

    def plan(self, k: int, ma: int, mb: int) -> CMPCPlan:
        plan = self.plans.get((k, ma, mb))
        if plan is None:
            shapes = BlockShapes(k, ma, mb, self.scheme.s, self.scheme.t)
            plan = get_plan(self.scheme, shapes, field=self.field)
            protocol.device_plan(plan, self.device)
            self.plans[(k, ma, mb)] = plan
            REGISTRY.counter("moe.plans_built").inc()
        return plan

    def __call__(self, a: torch.Tensor, w: torch.Tensor, seed: int) -> torch.Tensor:
        """Y[i] = A[i]ᵀ W[i] mod p: a [batch, k, ma] residues, w [batch, k,
        mb] or one [k, mb] for the whole batch (a broadcast view).
        Returns int64 residues [batch, ma, mb], unsynchronised."""
        batch, k, ma = a.shape
        if w.dim() == 2:
            w = w.expand(batch, *w.shape)
        y, _ = protocol.run_batched(self.plan(k, ma, w.shape[-1]), a, w, seed=seed,
                                    backend=self.backend, fused_masks=False, device=self.device)
        return y


def private_swiglu(products: PrivateProducts, a: torch.Tensor, w_gate_up: torch.Tensor,
                   w_down: torch.Tensor, fp: FixedPoint, seed: int) -> torch.Tensor:
    """(silu(a W_gate) · a W_up) W_down for the tokens a (residues [T, d]),
    both products private; the down product's centered lift, int64 [T, d]."""
    y = products(a.T[None], w_gate_up, seed)[0]
    h = silu_up_encode(y, fp, products.p)
    return centered(products(h.T[None], w_down, seed + 1)[0], products.p)


class PrivateFFN:
    """The dense sublayer x + FFN(RMSNorm(x)), FFN the SiLU-gated MLP with
    ``w_gate_up`` [d, 2f] (the gate's f columns first) and ``w_down``
    [f, d], residues."""

    def __init__(self, w_gate_up: torch.Tensor, w_down: torch.Tensor,
                 products: PrivateProducts, fp: FixedPoint = FixedPoint()):
        self.w_gate_up, self.w_down, self.products, self.fp = w_gate_up, w_down, products, fp

    def prepare(self, tokens: int) -> None:
        d, f2 = self.w_gate_up.shape
        self.products.plan(d, tokens, f2)
        self.products.plan(f2 // 2, tokens, d)

    def __call__(self, x: torch.Tensor, seed: int) -> torch.Tensor:
        with TRACER.span("ffn.dense"):
            a = rms_encode(x, self.fp, self.products.p)
            return x + private_swiglu(self.products, a, self.w_gate_up, self.w_down, self.fp,
                                      seed)


class PrivateMoE:
    """The MoE sublayer x + MoE(RMSNorm(x)) over the routed experts
    ``experts`` (global ids) that this device holds.

    ``router`` [d, E] and ``bias`` [E] (float64, the correction bias of
    the selection) cover all E experts; ``w_gate_up`` [len(experts), d,
    2f] and ``w_down`` [len(experts), f, d] are the held experts' weights
    in the order of ``experts``; ``shared_gate_up`` [d, 2f_s] and
    ``shared_down`` [f_s, d] the shared experts' (all residues).
    ``__call__`` returns the new residual stream and the route's expert
    ids [T, top_k] (ascending in each row)."""

    def __init__(self, router: torch.Tensor, bias: torch.Tensor, experts: Sequence[int],
                 w_gate_up: torch.Tensor, w_down: torch.Tensor, shared_gate_up: torch.Tensor,
                 shared_down: torch.Tensor, products: PrivateProducts, *, top_k: int,
                 n_group: int, topk_group: int, scaling: float,
                 fp: FixedPoint = FixedPoint(), bucket: int = 16):
        n_experts = router.shape[1]
        experts = [int(e) for e in experts]
        if len(set(experts)) != len(experts) or not all(0 <= e < n_experts for e in experts):
            raise ValueError(f"experts must be distinct ids in [0, {n_experts}), got {experts}")
        if w_gate_up.shape[0] != len(experts) or w_down.shape[0] != len(experts):
            raise ValueError("one gate/up and one down weight per held expert")
        if bucket % products.scheme.t:
            raise ValueError(f"the pad bucket {bucket} must be a multiple of t")
        self.router, self.w_gate_up, self.w_down = router, w_gate_up, w_down
        self.shared_gate_up, self.shared_down = shared_gate_up, shared_down
        self.bias = bias.to(torch.float64)
        self.experts, self.products, self.fp, self.bucket = experts, products, fp, bucket
        self.top_k, self.n_group, self.topk_group = top_k, n_group, topk_group
        self.scaling = scaling
        device = products.device
        local_of = torch.full((n_experts,), len(experts), dtype=torch.int64)
        local_of[experts] = torch.arange(len(experts))
        self.local_of = local_of.to(device)
        self._pinned = device.type == "cuda"
        self._load = torch.empty(2, dtype=torch.int64, pin_memory=self._pinned)

    def padded(self, load: int) -> int:
        """The M a largest local load of ``load`` pads to (0: no pair)."""
        return -(-load // self.bucket) * self.bucket

    def prepare(self, tokens: int) -> None:
        """The plans of every M a call of ``tokens`` tokens can pad to."""
        d, n_experts = self.router.shape
        f2, fs2 = self.w_gate_up.shape[-1], self.shared_gate_up.shape[-1]
        plan = self.products.plan
        plan(d, tokens, n_experts)
        plan(d, tokens, fs2)
        plan(fs2 // 2, tokens, d)
        for m in range(self.bucket, self.padded(tokens) + 1, self.bucket):
            plan(d, m, f2)
            plan(f2 // 2, m, d)

    def _dispatch(self, ids: torch.Tensor):
        """The route's flat (token, expert) pairs of ``ids`` [T, k] sorted by
        local expert, then token (``order``; the absent experts' pairs
        last), each one's local expert (``key``, ``len(experts)`` for an
        absent one) and its row in its expert's batch (``rank``), and
        [largest local load, local pairs] on the device."""
        held = len(self.experts)
        key = self.local_of[ids].reshape(-1)
        order = torch.argsort(key, stable=True)
        key = key[order]
        counts = torch.zeros(held + 1, dtype=torch.int64, device=ids.device)
        counts.scatter_add_(0, key, torch.ones_like(key))
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(key.shape[0], device=ids.device) - starts[key]
        return order, key, rank, torch.stack([counts[:held].max(), counts[:held].sum()])

    def _read_load(self, stats: torch.Tensor):
        """Start the copy of ``stats`` to the host; the event that ends it."""
        self._load.copy_(stats, non_blocking=self._pinned)
        if not self._pinned:
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _wait_load(self, event) -> Tuple[int, int]:
        """Wait for the load read: (the padded M of the expert batch, local pairs)."""
        if event is not None:
            event.synchronize()
        max_load, pairs = (int(v) for v in self._load.tolist())
        m = self.padded(max_load)
        REGISTRY.counter("moe.host_syncs").inc()
        REGISTRY.counter("moe.routed_pairs").inc(pairs)
        REGISTRY.counter("moe.max_load").inc(max_load)
        REGISTRY.counter("moe.padded_rows").inc(len(self.experts) * m - pairs)
        return m, pairs

    def delta(self, x: torch.Tensor, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(numerator, ids): the sublayer's addition to x times 2**gate_bits,
        int64 [T, d], before its rounding, and the route's expert ids."""
        p, fp, products = self.products.p, self.fp, self.products
        held = len(self.experts)
        a = rms_encode(x, fp, p)
        with TRACER.span("moe.router"):
            logits = products(a.T[None], self.router, seed)[0]
        with TRACER.span("moe.route"):
            logits = centered(logits, p).to(torch.float64) / 2.0 ** fp.logit_bits
            gates, ids = route_noaux_tc(logits, self.bias, self.top_k, self.n_group,
                                        self.topk_group, self.scaling)
            order, key, rank, stats = self._dispatch(ids)
            event = self._read_load(stats)
        with TRACER.span("moe.shared"):
            num = private_swiglu(products, a, self.shared_gate_up, self.shared_down, fp,
                                 seed + 1) * (1 << fp.gate_bits)
        with TRACER.span("moe.route"):
            m, pairs = self._wait_load(event)
            if pairs:
                pair = order[:pairs]
                slot = key[:pairs] * m + rank[:pairs]
                token = pair // self.top_k
                batch = torch.zeros((held * m, a.shape[1]), dtype=torch.int32, device=a.device)
                batch.index_copy_(0, slot, a.index_select(0, token))
        if pairs:
            with TRACER.span("moe.experts.gate_up"):
                y = products(batch.view(held, m, -1).transpose(1, 2), self.w_gate_up, seed + 3)
            with TRACER.span("moe.act"):
                h = silu_up_encode(y, fp, p)
            with TRACER.span("moe.experts.down"):
                y = products(h.transpose(1, 2), self.w_down, seed + 4)
        with TRACER.span("moe.combine"):
            if pairs:
                q = torch.round(gates * 2.0 ** fp.gate_bits).to(torch.int64).reshape(-1)[pair]
                out = centered(y, p).reshape(held * m, -1).index_select(0, slot)
                num.index_add_(0, token, out * q[:, None])
        return num, ids

    def __call__(self, x: torch.Tensor, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        with TRACER.span("moe.layer"):
            num, ids = self.delta(x, seed)
            return add_rounded(x, num, self.fp.gate_bits), ids


class PrivateFFNStack:
    """FFN sublayers (``PrivateFFN``, ``PrivateMoE``) in order over one
    batch of tokens sharing one ``PrivateProducts``."""

    def __init__(self, layers: Sequence, products: PrivateProducts):
        self.layers, self.products = list(layers), products

    def prepare(self, tokens: int) -> None:
        """Every plan a call of ``tokens`` tokens can need."""
        for layer in self.layers:
            layer.prepare(tokens)

    def __call__(self, hidden: torch.Tensor, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """``hidden``: the tokens' hidden states as residues [T, d], whose
        centered lift is the residual stream.  Returns (the residual
        stream after every sublayer, int64 [T, d]; the MoE sublayers'
        expert ids, int64 [layers, T, top_k]), unsynchronised but for one
        load read a MoE sublayer.  Sublayer i of call ``seed`` runs its
        products with protocol seeds from (seed · layers + i) · 8."""
        x = centered(hidden, self.products.p)
        ids = []
        for i, layer in enumerate(self.layers):
            layer_seed = (seed * len(self.layers) + i) * SEEDS_PER_LAYER
            if isinstance(layer, PrivateMoE):
                x, e = layer(x, layer_seed)
                ids.append(e)
            else:
                x = layer(x, layer_seed)
        empty = torch.zeros((0, x.shape[0], 0), dtype=torch.int64, device=x.device)
        return x, torch.stack(ids) if ids else empty
