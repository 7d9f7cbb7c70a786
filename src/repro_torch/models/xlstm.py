"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM
(scalar memory, sequential scan), following arXiv:2405.04517.

The counterpart of ``repro.models.xlstm``.  mLSTM per head (dim P):
matrix memory C in R^{P x P}, normalizer n:

    C_t = f_t C_{t-1} + i_t v_t k_t^T
    n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t q_t / max(|n_t^T q_t|, 1)

with exponentially-gated i/f stabilised by a running max m_t.  A full
sequence runs the chunked dual form (decay products inside a chunk,
the carried state across chunks); sLSTM keeps per-unit scalar state and
steps through time.  The reference's ``lax.scan`` over chunks and over
time steps are Python loops over the same chunks and steps.

The reference's numerics are kept: q, k and v come out of the
projections in the compute dtype, k divided by ``sqrt(P)`` rounded to
that dtype; the gates, the chunk einsums and every recurrent state are
float32; masked log weights are ``-inf``, the carried ``m`` starts at
-1e30, and the denominator is ``max(|denom|, exp(-m))``.

On a mesh (``x`` a DTensor in the residual stream's layout) each block
runs on the rank's own batch rows with its weights gathered whole once
(``sharding.run_on_rows``): every head on every ``model`` rank, so the
sLSTM's recurrence needs no collective per step, and the fused
``w_up`` ([x | z]) and ``w_gates`` / ``r_gates`` ([z | i | f | o]),
whose splits do not fall on the shard boundaries, are cut locally.

One deliberate difference: ``slstm_scan`` multiplies the whole
sequence's inputs by ``w_gates`` (float32) once, before the time loop,
where the reference multiplies each step's row inside it.  Both compute
the same float32 products, summed in another order; the recurrent
``hprev @ r_gates`` stays inside the loop.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..distributed.sharding import run_on_rows
from .common import ParamInfo, ShapeDtype, rms_norm

_M0 = -1e30  # the stabiliser of an empty history, as the reference's


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    h = cfg.num_heads
    d_in = int(cfg.xlstm.proj_factor * d)
    p = d_in // h
    return d, h, d_in, p


def _key_scale(hd: int, dt: torch.dtype) -> torch.Tensor:
    """``jnp.sqrt(hd).astype(dt)``: the float32 root rounded to ``dt``
    (5.65625 for hd = 32 in bfloat16), a 0-d CPU tensor."""
    return torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dt)


def mlstm_params(cfg: ModelConfig) -> Dict[str, ParamInfo]:
    d, h, d_in, _ = _dims(cfg)
    return {
        "w_up": ParamInfo((d, 2 * d_in), ("embed", "heads")),
        "w_q": ParamInfo((d_in, d_in), (None, "heads")),
        "w_k": ParamInfo((d_in, d_in), (None, "heads")),
        "w_v": ParamInfo((d_in, d_in), (None, "heads")),
        "w_if": ParamInfo((d_in, 2 * h), ("heads", None), init="small"),
        "b_if": ParamInfo((2 * h,), (None,), init="zeros"),
        "norm_w": ParamInfo((d_in,), ("heads",), init="ones"),
        "w_down": ParamInfo((d_in, d), ("heads", "embed")),
    }


def _mlstm_gates(p, xv: torch.Tensor, h: int):
    """(log i, log f) in float32 from the float32 ``xv``: i exponential,
    f through a log-sigmoid (forget in (0, 1))."""
    gf = xv @ p["w_if"].float() + p["b_if"].float()
    return gf[..., :h], F.logsigmoid(gf[..., h:])


def _qkv(p, xv: torch.Tensor, hd: int):
    """q, k / sqrt(hd) and v in the compute dtype of ``xv``."""
    dt = xv.dtype
    shape = xv.shape[:-1] + (-1, hd)
    q = (xv @ p["w_q"].to(dt)).reshape(shape)
    k = (xv @ p["w_k"].to(dt)).reshape(shape) / _key_scale(hd, dt)
    v = (xv @ p["w_v"].to(dt)).reshape(shape)
    return q, k, v


def _chunk_len(cfg: ModelConfig, t: int) -> int:
    """The reference's rule: the configured chunk (64 without an ssm
    config), at most T, halved until it divides T."""
    qn = min(cfg.ssm.chunk if cfg.ssm else 64, t)
    while t % qn:
        qn //= 2
    return qn


def mlstm_scan(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
               return_state: bool = False):
    """Chunked-parallel mLSTM over a full sequence.  x: [B, T, d].
    With ``return_state`` also the final ``{"c", "n", "m"}`` (float32)."""
    if isinstance(x, DTensor):
        return run_on_rows(lambda pl, xl, _: mlstm_scan(pl, xl, cfg, return_state), p, x)
    d, h, d_in, hd = _dims(cfg)
    dt = x.dtype
    b, t, _ = x.shape
    up = x @ p["w_up"].to(dt)
    xv, gate = up[..., :d_in], up[..., d_in:]
    q, k, v = _qkv(p, xv, hd)  # [B, T, H, P]
    logi, logf = _mlstm_gates(p, xv.float(), h)  # [B, T, H]

    qn = _chunk_len(cfg, t)
    ar = torch.arange(qn, device=x.device)
    tri = (ar[:, None] >= ar[None, :])[None, :, :, None]  # [1, q, s, 1]
    c_state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    n_state = torch.zeros((b, h, hd), dtype=torch.float32, device=x.device)
    m_state = torch.full((b, h), _M0, dtype=torch.float32, device=x.device)
    hs = []
    for j in range(0, t, qn):
        qk, kk, vk = q[:, j:j + qn], k[:, j:j + qn], v[:, j:j + qn]
        lik, lfk = logi[:, j:j + qn], logf[:, j:j + qn]
        qf, kf, vf = qk.float(), kk.float(), vk.float()
        cumf = torch.cumsum(lfk, dim=1)  # [B, q, H]
        # within-chunk log weights: w[q_, s] = cumf_q - cumf_s + li_s  (s <= q_)
        logw = cumf[:, :, None, :] - cumf[:, None, :, :] + lik[:, None, :, :]
        logw = torch.where(tri, logw, -math.inf)
        # inter-chunk log weight for the carried state: cumf_q + m_state
        log_inter = cumf + m_state[:, None, :]
        m_new = torch.maximum(logw.amax(dim=2), log_inter)
        w = torch.exp(logw - m_new[:, :, None, :])  # [B, q, s, H]
        scores = torch.einsum("bqhp,bshp->bqsh", qk, kk).float()
        intra = torch.einsum("bqsh,bshp->bqhp", w * scores, vf)
        inter_scale = torch.exp(log_inter - m_new)
        inter = torch.einsum("bqhp,bhvp->bqhv", qf, c_state) * inter_scale[..., None]
        norm_intra = torch.einsum("bqsh,bshp->bqhp", w, kf)
        denom = torch.einsum("bqhp,bqhp->bqh", qf, norm_intra) + \
            torch.einsum("bqhp,bhp->bqh", qf, n_state) * inter_scale
        # max(|n^T q|, 1) in unscaled units is max(|denom|, exp(-m)) here
        hs.append((intra + inter) / torch.maximum(denom.abs(), torch.exp(-m_new))[..., None])
        # carry: decay to the end of the chunk, renormalised to its m
        m_end = m_new[:, -1, :]
        decay_end = torch.exp(cumf[:, -1:, :] - cumf + lik - m_end[:, None, :])
        c_contrib = torch.einsum("bqh,bqhv,bqhp->bhvp", decay_end, vf, kf)
        carry_scale = torch.exp(cumf[:, -1, :] + m_state - m_end)
        c_state = c_state * carry_scale[:, :, None, None] + c_contrib
        n_state = n_state * carry_scale[:, :, None] + torch.einsum("bqh,bqhp->bhp", decay_end, kf)
        m_state = m_end
    hvec = torch.cat(hs, dim=1).reshape(b, t, d_in).to(dt)
    hvec = rms_norm(hvec, p["norm_w"], 1e-5) * F.silu(gate)
    out = hvec @ p["w_down"].to(dt)
    if return_state:
        return out, {"c": c_state, "n": n_state, "m": m_state}
    return out


def mlstm_decode_step(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], cfg: ModelConfig):
    """One token: x [B, 1, d] -> (out [B, 1, d], new ``{"c", "n", "m"}``)."""
    if isinstance(x, DTensor):
        return run_on_rows(lambda pl, xl, cl: mlstm_decode_step(pl, xl, cl, cfg), p, x, cache)
    d, h, d_in, hd = _dims(cfg)
    dt = x.dtype
    up = x[:, 0] @ p["w_up"].to(dt)
    xv, gate = up[..., :d_in], up[..., d_in:]
    q, k, v = (a.float() for a in _qkv(p, xv, hd))  # [B, H, P]
    logi, logf = _mlstm_gates(p, xv.float(), h)  # [B, H]
    c, n, m = cache["c"], cache["n"], cache["m"]
    m_new = torch.maximum(logf + m, logi)
    fdec = torch.exp(logf + m - m_new)
    iexp = torch.exp(logi - m_new)
    c = c * fdec[:, :, None, None] + iexp[:, :, None, None] * torch.einsum("bhv,bhp->bhvp", v, k)
    n = n * fdec[:, :, None] + iexp[:, :, None] * k
    denom = torch.maximum(torch.einsum("bhp,bhp->bh", n, q).abs(), torch.exp(-m_new))
    hvec = torch.einsum("bhp,bhvp->bhv", q, c) / denom[:, :, None]
    hvec = hvec.reshape(x.shape[0], d_in).to(dt)
    hvec = rms_norm(hvec, p["norm_w"], 1e-5) * F.silu(gate)
    return (hvec @ p["w_down"].to(dt))[:, None, :], {"c": c, "n": n, "m": m_new}


def mlstm_cache_spec(cfg: ModelConfig, batch: int):
    _, h, _, hd = _dims(cfg)
    return {
        "c": ShapeDtype((batch, h, hd, hd), torch.float32),
        "n": ShapeDtype((batch, h, hd), torch.float32),
        "m": ShapeDtype((batch, h), torch.float32),
    }


# ----------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------
def slstm_params(cfg: ModelConfig) -> Dict[str, ParamInfo]:
    d, h, d_in, _ = _dims(cfg)
    return {
        "w_up": ParamInfo((d, 2 * d_in), ("embed", "heads")),
        "w_gates": ParamInfo((d_in, 4 * d_in), (None, "heads")),
        "r_gates": ParamInfo((d_in, 4 * d_in), (None, "heads"), init="small"),
        "b_gates": ParamInfo((4 * d_in,), ("heads",), init="zeros"),
        "norm_w": ParamInfo((d_in,), ("heads",), init="ones"),
        "w_down": ParamInfo((d_in, d), ("heads", "embed")),
    }


def _slstm_cell(p, xw: torch.Tensor, state):
    """One sLSTM step.  xw: the step's input times ``w_gates``, [B,
    4 d_in] float32; state: (c, n, hprev, m), float32."""
    c, n, hprev, m = state
    gates = xw + hprev @ p["r_gates"].float() + p["b_gates"].float()
    zi, ii, fi, oi = gates.chunk(4, dim=-1)
    zt = torch.tanh(zi)
    ot = torch.sigmoid(oi)
    logf = F.logsigmoid(fi)
    m_new = torch.maximum(logf + m, ii)
    fdec = torch.exp(logf + m - m_new)
    iexp = torch.exp(ii - m_new)
    c_new = fdec * c + iexp * zt
    n_new = fdec * n + iexp
    h_new = ot * c_new / torch.clamp_min(n_new.abs(), 1.0)
    return c_new, n_new, h_new, m_new


def _slstm_in(p, x: torch.Tensor, d_in: int):
    """(xv @ w_gates in float32, the gate branch in the compute dtype)."""
    up = x @ p["w_up"].to(x.dtype)
    return up[..., :d_in].float() @ p["w_gates"].float(), up[..., d_in:]


def _slstm_out(p, hvec: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    hvec = rms_norm(hvec.to(gate.dtype), p["norm_w"], 1e-5) * F.silu(gate)
    return hvec @ p["w_down"].to(gate.dtype)


def slstm_scan(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
               return_state: bool = False):
    """sLSTM over a full sequence, step by step.  x: [B, T, d].  With
    ``return_state`` also the final ``{"c", "n", "h", "m"}`` (float32)."""
    if isinstance(x, DTensor):
        return run_on_rows(lambda pl, xl, _: slstm_scan(pl, xl, cfg, return_state), p, x)
    _, _, d_in, _ = _dims(cfg)
    b, t, _ = x.shape
    # the input projection of every step at once (see the module's note)
    xw, gate = _slstm_in(p, x, d_in)
    z = torch.zeros((b, d_in), dtype=torch.float32, device=x.device)
    state = (z, z, z, torch.full((b, d_in), _M0, dtype=torch.float32, device=x.device))
    hs = []
    for i in range(t):
        state = _slstm_cell(p, xw[:, i], state)
        hs.append(state[2])
    out = _slstm_out(p, torch.stack(hs, dim=1), gate)
    if return_state:
        c, n, hf, m = state
        return out, {"c": c, "n": n, "h": hf, "m": m}
    return out


def slstm_decode_step(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], cfg: ModelConfig):
    """One token: x [B, 1, d] -> (out [B, 1, d], new ``{"c", "n", "h", "m"}``)."""
    if isinstance(x, DTensor):
        return run_on_rows(lambda pl, xl, cl: slstm_decode_step(pl, xl, cl, cfg), p, x, cache)
    _, _, d_in, _ = _dims(cfg)
    xw, gate = _slstm_in(p, x[:, 0], d_in)
    c, n, hnew, m = _slstm_cell(p, xw, (cache["c"], cache["n"], cache["h"], cache["m"]))
    return _slstm_out(p, hnew, gate)[:, None, :], {"c": c, "n": n, "h": hnew, "m": m}


def slstm_cache_spec(cfg: ModelConfig, batch: int):
    _, _, d_in, _ = _dims(cfg)
    return {name: ShapeDtype((batch, d_in), torch.float32) for name in ("c", "n", "h", "m")}
