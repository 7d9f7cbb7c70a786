"""Mamba2 (SSD) blocks: the chunked scan over a sequence and the O(1)
decode update.

The counterpart of ``repro.models.ssm``.  The selective state space
recurrence per head (state N, head dim P):

    S_t = exp(A dt_t) S_{t-1} + dt_t x_t B_t^T      S in R^{P x N}
    y_t = S_t C_t + D x_t

A full sequence runs the chunked dual form: within a chunk an
attention-like product against the decay-products matrix, across
chunks the carried state (the reference's ``lax.scan`` over chunks is a
Python loop over the same chunks).  Decode is one recurrence step on a
cached state.

The reference's numerics are kept, and they are not all float32: the
carried state is in the compute dtype (bfloat16 in the served configs),
``exp(A dt)`` and the intra-chunk weights are rounded to it before they
multiply, and the cache's ``state`` and ``conv`` leaves come back from a
prefill or a step in the dtype the compute dtype and the cache's
promote to.  Only the step sizes, ``A`` and the decay sums are float32.
A float32 state would be more accurate; it would not be the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import ParamInfo, ShapeDtype


def mamba_params(cfg: ModelConfig) -> Dict[str, ParamInfo]:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    h = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return {
        "w_in": ParamInfo((d, 2 * d_in + 2 * s.d_state + h), ("embed", "heads")),
        "conv_w": ParamInfo((s.d_conv, conv_dim), (None, "heads")),
        "conv_b": ParamInfo((conv_dim,), ("heads",), init="zeros"),
        "a_log": ParamInfo((h,), ("heads",), init="zeros"),
        "d_skip": ParamInfo((h,), ("heads",), init="ones"),
        "dt_bias": ParamInfo((h,), ("heads",), init="zeros"),
        "norm_w": ParamInfo((d_in,), ("heads",), init="ones"),
        "w_out": ParamInfo((d_in, d), ("heads", "embed")),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """(z, xBC, dt, d_in, heads) of the input projection."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * s.d_state, h], dim=-1)
    return z, xbc, dt, d_in, h


def _conv_step(conv_state: torch.Tensor, xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Causal depthwise conv for one step.  conv_state: [B, K-1, C]."""
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # [B, K, C]
    out = torch.einsum("bkc,kc->bc", window, w.to(window.dtype)) + b
    return F.silu(out), window[:, 1:, :]


def _step_sizes(p, dtr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softplus(dt + dt_bias), A = -exp(a_log)), float32."""
    dt_act = F.softplus(dtr.float() + p["dt_bias"].float())
    return dt_act, -torch.exp(p["a_log"].float())


def _gated_norm_out(p, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The gated RMS norm (float32 statistics, eps 1e-5), then ``w_out``."""
    dt = z.dtype
    y = y * F.silu(z)
    var = y.float().square().mean(-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-5)).to(dt) * p["norm_w"].to(dt)
    return y @ p["w_out"].to(dt)


def _chunk_len(s, t: int) -> int:
    """The reference's rule: the configured chunk, at most T, less one
    until it divides T (unlike the mLSTM's halving)."""
    q = min(s.chunk, t)
    while t % q:
        q -= 1
    return q


def mamba_scan(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
               return_state: bool = False):
    """Full-sequence pass.  x: [B, T, d].  With ``return_state`` also
    ``{"state": [B, H, P, N], "conv": [B, K-1, C]}``: the carried state
    and the last K-1 raw (pre-conv) xBC rows, zero rows first when T <
    K-1, both in the compute dtype."""
    s = cfg.ssm
    dt = x.dtype
    b, t, _ = x.shape
    z, xbc, dtr, d_in, h = _split_proj(cfg, x @ p["w_in"].to(dt))

    # causal depthwise conv over time
    k = s.d_conv
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    conv_tail = pad[:, t:, :]  # the last k-1 raw inputs: the decode conv state
    windows = torch.stack([pad[:, i:i + t, :] for i in range(k)], dim=2)  # [B, T, K, C]
    xbc = F.silu(torch.einsum("btkc,kc->btc", windows, p["conv_w"].to(dt)) + p["conv_b"].to(dt))

    xs, bmat, cmat = torch.split(xbc, [d_in, s.d_state, s.d_state], dim=-1)
    xs = xs.reshape(b, t, h, s.head_dim)
    dt_act, a = _step_sizes(p, dtr)  # [B, T, H], [H]
    adt = a * dt_act  # negative

    q = _chunk_len(s, t)
    ar = torch.arange(q, device=x.device)
    tri = (ar[:, None] >= ar[None, :])[None, :, :, None]  # [1, q, s, 1]
    state = torch.zeros((b, h, s.head_dim, s.d_state), dtype=dt, device=x.device)
    ys = []
    for j in range(0, t, q):
        xs_k, b_k, c_k = xs[:, j:j + q], bmat[:, j:j + q], cmat[:, j:j + q]
        adt_k, dt_k = adt[:, j:j + q], dt_act[:, j:j + q]
        cum = torch.cumsum(adt_k, dim=1)  # [B, q, H]
        # inter-chunk: y_inter[q] = C_q . S_prev^T . exp(cum_q), in float32
        y_inter = torch.einsum("bqn,bhpn->bqhp", c_k.float(), state.float()) * \
            torch.exp(cum)[..., None]
        # decay matrix L[q, s] = exp(cum_q - cum_s) for s <= q
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # [B, q, s, H]
        l_mat = torch.where(tri, torch.exp(diff), 0.0)
        cb = torch.einsum("bqn,bsn->bqs", c_k, b_k)[..., None]  # [B, q, s, 1]
        w = cb * l_mat * dt_k[:, None, :, :]  # [B, q, s, H] float32
        y_intra = torch.einsum("bqsh,bshp->bqhp", w.to(dt), xs_k)
        # state update, in the compute dtype
        decay_end = torch.exp(cum[:, -1:, :] - cum)  # [B, q, H]
        contrib = torch.einsum("bqh,bqhp,bqn->bhpn", (decay_end * dt_k).to(dt), xs_k, b_k)
        state = state * torch.exp(cum[:, -1, :]).to(dt)[:, :, None, None] + contrib
        ys.append(y_inter.to(dt) + y_intra)
    y = torch.cat(ys, dim=1) + p["d_skip"].to(dt)[None, None, :, None] * xs
    out = _gated_norm_out(p, y.reshape(b, t, d_in), z)
    if return_state:
        return out, {"state": state, "conv": conv_tail}
    return out


def mamba_decode_step(p: Dict[str, torch.Tensor], x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], cfg: ModelConfig):
    """One token: x [B, 1, d] -> (out [B, 1, d], new ``{"state", "conv"}``)."""
    s = cfg.ssm
    dt = x.dtype
    b = x.shape[0]
    z, xbc, dtr, d_in, h = _split_proj(cfg, x[:, 0] @ p["w_in"].to(dt))
    xbc, conv_state = _conv_step(cache["conv"], xbc, p["conv_w"].to(dt), p["conv_b"].to(dt))
    xs, bvec, cvec = torch.split(xbc, [d_in, s.d_state, s.d_state], dim=-1)
    xs = xs.reshape(b, h, s.head_dim)
    dt_act, a = _step_sizes(p, dtr)  # [B, H], [H]
    decay = torch.exp(a[None] * dt_act).to(dt)
    state = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt_act.to(dt), xs, bvec)
    y = torch.einsum("bhpn,bn->bhp", state, cvec.to(state.dtype)) + \
        p["d_skip"].to(dt)[None, :, None] * xs
    out = _gated_norm_out(p, y.reshape(b, d_in), z)
    return out[:, None, :], {"state": state, "conv": conv_state}


def mamba_cache_spec(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.bfloat16):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return {
        "state": ShapeDtype((batch, h, s.head_dim, s.d_state), dtype),
        "conv": ShapeDtype((batch, s.d_conv - 1, conv_dim), dtype),
    }
