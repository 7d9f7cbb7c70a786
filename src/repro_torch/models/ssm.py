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

On a mesh (``x`` a DTensor in the residual stream's layout) the layer
is head-parallel (``_mamba_sharded``): the input projection runs on
DTensors (each ``model`` rank its column shard) and is all-gathered, as
its [z | x | B | C | dt] split does not fall on the shard boundaries;
each rank then takes its own heads' z, x and dt and the shared B and C,
convolves its own channels, scans its own heads (the state's cache
layout: heads over ``model``), reduces the gated norm's sum of squares
over ``model`` once, and multiplies by its rows of ``w_out``, whose
partial sums meet in the block's all-reduce.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..distributed import sharding
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


def _ssd_chunks(s, xs, bmat, cmat, dt_act, a, dt):
    """The chunked dual form over T: (the output chunks [B, q, H, P] in
    ``dt``, the carried state [B, H, P, N] in ``dt``), from the heads'
    inputs ``xs`` [B, T, H, P], the shared ``bmat`` / ``cmat`` [B, T, N],
    the step sizes [B, T, H] and ``a`` [H] (float32)."""
    b, t, h = dt_act.shape
    adt = a * dt_act  # negative
    q = _chunk_len(s, t)
    ar = torch.arange(q, device=xs.device)
    tri = (ar[:, None] >= ar[None, :])[None, :, :, None]  # [1, q, s, 1]
    state = torch.zeros((b, h, s.head_dim, s.d_state), dtype=dt, device=xs.device)
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
    return ys, state


def mamba_scan(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
               return_state: bool = False):
    """Full-sequence pass.  x: [B, T, d].  With ``return_state`` also
    ``{"state": [B, H, P, N], "conv": [B, K-1, C]}``: the carried state
    and the last K-1 raw (pre-conv) xBC rows, zero rows first when T <
    K-1, both in the compute dtype."""
    if isinstance(x, DTensor):
        return _mamba_sharded(p, x, cfg, return_state=return_state)
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
    ys, state = _ssd_chunks(s, xs, bmat, cmat, dt_act, a, dt)
    y = torch.cat(ys, dim=1) + p["d_skip"].to(dt)[None, None, :, None] * xs
    out = _gated_norm_out(p, y.reshape(b, t, d_in), z)
    if return_state:
        return out, {"state": state, "conv": conv_tail}
    return out


def mamba_decode_step(p: Dict[str, torch.Tensor], x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], cfg: ModelConfig):
    """One token: x [B, 1, d] -> (out [B, 1, d], new ``{"state", "conv"}``)."""
    if isinstance(x, DTensor):
        return _mamba_sharded(p, x, cfg, cache=cache)
    s = cfg.ssm
    dt = x.dtype
    b = x.shape[0]
    z, xbc, dtr, d_in, h = _split_proj(cfg, x[:, 0] @ p["w_in"].to(dt))
    xbc, conv_state = _conv_step(cache["conv"], xbc, p["conv_w"].to(dt), p["conv_b"].to(dt))
    xs, bvec, cvec = torch.split(xbc, [d_in, s.d_state, s.d_state], dim=-1)
    xs = xs.reshape(b, h, s.head_dim)
    dt_act, a = _step_sizes(p, dtr)  # [B, H], [H]
    state, y = _ssd_step(cache["state"], xs, bvec, cvec, dt_act, a, dt)
    y = y + p["d_skip"].to(dt)[None, :, None] * xs
    out = _gated_norm_out(p, y.reshape(b, d_in), z)
    return out[:, None, :], {"state": state, "conv": conv_state}


def _ssd_step(state, xs, bvec, cvec, dt_act, a, dt):
    """One recurrence step: (the new state, y [B, H, P] before the skip)."""
    decay = torch.exp(a[None] * dt_act).to(dt)
    state = state * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt_act.to(dt), xs, bvec)
    return state, torch.einsum("bhpn,bn->bhp", state, cvec.to(state.dtype))


def _mamba_sharded(p, x, cfg: ModelConfig, cache=None, return_state: bool = False):
    """``mamba_scan`` (no ``cache``) or ``mamba_decode_step`` (x [B, 1, d])
    on a mesh, head-parallel where the model axis divides the heads (else
    every head on every rank): see the module's note.  The numbers are
    the plain functions' on the same rows."""
    s = cfg.ssm
    dt = x.dtype
    d_in = s.expand * cfg.d_model
    h, n = d_in // s.head_dim, s.d_state
    mesh = x.device_mesh
    mi = sharding.model_dim(mesh)
    m = 1 if mi is None else mesh.size(mi)
    split = m > 1 and h % m == 0
    r = mesh.get_local_rank(mi) if split else 0
    cp, hp = (d_in // m, h // m) if split else (d_in, h)
    rows = sharding.rows_placements(x)
    # the projection's column shards, then whole on every rank of the row
    proj = sharding.local_rows(x @ p["w_in"].to(dt), split)
    b, t = proj.shape[:2]
    dev = proj.device
    z = proj[..., r * cp:(r + 1) * cp]
    xbc = proj[..., d_in:2 * d_in + 2 * n]  # every raw channel: the conv state's
    dtr = proj[..., 2 * d_in + 2 * n + r * hp:2 * d_in + 2 * n + (r + 1) * hp]
    chans = torch.cat([torch.arange(r * cp, (r + 1) * cp, device=dev),
                       torch.arange(d_in, d_in + 2 * n, device=dev)])  # this rank's x, B, C
    conv_w = sharding.local_whole(p["conv_w"], rows, split)[:, chans].to(dt)
    conv_b = sharding.local_whole(p["conv_b"], rows, split)[chans].to(dt)
    k = s.d_conv
    if cache is None:
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        tail = pad[:, t:, :]
        mine = pad[..., chans]
        windows = torch.stack([mine[:, i:i + t, :] for i in range(k)], dim=2)  # [B, T, K, C]
        xbc = F.silu(torch.einsum("btkc,kc->btc", windows, conv_w) + conv_b)
    else:
        conv = sharding.state_rows(cache["conv"], x)
        window = torch.cat([conv, xbc], dim=1)  # [B, K, C]
        tail = window[:, 1:, :]
        xbc = F.silu(torch.einsum("bkc,kc->bc", window[..., chans], conv_w.to(window.dtype))
                     + conv_b)[:, None]
    xs, bmat, cmat = torch.split(xbc, [cp, n, n], dim=-1)
    heads = slice(r * hp, (r + 1) * hp)
    pv = {name: sharding.local_whole(p[name], rows, split)[heads]
          for name in ("a_log", "dt_bias", "d_skip")}
    dt_act, a = _step_sizes(pv, dtr)  # [B, T, H/m], [H/m]
    if cache is None:
        xs = xs.reshape(b, t, hp, s.head_dim)
        ys, state = _ssd_chunks(s, xs, bmat, cmat, dt_act, a, dt)
        y = torch.cat(ys, dim=1) + pv["d_skip"].to(dt)[None, None, :, None] * xs
    else:
        xs = xs[:, 0].reshape(b, hp, s.head_dim)
        state = sharding.state_rows(cache["state"], x, split)
        state, y = _ssd_step(state, xs, bmat[:, 0], cmat[:, 0], dt_act[:, 0], a, dt)
        y = (y + pv["d_skip"].to(dt)[None, :, None] * xs)[:, None]
    y = y.reshape(b, t, cp) * F.silu(z)
    if split:  # the norm's mean over every head's units
        var = sharding.reduce_over_model(y.float().square().sum(-1, keepdim=True), x) / d_in
    else:
        var = y.float().square().mean(-1, keepdim=True)
    norm_w = sharding.local_whole(p["norm_w"], rows, split)[r * cp:(r + 1) * cp]
    y = (y.float() * torch.rsqrt(var + 1e-5)).to(dt) * norm_w.to(dt)
    w_out = sharding.local_shard(p["w_out"], rows) if split else \
        sharding.local_whole(p["w_out"], rows)
    out = sharding.from_rows(y @ w_out.to(dt), x, partial=split)
    if cache is None and not return_state:
        return out
    return out, {"state": sharding.state_from_rows("state", state, x, h if split else 0),
                 "conv": sharding.state_from_rows("conv", tail, x)}


def mamba_cache_spec(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.bfloat16):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return {
        "state": ShapeDtype((batch, h, s.head_dim, s.d_state), dtype),
        "conv": ShapeDtype((batch, s.d_conv - 1, conv_dim), dtype),
    }
