"""High-level privacy-preserving compute API (batched engine).

``secure_matmul_batched`` runs a batch of Y[i] = A[i]^T B[i] under CMPC
with fixed-point quantisation into GF(p) and centered-lift decode — the
counterpart of ``repro.core.layers.secure_matmul_batched``, with the
quantisation done on the device.

Overflow discipline: an inner product of length k with operands bounded
by ``a_max``/``w_max`` needs  k * (a_max*scale_a) * (w_max*scale_w)
< (p-1)/2.  ``choose_scales`` picks the largest power-of-two scale
satisfying that bound.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import protocol
from .constructions import build_scheme
from .gf import Field
from .planner import BlockShapes, CMPCPlan, get_plan


def choose_scales(k: int, a_max: float, w_max: float, p: int) -> int:
    """Largest power-of-two scale S such that k*(a_max*S)*(w_max*S) fits."""
    half = (p - 1) // 2
    s = 1
    while k * (a_max * 2 * s) * (w_max * 2 * s) < half:
        s *= 2
    return s


@dataclasses.dataclass
class SecureMatmulResult:
    y: torch.Tensor
    trace: protocol.Trace
    plan: CMPCPlan


def _encode(field: Field, x: torch.Tensor, scale: int) -> torch.Tensor:
    """``Field.encode`` on the device: round half to even (as np.rint),
    refuse values past the centered range, lift into [0, p)."""
    q = torch.round(x * scale).to(torch.int64)
    half = (field.p - 1) // 2
    if bool((q.abs() > half).any()):
        raise OverflowError("value out of field range at this scale")
    return torch.remainder(q, field.p)


def _decode(field: Field, x: torch.Tensor, scale: int) -> torch.Tensor:
    """``Field.decode`` on the device: centered lift back to float64."""
    x = torch.remainder(x.to(torch.int64), field.p)
    half = (field.p - 1) // 2
    signed = torch.where(x > half, x - field.p, x)
    return signed.to(torch.float64) / scale


def secure_matmul_batched(
    a,
    b,
    method: str = "age",
    s: int = 2,
    t: int = 2,
    z: int = 1,
    field: Optional[Field] = None,
    scale: Optional[int] = None,
    n_spare: int = 0,
    seed: int = 0,
    backend: str = "auto",
    device=None,
) -> SecureMatmulResult:
    """Privacy-preserving Y[i] = A[i]^T B[i] for a batch of products.

    a: [batch, k, ma];  b: [batch, k, mb] or [k, mb] (one B against a
    batch of activations is broadcast), as numpy arrays or tensors.
    One plan (from the process-wide plan cache) serves every product;
    all three phases run on ``device`` (default: the GPU) via
    ``protocol.run_batched``.  Returns y as float64 on ``device``.
    """
    field = field or Field()
    device = protocol.resolve_device(device)
    a = torch.as_tensor(a, device=device).to(torch.float64)
    b = torch.as_tensor(b, device=device).to(torch.float64)
    if a.dim() != 3:
        raise ValueError(f"a must be [batch, k, ma], got {tuple(a.shape)}")
    if b.dim() == 2:
        b = b.expand((a.shape[0],) + tuple(b.shape))
    batch, k, ma = a.shape
    if tuple(b.shape[:2]) != (batch, k):
        raise ValueError(f"batch/inner dims disagree: {tuple(a.shape)} vs {tuple(b.shape)}")
    mb = b.shape[2]
    if scale is None:
        scale = choose_scales(
            k,
            float(a.abs().max()) + 1e-9,
            float(b.abs().max()) + 1e-9,
            field.p,
        )
    scheme = build_scheme(method, s, t, z)
    shapes = BlockShapes(k=k, ma=ma, mb=mb, s=s, t=t)
    plan = get_plan(scheme, shapes, field=field, n_spare=n_spare, seed=seed)
    aq = _encode(field, a, scale)
    bq = _encode(field, b, scale)
    yq, trace = protocol.run_batched(
        plan, aq, bq, seed=seed + 1, backend=backend, device=device
    )
    return SecureMatmulResult(y=_decode(field, yq, scale * scale), trace=trace, plan=plan)
