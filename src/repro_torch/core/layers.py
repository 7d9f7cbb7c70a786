"""High-level privacy-preserving compute API.

The counterpart of ``repro.core.layers``.  ``secure_matmul`` runs one
Y = A^T B under CMPC between two logical sources (the per-product
reference path, ``protocol.run``), with fixed-point quantisation into
GF(p) and centered-lift decode; ``secure_matmul_batched`` runs a batch
through the batched engine with the quantisation done on the device.
``InlineExecutor`` / ``secure_matmul_submit`` defer products and fold
each group into one ``protocol.run_batched`` at flush.
``PrivateLinear`` wraps a weight matrix as "source 2" so that
activations from "source 1" are multiplied without either worker (or
the master) learning the operands.

Every entry point runs on ``device`` (default: the GPU) and returns its
y as a float64 tensor there.

Overflow discipline: an inner product of length k with operands bounded
by ``a_max``/``w_max`` needs  k * (a_max*scale_a) * (w_max*scale_w)
< (p-1)/2.  ``choose_scales`` picks the largest power-of-two scale
satisfying that bound; ``PrivateLinear`` also supports column-blocked
accumulation (split the inner dim, run one protocol instance per block,
sum the decoded reals).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
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


def _host_float(x) -> np.ndarray:
    """Operands of the host-side reference path as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


class MatmulHandle:
    """One deferred Y = A^T B submission against an executor.

    ``submit`` returns immediately with a handle; the numeric result
    materializes when the owning executor flushes — either explicitly
    or implicitly on the first ``result()`` of a still-pending handle.
    """

    __slots__ = ("_executor", "_value")

    def __init__(self, executor: "InlineExecutor"):
        self._executor = executor
        self._value: Optional[SecureMatmulResult] = None

    def done(self) -> bool:
        return self._value is not None

    def result(self) -> SecureMatmulResult:
        """The decoded product (flushes the executor when pending)."""
        if self._value is None:
            self._executor.flush()
        assert self._value is not None, "flush did not resolve this handle"
        return self._value

    def _resolve(self, value: SecureMatmulResult) -> None:
        self._value = value


@dataclasses.dataclass
class _PendingMatmul:
    handle: MatmulHandle
    aq: torch.Tensor  # [k, ma], field-encoded
    bq: torch.Tensor  # [k, mb], field-encoded
    scale: int


class InlineExecutor:
    """Synchronous batching executor for secure matmuls.

    Submissions accumulate per *group* — products with identical
    ``(method, s, t, z, n_spare, k, ma, mb)`` signatures share one plan
    and fold into one batched protocol execution — until :meth:`flush`
    runs one ``protocol.run_batched`` per group on ``device`` (default:
    the GPU) and resolves every handle.  Per-request fixed-point scales
    survive the fold: encoding happens at submit with the request's own
    scale, and each product decodes with its own ``scale**2``.
    """

    def __init__(
        self,
        field: Optional[Field] = None,
        backend: str = "auto",
        seed: int = 0,
        device=None,
    ):
        self.field = field or Field()
        self.backend = backend
        self.seed = seed
        self.device = protocol.resolve_device(device)
        self._pending: dict = {}  # group signature -> [_PendingMatmul]
        self.flushes = 0
        self.submitted = 0

    def pending(self) -> int:
        return sum(len(g) for g in self._pending.values())

    def submit(
        self,
        a,
        b,
        method: str = "age",
        s: int = 2,
        t: int = 2,
        z: int = 1,
        scale: Optional[int] = None,
        n_spare: int = 0,
    ) -> MatmulHandle:
        """Queue one Y = A^T B (a: [k, ma], b: [k, mb]); returns its
        handle.  ``scale=None`` picks the per-request power-of-two
        fixed-point scale from this request's operand ranges."""
        a = torch.as_tensor(a, device=self.device).to(torch.float64)
        b = torch.as_tensor(b, device=self.device).to(torch.float64)
        if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
            raise ValueError(
                f"expected [k, ma] / [k, mb] operands, got {tuple(a.shape)} {tuple(b.shape)}"
            )
        k, ma = a.shape
        mb = b.shape[1]
        if scale is None:
            scale = choose_scales(
                k, float(a.abs().max()) + 1e-9, float(b.abs().max()) + 1e-9, self.field.p
            )
        key = (method, s, t, z, n_spare, k, ma, mb)
        handle = MatmulHandle(self)
        self._pending.setdefault(key, []).append(
            _PendingMatmul(
                handle=handle,
                aq=_encode(self.field, a, scale),
                bq=_encode(self.field, b, scale),
                scale=int(scale),
            )
        )
        self.submitted += 1
        return handle

    def flush(self) -> int:
        """Run every pending group through ``protocol.run_batched`` and
        resolve its handles; returns the number of products served."""
        pending, self._pending = self._pending, {}
        served = 0
        for (method, s, t, z, n_spare, k, ma, mb), group in pending.items():
            scheme = build_scheme(method, s, t, z)
            shapes = BlockShapes(k=k, ma=ma, mb=mb, s=s, t=t)
            plan = get_plan(
                scheme, shapes, field=self.field, n_spare=n_spare, seed=self.seed,
            )
            aq = torch.stack([g.aq for g in group])
            bq = torch.stack([g.bq for g in group])
            yq, trace = protocol.run_batched(
                plan, aq, bq, seed=self.seed + 1 + self.flushes,
                backend=self.backend, device=self.device,
            )
            self.flushes += 1
            for i, g in enumerate(group):
                g.handle._resolve(
                    SecureMatmulResult(
                        y=_decode(self.field, yq[i], g.scale * g.scale),
                        trace=trace,
                        plan=plan,
                    )
                )
            served += len(group)
        return served


def secure_matmul_submit(
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
    executor: Optional[InlineExecutor] = None,
    device=None,
) -> MatmulHandle:
    """Async twin of :func:`secure_matmul`: queue the product on an
    executor and return a :class:`MatmulHandle`.

    With a shared ``executor`` many submissions fold into one batched
    protocol run at the next flush; without one, a private single-use
    executor on ``device`` makes ``handle.result()`` equivalent to
    ``secure_matmul_batched`` at batch 1.  When ``executor`` is given,
    its field/seed/backend/device govern and the corresponding arguments
    here must be left at their defaults.
    """
    if executor is None:
        executor = InlineExecutor(field=field, backend=backend, seed=seed, device=device)
    elif field is not None and field.p != executor.field.p:
        raise ValueError(
            f"executor field p={executor.field.p} != requested p={field.p}"
        )
    return executor.submit(
        a, b, method=method, s=s, t=t, z=z, scale=scale, n_spare=n_spare
    )


def secure_matmul(
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
    device=None,
) -> SecureMatmulResult:
    """Privacy-preserving Y = A^T B over the reals, on the per-product
    reference path (``protocol.run``).

    a: [k, ma] held by source 1;  b: [k, mb] held by source 2.  The
    quantisation and the decode run on the host, the protocol's products
    on ``device`` (default: the GPU); y is float64 on ``device``.
    """
    field = field or Field()
    device = protocol.resolve_device(device)
    a = _host_float(a)
    b = _host_float(b)
    k, ma = a.shape
    k2, mb = b.shape
    if k != k2:
        raise ValueError("inner dimensions disagree")
    if scale is None:
        scale = choose_scales(
            k, float(np.abs(a).max() + 1e-9), float(np.abs(b).max() + 1e-9), field.p
        )
    scheme = build_scheme(method, s, t, z)
    shapes = BlockShapes(k=k, ma=ma, mb=mb, s=s, t=t)
    plan = get_plan(scheme, shapes, field=field, n_spare=n_spare, seed=seed)
    aq = field.encode(a, scale)
    bq = field.encode(b, scale)
    yq, trace = protocol.run(plan, aq, bq, seed=seed + 1, device=device)
    y = torch.from_numpy(field.decode(yq, scale * scale)).to(device)
    return SecureMatmulResult(y=y, trace=trace, plan=plan)


class LinearHandle:
    """Deferred ``PrivateLinear`` application: one part-handle per
    inner-dim block, summed at :meth:`result`."""

    __slots__ = ("_parts",)

    def __init__(self, parts):
        self._parts = list(parts)

    def done(self) -> bool:
        return all(h.done() for h in self._parts)

    def result(self) -> torch.Tensor:
        """[batch, out] activations (flushes pending parts)."""
        out = self._parts[0].result().y
        for h in self._parts[1:]:
            out = out + h.result().y
        return out


class PrivateLinear:
    """y = x @ W via CMPC, W private to the layer owner.

    The plan is built once per (k, out, s, t, z) signature and reused
    across calls; the inner dimension may be split into ``blocks``
    independent protocol instances for extra fixed-point headroom.

    With an ``executor`` (:class:`InlineExecutor`) the layer becomes a
    submission source: :meth:`submit` queues its per-block products and
    returns a :class:`LinearHandle`, and ``__call__`` submits and
    flushes.  Without one, ``__call__`` runs one ``protocol.run`` per
    block on ``device`` (default: the executor's device, else the GPU).
    Outputs are float64 tensors on that device.
    """

    def __init__(
        self,
        w,
        method: str = "age",
        s: int = 2,
        t: int = 2,
        z: int = 1,
        blocks: int = 1,
        field: Optional[Field] = None,
        seed: int = 0,
        executor: Optional[InlineExecutor] = None,
        device=None,
    ):
        self.w = _host_float(w)
        self.method, self.s, self.t, self.z = method, s, t, z
        self.blocks = blocks
        self.field = field or Field()
        self.seed = seed
        self.executor = executor
        if executor is not None and executor.field.p != self.field.p:
            raise ValueError(
                f"executor field p={executor.field.p} != layer p={self.field.p}"
            )
        if executor is not None and device is None:
            self.device = executor.device
        else:
            self.device = protocol.resolve_device(device)
        if executor is not None and executor.device != self.device:
            raise ValueError(
                f"executor device {executor.device} != layer device {self.device}"
            )
        # the scheme depends only on ctor args: build it once, not per call
        self._scheme = build_scheme(method, s, t, z)
        k = self.w.shape[0]
        if k % blocks:
            raise ValueError("blocks must divide the inner dimension")

    def submit(self, x) -> LinearHandle:
        """Queue x @ W on the layer's executor (requires one); returns
        a :class:`LinearHandle` resolving to [batch, out]."""
        if self.executor is None:
            raise ValueError("PrivateLinear.submit needs an executor")
        x = _host_float(x)
        _, k = x.shape
        kblk = k // self.blocks
        parts = []
        for bi in range(self.blocks):
            sl = slice(bi * kblk, (bi + 1) * kblk)
            parts.append(
                self.executor.submit(
                    x[:, sl].T,  # [kblk, batch] == "A"
                    self.w[sl],  # [kblk, out]  == "B"
                    method=self.method, s=self.s, t=self.t, z=self.z,
                )
            )
        return LinearHandle(parts)

    def _plan(self, batch: int, kblk: int) -> CMPCPlan:
        # Delegates to the process-wide plan cache (planner.get_plan).
        shapes = BlockShapes(k=kblk, ma=batch, mb=self.w.shape[1], s=self.s, t=self.t)
        return get_plan(self._scheme, shapes, field=self.field, seed=self.seed)

    def __call__(self, x) -> torch.Tensor:
        """x: [batch, k] activations (source 1).  Returns [batch, out]."""
        if self.executor is not None:
            handle = self.submit(x)
            self.executor.flush()
            return handle.result()
        x = _host_float(x)
        batch, k = x.shape
        kblk = k // self.blocks
        out = np.zeros((batch, self.w.shape[1]))
        for bi in range(self.blocks):
            sl = slice(bi * kblk, (bi + 1) * kblk)
            xa = x[:, sl].T  # [kblk, batch] == "A"
            wb = self.w[sl]  # [kblk, out]  == "B"
            scale = choose_scales(
                kblk,
                float(np.abs(xa).max() + 1e-9),
                float(np.abs(wb).max() + 1e-9),
                self.field.p,
            )
            plan = self._plan(batch, kblk)
            aq = self.field.encode(xa, scale)
            bq = self.field.encode(wb, scale)
            yq, _ = protocol.run(plan, aq, bq, seed=self.seed + bi, device=self.device)
            out += self.field.decode(yq, scale * scale)
        return torch.from_numpy(out).to(self.device)
