"""Public entry points of the GF(p) matmul: backend dispatch and batching.

Backends of :func:`mod_matmul` / :func:`mod_matmul_masked`:

* ``"cuda_int32"`` — the Hopper int32 kernel (counterpart of
                     ``"pallas_int32"``): integer limb dots, uint32
                     Barrett, no depth limit.
* ``"cuda"``       — the Hopper f32-limb kernel (counterpart of
                     ``"pallas"``).
* ``"f32limb"`` / ``"int32"`` — the plain torch paths of ``core.gf``,
                     for CPU tensors only.
* ``"auto"``       — ``"cuda_int32"`` on a CUDA tensor (its folded
                     accumulators leave it no depth bound, so the f32
                     kernel is never the better pick); on a CPU tensor
                     the JAX package's CPU rule: ``"int32"`` once the
                     contraction is deeper than one 256 chunk and within
                     the uint32 bound, ``"f32limb"`` otherwise.

Batching follows the JAX package: leading batch dims of ``a`` and ``b``
broadcast against each other and are flattened into the kernel's one
batch axis, and an operand whose batch dims are absent or all 1 stays
2D — the kernel reads it with batch stride 0, so it is never copied per
batch element.
"""
from __future__ import annotations

import torch

from ...core.gf import (
    CHUNK_K,
    INT32_ACC_K,
    P_DEFAULT,
    field_mask,
    mod_add,
    mod_matmul_f32,
    mod_matmul_int32,
)
from ...obs.metrics import REGISTRY
from ...obs.tracer import TRACER
from .kernel import KERNEL_TILES, modmatmul_cuda, modmatmul_masked_cuda

_CUDA_VARIANTS = {"cuda": "f32", "cuda_int32": "int32"}
_PLAIN = {"f32limb": mod_matmul_f32, "int32": mod_matmul_int32}


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# ----------------------------------------------------------------------
# tile selection
# ----------------------------------------------------------------------
def _pick_tiles_cuda(m: int, k: int, n: int) -> tuple:
    """The Hopper kernel has one compiled block shape (BM, BN, BK)."""
    return KERNEL_TILES


_TILE_CHOOSERS = {"cuda": _pick_tiles_cuda, "cuda_int32": _pick_tiles_cuda}


def register_tile_chooser(backend: str, chooser) -> None:
    """Install a tile-selection policy ``chooser(m, k, n) -> (bm, bn,
    bk)`` for one kernel backend.  The wrapper accepts only tiles the
    compiled kernel has, so a chooser is the hook for kernels that
    compile more than one block shape."""
    _TILE_CHOOSERS[backend] = chooser


def pick_tiles(m: int, k: int, n: int, backend: str = "cuda_int32") -> tuple:
    """(bm, bn, bk) the kernel backend runs one [M,K]@[K,N] product with."""
    return _TILE_CHOOSERS.get(backend, _pick_tiles_cuda)(m, k, n)


def padded_shape(m: int, k: int, n: int, tiles: tuple) -> tuple:
    """(M, K, N) rounded up to whole tiles: the extent the kernel's
    blocks cover, ragged edges included (the kernel masks them instead
    of padding memory)."""
    bm, bn, bk = tiles
    return _round_up(m, bm), _round_up(k, bk), _round_up(n, bn)


def padding_waste(m: int, k: int, n: int, tiles: tuple) -> float:
    """Fraction of the blocks' multiply-adds that fall on ragged edges."""
    mp, kp, np_ = padded_shape(m, k, n, tiles)
    return 1.0 - (m * k * n) / float(mp * kp * np_)


def _flatten_batch(x: torch.Tensor, batch: tuple) -> torch.Tensor:
    """Collapse leading batch dims to one axis; an operand whose batch
    dims are absent or all 1 stays 2D (shared across the kernel's batch
    axis, never materialized per element)."""
    nbatch = 1
    for d in x.shape[:-2]:
        nbatch *= d
    if nbatch == 1:
        return x.reshape(x.shape[-2:]).contiguous()
    if tuple(x.shape[:-2]) != tuple(batch):
        x = x.expand(tuple(batch) + tuple(x.shape[-2:]))
    return x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()


def _resolve_auto(k: int, device: torch.device) -> str:
    """The ``"auto"`` policy for one call's contraction depth and device."""
    if device.type == "cuda":
        return "cuda_int32"
    if CHUNK_K < k and _round_up(k, CHUNK_K) <= INT32_ACC_K:
        # deeper than one exact-f32 chunk: the uint32-accumulator path
        # skips the per-chunk reductions the f32limb path must pay
        return "int32"
    return "f32limb"


def _backend(backend: str, a: torch.Tensor, b: torch.Tensor) -> str:
    if backend == "auto":
        backend = _resolve_auto(int(a.shape[-1]), a.device)
    if backend in _PLAIN:
        if a.device.type != "cpu" or b.device.type != "cpu":
            raise ValueError(
                f"backend {backend!r} is the plain version and takes CPU "
                f"tensors only; use 'cuda_int32' or 'cuda' on the card"
            )
    elif backend not in _CUDA_VARIANTS:
        raise ValueError(f"unknown backend {backend}")
    return backend


def _batch_of(a: torch.Tensor, b: torch.Tensor) -> tuple:
    if a.dim() == 2 and b.dim() == 2:
        return ()
    return tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))


def _event(backend, a, b, **attrs) -> None:
    REGISTRY.counter("kernels.modmatmul_calls").inc()
    if TRACER.enabled:
        TRACER.event(
            "modmatmul.call", backend=backend,
            m=int(a.shape[-2]), k=int(a.shape[-1]), n=int(b.shape[-1]), **attrs,
        )


def _check_tiles(backend, m, k, n) -> None:
    tiles = tuple(pick_tiles(m, k, n, backend=backend))
    if tiles != KERNEL_TILES:
        raise ValueError(
            f"{backend}: tiles {tiles} are not compiled; the kernel has {KERNEL_TILES}"
        )


def mod_matmul(
    a: torch.Tensor, b: torch.Tensor, p: int = P_DEFAULT, backend: str = "auto"
) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] mod p (int32), batched over leading dims.

    Batch dims of ``a`` and ``b`` must broadcast against each other; one
    side may omit them entirely (a 2D constant matrix against a batched
    operand), and that side is shared, never broadcast.
    """
    backend = _backend(backend, a, b)
    _event(backend, a, b)
    if backend in _PLAIN:
        return _PLAIN[backend](a, b, p)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    _check_tiles(backend, m, k, n)
    variant = _CUDA_VARIANTS[backend]
    batch = _batch_of(a, b)
    if not batch:
        return modmatmul_cuda(a.contiguous(), b.contiguous(), p, variant)
    out = modmatmul_cuda(_flatten_batch(a, batch), _flatten_batch(b, batch), p, variant)
    return out.reshape(batch + (m, n))


def mod_matmul_masked(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    key,
    p: int = P_DEFAULT,
    backend: str = "auto",
) -> torch.Tensor:
    """``a @ b + v @ R(key)  (mod p)`` — blinding fused into the matmul.

    ``v`` is a 2D [M, z] constant; R is the counter-based mask
    ``field_mask(key, batch + (z, N), p)`` where ``batch`` is the
    broadcast batch of ``a`` and ``b``.  The kernel backends generate R
    in the epilogue; the plain backends materialize the same values.
    All backends are bit-identical for a given ``key``.
    """
    backend = _backend(backend, a, b)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    z = v.shape[-1]
    if v.dim() != 2 or v.shape[0] != m:
        raise ValueError(f"v must be [M={m}, z], got {tuple(v.shape)}")
    batch = _batch_of(a, b)
    if backend in _PLAIN:
        mm = mod_matmul(a, b, p=p, backend=backend)
        mask = field_mask(key, batch + (z, n), p, device=a.device)
        return mod_add(mm, mod_matmul(v, mask, p=p, backend=backend), p)
    _event(backend, a, b, fused_mask=True)
    _check_tiles(backend, m, k, n)
    variant = _CUDA_VARIANTS[backend]
    v = v.contiguous()
    if not batch:
        return modmatmul_masked_cuda(a.contiguous(), b.contiguous(), v, key, p, variant)
    out = modmatmul_masked_cuda(
        _flatten_batch(a, batch), _flatten_batch(b, batch), v, key, p, variant
    )
    return out.reshape(batch + (m, n))


def polyeval(
    vander: torch.Tensor, coeffs: torch.Tensor, p: int = P_DEFAULT, **kw
) -> torch.Tensor:
    """Evaluate matrix-coefficient polynomials at many points.

    vander: [N, K] powers matrix (alpha_n ** power_k mod p)
    coeffs: [..., K, R, C] stacked matrix coefficients
    returns [..., N, R, C]: F(alpha_n) = sum_k vander[n, k] * coeffs[k].
    """
    *batch, k, r, c = coeffs.shape
    flat = mod_matmul(vander, coeffs.reshape(tuple(batch) + (k, r * c)), p=p, **kw)
    return flat.reshape(tuple(batch) + (vander.shape[0], r, c))


def polyeval_masked(
    vander: torch.Tensor,
    coeffs: torch.Tensor,
    vsecret: torch.Tensor,
    key,
    p: int = P_DEFAULT,
    **kw,
) -> torch.Tensor:
    """``polyeval`` with the z secret coefficients fused into the kernel:
    F(alpha_n) = V @ coeffs + Vsecret @ R(key).  ``coeffs`` must carry
    zeros at the secret rows."""
    *batch, k, r, c = coeffs.shape
    flat = mod_matmul_masked(
        vander, coeffs.reshape(tuple(batch) + (k, r * c)), vsecret, key, p=p, **kw
    )
    return flat.reshape(tuple(batch) + (vander.shape[0], r, c))
