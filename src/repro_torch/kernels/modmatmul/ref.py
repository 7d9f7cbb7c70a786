"""Plain versions of the GF(p) matmul kernels, and the host oracle.

Each CUDA kernel in ``kernel.py`` has a plain PyTorch version here that
computes the same function on any device: the CPU tests run it in place
of the kernel, and ``chip_smoke.py`` holds the kernel against it on the
card.  The results are integers, so "the same" means equal.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.gf import (
    INT32_ACC_K,
    P_DEFAULT,
    field_mask,
    mod_add,
    mod_matmul_f32,
    mod_matmul_int32,
)


def modmatmul_ref(a, b, p: int = P_DEFAULT) -> np.ndarray:
    """Ground-truth a @ b mod p on the host: arbitrary-precision integers,
    correct for batched operands on either side."""
    prod = np.asarray(a, np.int64).astype(np.object_) @ np.asarray(b, np.int64).astype(np.object_)
    return (prod % p).astype(np.int64)


def modmatmul_int32_plain(a: torch.Tensor, b: torch.Tensor, p: int = P_DEFAULT) -> torch.Tensor:
    """The int32 kernel's function: the uint32-accumulator limb product,
    folded mod p every ``INT32_ACC_K`` of depth as the kernel folds its
    raw accumulators, so it has no depth limit either."""
    k = a.shape[-1]
    out = None
    for s in range(0, max(k, 1), INT32_ACC_K):
        part = mod_matmul_int32(a[..., s : s + INT32_ACC_K], b[..., s : s + INT32_ACC_K, :], p)
        out = part if out is None else mod_add(out, part, p)
    return out


# the plain version of each kernel variant; the f32-limb kernel's is
# gf.mod_matmul_f32 itself (float32 limb dots reduced per chunk)
PLAIN = {"int32": modmatmul_int32_plain, "f32": mod_matmul_f32}


def modmatmul_masked_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    key,
    p: int = P_DEFAULT,
    variant: str = "int32",
) -> torch.Tensor:
    """The fused-mask kernel's function with the mask materialized:
    ``a @ b + v @ field_mask(key, batch + (z, N))  (mod p)``."""
    mm = PLAIN[variant](a, b, p)
    batch = tuple(mm.shape[:-2])
    mask = field_mask(key, batch + (v.shape[-1], b.shape[-1]), p, device=mm.device)
    return mod_add(mm, PLAIN[variant](v, mask, p), p)


def modmatmul_rows_plus_plain(
    a: torch.Tensor,
    h: torch.Tensor,
    rows: torch.Tensor,
    v: torch.Tensor,
    r: torch.Tensor,
    p: int = P_DEFAULT,
    variant: str = "int32",
) -> torch.Tensor:
    """The loaded-rows skinny kernel's function with the selection and
    both products materialized: ``a @ h[..., rows, :] + v @ r  (mod p)``."""
    picked = PLAIN[variant](a, h.index_select(-2, rows), p)
    return mod_add(picked, PLAIN[variant](v, r, p), p)


def gather_blocks(x: torch.Tensor, offsets: torch.Tensor, bc: int, ld: int, n: int) -> torch.Tensor:
    """The K blocks the blocks form reads, materialized: [..., K, n] with
    element (k, j) at ``offsets[k] + (j // bc) * ld + j % bc`` of x's
    batch element in row-major order.  Raises where a block leaves it."""
    flat = x.reshape(tuple(x.shape[:-2]) + (-1,))
    cols = torch.arange(n, dtype=torch.int64, device=x.device)
    idx = offsets.to(torch.int64)[:, None] + (cols // bc) * ld + cols % bc  # [K, n]
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= flat.shape[-1]):
        raise ValueError(f"a block reads outside x's {flat.shape[-1]} elements a batch element")
    return flat[..., idx]


def modmatmul_blocks_plus_plain(
    a: torch.Tensor,
    x: torch.Tensor,
    offsets: torch.Tensor,
    bc: int,
    ld: int,
    v: torch.Tensor,
    r: torch.Tensor,
    p: int = P_DEFAULT,
    variant: str = "int32",
) -> torch.Tensor:
    """The blocks skinny kernel's function with the blocks gathered and
    both products materialized: ``a @ blocks(x) + v @ r  (mod p)``."""
    blocks = gather_blocks(x, offsets, bc, ld, int(r.shape[-1]))
    return mod_add(PLAIN[variant](a, blocks, p), PLAIN[variant](v, r, p), p)
