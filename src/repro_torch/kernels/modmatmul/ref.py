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
