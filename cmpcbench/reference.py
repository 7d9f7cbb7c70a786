"""The plain reference of the private product, and its control.

``y_exact`` works Y[i] = A[i]^T W mod p out again from the activations
and the weight the benchmark drew, in plain PyTorch on whatever device
holds them.  The contraction is cut into chunks of at most
``exact_terms(p)`` rows, so that every float64 partial sum is an integer
below 2**53 and exact whatever the summation order; the chunks' residues
are summed in int64.  It imports nothing of the program.

``y_float32`` is the control: the same product in float32 (TF32 off),
the nearest precision below the exact one the configuration states.
The comparison has to find it wrong.
"""
from __future__ import annotations

import torch


def exact_terms(p: int) -> int:
    """How many products of residues below ``p`` a float64 sum holds exactly."""
    return (2 ** 53 - 1) // (p - 1) ** 2


def y_exact(a: torch.Tensor, w: torch.Tensor, p: int) -> torch.Tensor:
    """a [batch, k, ma], w [k, mb] residues -> int64 [batch, ma, mb]."""
    step = exact_terms(p)
    out = []
    for ai in a:  # one product at a time bounds the float64 copies
        y = None
        for k0 in range(0, ai.shape[0], step):
            part = ai[k0:k0 + step].T.to(torch.float64) @ w[k0:k0 + step].to(torch.float64)
            part = torch.remainder(part, p).to(torch.int64)
            y = part if y is None else torch.remainder(y + part, p)
        out.append(y)
    return torch.stack(out)


def y_float32(a: torch.Tensor, w: torch.Tensor, p: int) -> torch.Tensor:
    """The control: Y in float32 with TF32 off, as int64 [batch, ma, mb]."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        wf = w.to(torch.float32)
        return torch.stack([
            torch.remainder(ai.T.to(torch.float32) @ wf, p).to(torch.int64) for ai in a
        ])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
