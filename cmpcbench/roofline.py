"""The yardstick of the roofline shares and of ``call_mfu``.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit), and the work of one modular matmul launch counted
from its shape alone, whatever kernel computes it:

* operations: ``2 * batch * m * k * n``, held against the int8 tensor-core
  peak, the highest the card has for integers.  A product of 16-bit
  residues needs more than one int8 operation, so no representation of
  the residues can read above the peak by this count;
* bytes: each input element read once and each output element written
  once, at 2 bytes an element, because every value is a residue below
  p < 2**16.  int32 storage moves twice the bytes counted, so no storage
  format can read above the bandwidth peak either.  The left operand of
  a skinny launch is the [M, K] coefficient matrix (a Vandermonde, the
  mix or the decode matrix), passed without a batch axis and read once;
  every other operand counts once per batch element.  The counters give
  no mask width, so a masked launch counts neither its [M, z] mask
  coefficients nor the z mask rows it generates (fewer bytes and
  operations than it does: the share can only read lower).

A launch's bound is the larger of its operations over the operation
peak and its bytes over the bandwidth peak.
"""
from __future__ import annotations

PEAK_OPS_PER_S = 1.979e15  # dense int8 tensor-core operations per second
PEAK_BYTES_PER_S = 3.35e12  # HBM3
ELEM_BYTES = 2  # a residue below p < 2**16


def left_read_once(kernel: str) -> bool:
    """Whether ``kernel``'s left operand is a 2D matrix read once."""
    return "skinny" in kernel


def launch_ops(batch: int, m: int, k: int, n: int) -> int:
    return 2 * batch * m * k * n


def launch_bytes(kernel: str, batch: int, m: int, k: int, n: int) -> int:
    left = m * k if left_read_once(kernel) else batch * m * k
    return ELEM_BYTES * (left + batch * k * n + batch * m * n)


def launch_bound_s(kernel: str, batch: int, m: int, k: int, n: int) -> float:
    return max(launch_ops(batch, m, k, n) / PEAK_OPS_PER_S,
               launch_bytes(kernel, batch, m, k, n) / PEAK_BYTES_PER_S)


def call_ops(batch: int, k: int, ma: int, mb: int) -> int:
    """Operations of the plain product Y = A^T B of one call."""
    return 2 * batch * k * ma * mb


LIBRARY = "gfmm::"  # the namespace of every kernel of the library


def kernel_share(traced, kernel: str):
    """The percentage of its roofline that compiled ``kernel`` (plain and
    masked forms) reaches over a traced stretch: the sum of its launches'
    bounds, from the program's launch shapes, over the sum of its device
    time.  None where the trace holds none of it."""
    if not traced:
        return None
    device_s = sum(e - s for name, s, e, _ in traced["device"]
                   if LIBRARY in name and f"modmatmul_{kernel}" in name) / 1e9
    bound_s = sum(n * launch_bound_s(name, b, m, k, cols)
                  for name, shapes in traced["launch_shapes"].items()
                  if name in (kernel, kernel + "_masked")
                  for b, m, k, cols, n in shapes)
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
