"""Public entry points of the GF(p) matmul: backend dispatch and batching.

Backends of :func:`mod_matmul` / :func:`mod_matmul_masked`:

* ``"cuda_int32"`` — the Hopper int32 kernels (counterpart of
                     ``"pallas_int32"``): integer limb dots on the
                     tensor cores, or the skinny kernel for small M
                     and K (``kernel.choose_design``); no depth limit.
* ``"cuda"``       — the Hopper f32-limb kernels (counterpart of
                     ``"pallas"``): 8-bit limbs exact in fp16 on the
                     tensor cores, or the skinny kernel with float
                     limbs for small M and K; no depth limit.
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

Tiles: each compiled design has one block shape (``pick_tiles``);
``autotune_tiles`` times the candidates compiled for a shape on the
device and pins the winner, which ``pick_tiles`` then returns first.
``mod_matmul_crt`` widens the range past one 16-bit prime: one
``mod_matmul`` per prime, combined on the host.

``mod_matmul_rows_plus`` is the Phase-2 degree reduction's shape,
``a @ h[rows] + v @ r``: one launch of the skinny kernel's loaded-rows
form where ``skinny_fuses`` says so, the selection and two products
otherwise.  ``mod_matmul_blocks_plus`` is the Phase-1 share's,
``a @ blocks(x) + v @ r`` with the blocks read from x in place by
offset, width and row stride: one launch of the blocks form, only where
``skinny_fuses`` says so.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ...core.gf import (
    CHUNK_K,
    INT32_ACC_K,
    P_DEFAULT,
    crt_combine,
    field_mask,
    mod_add,
    mod_matmul_f32,
    mod_matmul_int32,
)
from .kernel import (
    choose_design,
    design_tiles,
    modmatmul_blocks_plus_cuda,
    modmatmul_cuda,
    modmatmul_masked_cuda,
    modmatmul_rows_plus_cuda,
)

_CUDA_VARIANTS = {"cuda": "f32", "cuda_int32": "int32"}
_PLAIN = {"f32limb": mod_matmul_f32, "int32": mod_matmul_int32}


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# ----------------------------------------------------------------------
# tile selection
# ----------------------------------------------------------------------
def _compiled_tiles(backend: str, m: int, k: int, n: int, z: int = 0) -> tuple:
    """The block shape of the compiled design a product goes to."""
    variant = _CUDA_VARIANTS[backend]
    return design_tiles(choose_design(variant, z > 0, 1, m, k, n, z), m, k)


def _pick_tiles_f32(m: int, k: int, n: int, z: int = 0) -> tuple:
    return _compiled_tiles("cuda", m, k, n, z)


def _pick_tiles_int32(m: int, k: int, n: int, z: int = 0) -> tuple:
    return _compiled_tiles("cuda_int32", m, k, n, z)


_TILE_CHOOSERS = {"cuda": _pick_tiles_f32, "cuda_int32": _pick_tiles_int32}

# (backend, m, k, n, z) -> tiles pinned by autotune_tiles
_AUTOTUNE_CACHE: dict = {}


def register_tile_chooser(backend: str, chooser) -> None:
    """Install a tile-selection policy ``chooser(m, k, n, z) -> (bm, bn,
    bk)`` for one kernel backend (z: fused mask rows, 0 unmasked).  The
    wrapper accepts only the block shape of the compiled design a
    product goes to, so a chooser is the hook for kernels that compile
    more than one block shape per design."""
    _TILE_CHOOSERS[backend] = chooser


def pick_tiles(m: int, k: int, n: int, backend: str = "cuda_int32", z: int = 0) -> tuple:
    """(bm, bn, bk) the kernel backend runs one [M,K]@[K,N] product with
    (plus z fused mask rows).  Exact-shape autotune pins
    (``autotune_tiles``) take precedence over the backend's chooser."""
    pinned = _AUTOTUNE_CACHE.get((backend, m, k, n, z))
    if pinned is not None:
        return pinned
    return _TILE_CHOOSERS.get(backend, _pick_tiles_int32)(m, k, n, z)


def autotune_tiles(
    m: int,
    k: int,
    n: int,
    backend: str = "cuda_int32",
    p: int = P_DEFAULT,
    batch: int = 1,
    candidates=None,
    repeats: int = 3,
    device=None,
) -> tuple:
    """Measure candidate tilings on the device and pin the winner.

    Runs ``mod_matmul`` with each candidate ``(bm, bn, bk)`` on random
    operands of the given shape (one warm-up excluded, best of
    ``repeats``; CUDA events on the card, the host clock on the CPU,
    where the plain version runs), stores the fastest in the exact-shape
    cache that ``pick_tiles`` consults first, and returns it.  Only the
    block shape of the design ``choose_design`` sends the shape to is
    compiled, and it is the default candidate; any other candidate is
    reported (a warning) as not compiled and not run.  Raises when no
    candidate runs.  ``device`` defaults to the GPU.
    """
    from ...core.protocol import resolve_device

    if backend not in _CUDA_VARIANTS:
        raise ValueError(f"autotune_tiles supports the kernel backends, got {backend}")
    device = resolve_device(device)
    compiled = _compiled_tiles(backend, m, k, n)
    if candidates is None:
        candidates = [compiled]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    shape_a = (batch, m, k) if batch > 1 else (m, k)
    shape_b = (batch, k, n) if batch > 1 else (k, n)
    a = torch.randint(0, p, shape_a, generator=gen, dtype=torch.int32, device=device)
    b = torch.randint(0, p, shape_b, generator=gen, dtype=torch.int32, device=device)
    best, best_t, invalid = None, float("inf"), []
    for tiles in candidates:
        tiles = tuple(int(x) for x in tiles)
        if tiles != compiled:
            invalid.append(tiles)
            warnings.warn(
                f"autotune_tiles: {backend} tiles {tiles} are not compiled for "
                f"[{m},{k}]@[{k},{n}] (the kernel has {compiled}); not run",
                stacklevel=2,
            )
            continue
        run = lambda: mod_matmul(a, b, p=p, backend=backend)  # noqa: E731
        run()  # warm-up: the first call builds and loads the kernels
        t = min(_timed(run, device) for _ in range(max(1, repeats)))
        if t < best_t:
            best, best_t = tiles, t
    if best is None:
        raise RuntimeError(
            f"no autotune candidate ran for {backend} at [{m},{k}]@[{k},{n}]: "
            f"{invalid} are not compiled (the kernel has {compiled})"
        )
    _AUTOTUNE_CACHE[(backend, m, k, n, 0)] = best
    return best


def _timed(run, device: torch.device) -> float:
    """Seconds of one call of ``run``: CUDA events on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


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


def _check_tiles(backend, m, k, n, z=0) -> None:
    tiles = tuple(pick_tiles(m, k, n, backend=backend, z=z))
    compiled = _compiled_tiles(backend, m, k, n, z)
    if tiles != compiled:
        raise ValueError(
            f"{backend}: tiles {tiles} are not compiled; the kernel has {compiled}"
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
    _check_tiles(backend, m, k, n, z)
    variant = _CUDA_VARIANTS[backend]
    v = v.contiguous()
    if not batch:
        return modmatmul_masked_cuda(a.contiguous(), b.contiguous(), v, key, p, variant)
    out = modmatmul_masked_cuda(
        _flatten_batch(a, batch), _flatten_batch(b, batch), v, key, p, variant
    )
    return out.reshape(batch + (m, n))


def skinny_fuses(backend: str, device, m: int, k: int, z: int) -> bool:
    """Whether a loaded-terms form of the skinny kernel runs as one
    launch (``mod_matmul_rows_plus``, ``mod_matmul_blocks_plus``): on a
    CUDA device with a kernel backend (``"auto"`` is one there), at a
    shape the skinny designs take (M <= 32, K <= 32, K + z <= 128)."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    if backend == "auto":
        backend = _resolve_auto(k, device)
    variant = _CUDA_VARIANTS.get(backend)
    return variant is not None and choose_design(variant, True, 1, m, k, 1, z) == "skinny"


def _rows_contiguous(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where its rows are contiguous and N apart (any batch
    stride), else a contiguous copy."""
    n = x.shape[-1]
    if (n <= 1 or x.stride(-1) == 1) and (x.shape[-2] <= 1 or x.stride(-2) == n):
        return x
    return x.contiguous()


def mod_matmul_rows_plus(
    a: torch.Tensor,
    h: torch.Tensor,
    rows: torch.Tensor,
    v: torch.Tensor,
    r: torch.Tensor,
    p: int = P_DEFAULT,
    backend: str = "auto",
) -> torch.Tensor:
    """``a @ h[..., rows, :] + v @ r  (mod p)``, the degree reduction's
    ``mix.T @ H[ids2] + Vnoise @ R``.

    a [M, K] or [B, M, K]; h [n_rows, N] or [B, n_rows, N]; rows [K]
    int64 on h's device, each in [0, n_rows); v [M, z]; r [z, N] or
    [B, z, N].  Returns int32 [B, M, N] ([M, N] when no operand has a
    batch axis).

    Where ``skinny_fuses`` holds, one launch of the skinny kernel's
    loaded-rows form reads h's selected rows in place and sums both
    products in its accumulators.  Elsewhere (a plain backend, the CPU,
    or M > 32, K > 32, K + z > 128) it computes
    ``mod_add(mod_matmul(a, h.index_select(-2, rows)), mod_matmul(v, r))``.
    Both give the same residues.
    """
    m, k = a.shape[-2:]
    z = v.shape[-1]
    if not skinny_fuses(backend, h.device, m, k, z):
        picked = h.index_select(-2, rows)
        return mod_add(mod_matmul(a, picked, p=p, backend=backend),
                       mod_matmul(v, r, p=p, backend=backend), p)
    if backend == "auto":
        backend = _resolve_auto(k, h.device)
    return modmatmul_rows_plus_cuda(
        a.contiguous(), _rows_contiguous(h), rows.contiguous(), v.contiguous(), _rows_contiguous(r),
        p, _CUDA_VARIANTS[backend],
    )


def mod_matmul_blocks_plus(
    a: torch.Tensor,
    x: torch.Tensor,
    offsets: torch.Tensor,
    bc: int,
    ld: int,
    v: torch.Tensor,
    r: torch.Tensor,
    p: int = P_DEFAULT,
    backend: str = "auto",
) -> torch.Tensor:
    """``a @ blocks(x) + v @ r  (mod p)``, the Phase-1 share's
    ``V[:, pos] @ blocks + V[:, spos] @ R``.

    Block k, the term of a's column k, is the [N / bc, bc] block of x
    whose column n is the element ``offsets[k] + (n // bc) * ld + n %
    bc`` of x's batch element in row-major order (N = r's width).  a
    [M, K] or [B, M, K]; x [R, C] or [B, R, C] (batch stride free, 0 for
    a broadcast view); offsets [K] int64 on x's device; v [M, z]; r [z,
    N] or [B, z, N].  Returns int32 [B, M, N] ([M, N] when no operand
    has a batch axis).

    One launch of the skinny kernel's blocks form reads the blocks where
    they lie and sums both products in its accumulators.  It runs only
    where ``skinny_fuses`` holds and raises ``ValueError`` elsewhere (a
    plain backend, the CPU, or M > 32, K > 32, K + z > 128), where
    ``protocol._share`` keeps its coefficient-stack path;
    ``kernel.modmatmul_blocks_plus_cuda`` on CPU tensors is its plain
    version.
    """
    m, k = a.shape[-2:]
    z = v.shape[-1]
    if not skinny_fuses(backend, x.device, m, k, z):
        raise ValueError(f"the blocks form runs on the card at the skinny designs' shapes, not "
                         f"backend {backend!r} on {x.device} at M {m}, K {k}, z {z}")
    if backend == "auto":
        backend = _resolve_auto(k, x.device)
    return modmatmul_blocks_plus_cuda(
        a.contiguous(), _rows_contiguous(x), offsets.contiguous(), bc, ld, v.contiguous(),
        _rows_contiguous(r), p, _CUDA_VARIANTS[backend],
    )


def mod_matmul_crt(
    a,
    b,
    primes: tuple = (65521, 65519),
    backend: str = "auto",
    device=None,
) -> np.ndarray:
    """Wide-range exact matmul via CRT over several 16-bit primes.

    Computes a @ b mod prod(primes): one residue ``mod_matmul`` per
    prime, combined on the host with Garner's algorithm.  Operands may
    be any integers, numpy arrays or tensors; each is reduced per prime
    with ``torch.remainder`` (numpy's sign rule), on the device of the
    operand that is a tensor, else on ``device`` (default: the GPU); two
    tensors on different devices raise ``ValueError``.  Returns int64
    numpy in [0, prod(primes)), exact whenever the true product fits the
    combined modulus.
    """
    from ...core.protocol import resolve_device

    primes = tuple(int(q) for q in primes)
    if len(set(primes)) != len(primes):
        raise ValueError(f"CRT primes must be distinct, got {primes}")
    on = [x.device for x in (a, b) if isinstance(x, torch.Tensor)]
    if len(set(on)) > 1:
        raise ValueError(f"mod_matmul_crt operands on two devices: a on {on[0]}, b on {on[1]}")
    if device is None and on:
        device = on[0]
    device = resolve_device(device)
    a = torch.as_tensor(a, device=device).to(torch.int64)
    b = torch.as_tensor(b, device=device).to(torch.int64)
    residues = [
        mod_matmul(
            torch.remainder(a, q).to(torch.int32),
            torch.remainder(b, q).to(torch.int32),
            p=q, backend=backend,
        ).cpu().numpy().astype(np.int64)
        for q in primes
    ]
    return crt_combine(residues, primes)


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
