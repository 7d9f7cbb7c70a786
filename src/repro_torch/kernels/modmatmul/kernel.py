"""Hopper kernels for exact GF(p) matmul, p < 2**16: build, binding, wrappers.

The CUDA source is ``repro_torch/csrc/modmatmul.cu``: one tiled kernel
templated on the arithmetic variant (``"int32"``: integer limb dots and
uint32 Barrett; ``"f32"``: float limb dots with the lazy 128-deep
reduction) and on a fused-mask epilogue.  It replaces the three Pallas
tile bodies of ``repro.kernels.modmatmul.kernel`` — the source says how.

Build: at first use ``nvcc`` compiles the source into a shared library
with a plain C interface under ``build/repro_torch_kernels/`` (or
``$REPRO_TORCH_BUILD_DIR``), named by a hash of the source and flags so
an edit rebuilds; ``ctypes`` loads it.  Nothing is built or imported
when this module is imported.

Wrappers: :func:`modmatmul_cuda` and :func:`modmatmul_masked_cuda`.  On
CUDA tensors they check device, dtype, contiguity and shape, allocate
the output, launch on the current stream, raise if the launch failed,
and add one to the kernel's launch count.  On CPU tensors they run the
kernel's plain version from ``ref.py`` (and count nothing).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Tuple

import torch

from ...core.gf import P_DEFAULT
from . import ref

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "modmatmul.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
VARIANTS = {"int32": 0, "f32": 1}

# The launch geometry compiled into the source (BM, BN, BK).
KERNEL_TILES = (64, 64, 32)
_MAX_GRID_YZ = 65535

# Launch counts: name -> launches, and name -> Counter of (B, M, K, N).
# Each wrapper adds one where it launches its kernel and nowhere else.
KERNEL_NAMES = ("modmatmul_int32", "modmatmul_int32_masked", "modmatmul_f32", "modmatmul_f32_masked")
LAUNCHES = {name: 0 for name in KERNEL_NAMES}
LAUNCH_SHAPES = {name: collections.Counter() for name in KERNEL_NAMES}

_LIB = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0
        LAUNCH_SHAPES[name].clear()


def _kernel_name(variant: str, masked: bool) -> str:
    return f"modmatmul_{variant}" + ("_masked" if masked else "")


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the GF(p) matmul kernels cannot be built")
    return path


def load_library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    so = out_dir / f"libmodmatmul_{digest}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent builders
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        t0 = time.perf_counter()
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{res.stderr}")
        os.replace(tmp, so)
        BUILD_INFO.update(seconds=time.perf_counter() - t0, log=res.stderr)
    lib = ctypes.CDLL(str(so))
    fn = lib.modmatmul_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int,  # variant, masked
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # a, b, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch, M, N, K
        ctypes.c_longlong, ctypes.c_longlong,  # batch strides of a, b
        ctypes.c_uint,  # p
        ctypes.c_void_p, ctypes.c_int,  # v, z
        ctypes.c_uint, ctypes.c_uint,  # key words
        ctypes.c_void_p,  # stream
    ]
    BUILD_INFO.update(library=str(so))
    _LIB = lib
    return lib


def _geometry(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int, int, int]:
    """(batch, M, K, N) of [B?, M, K] @ [B?, K, N]; raises on bad shapes."""
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError(f"operands must be 2D or 3D, got {tuple(a.shape)} {tuple(b.shape)}")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"inner dims disagree: {tuple(a.shape)} @ {tuple(b.shape)}")
    batch = 1
    if a.dim() == 3 and b.dim() == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"batch dims disagree: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dim() == 3:
        batch = a.shape[0]
    elif b.dim() == 3:
        batch = b.shape[0]
    return int(batch), int(m), int(k), int(n)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: operands must share one CUDA device")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: operands must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _check_mask(v: torch.Tensor, batch: int, m: int, n: int) -> int:
    """z of the [M, z] mask coefficients; raises where the [batch, z, N]
    counter space would wrap."""
    if v.dim() != 2 or v.shape[0] != m:
        raise ValueError(f"v must be [M={m}, z], got {tuple(v.shape)}")
    z = int(v.shape[1])
    if z >= 1 << 16:
        raise ValueError("fused mask needs z < 2**16")
    if batch * z * n >= 1 << 32:
        raise ValueError(
            f"fused mask counter space exhausted: batch*z*ncols = "
            f"{batch * z * n} >= 2**32 — counters would wrap and "
            f"reuse mask values"
        )
    return z


def _launch(variant, a, b, p, v=None, key=(0, 0)) -> torch.Tensor:
    if variant not in VARIANTS:
        raise ValueError(f"unknown kernel variant {variant}")
    if not 2 < p < 1 << 16:
        raise ValueError("kernel requires 2 < p < 2**16")
    masked = v is not None
    name = _kernel_name(variant, masked)
    batch, m, k, n = _geometry(a, b)
    _check_cuda(name, a, b, *((v,) if masked else ()))
    if max(m, n, k) >= 1 << 31:
        raise ValueError(f"{name}: dims must be below 2**31")
    if batch > _MAX_GRID_YZ or -(-m // KERNEL_TILES[0]) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: batch {batch} / M {m} exceed the launch grid")
    z = _check_mask(v, batch, m, n) if masked else 0
    out_shape = (batch, m, n) if a.dim() == 3 or b.dim() == 3 else (m, n)
    out = torch.empty(out_shape, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.modmatmul_launch(
            VARIANTS[variant], int(masked),
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            batch, m, n, k,
            m * k if a.dim() == 3 else 0, k * n if b.dim() == 3 else 0,
            p,
            v.data_ptr() if masked else None, z,
            int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[name][(batch, m, k, n)] += 1
    return out


def modmatmul_cuda(
    a: torch.Tensor, b: torch.Tensor, p: int = P_DEFAULT, variant: str = "int32"
) -> torch.Tensor:
    """a [B, M, K] or [M, K]  @  b [B, K, N] or [K, N]  mod p  (int32).

    Counterpart of ``modmatmul_pallas``: one launch for the whole batch;
    a 2D operand is read with batch stride 0 by every batch element.
    No padding: M, N and K may take any size.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        _geometry(a, b)
        return ref.PLAIN[variant](a, b, p)
    return _launch(variant, a, b, p)


def modmatmul_masked_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    key,
    p: int = P_DEFAULT,
    variant: str = "int32",
) -> torch.Tensor:
    """Fused blinding: ``a @ b + v @ R(key)  (mod p)`` in one launch.

    Counterpart of ``modmatmul_masked_pallas``.  ``v`` is a 2D [M, z]
    constant; R is ``gf.field_mask(key, batch + (z, N))``, generated in
    the epilogue and never stored.  Without padding the logical width
    is N itself, which anchors the per-column counters.  ``key`` is a
    (k0, k1) word pair.
    """
    if a.device.type == "cpu" and b.device.type == "cpu" and v.device.type == "cpu":
        batch, m, _, n = _geometry(a, b)
        _check_mask(v, batch, m, n)
        return ref.modmatmul_masked_plain(a, b, v, key, p, variant)
    return _launch(variant, a, b, p, v=v, key=key)

