"""Hopper kernels for exact GF(p) matmul, p < 2**16: build, binding, wrappers.

The CUDA sources are under ``repro_torch/csrc/``; ``modmatmul.cu`` is the
one translation unit and includes the others.  Four compiled designs,
each with a fused-mask form, replace the three Pallas tile bodies of
``repro.kernels.modmatmul.kernel`` — each source says how:

* ``int32_mma``  (``int32_mma.cuh``): the int32 variant on the integer
  tensor cores (u8 limbs, ``wgmma`` m64n64k32, s32 accumulators), for
  every int32 product that is not skinny;
* ``f32_wgmma``  (``f32_wgmma.cuh``): the f32-limb variant on the fp16
  tensor cores (8-bit limbs exact in fp16, ``wgmma`` m64n128k16 into two
  f32 accumulator sets folded every 128 K; A's planes from a pre-pass
  into device scratch, B's split by warp-specialized producers), for
  every f32 product that is not skinny;
* ``int32_skinny`` and ``f32_skinny`` (``skinny.cuh``): either variant
  for M <= 32, K <= 32 and K + z <= 128, one pass over B and over the
  output, the mask words made as extra rows of B; one template whose
  arithmetic (``dp2a`` on packed coefficients, or float limbs) is its
  policy parameter.  Its loaded-rows form computes ``a @ h[rows] + v @
  r`` in one pass: B's K rows picked from a taller ``h`` by an index
  list, and z more rows loaded from ``r`` (the Phase-2 degree
  reduction); its blocks form, ``a @ blocks(x) + v @ r``, reads B's K
  terms as blocks of a larger ``x`` in place, by element offset, block
  width and row stride (the Phase-1 share).

:func:`choose_design` is the shape rule.

Build: at first use ``nvcc`` compiles ``modmatmul.cu`` into a shared
library with a plain C interface under ``build/repro_torch_kernels/`` (or
``$REPRO_TORCH_BUILD_DIR``), named by a hash of every source and the
flags so an edit rebuilds; ``ctypes`` loads it.  Nothing is built or
imported when this module is imported.

Wrappers: :func:`modmatmul_cuda`, :func:`modmatmul_masked_cuda`,
:func:`modmatmul_rows_plus_cuda` and :func:`modmatmul_blocks_plus_cuda`.  On
CUDA tensors they check device, dtype, contiguity and shape, allocate
the output (and the scratch a design asks for), launch on the current
stream, raise if the launch failed, and add one to the launch counts.  On CPU tensors they run the kernel's
plain version from ``ref.py`` (and count nothing).
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

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCE = CSRC / "modmatmul.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Constants compiled into the sources, mirrored here for the shape rule
# (load_library checks the mirror against the built library).
MMA_TILES = (128, 128, 32)  # int32_mma.cuh: BM, BN, BK
MMA_FOLD_K = 16512  # int32_mma.cuh: FOLD_K, the accumulator fold period
SKINNY_MAX_M = 32  # skinny.cuh: the skinny designs' shape cap
SKINNY_MAX_K = 32
SKINNY_MAX_TERMS = 128  # K + z: the skinny accumulators' wrap / 2**24 bound
SKINNY_THREADS = 256
WGMMA_TILES = (128, 128, 32)  # f32_wgmma.cuh: BM, BN, BK
WGMMA_FOLD_K = 128  # f32_wgmma.cuh: FOLD_K, the f32 sets' fold period
# compiled design -> its id in modmatmul_launch
DESIGNS = {"int32_mma": 1, "int32_skinny": 2, "f32_wgmma": 3, "f32_skinny": 4}
_MAX_GRID_X = (1 << 31) - 1
_MAX_GRID_YZ = 65535

# Launch counts.  LAUNCHES is keyed by the TPU kernel each launch stands
# for; LAUNCHES_BY_KERNEL by the compiled kernel that ran.  Each has a
# Counter of (B, M, K, N) per name beside it.  Each wrapper adds one
# where it launches a kernel and nowhere else.  A loaded-rows or blocks
# launch counts as its design's plain form with K + z rows of B.
KERNEL_NAMES = ("modmatmul_int32", "modmatmul_int32_masked", "modmatmul_f32", "modmatmul_f32_masked")
COMPILED_NAMES = (
    "int32_mma", "int32_mma_masked", "int32_skinny", "int32_skinny_masked",
    "f32_wgmma", "f32_wgmma_masked", "f32_skinny", "f32_skinny_masked",
)
LAUNCHES = {name: 0 for name in KERNEL_NAMES}
LAUNCH_SHAPES = {name: collections.Counter() for name in KERNEL_NAMES}
LAUNCHES_BY_KERNEL = {name: 0 for name in COMPILED_NAMES}
LAUNCH_SHAPES_BY_KERNEL = {name: collections.Counter() for name in COMPILED_NAMES}

_LIB = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for counts, shapes in ((LAUNCHES, LAUNCH_SHAPES), (LAUNCHES_BY_KERNEL, LAUNCH_SHAPES_BY_KERNEL)):
        for name in counts:
            counts[name] = 0
            shapes[name].clear()


def _kernel_name(variant: str, masked: bool) -> str:
    return f"modmatmul_{variant}" + ("_masked" if masked else "")


def choose_design(variant: str, masked: bool, batch: int, m: int, k: int, n: int, z: int = 0) -> str:
    """The compiled kernel one product runs on: ``"skinny"`` for products
    of either variant with M <= 32, K <= 32 and K + z <= 128 (z mask rows
    count as rows of B), otherwise ``"mma"`` for the int32 variant and
    ``"wgmma"`` for the f32 variant.  ``batch`` and ``n`` only set the
    grid, which every design tiles without limit on N and up to 65535 on
    batch."""
    if variant not in ("int32", "f32"):
        raise ValueError(f"unknown kernel variant {variant}")
    terms = k + (z if masked else 0)
    if m <= SKINNY_MAX_M and k <= SKINNY_MAX_K and terms <= SKINNY_MAX_TERMS:
        return "skinny"
    return "mma" if variant == "int32" else "wgmma"


def skinny_cols(m: int) -> int:
    """Columns one thread of the skinny kernel owns (SkinnyCols of M
    rounded up to a multiple of 4)."""
    return 4 if m <= 16 else 2


def design_tiles(design: str, m: int, k: int) -> Tuple[int, int, int]:
    """(bm, bn, bk) one block of ``design`` covers.  A skinny block covers
    all M rows and the whole contraction across its columns."""
    if design == "mma":
        return MMA_TILES
    if design == "wgmma":
        return WGMMA_TILES
    if design == "skinny":
        return (m, SKINNY_THREADS * skinny_cols(m), k)
    raise ValueError(f"unknown design {design}")


def _grid_ok(design: str, batch: int, m: int, n: int) -> bool:
    bm, bn, _ = design_tiles(design, m, 1)
    col_blocks = -(-n // bn)
    if design == "wgmma":  # grid (N tiles, M tiles, batch); A's split strides over M
        return col_blocks <= _MAX_GRID_X and -(-m // bm) <= _MAX_GRID_YZ and batch <= _MAX_GRID_YZ
    if design == "mma":
        col_blocks *= -(-m // bm)  # M tiles and N tiles share grid.x
    return col_blocks <= _MAX_GRID_X and batch <= _MAX_GRID_YZ


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


def compile_library(source: Path, so: Path) -> str:
    """nvcc ``source`` into the shared library ``so``; returns the
    compiler's report (``-Xptxas -v``: registers, spills per kernel)."""
    so.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)], capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name}:\n{res.stderr}")
    os.replace(tmp, so)
    return res.stderr


def bind(so: Path):
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(so))
    fn = lib.modmatmul_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int,  # design, masked
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # a, b, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch, M, N, K
        ctypes.c_longlong, ctypes.c_longlong,  # batch strides of a, b
        ctypes.c_uint,  # p
        ctypes.c_void_p, ctypes.c_int,  # v, z
        ctypes.c_uint, ctypes.c_uint,  # key words
        ctypes.c_void_p,  # scratch
        ctypes.c_void_p,  # stream
    ]
    fn = lib.modmatmul_rows_plus_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int,  # design
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # a, h, rows
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # v, r, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch, M, N, K, z
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # batch strides of a, h, r
        ctypes.c_uint,  # p
        ctypes.c_void_p,  # stream
    ]
    fn = lib.modmatmul_blocks_plus_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int,  # design
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # a, x, offsets
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # v, r, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch, M, N, K, z
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # batch strides of a, x, r
        ctypes.c_longlong, ctypes.c_longlong,  # bc, ld
        ctypes.c_uint,  # p
        ctypes.c_void_p,  # stream
    ]
    lib.modmatmul_scratch_bytes.restype = ctypes.c_longlong
    lib.modmatmul_scratch_bytes.argtypes = [ctypes.c_int] * 4
    return lib


def load_library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    so = build_dir() / f"libmodmatmul_{h.hexdigest()[:16]}.so"
    if not so.exists():
        t0 = time.perf_counter()
        log = compile_library(SOURCE, so)
        BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log)
    lib = bind(so)
    consts = (ctypes.c_int * 12)()
    lib.modmatmul_constants(consts)
    mirror = (*MMA_TILES, MMA_FOLD_K, SKINNY_MAX_M, SKINNY_MAX_K, SKINNY_MAX_TERMS,
              SKINNY_THREADS, *WGMMA_TILES, WGMMA_FOLD_K)
    if tuple(consts) != mirror:
        raise RuntimeError(f"{so.name}: compiled constants {tuple(consts)} != kernel.py's {mirror}")
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


def _check_device(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: operands must share one CUDA device")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    _check_device(name, *tensors)
    for t in tensors:
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


def launch_into(lib, design: str, a, b, out, p: int, v=None, key=(0, 0)) -> int:
    """One launch of ``lib``'s compiled ``design`` (a key of ``DESIGNS``,
    e.g. ``"f32_wgmma"``) writing ``out``, on the current stream, with no
    checks and no counting; returns the CUDA error."""
    batch, m, k, n = _geometry(a, b)
    nbytes = lib.modmatmul_scratch_bytes(DESIGNS[design], batch if a.dim() == 3 else 1, m, k)
    # freed on return: the caching allocator hands it out again only to
    # work queued after this launch on the same stream
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=a.device) if nbytes else None
    with torch.cuda.device(a.device):
        return lib.modmatmul_launch(
            DESIGNS[design], int(v is not None),
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            batch, m, n, k,
            m * k if a.dim() == 3 else 0, k * n if b.dim() == 3 else 0,
            p,
            None if v is None else v.data_ptr(), 0 if v is None else int(v.shape[1]),
            int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream,
        )


def _launch(variant, a, b, p, v=None, key=(0, 0)) -> torch.Tensor:
    if not 2 < p < 1 << 16:
        raise ValueError("kernel requires 2 < p < 2**16")
    masked = v is not None
    name = _kernel_name(variant, masked)
    batch, m, k, n = _geometry(a, b)
    _check_cuda(name, a, b, *((v,) if masked else ()))
    if max(m, n, k) >= 1 << 31:
        raise ValueError(f"{name}: dims must be below 2**31")
    z = _check_mask(v, batch, m, n) if masked else 0
    design = choose_design(variant, masked, batch, m, k, n, z)
    base = f"{variant}_{design}"
    compiled = base + ("_masked" if masked else "")
    if not _grid_ok(design, batch, m, n):
        raise ValueError(f"{compiled}: batch {batch} / M {m} / N {n} exceed the launch grid")
    out_shape = (batch, m, n) if a.dim() == 3 or b.dim() == 3 else (m, n)
    out = torch.empty(out_shape, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    err = launch_into(load_library(), base, a, b, out, p, v, key)
    if err != 0:
        raise RuntimeError(f"{compiled}: kernel launch failed with CUDA error {err}")
    _count(name, compiled, (batch, m, k, n))
    return out


def _count(name: str, compiled: str, shape: tuple) -> None:
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[name][shape] += 1
    LAUNCHES_BY_KERNEL[compiled] += 1
    LAUNCH_SHAPES_BY_KERNEL[compiled][shape] += 1


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


def _rows_plus_geometry(a, h, rows, v, r) -> Tuple[int, int, int, int, int]:
    """(batch, M, K, z, N) of ``a @ h[rows] + v @ r``; raises on bad shapes.

    a [M, K] or [B, M, K]; h [n_rows, N] or [B, n_rows, N]; rows [K];
    v [M, z]; r [z, N] or [B, z, N].  The 3D operands share one B."""
    if a.dim() not in (2, 3) or h.dim() not in (2, 3) or r.dim() not in (2, 3):
        raise ValueError(f"a, h and r must be 2D or 3D, got {tuple(a.shape)} "
                         f"{tuple(h.shape)} {tuple(r.shape)}")
    m, k = (int(x) for x in a.shape[-2:])
    n = int(h.shape[-1])
    if rows.dim() != 1 or rows.shape[0] != k:
        raise ValueError(f"rows must be [K={k}], got {tuple(rows.shape)}")
    if v.dim() != 2 or v.shape[0] != m:
        raise ValueError(f"v must be [M={m}, z], got {tuple(v.shape)}")
    z = int(v.shape[1])
    if tuple(r.shape[-2:]) != (z, n):
        raise ValueError(f"r must be [..., z={z}, N={n}], got {tuple(r.shape)}")
    batches = {int(x.shape[0]) for x in (a, h, r) if x.dim() == 3}
    if len(batches) > 1:
        raise ValueError(f"batch dims disagree: {tuple(a.shape)} {tuple(h.shape)} {tuple(r.shape)}")
    return (batches.pop() if batches else 1), m, k, z, n


def _batch_stride(name: str, x: torch.Tensor) -> int:
    """The batch stride of a 2D or 3D operand whose rows are contiguous
    and N apart (0 for a 2D one, read by every batch element)."""
    if (x.shape[-1] > 1 and x.stride(-1) != 1) or (x.shape[-2] > 1 and x.stride(-2) != x.shape[-1]):
        raise ValueError(f"{name}: rows must be contiguous and N apart, strides {x.stride()}")
    return int(x.stride(0)) if x.dim() == 3 and x.shape[0] > 1 else 0


def launch_rows_plus_into(lib, design: str, a, h, rows, v, r, out, p: int) -> int:
    """One launch of ``lib``'s loaded-rows form of the skinny ``design``
    (``"int32_skinny"`` or ``"f32_skinny"``) writing ``out``, on the
    current stream, with no checks and no counting; returns the CUDA
    error."""
    batch, m, k, z, n = _rows_plus_geometry(a, h, rows, v, r)
    with torch.cuda.device(a.device):
        return lib.modmatmul_rows_plus_launch(
            DESIGNS[design],
            a.data_ptr(), h.data_ptr(), rows.data_ptr(), v.data_ptr(), r.data_ptr(), out.data_ptr(),
            batch, m, n, k, z,
            m * k if a.dim() == 3 else 0, _batch_stride("h", h), _batch_stride("r", r),
            p,
            torch.cuda.current_stream(a.device).cuda_stream,
        )


def modmatmul_rows_plus_cuda(
    a: torch.Tensor,
    h: torch.Tensor,
    rows: torch.Tensor,
    v: torch.Tensor,
    r: torch.Tensor,
    p: int = P_DEFAULT,
    variant: str = "int32",
) -> torch.Tensor:
    """``a @ h[..., rows, :] + v @ r  (mod p)`` in one launch of the skinny
    design's loaded-rows form.

    a [M, K] or [B, M, K]; h [n_rows, N] or [B, n_rows, N], each row
    contiguous, batch elements any stride apart (h is never copied);
    rows [K] int64 on h's device; v [M, z]; r [z, N] or [B, z, N], rows
    contiguous.  Takes only what the skinny designs take: M <= 32, K <=
    32, K + z <= 128.  The launch reads ``rows`` on the card unchecked:
    every index must lie in [0, n_rows).  Counted once, under the skinny
    design, as a product of shape (B, M, K + z, N).  On CPU tensors it
    runs the plain version (and counts nothing).
    """
    tensors = (a, h, rows, v, r)
    if all(t.device.type == "cpu" for t in tensors):
        _rows_plus_geometry(*tensors)
        return ref.modmatmul_rows_plus_plain(a, h, rows, v, r, p, variant)
    return _launch_rows_plus(variant, a, h, rows, v, r, p)


def _launch_rows_plus(variant, a, h, rows, v, r, p) -> torch.Tensor:
    return _launch_loaded(
        variant, "loaded rows", ("h", h), ("rows", rows), a, v, r, p,
        _rows_plus_geometry(a, h, rows, v, r),
        lambda lib, compiled, out: launch_rows_plus_into(lib, compiled, a, h, rows, v, r, out, p))


def _launch_loaded(variant, form, source, index, a, v, r, p, geometry, launch) -> torch.Tensor:
    """The checks, output and count that the loaded-terms forms share.

    ``source`` and ``index`` are (name, tensor) of the operand the K terms
    are read from and of its int64 row indices or offsets; ``geometry``
    is the form's (batch, M, K, z, N); ``launch(lib, compiled, out)``
    launches the form into ``out`` and returns the CUDA error."""
    if not 2 < p < 1 << 16:
        raise ValueError("kernel requires 2 < p < 2**16")
    name = _kernel_name(variant, False)
    compiled = f"{variant}_skinny"
    (xname, x), (iname, idx) = source, index
    batch, m, k, z, n = geometry
    _check_device(compiled, a, x, idx, v, r)
    for t in (a, x, idx, v, r):
        if t.dtype != (torch.int64 if t is idx else torch.int32):
            raise ValueError(f"{compiled}: {iname} must be int64 and the other operands int32")
    for t in (a, idx, v):
        if not t.is_contiguous():
            raise ValueError(f"{compiled}: a, {iname} and v must be contiguous")
    _batch_stride(xname, x)
    _batch_stride("r", r)
    if max(m, n, k) >= 1 << 31:
        raise ValueError(f"{compiled}: dims must be below 2**31")
    if choose_design(variant, True, batch, m, k, n, z) != "skinny":
        raise ValueError(f"{compiled}: M {m}, K {k}, z {z} are outside the skinny designs")
    if not _grid_ok("skinny", batch, m, n):
        raise ValueError(f"{compiled}: batch {batch} / M {m} / N {n} exceed the launch grid")
    batched = any(t.dim() == 3 for t in (a, x, r))
    out = torch.empty((batch, m, n) if batched else (m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    err = launch(load_library(), compiled, out)
    if err != 0:
        raise RuntimeError(f"{compiled} ({form}): kernel launch failed with CUDA error {err}")
    _count(name, compiled, (batch, m, k + z, n))
    return out


def _blocks_plus_geometry(a, x, offsets, bc, ld, v, r) -> Tuple[int, int, int, int, int]:
    """(batch, M, K, z, N) of ``a @ blocks(x) + v @ r``; raises on bad shapes.

    a [M, K] or [B, M, K]; x [R, C] or [B, R, C]; offsets [K]; v [M, z];
    r [z, N] or [B, z, N], N a whole number of block rows of ``bc``
    columns (N / bc rows ``ld`` apart) that fit in x's batch element.
    The 3D operands share one B.  The offsets stay on their device,
    unchecked."""
    if a.dim() not in (2, 3) or x.dim() not in (2, 3) or r.dim() not in (2, 3):
        raise ValueError(f"a, x and r must be 2D or 3D, got {tuple(a.shape)} "
                         f"{tuple(x.shape)} {tuple(r.shape)}")
    m, k = (int(d) for d in a.shape[-2:])
    if offsets.dim() != 1 or offsets.shape[0] != k:
        raise ValueError(f"offsets must be [K={k}], got {tuple(offsets.shape)}")
    if v.dim() != 2 or v.shape[0] != m:
        raise ValueError(f"v must be [M={m}, z], got {tuple(v.shape)}")
    z, n = int(v.shape[1]), int(r.shape[-1])
    if int(r.shape[-2]) != z:
        raise ValueError(f"r must be [..., z={z}, N], got {tuple(r.shape)}")
    if not (0 < bc <= n and n % bc == 0 and ld >= bc):
        raise ValueError(f"blocks of width {bc}, rows {ld} apart, cannot make N = {n} columns")
    extent = int(x.shape[-2]) * int(x.shape[-1])
    if (n // bc - 1) * ld + bc > extent:
        raise ValueError(f"a block of {n // bc} rows of {bc}, {ld} apart, reads outside x's "
                         f"{extent} elements a batch element")
    batches = {int(t.shape[0]) for t in (a, x, r) if t.dim() == 3}
    if len(batches) > 1:
        raise ValueError(f"batch dims disagree: {tuple(a.shape)} {tuple(x.shape)} {tuple(r.shape)}")
    return (batches.pop() if batches else 1), m, k, z, n


def launch_blocks_plus_into(lib, design: str, a, x, offsets, bc, ld, v, r, out, p: int) -> int:
    """One launch of ``lib``'s blocks form of the skinny ``design``
    (``"int32_skinny"`` or ``"f32_skinny"``) writing ``out``, on the
    current stream, with no checks and no counting; returns the CUDA
    error."""
    batch, m, k, z, n = _blocks_plus_geometry(a, x, offsets, bc, ld, v, r)
    with torch.cuda.device(a.device):
        return lib.modmatmul_blocks_plus_launch(
            DESIGNS[design],
            a.data_ptr(), x.data_ptr(), offsets.data_ptr(), v.data_ptr(), r.data_ptr(),
            out.data_ptr(),
            batch, m, n, k, z,
            m * k if a.dim() == 3 else 0, _batch_stride("x", x), _batch_stride("r", r),
            bc, ld, p,
            torch.cuda.current_stream(a.device).cuda_stream,
        )


def modmatmul_blocks_plus_cuda(
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
    """``a @ blocks(x) + v @ r  (mod p)`` in one launch of the skinny
    design's blocks form.

    Block k of x, the term of a's column k, is the [N / bc, bc] block
    whose column n is x's element ``offsets[k] + (n // bc) * ld + n %
    bc`` of its batch element, counted in the batch element's
    row-major order.  a [M, K] or [B, M, K]; x [R, C] or [B, R, C],
    each batch element's rows contiguous (C apart), batch elements any
    stride apart (0 where x is a broadcast view; x is never copied);
    offsets [K] int64 on x's device; v [M, z]; r [z, N] or [B, z, N],
    rows contiguous.  Takes only what the skinny designs take: M <= 32,
    K <= 32, K + z <= 128.  The host checks that a block's span fits in
    x's batch element; the launch reads ``offsets`` on the card
    unchecked, so each must leave its block inside x
    (``protocol.device_plan_arrays`` checks the share's where it builds
    them).  Counted
    once, under the skinny design, as a product of shape (B, M, K + z,
    N).  On CPU tensors it runs the plain version (and counts nothing).
    """
    tensors = (a, x, offsets, v, r)
    if all(t.device.type == "cpu" for t in tensors):
        _blocks_plus_geometry(a, x, offsets, bc, ld, v, r)
        return ref.modmatmul_blocks_plus_plain(a, x, offsets, bc, ld, v, r, p, variant)
    return _launch_blocks_plus(variant, a, x, offsets, int(bc), int(ld), v, r, p)


def _launch_blocks_plus(variant, a, x, offsets, bc, ld, v, r, p) -> torch.Tensor:
    if ld >= 1 << 31:
        raise ValueError(f"{variant}_skinny: the row stride must be below 2**31")
    return _launch_loaded(
        variant, "blocks", ("x", x), ("offsets", offsets), a, v, r, p,
        _blocks_plus_geometry(a, x, offsets, bc, ld, v, r),
        lambda lib, compiled, out: launch_blocks_plus_into(lib, compiled, a, x, offsets, bc, ld, v, r,
                                                           out, p))
