"""The three-phase CMPC protocol engine, on torch tensors.

The counterpart of the JAX package's ``repro.core.protocol``, with its
three execution paths:

* ``run``          — per-product reference: host-side block stacking,
                     numpy-rng secrets and blinding, the share
                     evaluation, worker multiply and degree reduction
                     on the device, and the Phase-3 decode in numpy
                     (``share_a``/``share_b``, ``worker_multiply``,
                     ``degree_reduce``, ``reconstruct*``); the edge
                     runtime's per-product data plane,
* ``run_batched``  — the batched engine below, every phase on the
                     device; ``run_batched_crt`` runs it once per prime
                     of a CRT modulus and combines on the host,
* ``run_batched_sharded`` — the batched engine with the Phase-2 exchange
                     as one ``torch.distributed`` collective over a
                     device mesh (``core.distributed``).

The three phases:

Phase 1  sources evaluate F_A(alpha_n), F_B(alpha_n) for every
         provisioned worker (``share_batched``),
Phase 2  every worker computes H(alpha_n) = F_A(alpha_n) F_B(alpha_n);
         the degree-reduction exchange is the dense mix
         I = mix.T @ H + Vnoise @ R,
Phase 3  the master reconstructs I(x) from t^2 + z responses and reads
         Y = A^T B off the first t^2 coefficients.

Every modular product goes through ``kernels.modmatmul`` (the Hopper
kernels on the card).  Block scatter and gather are index ops on
device tensors built once per plan and device (``device_plan``).

Randomness.  Keys are derived exactly as the JAX package derives them
(``gf.prng_key``/``gf.split``), so with ``fused_masks`` the secret and
blinding terms — the counter-based threefry stream generated inside the
kernels — are bit-identical to the reference's.  Without fused masks the
draws come from a ``torch.Generator`` seeded from the key; they differ
from ``jax.random.randint``'s, and Y does not depend on them.  The
reference path draws from the caller's ``numpy.random.Generator`` in
the reference's order, dtypes and shapes, so its shares, blinding and
every decision taken from them are the reference's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.modmatmul.ops import (
    mod_matmul,
    mod_matmul_blocks_plus,
    mod_matmul_masked,
    mod_matmul_rows_plus,
    polyeval,
    polyeval_masked,
    skinny_fuses,
)
from ..obs.metrics import REGISTRY
from ..obs.tracer import TRACER
from .gf import Key, crt_combine, mod_add, prng_key, random_field_device, split
from .planner import CMPCPlan


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA device.  Without a GPU the caller must ask for the CPU
    explicitly; the port never falls back to it on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port's plain versions"
        )
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass
class Trace:
    """Scalar-movement accounting, in field elements.

    Phase-1 counts cover every *provisioned* worker (primaries and
    spares alike — spares receive shares up front so they can step in),
    matching Corollary 12's accounting at N = n_total.  Phase-2 counts
    are spare-inclusive on the *receive* side for the same reason: each
    of the ``n_workers`` senders reaches the other ``n_total - 1``
    provisioned workers, because Phase 3 may decode from any of them.
    ``elem_bytes`` (the field's wire width, ``Field.elem_bytes``)
    converts the element counts into the bytes-level view.
    """

    phase1_source_to_worker: int = 0
    phase2_worker_to_worker: int = 0
    phase3_worker_to_master: int = 0
    elem_bytes: int = 2  # width of one GF(p) element on the wire

    def __add__(self, other: "Trace") -> "Trace":
        """Phase-wise sum — aggregate accounting across replays."""
        if not isinstance(other, Trace):
            return NotImplemented
        if self.elem_bytes != other.elem_bytes:
            raise ValueError(
                f"cannot sum traces with different wire widths "
                f"({self.elem_bytes} vs {other.elem_bytes} bytes)"
            )
        return Trace(
            phase1_source_to_worker=self.phase1_source_to_worker
            + other.phase1_source_to_worker,
            phase2_worker_to_worker=self.phase2_worker_to_worker
            + other.phase2_worker_to_worker,
            phase3_worker_to_master=self.phase3_worker_to_master
            + other.phase3_worker_to_master,
            elem_bytes=self.elem_bytes,
        )

    @property
    def total(self) -> int:
        return (
            self.phase1_source_to_worker
            + self.phase2_worker_to_worker
            + self.phase3_worker_to_master
        )

    @property
    def phase1_bytes(self) -> int:
        return self.phase1_source_to_worker * self.elem_bytes

    @property
    def phase2_bytes(self) -> int:
        return self.phase2_worker_to_worker * self.elem_bytes

    @property
    def phase3_bytes(self) -> int:
        return self.phase3_worker_to_master * self.elem_bytes

    @property
    def total_bytes(self) -> int:
        return self.total * self.elem_bytes


def batch_trace(
    plan: CMPCPlan,
    batch: int = 1,
    n_receivers: Optional[int] = None,
    n_responses: Optional[int] = None,
) -> Trace:
    """Corollary-12 communication accounting for ``batch`` products.

    Phase 1 provisions every worker (spares included); Phase 2's
    receivers likewise span all ``n_total`` provisioned workers (each of
    the ``n_workers`` senders reaches the other n_total - 1).
    ``n_receivers``/``n_responses`` override the idealized full-pool /
    threshold counts.
    """
    sh = plan.shapes
    t = plan.scheme.t
    blk_y = (sh.ma // t) * (sh.mb // t)
    if n_receivers is None:
        n_receivers = plan.n_total
    if n_responses is None:
        n_responses = plan.decode_threshold
    return Trace(
        phase1_source_to_worker=batch
        * plan.n_total
        * (sh.blk_a[0] * sh.blk_a[1] + sh.blk_b[0] * sh.blk_b[1]),
        phase2_worker_to_worker=batch * plan.n_workers * (n_receivers - 1) * blk_y,
        phase3_worker_to_master=batch * n_responses * blk_y,
        elem_bytes=plan.field.elem_bytes,
    )


# ----------------------------------------------------------------------
# worker-subset selection
# ----------------------------------------------------------------------
def _phase2_selection(
    plan: CMPCPlan, worker_ids: Optional[Sequence[int]], device
) -> Tuple[np.ndarray, torch.Tensor]:
    """(sender ids, device mix.T) for a Phase-2 worker subset.

    ``None`` is the primary-prefix fast path: the pre-transposed device
    constant from ``device_plan``.  Any explicit subset routes through
    the plan's cached subset matrices.
    """
    if worker_ids is None:
        return np.arange(plan.n_workers), device_plan(plan, device).mix_t
    ids = np.asarray(worker_ids)
    mix = plan.phase2_matrix_cached(ids)
    return ids, _const(mix.T % plan.field.p, device)


def _decode_selection(
    plan: CMPCPlan, worker_ids: Optional[Sequence[int]]
) -> Tuple[np.ndarray, np.ndarray]:
    """(responder ids, decode matrix) for a Phase-3 responder subset."""
    if worker_ids is None:
        return np.arange(plan.decode_threshold), plan.decode_w
    ids = np.asarray(worker_ids)
    return ids, plan.decode_matrix_cached(ids)


def _phase3_device_selection(
    plan: CMPCPlan, phase3_ids: Optional[Sequence[int]], device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(device ids3, device decode matrix) for a responder subset."""
    dp = device_plan(plan, device)
    if phase3_ids is None:
        return dp.ids3, dp.decode_w
    ids3_h, decode_w_h = _decode_selection(plan, phase3_ids)
    return _index(ids3_h, device), _const(decode_w_h % plan.field.p, device)


# ----------------------------------------------------------------------
# device-resident plan constants
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """Device-resident constants of one CMPCPlan on one device.

    Share Vandermondes, the Phase-2 mixing matrix (pre-transposed), the
    blinding Vandermonde and the Phase-3 decode matrix as int32; the
    block scatter maps and default worker sets as int64 index tensors.

    The share's blocks form (``_share`` where ``skinny_fuses`` holds)
    reads the Vandermondes' columns split into the data blocks' and the
    secrets' (``va_blocks`` = va[:, a_pos], ``va_secrets`` = va[:, sa_pos],
    the same for B) and each data block's element offset in A^T [ma, k]
    or B [k, mb] (``a_offsets``, ``b_offsets``).  They depend on the
    plan's block shapes, so only ``device_plan`` builds them; a
    DevicePlan made from bare arrays without them keeps the stack path.
    """

    va: torch.Tensor  # [n_total, |P(F_A)|]
    vb: torch.Tensor  # [n_total, |P(F_B)|]
    mix_t: torch.Tensor  # [n_total, n_workers]  (plan.mix.T mod p)
    vnoise: torch.Tensor  # [n_total, z]
    decode_w: torch.Tensor  # [thr, thr]
    a_pos: torch.Tensor  # [t*s] block (i,j) -> row of the F_A coeff stack
    sa_pos: torch.Tensor  # [z]   secret power -> row of the F_A stack
    b_pos: torch.Tensor  # [s*t] block (k,l) -> row of the F_B coeff stack
    sb_pos: torch.Tensor  # [z]
    ids2: torch.Tensor  # [n_workers] default Phase-2 worker set
    ids3: torch.Tensor  # [thr] default Phase-3 responder set
    # host copies of the scatter maps for the numpy share path of ``run``
    a_pos_h: np.ndarray = None
    sa_pos_h: np.ndarray = None
    b_pos_h: np.ndarray = None
    sb_pos_h: np.ndarray = None
    # the share's blocks form (None: the stack path)
    va_blocks: Optional[torch.Tensor] = None  # [n_total, t*s] va[:, a_pos]
    va_secrets: Optional[torch.Tensor] = None  # [n_total, z]  va[:, sa_pos]
    vb_blocks: Optional[torch.Tensor] = None  # [n_total, s*t] vb[:, b_pos]
    vb_secrets: Optional[torch.Tensor] = None  # [n_total, z]  vb[:, sb_pos]
    a_offsets: Optional[torch.Tensor] = None  # [t*s] block (i,j) -> element offset in A^T
    b_offsets: Optional[torch.Tensor] = None  # [s*t] block (k,l) -> element offset in B


# fields holding field elements (int32) vs index maps (int64)
CONST_FIELDS = ("va", "vb", "mix_t", "vnoise", "decode_w")
INDEX_FIELDS = ("a_pos", "sa_pos", "b_pos", "sb_pos", "ids2", "ids3")
# the share's blocks form, built from the plan's shapes by device_plan_arrays
SHARE_CONST_FIELDS = ("va_blocks", "va_secrets", "vb_blocks", "vb_secrets")
SHARE_INDEX_FIELDS = ("a_offsets", "b_offsets")
# index maps the numpy share path also keeps on the host (``<name>_h``)
HOST_FIELDS = ("a_pos", "sa_pos", "b_pos", "sb_pos")


def _const(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64).astype(np.int32), device=device).contiguous()


def _index(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.int64), device=device)


def _positions(all_powers, powers) -> np.ndarray:
    pos = {u: idx for idx, u in enumerate(all_powers)}
    return np.array([pos[u] for u in powers], np.int64)


def device_plan_arrays(plan: CMPCPlan) -> dict:
    """The DevicePlan fields of ``plan`` as host numpy arrays."""
    sch = plan.scheme
    p = plan.field.p
    amap = sch.coded.a_power_map()
    bmap = sch.coded.b_power_map()
    a_pos = np.zeros(sch.t * sch.s, np.int64)
    fa_index = {u: idx for idx, u in enumerate(sch.fa_powers)}
    for (i, j), u in amap.items():
        a_pos[i * sch.s + j] = fa_index[u]
    b_pos = np.zeros(sch.s * sch.t, np.int64)
    fb_index = {u: idx for idx, u in enumerate(sch.fb_powers)}
    for (k, l), u in bmap.items():
        b_pos[k * sch.t + l] = fb_index[u]
    sa_pos = _positions(sch.fa_powers, sch.sa)
    sb_pos = _positions(sch.fb_powers, sch.sb)
    sh = plan.shapes
    bra, bca = sh.ma // sch.t, sh.k // sch.s  # A^T [ma, k]: t x s blocks, rows k apart
    brb, bcb = sh.k // sch.s, sh.mb // sch.t  # B [k, mb]: s x t blocks, rows mb apart
    va, vb = plan.va % p, plan.vb % p
    return dict(
        va=va,
        vb=vb,
        mix_t=plan.mix.T % p,
        vnoise=plan.vnoise % p,
        decode_w=plan.decode_w % p,
        a_pos=a_pos,
        sa_pos=sa_pos,
        b_pos=b_pos,
        sb_pos=sb_pos,
        ids2=np.arange(plan.n_workers),
        ids3=np.arange(plan.decode_threshold),
        va_blocks=va[:, a_pos],
        va_secrets=va[:, sa_pos],
        vb_blocks=vb[:, b_pos],
        vb_secrets=vb[:, sb_pos],
        a_offsets=_block_offsets(sch.t, sch.s, bra, bca, sh.k, sh.ma * sh.k),
        b_offsets=_block_offsets(sch.s, sch.t, brb, bcb, sh.mb, sh.k * sh.mb),
    )


def _block_offsets(nr: int, nc: int, br: int, bc: int, ld: int, extent: int) -> np.ndarray:
    """Element offsets of the nr x nc blocks [br, bc] of a row-major
    matrix of ``extent`` elements, rows ``ld`` apart, block (i, j) at
    i * nc + j.  Raises where a block would leave the matrix: the
    blocks-form launch reads the offsets unchecked."""
    offs = np.array([i * br * ld + j * bc for i in range(nr) for j in range(nc)], np.int64)
    if nc * bc > ld or int(offs.max()) + (br - 1) * ld + bc > extent:
        raise ValueError(f"{nr} x {nc} blocks [{br}, {bc}], rows {ld} apart, leave a matrix of "
                         f"{extent} elements")
    return offs


def device_plan_from_arrays(arrays: dict, device) -> DevicePlan:
    """Upload DevicePlan fields given as numpy arrays to ``device``; the
    share's blocks-form fields only where ``arrays`` holds them."""
    fields = {k: _const(arrays[k], device) for k in CONST_FIELDS}
    fields.update({k: _index(arrays[k], device) for k in INDEX_FIELDS})
    fields.update({f"{k}_h": np.array(arrays[k], np.int64) for k in HOST_FIELDS})
    fields.update({k: _const(arrays[k], device) for k in SHARE_CONST_FIELDS if k in arrays})
    fields.update({k: _index(arrays[k], device) for k in SHARE_INDEX_FIELDS if k in arrays})
    return DevicePlan(**fields)


def device_plan(plan: CMPCPlan, device) -> DevicePlan:
    """Build (and cache on the plan, per device) the device constants."""
    device = torch.device(device)
    cache = plan.__dict__.get("_device_plans")
    if cache is None:
        cache = {}
        object.__setattr__(plan, "_device_plans", cache)
    dp = cache.get(device)
    if dp is None:
        dp = device_plan_from_arrays(device_plan_arrays(plan), device)
        cache[device] = dp
    return dp


def _key_words(key) -> Key:
    """A key as its (k0, k1) 32-bit word pair: accepts a pair of ints, a
    numpy array or a tensor of two words (e.g. a raw JAX key's data)."""
    words = [int(w) for w in np.asarray(key, np.int64).reshape(-1)]
    if len(words) != 2:
        raise ValueError(f"a key is two 32-bit words, got {len(words)}")
    return (words[0] & 0xFFFFFFFF, words[1] & 0xFFFFFFFF)


def _generator(key: Key, device) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from a key's words."""
    gen = torch.Generator(device=device)
    gen.manual_seed((key[0] << 32) | key[1])
    return gen


# ----------------------------------------------------------------------
# Phase 1 — sources share data with workers
# ----------------------------------------------------------------------
def _share(a, b, key: Key, dp: DevicePlan, *, p, s, t, z, na, nb, backend, fused_masks):
    """Phase 1 for a batch of products on ``a``'s device.

    a: [batch, k, ma], b: [batch, k, mb] int32 in [0, p).  Returns
    (F_A(alpha_n), F_B(alpha_n)) stacked [batch, n_total, ., .].

    Without ``fused_masks``, where ``skinny_fuses`` holds (a kernel backend
    on the card, n_total <= 32, t*s <= 32, t*s + z <= 128) and ``dp``
    has the blocks-form fields, each operand is one
    ``mod_matmul_blocks_plus``: F = V[:, pos] @ blocks + V[:, spos] @ R,
    B's blocks read where they lie in b and A's in one contiguous copy
    of A^T, the z secrets drawn as below and read as loaded rows.  The
    ``REGISTRY`` counter ``protocol.share.fused`` or
    ``protocol.share.unfused`` counts which, once a call.  Elsewhere (and
    with ``fused_masks``) the blocks are scattered into a zero-filled
    coefficient stack, the secrets into its secret rows, and ``polyeval``
    runs V @ stack.  Both give the same integers.
    """
    batch, k, ma = a.shape
    mb = b.shape[-1]
    bra, bca = ma // t, k // s  # F_A coefficient block
    brb, bcb = k // s, mb // t  # F_B coefficient block
    k1, k2 = split(key, 2)
    dev = a.device

    if not fused_masks:
        one = dp.va_blocks is not None and skinny_fuses(backend, dev, int(dp.va.shape[0]), t * s, z)
        REGISTRY.counter("protocol.share." + ("fused" if one else "unfused")).inc()
        if one:
            ra = random_field_device(_generator(k1, dev), (batch, z, bra, bca), p, dev)
            rb = random_field_device(_generator(k2, dev), (batch, z, brb, bcb), p, dev)
            at = a.transpose(-1, -2).contiguous()  # [batch, ma, k]
            fa = mod_matmul_blocks_plus(
                dp.va_blocks, at, dp.a_offsets, bca, k, dp.va_secrets,
                ra.reshape(batch, z, bra * bca), p=p, backend=backend,
            )
            fb = mod_matmul_blocks_plus(
                dp.vb_blocks, b, dp.b_offsets, bcb, mb, dp.vb_secrets,
                rb.reshape(batch, z, brb * bcb), p=p, backend=backend,
            )
            return fa.reshape(batch, -1, bra, bca), fb.reshape(batch, -1, brb, bcb)

    at = a.transpose(-1, -2)  # [batch, ma, k]
    a_blocks = (
        at.reshape(batch, t, bra, s, bca).permute(0, 1, 3, 2, 4).reshape(batch, t * s, bra, bca)
    )
    stack_a = torch.zeros((batch, na, bra, bca), dtype=torch.int32, device=dev)
    stack_a[:, dp.a_pos] = a_blocks
    b_blocks = (
        b.reshape(batch, s, brb, t, bcb).permute(0, 1, 3, 2, 4).reshape(batch, s * t, brb, bcb)
    )
    stack_b = torch.zeros((batch, nb, brb, bcb), dtype=torch.int32, device=dev)
    stack_b[:, dp.b_pos] = b_blocks
    if fused_masks:
        # the secret coefficients never materialize: V[:, secret] @ R(key)
        # is generated inside the matmul kernel
        fa = polyeval_masked(
            dp.va, stack_a, dp.va.index_select(1, dp.sa_pos), k1, p=p, backend=backend
        )
        fb = polyeval_masked(
            dp.vb, stack_b, dp.vb.index_select(1, dp.sb_pos), k2, p=p, backend=backend
        )
        return fa, fb
    stack_a[:, dp.sa_pos] = random_field_device(_generator(k1, dev), (batch, z, bra, bca), p, dev)
    stack_b[:, dp.sb_pos] = random_field_device(_generator(k2, dev), (batch, z, brb, bcb), p, dev)
    fa = polyeval(dp.va, stack_a, p=p, backend=backend)  # [batch, n_total, bra, bca]
    fb = polyeval(dp.vb, stack_b, p=p, backend=backend)
    return fa, fb


def _prep_batched_operands(plan: CMPCPlan, a, b, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate and promote operands to int32 [batch, k, m] tensors on
    ``device`` (numpy arrays or tensors, any integer dtype)."""
    p = plan.field.p

    def prep(x):
        x = torch.as_tensor(x, device=device)
        if x.dtype not in (torch.int32, torch.int64):
            x = x.to(torch.int64)
        x = torch.remainder(x, p).to(torch.int32)
        return x[None] if x.dim() == 2 else x

    a, b = prep(a), prep(b)
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"expected [batch, k, m] operands, got {tuple(a.shape)} {tuple(b.shape)}")
    sh = plan.shapes
    if tuple(a.shape[1:]) != (sh.k, sh.ma) or tuple(b.shape[1:]) != (sh.k, sh.mb):
        raise ValueError(
            f"operands {tuple(a.shape[1:])}/{tuple(b.shape[1:])} disagree with plan "
            f"shapes ({sh.k}, {sh.ma})/({sh.k}, {sh.mb})"
        )
    return a, b


def _plan_dims(plan: CMPCPlan) -> dict:
    sch = plan.scheme
    return dict(
        p=plan.field.p, s=sch.s, t=sch.t, z=sch.z,
        na=len(sch.fa_powers), nb=len(sch.fb_powers),
    )


def share_batched(
    plan: CMPCPlan,
    a,
    b,
    key,
    backend: str = "auto",
    fused_masks: bool = False,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sources evaluate a whole batch of share pairs.

    a: [batch, k, ma], b: [batch, k, mb] in [0, p); ``key`` is a (k0, k1)
    word pair (``gf.prng_key``/``gf.split``).  Returns int32
    (F_A(alpha_n) [batch, n_total, ma/t, k/s], F_B(alpha_n)
    [batch, n_total, k/s, mb/t]) on ``device`` (default: the GPU).
    """
    device = resolve_device(device)
    a, b = _prep_batched_operands(plan, a, b, device)
    dp = device_plan(plan, device)
    with TRACER.span(
        "protocol.phase1.share_batched", batch=int(a.shape[0]), backend=backend
    ):
        return _share(
            a, b, _key_words(key), dp, backend=backend, fused_masks=fused_masks,
            **_plan_dims(plan),
        )


# ----------------------------------------------------------------------
# Phase 3 — master reconstructs Y = A^T B
# ----------------------------------------------------------------------
def _decode_batched(i_evals, decode_w, ids3, *, p: int, t: int, backend: str):
    """Phase 3: mod_matmul with the decode matrix, then the block gather.

    i_evals: [batch, n_total, bry, bcy]; returns y [batch, ma, mb] int32.
    """
    batch, _, bry, bcy = i_evals.shape
    sel = i_evals.index_select(1, ids3).reshape(batch, ids3.shape[0], bry * bcy)
    coeffs = mod_matmul(decode_w, sel, p=p, backend=backend)
    # coefficient g = i + t*l of I(x) is output block (row i, col l)
    y_blocks = coeffs[:, : t * t].reshape(batch, t, t, bry, bcy)  # [b, l, i, ., .]
    return y_blocks.permute(0, 2, 3, 1, 4).reshape(batch, t * bry, t * bcy)


# ----------------------------------------------------------------------
# all three phases
# ----------------------------------------------------------------------
def run_batched(
    plan: CMPCPlan,
    a,
    b,
    seed: int = 0,
    phase2_ids: Optional[Sequence[int]] = None,
    phase3_ids: Optional[Sequence[int]] = None,
    backend: str = "auto",
    fused_masks: bool = False,
    device=None,
) -> Tuple[torch.Tensor, Trace]:
    """Batched protocol: Y[i] = A[i]^T B[i] mod p for a batch of products.

    a: [batch, k, ma], b: [batch, k, mb] (numpy arrays or tensors; a
    single 2D pair is promoted to batch 1).  Share evaluation, worker
    multiply, degree reduction and decode all run on ``device`` (default:
    the GPU); plan constants are uploaded once per device
    (``device_plan``).  ``phase2_ids``/``phase3_ids`` pick the Phase-2
    senders and Phase-3 responders (default: the primary prefixes).

    ``fused_masks`` generates the Phase-1 secret coefficients and the
    Phase-2 summed blinding term inside the matmul kernels instead of
    materializing them; Y is the same either way.

    Returns (y [batch, ma, mb] int64 on ``device``, Trace for the batch).

    Without ``fused_masks`` the degree reduction is one
    ``mod_matmul_rows_plus``: on the card, at the skinny designs' shapes
    (n_total <= 32, n_workers <= 32, n_workers + z <= 128), one launch
    that reads the selected rows of H in place; otherwise the selection,
    the mix, the noise and their sum as separate operations.  The
    ``REGISTRY`` counter ``protocol.reduce.fused`` or
    ``protocol.reduce.unfused`` counts which, once per call.

    With the tracer on, ``protocol.run_batched`` holds five phase spans,
    in order: ``.prep`` (operands, device plan, the Phase-2/3
    selections), ``.share``, ``.multiply`` (the P2 worker product),
    ``.reduce`` (the degree reduction) and ``.decode`` (with the int64
    cast of Y); every device operation of the call is launched inside
    one of them.
    """
    with TRACER.span("protocol.run_batched", backend=backend) as span:
        with TRACER.span("protocol.run_batched.prep"):
            device = resolve_device(device)
            a, b = _prep_batched_operands(plan, a, b, device)
            dp = device_plan(plan, device)
            dims = _plan_dims(plan)
            p, t, z = dims["p"], dims["t"], dims["z"]
            if phase2_ids is None:
                ids2, mix_t = dp.ids2, dp.mix_t
            else:
                ids2_h = np.asarray(phase2_ids)
                if ids2_h.size and (ids2_h.min() < 0 or ids2_h.max() >= plan.n_total):
                    raise ValueError(f"phase2_ids must lie in [0, {plan.n_total}), got {ids2_h}")
                ids2_h, mix_t = _phase2_selection(plan, ids2_h, device)
                ids2 = _index(ids2_h, device)
            ids3, decode_w = _phase3_device_selection(plan, phase3_ids, device)
        batch, _, ma = a.shape
        mb = b.shape[-1]
        bry, bcy = ma // t, mb // t
        blk_flat = bry * bcy
        span.set(batch=int(batch))

        kshare, k3 = split(prng_key(seed), 2)
        # Phase 1
        with TRACER.span("protocol.run_batched.share"):
            fa, fb = _share(
                a, b, kshare, dp, backend=backend, fused_masks=fused_masks, **dims
            )
        # Phase 2 — worker multiply + dense degree-reduction exchange
        with TRACER.span("protocol.run_batched.multiply"):
            h = mod_matmul(fa, fb, p=p, backend=backend)  # [batch, n_total, bra, bcb]
        with TRACER.span("protocol.run_batched.reduce"):
            # Only the sum over workers of their blinding matrices enters
            # I(x), and a sum of uniforms mod p is uniform: the summed term
            # is drawn directly, as in the JAX package's batched engine.
            if fused_masks:
                h_flat = h.index_select(1, ids2).reshape(batch, plan.n_workers, blk_flat)
                i_evals = mod_matmul_masked(mix_t, h_flat, dp.vnoise, k3, p=p, backend=backend)
            else:
                r_sum = random_field_device(
                    _generator(k3, device), (batch, z, blk_flat), p, device
                )
                one = skinny_fuses(backend, device, plan.n_total, int(ids2.shape[0]), z)
                REGISTRY.counter("protocol.reduce." + ("fused" if one else "unfused")).inc()
                i_evals = mod_matmul_rows_plus(  # [b, n_total, .]
                    mix_t, h.reshape(batch, plan.n_total, blk_flat), ids2, dp.vnoise, r_sum,
                    p=p, backend=backend,
                )
        # Phase 3
        with TRACER.span("protocol.run_batched.decode"):
            y = _decode_batched(
                i_evals.reshape(batch, -1, bry, bcy), decode_w, ids3,
                p=p, t=t, backend=backend,
            ).to(torch.int64)
    return y, batch_trace(plan, int(batch))


def _sum_traces(traces: Sequence[Trace]) -> Trace:
    """Aggregate per-residue traces whose wire widths may differ (CRT
    primes of different byte widths): element counts sum, the combined
    width is the widest residue's (an upper bound on the byte view)."""
    out = Trace(elem_bytes=max(t.elem_bytes for t in traces))
    for t in traces:
        out.phase1_source_to_worker += t.phase1_source_to_worker
        out.phase2_worker_to_worker += t.phase2_worker_to_worker
        out.phase3_worker_to_master += t.phase3_worker_to_master
    return out


def run_batched_crt(
    plans: Sequence[CMPCPlan],
    a,
    b,
    seed: int = 0,
    phase2_ids: Optional[Sequence[int]] = None,
    phase3_ids: Optional[Sequence[int]] = None,
    backend: str = "auto",
    fused_masks: bool = False,
    device=None,
) -> Tuple[np.ndarray, Trace]:
    """CRT multi-prime batched protocol: Y mod prod(p_i) from one
    ``run_batched`` per residue plan.

    ``plans`` hold the same scheme/shapes over *distinct* prime fields;
    operands are arbitrary integers (numpy or tensors), uploaded once to
    ``device`` (default: the GPU) as int64 and reduced per field inside
    ``run_batched`` with ``torch.remainder`` (numpy's sign rule).
    Residue ``i`` runs with ``seed + 31*i``; the residue outputs come to
    the host and combine there via Garner's algorithm into int64 numpy
    in [0, prod(p_i)).  The returned Trace sums all residue passes.
    """
    primes = [plan.field.p for plan in plans]
    if len(set(primes)) != len(primes):
        raise ValueError(f"CRT plans must use distinct primes, got {primes}")
    device = resolve_device(device)
    a = torch.as_tensor(a, device=device).to(torch.int64)
    b = torch.as_tensor(b, device=device).to(torch.int64)
    residues, traces = [], []
    with TRACER.span("protocol.run_batched_crt", primes=len(primes)):
        for i, plan in enumerate(plans):
            y, tr = run_batched(
                plan, a, b, seed=seed + 31 * i,
                phase2_ids=phase2_ids, phase3_ids=phase3_ids,
                backend=backend, fused_masks=fused_masks, device=device,
            )
            residues.append(y.cpu().numpy())
            traces.append(tr)
    return crt_combine(residues, primes), _sum_traces(traces)


def run_batched_sharded(
    plan: CMPCPlan,
    a,
    b,
    mesh,
    axis: str = "workers",
    mode: str = "all_to_all",
    seed: int = 0,
    phase2_ids: Optional[Sequence[int]] = None,
    phase3_ids: Optional[Sequence[int]] = None,
    backend: str = "auto",
) -> Tuple[torch.Tensor, Trace]:
    """Batched protocol with the *distributed* Phase 2 over a device mesh.

    Same contract as ``run_batched``, but the degree-reduction exchange
    is the collective of ``repro_torch.core.distributed.run_phase2_sharded``
    (``mode`` selects ``all_to_all`` / ``psum`` / ``psum_scatter``):
    workers live as shards on the ``axis`` mesh dimension, each rank
    multiplies its own workers' shares, and the whole batch rides one
    collective.  Every rank of ``mesh`` calls this with the same
    arguments and gets the same Y; each computes on its mesh's device
    (``distributed.mesh_device``).  Phases 1 and 3 are ``run_batched``'s
    (``share_batched`` / ``_decode_batched``).

    ``phase2_ids`` is the Phase-2 sender subset and routes through the
    plan's cached subset mix matrices; ``phase3_ids`` is the responder
    subset for the decode.  Unlike ``run_batched``'s summed-blinding
    shortcut, the exchange keeps faithful *per-worker* blinding draws
    R_w^{(n)}, drawn on the device from the key's second half (unfused
    draws differ from the reference's by construction; Y does not
    depend on them).

    Returns (y [batch, ma, mb] int64 on the rank's device, Trace for the
    whole batch).
    """
    from .distributed import mesh_device, run_phase2_sharded  # local: avoid cycle

    device = mesh_device(mesh)
    a, b = _prep_batched_operands(plan, a, b, device)
    p, t, z = plan.field.p, plan.scheme.t, plan.scheme.z
    batch = int(a.shape[0])
    kshare, knoise = split(prng_key(seed), 2)
    with TRACER.span(
        "protocol.run_batched_sharded", batch=batch, mode=mode, backend=backend
    ):
        fa, fb = share_batched(plan, a, b, kshare, backend=backend, device=device)
        noise = random_field_device(
            _generator(knoise, device), (batch, plan.n_workers, z) + plan.shapes.blk_y,
            p, device,
        )
        with TRACER.span("protocol.phase2.sharded_exchange", mode=mode):
            i_evals = run_phase2_sharded(
                plan, fa, fb, noise, mesh, axis=axis, mode=mode, matmul_backend=backend,
                worker_ids=None if phase2_ids is None else np.asarray(phase2_ids),
            )  # [batch, n_total, bry, bcy]
        del fa, fb, noise
        ids3, decode_w = _phase3_device_selection(plan, phase3_ids, device)
        with TRACER.span("protocol.phase3.decode_batched"):
            y = _decode_batched(i_evals, decode_w, ids3, p=p, t=t, backend=backend)
    return y.to(torch.int64), batch_trace(plan, batch)


# ----------------------------------------------------------------------
# the per-product reference path: numpy rng on the host, products on the
# device, the Phase-3 decode in numpy
# ----------------------------------------------------------------------
def _host(x) -> np.ndarray:
    """A worker-stacked array on the host (a device tensor is copied)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _host_rows(x, ids: np.ndarray) -> np.ndarray:
    """Rows ``ids`` of a worker-stacked array, on the host; a device
    tensor is indexed on its device, so only those rows are copied."""
    if isinstance(x, torch.Tensor):
        return x.index_select(0, _index(ids, x.device)).cpu().numpy()
    return np.asarray(x)[ids]


def _share_stack(
    blocks: np.ndarray,
    n_coeff: int,
    data_pos: np.ndarray,
    secret_pos: np.ndarray,
    p: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Scatter data blocks + fresh secrets into an int32 coeff stack."""
    stack = np.zeros((n_coeff,) + blocks.shape[1:], np.int32)
    stack[data_pos] = blocks
    stack[secret_pos] = rng.integers(
        0, p, size=(secret_pos.size,) + blocks.shape[1:], dtype=np.int32
    )
    return stack


def share_a(plan: CMPCPlan, a, rng: np.random.Generator, device=None) -> torch.Tensor:
    """Source 1: F_A(alpha_n) for every provisioned worker.

    The coefficient stack (data blocks and the z secrets from ``rng``)
    is built on the host and evaluated on ``device`` (default: the GPU).
    Returns int32 [n_total, ma/t, k/s].
    """
    device = resolve_device(device)
    s, t = plan.scheme.s, plan.scheme.t
    br, bc = plan.shapes.blk_a
    dp = device_plan(plan, device)
    with TRACER.span("protocol.phase1.share_a"):
        at = np.ascontiguousarray(_host(a).astype(np.int64).T)  # [ma, k]
        blocks = (
            at.reshape(t, br, s, bc).transpose(0, 2, 1, 3).reshape(t * s, br, bc)
        ).astype(np.int32)
        stack = _share_stack(
            blocks, len(plan.scheme.fa_powers), dp.a_pos_h, dp.sa_pos_h,
            plan.field.p, rng,
        )
        return polyeval(dp.va, torch.from_numpy(stack).to(device), p=plan.field.p)


def share_b(plan: CMPCPlan, b, rng: np.random.Generator, device=None) -> torch.Tensor:
    """Source 2: F_B(alpha_n), int32 [n_total, k/s, mb/t] on ``device``."""
    device = resolve_device(device)
    s, t = plan.scheme.s, plan.scheme.t
    br, bc = plan.shapes.blk_b
    dp = device_plan(plan, device)
    with TRACER.span("protocol.phase1.share_b"):
        bm = _host(b).astype(np.int64)
        blocks = (
            bm.reshape(s, br, t, bc).transpose(0, 2, 1, 3).reshape(s * t, br, bc)
        ).astype(np.int32)
        stack = _share_stack(
            blocks, len(plan.scheme.fb_powers), dp.b_pos_h, dp.sb_pos_h,
            plan.field.p, rng,
        )
        return polyeval(dp.vb, torch.from_numpy(stack).to(device), p=plan.field.p)


def worker_multiply(
    plan: CMPCPlan, fa: torch.Tensor, fb: torch.Tensor, backend: str = "auto"
) -> torch.Tensor:
    """H(alpha_n) = F_A(alpha_n) @ F_B(alpha_n), batched over workers."""
    with TRACER.span("protocol.phase2.worker_multiply"):
        return mod_matmul(fa, fb, p=plan.field.p, backend=backend)


def _blinding_sum(plan: CMPCPlan, rng: np.random.Generator, n: int, blk: tuple) -> np.ndarray:
    """The n Phase-2 workers' z blinding matrices each, drawn on the
    host from ``rng``, summed over workers: int64 [z, *blk] in [0, p)."""
    r = plan.field.random(rng, (n, plan.scheme.z) + tuple(blk))
    return np.sum(r, axis=0) % plan.field.p


def degree_reduce(
    plan: CMPCPlan,
    h: torch.Tensor,
    rng: np.random.Generator,
    worker_ids: Optional[Sequence[int]] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Dense (single-host) simulation of the Phase-2 exchange.

    Every worker n forms G_n(x) (eq. 19) and evaluates it at every other
    worker's alpha; the receivers sum into I(alpha_{n'}) (eq. 20).  Here
    that is two modular matmuls on ``h``'s device:

      I[n'] = sum_n mix[n, n'] * H[n]  +  sum_w (sum_n R_w^(n)) vnoise[n', w]

    The per-worker blinding draws R_w^(n) come from ``rng`` on the host.
    ``worker_ids`` selects which n_workers (of n_total provisioned)
    serve Phase 2 — straggler mitigation; default = the primary set.
    Returns int32 I evaluations for *all* provisioned workers
    [n_total, ...].
    """
    p = plan.field.p
    n = plan.n_workers
    device = h.device
    dp = device_plan(plan, device)
    with TRACER.span("protocol.phase2.degree_reduce"):
        ids, mix_t = _phase2_selection(plan, worker_ids, device)
        blk = tuple(h.shape[-2:])
        h_flat = h.index_select(0, _index(ids, device)).reshape(n, -1)
        i_flat = mod_matmul(mix_t, h_flat, p=p, backend=backend)  # [n_total, blk]
        # Workers' blinding terms R_w^{(n)}: each of the n Phase-2
        # workers contributes z random matrices; only their sum enters
        # I(x).
        r_sum = _blinding_sum(plan, rng, n, blk)
        r_dev = torch.from_numpy(r_sum.reshape(plan.scheme.z, -1).astype(np.int32)).to(device)
        noise_flat = mod_matmul(dp.vnoise, r_dev, p=p, backend=backend)
        return mod_add(i_flat, noise_flat, p).reshape((plan.n_total,) + blk)


def assemble_y(plan: CMPCPlan, coeffs: np.ndarray) -> np.ndarray:
    """Lay the first t^2 coefficients of I(x) out as Y (eq. 21).

    coeffs: [>= t^2, blk_flat]; coefficient g = i + t*l is output block
    (row i, col l).
    """
    t = plan.scheme.t
    br, bc = plan.shapes.blk_y
    blocks = np.asarray(coeffs)[: t * t].reshape(t, t, br, bc)  # [l, i, ., .]
    return blocks.transpose(1, 2, 0, 3).reshape(plan.shapes.ma, plan.shapes.mb)


def reconstruct(
    plan: CMPCPlan,
    i_evals,
    worker_ids: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Interpolate I(x) from t^2 + z responses and assemble Y, on the host.

    ``worker_ids`` is the responder subset (any ``decode_threshold``
    indices into the provisioned pool); the default is the primary
    prefix, whose decode matrix is precomputed on the plan.
    """
    thr = plan.decode_threshold
    with TRACER.span("protocol.phase3.reconstruct"):
        ids, w = _decode_selection(plan, worker_ids)
        sel = _host_rows(i_evals, ids).reshape(thr, -1)
        coeffs = plan.field.matmul(w, sel)  # [thr, blk_flat]
        return assemble_y(plan, coeffs)


def reconstruct_corrected(
    plan: CMPCPlan,
    i_evals,
    worker_ids: Sequence[int],
    e: int,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Byzantine-tolerant reconstruction: decode Y from ``thr + 2e``
    responses of which up to ``e`` may be arbitrarily corrupted
    (Berlekamp-Welch, :mod:`repro_torch.core.bw_decode`).  Returns
    ``(y, corrected_ids)``; raises ``BWDecodeError`` past the budget.
    """
    from .bw_decode import bw_decode_evals  # deferred: keeps import light

    evals = _host(i_evals)
    coeffs, corrected = bw_decode_evals(
        plan, evals.reshape(evals.shape[0], -1), np.asarray(worker_ids), e,
        rng=rng,
    )
    return assemble_y(plan, coeffs), corrected


def reconstruct_coded_only(
    plan: CMPCPlan, h, worker_ids: Optional[Sequence[int]] = None
) -> np.ndarray:
    """Coded-computation decode (no Phase 2): interpolate H(x) directly.

    Used for validating decodability of the underlying AGE/PolyDot codes
    (Theorem 6); the master learns garbage coefficients, so this mode
    does NOT provide master-side privacy.
    """
    n = plan.n_workers
    ids = np.arange(n) if worker_ids is None else np.asarray(worker_ids)
    if ids.size != n:
        raise ValueError(f"coded decode needs exactly {n} evaluations")
    v = plan.field.vandermonde(plan.alphas[ids], plan.scheme.h_powers)
    vinv = plan.field.inv_matrix(v)
    sel = _host_rows(h, ids).reshape(n, -1)
    coeffs = plan.field.matmul(vinv, sel)
    t = plan.scheme.t
    br, bc = plan.shapes.blk_y
    y = np.zeros((plan.shapes.ma, plan.shapes.mb), np.int64)
    for i in range(t):
        for l in range(t):
            blkc = coeffs[plan.important_idx[i, l]].reshape(br, bc)
            y[i * br : (i + 1) * br, l * bc : (l + 1) * bc] = blkc
    return y


def run(
    plan: CMPCPlan,
    a,
    b,
    seed: int = 0,
    phase2_ids: Optional[Sequence[int]] = None,
    phase3_ids: Optional[Sequence[int]] = None,
    device=None,
) -> Tuple[np.ndarray, Trace]:
    """Full protocol for one product: returns (Y = A^T B mod p as a host
    int64 array, communication trace).  Shares, worker multiply and
    degree reduction run on ``device`` (default: the GPU)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    with TRACER.span("protocol.run"):
        fa = share_a(plan, a, rng, device=device)
        fb = share_b(plan, b, rng, device=device)
        h = worker_multiply(plan, fa, fb)
        i_evals = degree_reduce(plan, h, rng, worker_ids=phase2_ids)
        y = reconstruct(plan, i_evals, worker_ids=phase3_ids)
    return y, batch_trace(plan, 1)
