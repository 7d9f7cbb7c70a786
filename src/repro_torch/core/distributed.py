"""Distributed CMPC: the protocol workers as ranks of a ``workers`` mesh.

The counterpart of the JAX package's ``repro.core.distributed``, on
``torch.distributed``.  The edge-worker topology maps onto a 1-D
``DeviceMesh`` whose one dimension is named by ``axis``:

* the N protocol workers become shards along that dimension (padded to a
  multiple of its size; pad workers send zero and only receive),
* Phase 2's pairwise exchange -- worker n sends G_n(alpha_{n'}) to every
  n' (N(N-1) point-to-point messages in the paper) -- is ONE collective:

    - ``all_to_all``     ``all_to_all_single``: the faithful transposition
                          of the (sender, receiver) axes; bytes on the
                          wire match the paper's N(N-1) m^2/t^2 accounting,
    - ``psum``           ``all_reduce`` of the receiver-indexed partial
                          sums, then this rank's receivers' rows,
    - ``psum_scatter``   ``reduce_scatter_tensor``: each rank ends with
                          exactly its receivers' I(alpha); the sum into
                          I(x) is linear, so it fuses into the collective.

The exchange is batched: the batch folds into each worker's flattened
block payload, so a whole batch rides one collective.

SPMD.  JAX's ``shard_map`` has one controller that gets every worker's
I(alpha) back.  Here every rank of the mesh calls ``run_phase2_sharded``
with the same arguments, computes its own workers' part, joins the
collective, and ends with one ``all_gather_into_tensor`` of the
receivers' I, so every rank returns the full result, as the reference
does.  A rank computes on its mesh's device type (``cuda`` on the card,
``cpu`` for gloo ranks); shares on another device type raise, and no
collective is staged through the host.

Arithmetic.  Lane values are < p < 2**16; the products mix*H and the
blinding terms are formed in int64 (p**2 > 2**31), reduced mod p, and
the payload that crosses the wire is int32, as in the reference.  The
partial sums of the reduction modes accumulate at most ``npad`` (the
pool padded to the axis size) int32 values < p, so the requirement is
``npad * p < 2**31``, independent of ``n_workers``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.modmatmul.ops import mod_matmul
from .planner import CMPCPlan
from .protocol import resolve_device

MODES = ("all_to_all", "psum", "psum_scatter")


def workers_mesh(device_type: str, axis: str = "workers"):
    """A 1-D ``DeviceMesh`` named ``axis`` over every rank of the
    initialized default process group (the counterpart of
    ``Mesh(np.array(jax.devices()), ("workers",))``).  The group must be
    initialized by the caller: this never starts one."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("initialize the default process group before building the mesh")
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: the CPU for a CPU mesh, else the
    current CUDA device (``resolve_device``, which raises without one)."""
    return resolve_device("cpu" if mesh.device_type == "cpu" else None)


def _on(x, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``device``: a numpy array is uploaded; a tensor
    must already be on a device of that type."""
    if isinstance(x, torch.Tensor):
        if x.device.type != device.type:
            raise ValueError(
                f"a {device.type} mesh cannot take tensors on {x.device}: the exchange "
                "neither stages through the host nor switches backend"
            )
        return x.to(device)
    x = np.asarray(x)
    return torch.as_tensor(x if x.flags.writeable else x.copy(), device=device)


def run_phase2_sharded(
    plan: CMPCPlan,
    fa,
    fb,
    noise,
    mesh,
    axis: str = "workers",
    mode: str = "all_to_all",
    matmul_backend: str = "auto",
    worker_ids: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Workers compute H and run the G-exchange over a device mesh.

    fa: [n_total, br, bk] shares, fb: [n_total, bk, bc]; noise:
    [n_workers, z, br, bc] per-worker blinding matrices R_w^{(n)}.
    Batched: fa [batch, n_total, br, bk], fb [batch, n_total, bk, bc],
    noise [batch, n_workers, z, br, bc] -- the batch folds into each
    worker's flat payload, so the whole batch rides ONE collective.
    Operands are numpy arrays or tensors on the mesh's device type.

    Every rank of ``mesh`` calls this with the same arguments (SPMD).
    Rank r owns workers [r*nloc, (r+1)*nloc) of the padded pool: it
    multiplies their shares (one batched ``mod_matmul`` on
    ``matmul_backend``), evaluates their G at every receiver, and joins
    the collective of ``mode``; a final ``all_gather_into_tensor`` of
    the receivers' I gives every rank the same int32 result, I(alpha_n)
    for all provisioned workers: [n_total, br, bc], or [batch, n_total,
    br, bc] for batched inputs, on the rank's device.

    ``worker_ids`` selects which ``n_workers`` of the provisioned pool
    serve as Phase-2 senders (straggler mitigation, e.g. the fastest
    subset the edge runtime picked); ``noise`` rows follow the same
    order.  Non-senders are receive-only (zero mix rows), as the pad
    workers are.  The default is the primary prefix; explicit subsets
    reuse the plan's cached subset mix matrices.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode}")
    p = plan.field.p
    dim = mesh.mesh_dim_names.index(axis)
    d = mesh.size(dim)
    rank = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    n_total = plan.n_total
    # the partial sums accumulate <= npad int32 values < p before reducing,
    # so the bound is npad * p (padded pool size; n_workers plays no role).
    npad = n_total + ((-n_total) % d)
    assert npad * p < (1 << 31), "int32 reduction bound: npad * p < 2**31"
    device = mesh_device(mesh)

    if worker_ids is None:
        ids = np.arange(plan.n_workers)
        mix = plan.mix
    else:
        ids = np.asarray(worker_ids)
        mix = plan.phase2_matrix_cached(ids)

    fa_t, fb_t, noise_t = _on(fa, device), _on(fb, device), _on(noise, device)
    batched = fa_t.dim() == 4
    if not batched:
        fa_t, fb_t, noise_t = fa_t[None], fb_t[None], noise_t[None]
    batch, _, br, bk = fa_t.shape
    bc = fb_t.shape[-1]
    z = plan.scheme.z
    blk = batch * br * bc  # per-worker flat payload (whole batch)
    nloc = npad // d
    lo = rank * nloc
    real = max(0, min(nloc, n_total - lo))  # this rank's workers that exist

    # Phase 2a: the local workers multiply their shares; the worker axis
    # leads and the batch joins the payload.  Pad workers multiply zeros.
    fa_l = torch.zeros((nloc, batch, br, bk), dtype=torch.int32, device=device)
    fb_l = torch.zeros((nloc, batch, bk, bc), dtype=torch.int32, device=device)
    fa_l[:real] = fa_t[:, lo:lo + real].movedim(1, 0)
    fb_l[:real] = fb_t[:, lo:lo + real].movedim(1, 0)
    h = mod_matmul(fa_l, fb_l, p=p, backend=matmul_backend).reshape(nloc, blk)
    del fa_l, fb_l
    h = h.to(torch.int64)

    # Phase 2b: the local workers' G evaluated at every receiver,
    #   contrib[s, r, :] = mix[s, r] * H[s] + sum_w R_w[s] * vn[r, w]  (mod p),
    # with zero mix rows and zero noise for non-senders and pad workers.
    mix_rows = np.zeros((npad, npad), np.int64)
    mix_rows[ids, :n_total] = mix % p  # [senders, receivers]
    vn = np.zeros((npad, z), np.int64)
    vn[:n_total] = plan.vnoise % p
    # noise rows follow ids; the local layout [nloc, z, blk] flattens the
    # batch into the payload in H's order (batch, br, bc).
    pos = np.full(npad, -1, np.int64)
    pos[ids] = np.arange(ids.size)
    rows = pos[lo:lo + nloc]
    nz = torch.zeros((nloc, z, batch, br, bc), dtype=torch.int64, device=device)
    have = np.flatnonzero(rows >= 0)
    if have.size:
        src = noise_t.index_select(1, torch.as_tensor(rows[have], device=device))
        nz[torch.as_tensor(have, device=device)] = src.movedim(0, 2).to(torch.int64)
    nz = nz.reshape(nloc, z, blk)
    mix_l = torch.as_tensor(mix_rows[lo:lo + nloc], device=device)  # [nloc, npad]

    def contrib(r: int) -> torch.Tensor:
        """G of the local senders at receiver r: int64 [nloc, blk] < (1+z) p^2."""
        acc = mix_l[:, r, None] * h
        for w in range(z):
            acc += nz[:, w] * int(vn[r, w])
        return acc

    if mode == "all_to_all":
        # send[j, s, r_loc] = contrib[s, j*nloc + r_loc]: rank j's receivers'
        # chunk is contiguous and sender-major, so the received
        # [d*nloc senders, nloc receivers, blk] sums over dim 0
        send = torch.empty((d, nloc, nloc, blk), dtype=torch.int32, device=device)
        for r in range(npad):
            send[r // nloc, :, r % nloc] = contrib(r) % p
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        del send
        i_local = _mod_sum(recv.reshape(npad, nloc, blk), p)
    else:
        part = torch.empty((npad, blk), dtype=torch.int32, device=device)
        for r in range(npad):
            part[r] = _mod_sum(contrib(r) % p, p)
        if mode == "psum":
            dist.all_reduce(part, group=group)
            i_local = part[lo:lo + nloc] % p
        else:
            i_local = torch.empty((nloc, blk), dtype=torch.int32, device=device)
            dist.reduce_scatter_tensor(i_local, part, group=group)
            i_local %= p
    i_all = torch.empty((npad, blk), dtype=torch.int32, device=device)
    dist.all_gather_into_tensor(i_all, i_local.contiguous(), group=group)
    i_evals = i_all[:n_total].reshape(n_total, batch, br, bc).movedim(1, 0)
    return i_evals if batched else i_evals[0]


def _mod_sum(x: torch.Tensor, p: int) -> torch.Tensor:
    """Sum over axis 0 mod p (``torch.sum`` accumulates int32 in int64:
    exact), as int32."""
    return (torch.sum(x, dim=0) % p).to(torch.int32)
