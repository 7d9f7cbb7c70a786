"""Private inference served at the edge on the PyTorch port: several
clients' MLP queries multiplexed through the CMPC serving engine (Phase 2
sharded over a ``workers`` mesh of ranks), with per-request SLOs and
continuous batching.  The counterpart of ``examples/private_inference.py``.

Each linear layer's weights stay private to the model owner: one
:class:`~repro_torch.serve.ServingEngine` per layer holds the encoded
weight operand, clients submit activation rows with simulated arrival
times, and the engine folds concurrent requests into in-flight protocol
replays.  The nonlinearity (ReLU) runs in the clear at each client
between layers, so a client's layer-2 request arrives exactly when its
layer-1 response completes.

    PYTHONPATH=src python examples/torch/private_inference.py              # one NCCL rank on the GPU
    PYTHONPATH=src python examples/torch/private_inference.py --device cpu --ranks 8

The mesh: one rank on the device (NCCL on the GPU, gloo on the CPU), or
``--ranks N`` gloo ranks on the CPU, spawned processes that meet at a
``FileStore`` in a temporary directory (the reference's 8 host devices).
Every rank serves the same requests (SPMD); rank 0 prints and checks.
"""
import argparse
import multiprocessing as mp
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.constructions import PlanConfig
from repro_torch.core.distributed import mesh_device, workers_mesh
from repro_torch.core.protocol import resolve_device
from repro_torch.core.gf import Field
from repro_torch.runtime.pool import ShiftedExponential, sample_trace
from repro_torch.serve import ServingEngine

N_CLIENTS = 6
POOL = 20
SLO = 25.0
JOIN_SECONDS = 600


def make_engine(w, traces, mesh, field):
    """One serving engine per private layer operand."""
    return ServingEngine(
        w,
        traces,
        PlanConfig("age", s=2, t=2, z=2),
        field=field,
        mesh=mesh,
        slo=SLO,
        validate=True,  # every decode checked against the field oracle
        seed=0,
        device=mesh_device(mesh),
    )


def serve(mesh) -> dict:
    """Both layers' engines over ``mesh``: the summaries, the workload's
    relative error, the worst end-to-end latency, whether every request
    was served."""
    field = Field()
    rng = np.random.default_rng(7)

    # a tiny 2-layer MLP; weights private to the model owner, activations
    # private to each querying client
    w1 = rng.normal(size=(16, 32)) * 0.5
    w2 = rng.normal(size=(32, 8)) * 0.5
    xs = [rng.normal(size=(4, 16)) for _ in range(N_CLIENTS)]  # [rows, k]
    arrivals = np.cumsum(rng.exponential(0.4, N_CLIENTS))

    # one replayable trace per protocol launch: heterogeneous edge pool
    traces = [
        sample_trace(POOL, ShiftedExponential(0.1, 0.5), seed=i, net_scale=0.3)
        for i in range(8)
    ]

    eng1 = make_engine(w1, traces, mesh, field)
    reqs1 = [eng1.submit(x, float(t)) for x, t in zip(xs, arrivals)]
    eng1.run()

    # ReLU in the clear at each client; the layer-2 request arrives the
    # moment the client holds its layer-1 response.
    eng2 = make_engine(w2, traces, mesh, field)
    reqs2 = [eng2.submit(np.maximum(r.y, 0.0), r.completion) for r in reqs1]
    rep2 = eng2.run()

    # one workload-level relative error: the worst absolute deviation
    # over every client, against the workload's output magnitude
    refs = [np.maximum(x @ w1, 0.0) @ w2 for x in xs]
    served = all(r.y is not None for r in reqs2)
    worst = float("inf")
    if served:
        abs_err = max(np.abs(r2.y - ref).max() for r2, ref in zip(reqs2, refs))
        worst = float(abs_err / (max(np.abs(ref).max() for ref in refs) + 1e-9))
    e2e = [r2.completion - r1.arrival for r1, r2 in zip(reqs1, reqs2)]
    return {"layer1": eng1.report().summary(), "layer2": rep2.summary(), "rel_err": worst,
            "e2e_worst": max(e2e), "served": served}


def report(res: dict, ranks: int, device) -> None:
    s1, s2 = res["layer1"], res["layer2"]
    print(f"ranks as workers: {ranks} ({device})")
    print(
        f"{N_CLIENTS} clients through a private 2-layer MLP: "
        f"{s1['replays']} + {s2['replays']} protocol replays "
        f"(continuous batching folded concurrent clients)"
    )
    print(
        f"layer latency p95: {s1['p95_latency']:.2f}s / "
        f"{s2['p95_latency']:.2f}s, end-to-end worst {res['e2e_worst']:.2f}s, "
        f"deadline misses {s1['deadline_misses'] + s2['deadline_misses']}"
    )
    print(
        f"relative error vs cleartext: {res['rel_err']:.4f} "
        "(16-bit fixed point; use secure_matmul_crt for ~2e-3)"
    )
    assert res["served"], "a request was shed"
    assert res["rel_err"] < 0.15


def _one_rank(device: torch.device) -> dict:
    """One rank on ``device``: NCCL on the GPU, gloo on the CPU, from an
    in-process store."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        return serve(workers_mesh(device.type))
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, ranks: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, ranks), rank=rank,
                            world_size=ranks)
    try:
        res = serve(workers_mesh("cpu"))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        report(res, ranks, "cpu")


def _spawn_ranks(ranks: int) -> None:
    tmp = tempfile.mkdtemp()
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(r, ranks, os.path.join(tmp, "store")))
                 for r in range(ranks)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(JOIN_SECONDS)
        hung = [proc for proc in procs if proc.is_alive()]
        for proc in hung:
            proc.kill()
            proc.join()
        codes = [proc.exitcode for proc in procs]
        if hung or any(codes):
            raise SystemExit(f"ranks failed: exit codes {codes}, {len(hung)} hung")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="the device (default: the GPU)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="gloo ranks on the CPU (more than 1 needs --device cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.ranks == 1:
        report(_one_rank(device), 1, device)
        return
    if device.type != "cpu":
        raise SystemExit("--ranks > 1 spawns gloo ranks on the CPU: pass --device cpu")
    _spawn_ranks(args.ranks)


if __name__ == "__main__":
    main()
