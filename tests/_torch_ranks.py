"""Gloo ranks on the CPU for the port's sharded Phase 2.

``run_ranks(d, tmp, job, *args)`` spawns ``d`` processes, each joins a
gloo group of size ``d`` from a ``FileStore`` under ``tmp`` (no port is
needed), builds the ``workers`` mesh and calls ``job(mesh, *args)``
(``ranks_job`` below); every rank's result comes back as a list, in
rank order.  The children import only ``repro_torch`` and numpy: what
they compare against is computed by the parent and handed over as
arrays.
"""
import multiprocessing as mp
import os
import pickle
import traceback

JOIN_SECONDS = 120


def run_ranks(d: int, tmp, job, *args) -> list:
    tmp = str(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, d, tmp, job, args)) for rank in range(d)]
    for proc in procs:
        proc.start()
    try:
        for proc in procs:
            proc.join(JOIN_SECONDS)
    finally:
        hung = [proc for proc in procs if proc.is_alive()]
        for proc in hung:
            proc.kill()
            proc.join()
    errors = []
    for rank, proc in enumerate(procs):
        path = os.path.join(tmp, f"rank{rank}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
    if hung or errors or any(proc.exitcode != 0 for proc in procs):
        raise AssertionError(
            f"ranks failed (exit codes {[proc.exitcode for proc in procs]}, "
            f"{len(hung)} hung)\n" + "\n".join(errors)
        )
    out = []
    for rank in range(d):
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, d: int, tmp: str, job, args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import workers_mesh

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), d), rank=rank, world_size=d
        )
        try:
            out = job(workers_mesh("cpu"), *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _plan(spec: dict):
    from repro_torch.core import constructions, planner

    scheme = constructions.build_scheme(*spec["scheme"])
    return planner.make_plan(
        scheme, planner.BlockShapes(**spec["shapes"]), n_spare=spec["n_spare"], seed=spec["seed"]
    )


def ranks_job(mesh, spec: dict, fa, fb, noise, cases, edge_calls) -> tuple:
    """``run_phase2_sharded`` for each (mode, sender ids) of ``cases`` (host
    I), and ``run_batch_over_pool(mesh=...)`` for each (a, b, trace,
    kwargs) of ``edge_calls``: (y, metrics, per-product metrics)."""
    from repro_torch.core.distributed import run_phase2_sharded
    from repro_torch.runtime import run_batch_over_pool

    plan = _plan(spec)
    i_evals = [
        run_phase2_sharded(plan, fa, fb, noise, mesh, mode=mode, worker_ids=ids).numpy()
        for mode, ids in cases
    ]
    runs = []
    for a, b, trace, kw in edge_calls:
        run = run_batch_over_pool(plan, a, b, trace, mesh=mesh, device="cpu", **kw)
        runs.append((run.y, run.metrics, run.per_product))
    return i_evals, runs
