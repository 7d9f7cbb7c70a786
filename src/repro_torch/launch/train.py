"""Training driver: the counterpart of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch minicpm-2b \\
        --steps 100 --mesh 1x1 --reduced --ckpt-dir results/run0 [--device cpu]
    python -m repro_torch.launch.train --arch minicpm-2b --steps 4 --mesh 1x1 --log-every 1

The reference's flags, schedules, data and printed lines (``training
...``, ``step ... loss ... lr ... gnorm ... tok/s``, ``auto-resumed from
step N``, ``done``): a trainable model (float32 weights) initialised
from seed 0, ``SyntheticLM`` batches by step index, the microbatched
AdamW step of ``launch.steps``, atomic checkpoints every
``--ckpt-every`` steps and at the end, and auto-resume from the latest
checkpoint under ``--ckpt-dir`` (in the reference's layout: each
package resumes from the other's).

``--device`` picks the device (default: the GPU; ``cpu`` on request).
Run as one process, the port trains on that one device (``--mesh``
``elastic`` or ``1x1``).  Under ``torchrun`` every process is one rank
of a ``(data, model)`` mesh (``--mesh DxM`` or ``elastic`` over the
world size; ``gloo`` ranks on the CPU with ``--device cpu``, else one
``nccl`` rank per card):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch minicpm-2b \
        --reduced --mesh 2x2 --device cpu --steps 4

The model is drawn leaf by leaf and sharded as it is drawn (FSDP + TP
by ``distributed/sharding.py``), trained by ``launch.steps``'s sharded
bundle, and checkpointed whole (rank 0 writes; a checkpoint of any mesh
or of one device resumes on any other).  Every rank builds each step's
global batch, process 0 of 1 of ``SyntheticLM``'s contract as the
reference's single controller does, and the bundle places its own data
shard.  Rank 0 prints the reference's lines.  Every family trains on a
mesh (the reference's launcher takes ``DxM`` alone; a ``(pod, data,
model)`` mesh is ``launch.mesh.make_production_mesh(multi_pod=True)`` or
``make_mesh`` with the bundles).
"""
import argparse
import dataclasses
import time

import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager
from ..configs import SHAPES, get_config, reduced as reduce_cfg
from ..core.protocol import resolve_device
from ..data.pipeline import DataConfig, SyntheticLM
from ..models import build_model
from ..train.optimizer import adamw_init
from .mesh import describe, distributed_launch, init_from_env, mesh_from_flag
from .serve import ONE_DEVICE_MESHES, one_device_mesh
from .steps import build_train_step, restore_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="elastic",
                    help=f"'elastic' or DxM like 2x2 under torchrun; one process: "
                         f"{' or '.join(ONE_DEVICE_MESHES)}")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default=None, help="cosine|wsd (arch default)")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--microbatch-seqs", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="the device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    schedule = args.schedule or ("wsd" if args.arch == "minicpm-2b" else "cosine")
    mesh = None
    if distributed_launch():
        device = init_from_env(args.device)
        mesh = mesh_from_flag(args.mesh, device.type)
        where = describe(mesh)
    else:
        one_device_mesh(args.mesh)
        device = resolve_device(args.device)
        where = f"{device} (one device)"
    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    model = (build_model(cfg, seed=0, device=device, train=True) if mesh is None
             else build_model(cfg, seed=0, device=device, train=True, mesh=mesh))
    say(f"training {args.arch} on {where}; schedule={schedule}")

    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=args.seq_len, global_batch=args.global_batch)
    step_fn = build_train_step(model, mesh, shape, lr=args.lr, schedule=schedule,
                               total_steps=args.steps, microbatch_seqs=args.microbatch_seqs)
    params = model.params()
    opt = adamw_init(params, step_fn.opt_cfg)

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if mgr.latest_step() is not None:
            start, opt = restore_train_state(mgr, params, opt)
            say(f"auto-resumed from step {start}")

    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq_len, args.global_batch))
    t0 = time.time()
    tokens_per_step = args.seq_len * args.global_batch
    for i in range(start, args.steps):
        params, opt, metrics = step_fn(params, opt, data.batch(i))
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            done = i - start + 1
            say(
                f"step {i:5d} loss {float(metrics['loss']):.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f} "
                f"{tokens_per_step * done / max(dt, 1e-9):,.0f} tok/s"
            )
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, {"params": params, "opt": opt._asdict()})
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt._asdict()})
    say("done")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
