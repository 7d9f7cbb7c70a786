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
The port trains on one device: ``--mesh`` takes ``elastic`` or ``1x1``,
both meaning that device.  A ``(data, model)`` mesh of several devices
shards the model and its optimizer state (FSDP + TP,
``distributed/sharding.py``) and waits for ROADMAP 13b.
"""
import argparse
import dataclasses
import time

from ..checkpoint.manager import CheckpointManager
from ..configs import SHAPES, get_config, reduced as reduce_cfg
from ..core.protocol import resolve_device
from ..data.pipeline import DataConfig, SyntheticLM
from ..models import build_model
from ..train.optimizer import adamw_init
from .serve import ONE_DEVICE_MESHES, one_device_mesh
from .steps import build_train_step, restore_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="elastic", help=f"one device: {' or '.join(ONE_DEVICE_MESHES)}")
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

    one_device_mesh(args.mesh)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    schedule = args.schedule or ("wsd" if args.arch == "minicpm-2b" else "cosine")
    device = resolve_device(args.device)
    model = build_model(cfg, seed=0, device=device, train=True)
    print(f"training {args.arch} on {device} (one device); schedule={schedule}")

    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=args.seq_len, global_batch=args.global_batch)
    step_fn = build_train_step(model, shape, lr=args.lr, schedule=schedule,
                               total_steps=args.steps, microbatch_seqs=args.microbatch_seqs)
    params = model.params()
    opt = adamw_init(params, step_fn.opt_cfg)

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if mgr.latest_step() is not None:
            start, opt = restore_train_state(mgr, params, opt)
            print(f"auto-resumed from step {start}")

    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq_len, args.global_batch))
    t0 = time.time()
    tokens_per_step = args.seq_len * args.global_batch
    for i in range(start, args.steps):
        params, opt, metrics = step_fn(params, opt, data.batch(i))
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            done = i - start + 1
            print(
                f"step {i:5d} loss {float(metrics['loss']):.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f} "
                f"{tokens_per_step * done / max(dt, 1e-9):,.0f} tok/s"
            )
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, {"params": params, "opt": opt._asdict()})
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt._asdict()})
    print("done")


if __name__ == "__main__":
    main()
