"""End-to-end training example on the PyTorch port: train a MiniCPM-family
model on the synthetic Markov corpus with checkpointing + auto-resume.
The counterpart of ``examples/train_lm.py``: the same profiles, WSD
schedule, data and checkpoints (in the reference's layout).

    PYTHONPATH=src python examples/torch/train_lm.py --steps 200 --profile 100m

(The default ``tiny`` profile runs in well under a minute on the CPU with
``--device cpu``; ``100m`` is ~109M parameters.)
"""
import argparse
import dataclasses
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.core.protocol import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.steps import build_train_step, restore_train_state
from repro_torch.models import build_model
from repro_torch.models.common import iter_leaves
from repro_torch.train.optimizer import adamw_init

PROFILES = {
    # ~100M params: d=768, 12 layers (MiniCPM recipe incl. WSD schedule)
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
                 head_dim=64, d_ff=2048, vocab_size=32_000),
    "tiny": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
                 head_dim=32, d_ff=256, vocab_size=2_048),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--profile", default="tiny", choices=PROFILES)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="results/train_lm_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="the device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(reduced(get_config("minicpm-2b")), **PROFILES[args.profile])
    device = resolve_device(args.device)
    model = build_model(cfg, seed=0, device=device, train=True)
    params = model.params()
    n_params = sum(p.numel() for _, p in iter_leaves(params))
    print(f"model: {cfg.name} ({args.profile}) ~{n_params / 1e6:.1f}M params on {device}")

    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq_len, args.batch))
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    # one micro-step of the whole batch; the MiniCPM WSD schedule
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=args.seq_len, global_batch=args.batch)
    step = build_train_step(model, shape, lr=6e-4, schedule="wsd", total_steps=args.steps,
                            microbatch_seqs=args.batch)

    opt = adamw_init(params, step.opt_cfg)
    start = 0
    if mgr.latest_step() is not None:  # auto-resume after preemption
        start, opt = restore_train_state(mgr, params, opt)
        print(f"resumed from step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        params, opt, m = step(params, opt, data.batch(i))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  lr {float(m['lr']):.2e}  "
                  f"({(time.time()-t0):.1f}s)")
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, {"params": params, "opt": opt._asdict()})
    mgr.save(args.steps, {"params": params, "opt": opt._asdict()})
    print("done; checkpoints in", args.ckpt_dir)


if __name__ == "__main__":
    main()
