"""Batched serving on the PyTorch port: prefill a batch of prompts, then
decode with temperature sampling against the KV (or recurrent-state)
cache.  The counterpart of ``examples/serve_lm.py`` at the same toy
scale (the reduced config of ``--arch``, random weights from seed 0).

    PYTHONPATH=src python examples/torch/serve_lm.py --arch zamba2-2.7b [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.core.protocol import resolve_device
from repro_torch.models import build_model


def sample(logits, vocab, rng, temperature=0.8):
    """Temperature sampling, vectorized over the batch: one inverse-CDF
    draw per row."""
    logits = logits[:, -1, :vocab].float().cpu().numpy() / temperature
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    cum = probs.cumsum(-1)
    u = rng.random((probs.shape[0], 1)) * cum[:, -1:]
    return np.minimum((cum < u).sum(-1), vocab - 1).astype(np.int32)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b", choices=ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default=None, help="the device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    if cfg.family == "encdec":
        raise SystemExit("pick a decoder-family arch for this example")
    device = resolve_device(args.device)
    model = build_model(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)

    b = args.batch
    max_len = args.prompt_len + args.gen_len
    prompts = rng.integers(0, cfg.vocab_size, (b, args.prompt_len)).astype(np.int32)
    cache = model.init_cache(b, max_len)
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(b, 4, cfg.d_model)).astype(np.float32)
        # patches occupy cache slots before the text
        cache = model.init_cache(b, max_len + 4)

    t0 = time.time()
    logits, cache = model.prefill(batch, cache)
    _sync(device)
    t_prefill = time.time() - t0

    offset = 4 if cfg.family == "vlm" else 0
    tok = sample(logits, cfg.vocab_size, rng)
    generated = [tok]
    t0 = time.time()
    for i in range(args.gen_len - 1):
        pos = np.full((b, 1), offset + args.prompt_len + i, np.int32)
        logits, cache = model.decode_step(tok[:, None], cache, pos)
        tok = sample(logits, cfg.vocab_size, rng)
        generated.append(tok)
    dt = time.time() - t0
    gen = np.stack(generated, axis=1)
    print(f"arch={args.arch} family={cfg.family} device={device}")
    print(f"prefill {args.prompt_len} toks x{b}: {t_prefill*1e3:.1f} ms")
    print(f"decode  {args.gen_len} steps x{b}: {dt*1e3:.1f} ms "
          f"({dt/args.gen_len*1e3:.2f} ms/step)")
    print("sampled token ids (seq 0):", gen[0][:16], "...")
    return gen


if __name__ == "__main__":
    main()
