"""Serving launcher: batched prefill + greedy decode of a language model.

    python -m repro_torch.launch.serve --arch mistral-nemo-12b --reduced \\
        --batch 4 --prompt-len 32 --gen-len 32 [--private-head] [--device cpu]
    python -m repro_torch.launch.serve --arch internvl2-26b --private-head
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --prompt-len 4096 --gen-len 8
    python -m repro_torch.launch.serve --arch xlstm-1.3b --prompt-len 256 --gen-len 8
    python -m repro_torch.launch.serve --arch zamba2-2.7b --prompt-len 256 --gen-len 8

The counterpart of ``repro.launch.serve``, with its flags, prompts,
traces and printed lines.  ``--private-head`` keeps the transformer
trunk local but routes every decode step's lm-head matmul
(``hidden @ W_head``) through the CMPC serving engine: the head matrix
stays the layer owner's private operand, each step's hidden states are
a request against it, and the reported latencies are the engine's
simulated protocol time.

``--device`` picks the device (default: the GPU; ``cpu`` on request).
Run as one process, the port serves on that one device (``--mesh``
``elastic`` or ``1x1``).  Under ``torchrun`` every process is one rank
of a ``(data, model)`` mesh (``--mesh DxM`` or ``elastic``; ``gloo``
ranks on the CPU with ``--device cpu``, else one ``nccl`` rank per
card), the model is sharded as it is drawn, and the prefill and each
decode step run as ``launch.steps``'s sharded bundles.  (The reference
builds its mesh but runs an unsharded ``jit``; a torch rank holds only
its shards, so the port runs the bundles: ROADMAP C14.)  With
``--private-head`` on a mesh the trunk's ``hidden_step`` runs under the
decode bundle's rules, and every rank gathers the head and runs the
same ``ServingEngine`` from the same seed, so the tokens and the summary
are the one-device run's.  Rank 0 prints.  The dense and moe families
run on a mesh; the others raise there (ROADMAP 13c).  The ported families: dense; moe (DBRX's GQA trunk,
DeepSeek-V2's MLA trunk with its dense first layer); vlm (InternVL2's
decoder; the launcher, as the reference's, passes no patches); and
encdec.  An encoder-decoder's prefill encodes ``--prompt-len`` frames
[B, prompt_len, d_model] (normals from the same ``default_rng(0)``,
drawn after the prompts, as the reference draws them) and prefills the
decoder with the prompts' first token; decode positions then start at
``--prompt-len`` while the decoder's cache slot starts at 1, as there.
The recurrent families: ssm (xLSTM: its prefill scans the prompts and
keeps the final sLSTM/mLSTM states as the caches) and hybrid (Zamba2:
Mamba2 states, and the shared attention block's KV caches).  The private
head takes every decoder alike (DeepSeek-V2-Lite's is ``[2048, 102400]``
float32, InternVL2's ``[6144, 92672]``); an encoder-decoder and the
recurrent families have no split lm head, and ``--private-head`` refuses
them after the prefill, as the reference's.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import SHAPES, get_config, reduced as reduce_cfg
from ..core.protocol import resolve_device
from ..models import build_model
from .mesh import describe, distributed_launch, init_from_env, mesh_from_flag

ONE_DEVICE_MESHES = ("elastic", "1x1")


def one_device_mesh(mesh: str) -> None:
    """Raises unless ``--mesh`` names the one device the port runs on."""
    if mesh not in ONE_DEVICE_MESHES:
        raise NotImplementedError(
            f"--mesh {mesh}: the port runs on one device ({' or '.join(ONE_DEVICE_MESHES)}); "
            "a (data, model) mesh of several devices waits for the model's sharding "
            "(distributed/sharding.py, ROADMAP 13b)"
        )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default="elastic")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument(
        "--private-head", action="store_true",
        help="run each decode step's lm-head matmul under CMPC via the "
        "serving engine (decoder families only)",
    )
    ap.add_argument(
        "--workers", type=int, default=16,
        help="simulated edge pool size for --private-head",
    )
    ap.add_argument("--device", default=None, help="the device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    max_len = args.prompt_len + args.gen_len
    mesh = None
    if distributed_launch():
        from .steps import SHARDED_FAMILIES

        if cfg.family not in SHARDED_FAMILIES:
            raise NotImplementedError(f"{args.arch}: the {cfg.family} family on a mesh is ROADMAP 13c")
        device = init_from_env(args.device)
        mesh = mesh_from_flag(args.mesh, device.type)
        where = describe(mesh)
    else:
        one_device_mesh(args.mesh)
        device = resolve_device(args.device)
        where = f"{device} (one device)"
    say = print if mesh is None or dist.get_rank() == 0 else (lambda *a, **k: None)
    model = (build_model(cfg, seed=0, device=device) if mesh is None
             else build_model(cfg, seed=0, device=device, mesh=mesh))
    say(f"serving {args.arch} on {where}")
    steps_of = _Steps(model, mesh, args.batch, max_len)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    cache = model.init_cache(args.batch, max_len)

    batch = {"tokens": prompts}
    if cfg.family == "encdec":
        frames = rng.normal(size=(args.batch, args.prompt_len, cfg.d_model)).astype(np.float32)
        batch = {"frames": frames, "tokens": prompts[:, :1]}
    t0 = time.perf_counter()
    logits, cache = steps_of.prefill(batch, cache)
    _sync(device)
    t_pre = time.perf_counter() - t0

    tok = argmax_last(logits, cfg.vocab_size)
    t0 = time.perf_counter()
    if args.private_head:
        steps, report, worst = _decode_private_head(args, cfg, model, cache, tok, steps_of)
    else:
        steps = 0
        for i in range(args.gen_len - 1):
            pos = np.full((args.batch, 1), args.prompt_len + i, np.int32)
            logits, cache = steps_of.decode_step(tok[:, None], cache, pos)
            tok = argmax_last(logits, cfg.vocab_size)
            steps += 1
        _sync(device)
    dt = time.perf_counter() - t0
    say(f"prefill: {t_pre * 1e3:.1f} ms for {args.prompt_len} x {args.batch} tokens")
    say(f"decode : {dt / max(steps, 1) * 1e3:.2f} ms/step (batch {args.batch})")
    if args.private_head:
        s = report.summary()
        say(
            f"private head: {s['replays']} protocol replays over {steps} steps "
            f"on {args.workers} workers, sim latency p50 {s['p50_latency']:.3f}s "
            f"p95 {s['p95_latency']:.3f}s, max |logit err| {worst:.3e}"
        )
    if mesh is not None:
        dist.destroy_process_group()


class _Steps:
    """The model's serving calls: its own methods on one device; on a
    mesh the sharded prefill, decode and hidden-step bundles, whose
    outputs come back whole (``full_tensor``) as the reference's
    controller gets them."""

    def __init__(self, model, mesh, batch: int, max_len: int):
        self.model, self.mesh = model, mesh
        if mesh is None:
            return
        from .steps import build_decode_step, build_prefill_step

        dec = dataclasses.replace(SHAPES["decode_32k"], seq_len=max_len, global_batch=batch)
        pre = dataclasses.replace(SHAPES["prefill_32k"], seq_len=max_len, global_batch=batch)
        self._prefill = build_prefill_step(model, mesh, pre)
        self._decode = build_decode_step(model, mesh, dec)
        self._hidden = build_decode_step(model, mesh, dec, hidden=True)

    def prefill(self, batch, cache):
        if self.mesh is None:
            return self.model.prefill(batch, cache)
        logits, cache = self._prefill(self.model.params(), batch, cache)
        return logits.full_tensor(), cache

    def decode_step(self, tokens, cache, positions):
        if self.mesh is None:
            return self.model.decode_step(tokens, cache, positions)
        logits, cache = self._decode(self.model.params(), cache, tokens, positions)
        return logits.full_tensor(), cache

    def hidden_step(self, tokens, cache, positions):
        if self.mesh is None:
            return self.model.hidden_step(tokens, cache, positions)
        hidden, cache = self._hidden(self.model.params(), cache, tokens, positions)
        return hidden.full_tensor(), cache

    def head_matrix(self) -> torch.Tensor:
        head = self.model.head_matrix()
        return head.full_tensor() if self.mesh is not None else head


def _decode_private_head(args, cfg, model, cache, tok, steps_of=None):
    """Greedy decode with every step's lm-head matmul served by the
    CMPC engine on the model's device.  Rows / head columns / the
    contraction dim are zero-padded up to the construction's
    divisibility (s | k, t | rows, t | out); zero padding contributes
    zero in the field, so the sliced logits are the exact fixed-point
    head product.  Returns (steps, the engine's report, the worst
    |logit - x @ W| over the steps)."""
    from ..core.constructions import PlanConfig
    from ..runtime.pool import ShiftedExponential, sample_trace
    from ..serve import ServingEngine

    if model.hidden_step is None or model.head_matrix is None:
        raise SystemExit(
            "--private-head needs a decoder family with a split lm head; "
            f"family {cfg.family!r} does not expose one"
        )
    steps_of = steps_of or _Steps(model, None, args.batch, 0)
    w = steps_of.head_matrix().cpu().numpy().astype(np.float64)  # [d_model, vocab]
    plan_cfg = PlanConfig()
    k, vocab = w.shape
    pad_k = (-k) % plan_cfg.s
    pad_out = (-vocab) % plan_cfg.t
    pad_rows = (-args.batch) % plan_cfg.t
    traces = [
        sample_trace(args.workers, ShiftedExponential(0.1, 0.5), seed=s, net_scale=0.3)
        for s in range(4)
    ]
    engine = ServingEngine(
        np.pad(w, ((0, pad_k), (0, pad_out))), traces, plan_cfg, seed=0, device=model.device
    )
    arrival, worst, steps = 0.0, 0.0, 0
    for i in range(args.gen_len - 1):
        pos = np.full((args.batch, 1), args.prompt_len + i, np.int32)
        hidden, cache = steps_of.hidden_step(tok[:, None], cache, pos)
        x = hidden[:, -1, :].float().cpu().numpy().astype(np.float64)
        # The next head matmul cannot be requested before the previous
        # token is known: arrivals chain on completions.
        req = engine.submit(np.pad(x, ((0, pad_rows), (0, pad_k))), arrival)
        engine.run()
        if req.y is None:
            raise SystemExit(
                f"step {i}: request shed ({req.shed_reason}); a pool of "
                f"{args.workers} workers cannot serve the head — raise --workers"
            )
        logits = req.y[: args.batch, :vocab]
        worst = max(worst, float(np.abs(logits - x @ w).max()))
        tok = logits.argmax(-1).astype(np.int32)
        arrival = req.completion
        steps += 1
    return steps, engine.report(), worst


def head_error_bound(x: np.ndarray, w: np.ndarray, scale: int) -> float:
    """The most a served logit can differ from ``x @ w`` when both are
    quantised at ``scale`` (``Field.encode`` rounds to the nearest
    1/scale, so each entry moves by at most 1/(2 scale)): per output,
    sum_k |x_k| |dw_k| + |w_k| |dx_k| + |dx_k dw_k|, at most
    (max row of ||x||_1 + max column of ||w||_1) / (2 scale) + k / (4 scale**2)."""
    k = x.shape[-1]
    spread = np.abs(x).sum(-1).max() + np.abs(w).sum(0).max()
    return float(spread / (2 * scale) + k / (4 * scale**2))


def argmax_last(logits: torch.Tensor, vocab: int) -> np.ndarray:
    """Greedy tokens [B] (int32, on the host) from the last position's
    logits over the real vocabulary."""
    return logits[:, -1, :vocab].argmax(-1).to(torch.int32).cpu().numpy()


if __name__ == "__main__":
    main()
