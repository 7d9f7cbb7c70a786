#!/usr/bin/env python3
"""Device time of the private FFN stack by ``moe.*`` span, at a benchmark cell's shapes.

    python3 cmpcbench/moe_profile.py --workload dsv3-moe.decode --seed 5400000017 \\
        [--seconds 6] [--out results/moe]

Run from the root of a checkout on a machine with a CUDA card.  For the
cell it builds the harness's session (the fixed weights, the program's
plans and the hidden states from the seed), warms it as a traced run
does, and then runs a traced ``Session.window`` of ``--seconds`` with the
port's ``TRACER`` on (its profiled stretch is ``harness.SUBWINDOW_S``, 2 s,
in the middle).  Each device operation of the stretch takes the
innermost ``moe.*`` or ``ffn.*`` span whose interval holds the runtime
call that launched it, and, apart from that, the ``protocol.run_batched``
phase span (``phase_profile.op_phases``); each idle gap the innermost
program span open at its middle.  The port's ``moe.*`` counters are read
before and after the whole window, so they cover every call of it.
Last, a few of the sampled calls are run again one at a time: each
one's ``moe.routed_pairs`` against the number of the reference's expert
ids that fall on the held experts.

``phase_profile.py``'s and ``trace.py``'s functions do the reduction;
this tool edits neither.  Prints one JSON line on standard output and
writes the full record to ``<out>/<cell>.json``; the exit code is 1 where
a sampled call is wrong or a count of routed pairs differs.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPAN_PREFIXES = ("moe.", "ffn.")
COUNTERS = ("moe.routed_pairs", "moe.padded_rows", "moe.max_load", "moe.host_syncs",
            "moe.plans_built")
RECHECKED_CALLS = 3


def layer_spans(spans: list) -> list:
    """The program spans of the stack's layers (``moe.*``, ``ffn.*``)."""
    return [s for s in spans if s[0].startswith(SPAN_PREFIXES)]


def device_ms_by(ops: list, labels: list, calls: int) -> dict:
    """Device ms a call of ``ops`` by ``labels`` (one per operation; None
    becomes the harness's host range of the operation)."""
    out = collections.defaultdict(float)
    for (_, s, e, host), label in zip(ops, labels):
        out[label or host] += (e - s) / 1e6 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def span_by_phase(ops: list, spans: list, phases: list, calls: int) -> dict:
    """{layer span: {protocol phase or "master": device ms a call}}: the
    operations a span launched inside a ``run_batched`` phase, and those
    it launched itself (the master's steps)."""
    out = collections.defaultdict(lambda: collections.defaultdict(float))
    for (_, s, e, host), span, phase in zip(ops, spans, phases):
        out[span or host][phase.rsplit(".", 1)[-1] if phase else "master"] += (e - s) / 1e6 / calls
    return {k: dict(sorted(v.items())) for k, v in sorted(out.items())}


def counters() -> dict:
    from repro_torch.obs.metrics import REGISTRY

    return {name: REGISTRY.counter(name).value for name in COUNTERS}


def per_call(before: dict, after: dict, calls: int) -> dict:
    """Each counter's growth over ``calls`` calls, a call."""
    return {name: (after[name] - before[name]) / calls for name in before} if calls else {}


def recheck(session, indices) -> list:
    """Each call of ``indices`` run alone: its ``moe.routed_pairs`` against
    the reference's expert ids on the held experts, and its mismatches."""
    import torch
    from cmpcbench import traffic

    held = torch.as_tensor(session.config["private_moe"]["experts_held"], device=session.device)
    out = []
    for index in indices:
        inputs = session.inputs(traffic.CALL_STREAM, index)
        before = counters()["moe.routed_pairs"]
        y = session.program(session.state, inputs, index)
        if session.device.type == "cuda":
            torch.cuda.synchronize(session.device)
        pairs = counters()["moe.routed_pairs"] - before
        want = session.ref.expect(session.config, session.fixed, inputs)
        out.append({"index": index, "routed_pairs": pairs,
                    "reference_pairs": int(torch.isin(want[1], held).sum()),
                    "mismatches": session.ref.mismatches(y, want)})
    return out


def profile_cell(name: str, seed: int, seconds: float, device, root: Path = ROOT) -> dict:
    import torch
    from cmpcbench import harness, trace, traffic
    from cmpcbench import phase_profile as pp
    from repro_torch.obs.tracer import TRACER

    cell = harness.load_cell(name, False, root)
    session = harness.Session(cell, seed, device, None)
    session.warm(harness.WARM_CALLS)
    prof = trace.start_profile(device.type)  # the profiler's first start is slow
    session.warm(1)
    trace.stop_profile(prof)
    sample = harness.Sample(harness.SAMPLE_CALLS, traffic.mix64(seed, 4))
    before = counters()
    TRACER.clear()
    TRACER.enable()
    try:
        with pp.raw_events([]) as events:
            win = session.window(seconds, True, sample)
    finally:
        TRACER.disable()
    after = counters()
    traced = win["trace"]
    w0, w1 = traced["window_ns"]
    spans = [s for s in pp.program_spans(TRACER.events) if w0 <= s[1] and s[2] <= w1]
    TRACER.clear()
    launched = pp.launch_times(events)
    line = pp.timeline(layer_spans(spans))
    by_span = [pp.name_at(line, t) for t in launched]
    phases = pp.op_phases(launched, spans)
    ops, calls = traced["device"], traced["calls"]
    checks = session.compare(sample)
    rechecked = recheck(session, sorted(i for i, _ in sample.slots)[:RECHECKED_CALLS])
    busy = sum(e - s for s, e in trace.busy_intervals(ops, w0, w1))
    return {
        "cell": name, "seed": seed,
        "correct": harness.checks_hold(checks)
        and all(r["routed_pairs"] == r["reference_pairs"] and not r["mismatches"]
                for r in rechecked),
        "checks": checks, "rechecked": rechecked,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "calls": calls, "window_calls": len(win["calls"]), "window_s": (w1 - w0) / 1e9,
        "device_ms_a_call": sum(e - s for _, s, e, _ in ops) / 1e6 / calls,
        "device_idle": 100.0 * (1.0 - busy / (w1 - w0)) if ops else None,
        "device_ms_by_span": device_ms_by(ops, by_span, calls),
        "device_ms_by_phase": device_ms_by(ops, phases, calls),
        "device_ms_by_span_and_phase": span_by_phase(ops, by_span, phases, calls),
        "counters_a_call": per_call(before, after, len(win["calls"])),
        "modmatmul_launches": sum(traced["launches"].values()) / calls,
        "idle_gaps_by_span": sorted(pp.idle_gaps_by_span(traced, spans), key=lambda g: -g[1]),
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=str(ROOT / "results" / "moe"))
    args = ap.parse_args(argv)
    build = ROOT / "build"  # the builds cmpcbench/run.py uses
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("moe_profile needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    record = profile_cell(args.workload, args.seed, args.seconds, device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.workload}.json").write_text(json.dumps(record, indent=1))
    brief = dict(record, idle_gaps_by_span=record["idle_gaps_by_span"][:10])
    print(json.dumps(brief), flush=True)
    return 0 if record["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
