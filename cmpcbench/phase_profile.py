#!/usr/bin/env python3
"""Device time of ``protocol.run_batched`` by phase, at a benchmark cell's shapes.

    python3 cmpcbench/phase_profile.py --workload nemo12b-wq.prefill [more cells] \\
        --seed 4100000013 [--seconds 6] [--cost-seconds 30] [--out results/phases]

Run from the root of a checkout on a machine with a CUDA card.  For each
cell of ``BENCHMARK.json`` it builds the harness's session (the cell's
weight, plan and activations from the seed), warms it as a traced run
does, and then:

1. the tracer's cost: a ``Session.window`` of ``--cost-seconds`` with no
   profile, the port's ``TRACER`` switched on and off call by call in
   pairs (off-on, on-off, ...); host µs inside ``run_batched`` until it
   returns.  Beside it, in a bare loop: the 8 spans a call records, and
   one ``gf.split`` (its span included), each with the tracer off and on;
2. a traced ``Session.window`` of ``--seconds`` (its profiled stretch is
   ``harness.SUBWINDOW_S``, 2 s, from 6 s on) with ``TRACER`` on.  The
   stretch's program spans and device operations share the Unix-epoch ns
   clock.  Each device operation takes the phase span
   (``protocol.run_batched.*``) whose interval holds the runtime call
   that launched it (``op_phase``; None outside every phase, or where the
   profile lacks the runtime call); each idle gap takes the innermost
   program span open at its middle, or the harness's label where none is.

``trace.reduce_events`` keeps no launch times, so the raw events are kept
here beside it while the window runs.  Until the harness switches the
tracer on in its own stretch, this tool is where the phase spans are read.

Prints one JSON line per cell on standard output and writes the full
record (every idle gap, device ms by operation name and phase) to
``<out>/<cell>.json``.  The window's sampled calls are checked against the
plain reference; the exit code is 1 where any is wrong.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASE = "protocol.run_batched."
PHASE_METRICS = {f"{p}_device_ms": PHASE + p
                 for p in ("prep", "share", "multiply", "reduce", "decode")}


# ----------------------------------------------------------------------
# the reduction (plain data; tested on the CPU)
# ----------------------------------------------------------------------
def program_spans(records) -> list:
    """``[name, t0_ns, t1_ns, id, parent]`` of the tracer's wall spans on
    the ns clock (a tracer that stamps another clock gives none)."""
    return [[e["name"], e["t0"], e["t1"], e["id"], e["parent"]] for e in records
            if e["kind"] == "span" and e["clock"] == "wall" and type(e["t0"]) is int]


def launch_times(events) -> list:
    """For each device operation of the raw profiler ``events``, in the
    order ``trace.reduce_events`` lists them, the start of the runtime
    call that launched it (None where the profile lacks it)."""
    launched, device = {}, []
    for ev in events:
        if ev.device_type().name == "CPU":
            launched.setdefault(ev.correlation_id(), ev.start_ns())
        else:
            device.append(ev.correlation_id())
    return [launched.get(c) for c in device]


def timeline(spans) -> tuple:
    """``(starts, names)``: from ``starts[i]`` on, the innermost of
    ``spans`` holding a time is ``names[i]`` (None: no span).  Spans nest
    or are disjoint, as one thread's are; a span holds [t0, t1)."""
    starts, names, stack = [], [], []

    def close():
        starts.append(stack.pop()[1])
        names.append(stack[-1][0] if stack else None)

    for name, t0, t1, *_ in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][1] <= t0:
            close()
        stack.append((name, t1))
        starts.append(t0)
        names.append(name)
    while stack:
        close()
    return starts, names


def name_at(line: tuple, t):
    """The innermost span of the ``timeline`` ``line`` that holds ``t``."""
    if t is None:
        return None
    i = bisect.bisect_right(line[0], t) - 1
    return line[1][i] if i >= 0 else None


def op_phases(launch_ns: list, spans: list) -> list:
    """For each device operation, the ``protocol.run_batched.*`` span whose
    interval holds its launch, else None."""
    line = timeline([s for s in spans if s[0].startswith(PHASE)])
    return [name_at(line, t) for t in launch_ns]


def device_ms_by_span(ops: list, phases: list, calls: int) -> dict:
    """Device ms a call by ``op_phase``, or by the harness's label for an
    operation outside every phase span."""
    out = collections.defaultdict(float)
    for (_, s, e, label), phase in zip(ops, phases):
        out[phase or label] += (e - s) / 1e6 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_gaps_by_span(traced: dict, spans: list) -> list:
    """``[label, seconds]`` of each gap of ``trace.idle_gaps``, labelled by
    the innermost program span open at its middle, else by its own label
    (the harness's host range there)."""
    from cmpcbench import trace

    w0, w1 = traced["window_ns"]
    edges = [w0] + [t for iv in trace.busy_intervals(traced["device"], w0, w1) for t in iv] + [w1]
    middles = [(s + e) // 2 for s, e in zip(edges[::2], edges[1::2]) if e > s]
    line = timeline(spans)
    return [[name_at(line, mid) or label, seconds]
            for mid, (label, seconds) in zip(middles, trace.idle_gaps(traced))]


def keys_host_ms(spans: list, calls: int):
    """Host ms a call inside ``gf.split`` spans under a
    ``protocol.run_batched`` span (None where there is none)."""
    by_id = {s[3]: s for s in spans}

    def under_run_batched(s):
        while s[4] in by_id:
            s = by_id[s[4]]
            if s[0] == "protocol.run_batched":
                return True
        return False

    keys = [s for s in spans if s[0] == "gf.split" and under_run_batched(s)]
    return sum(s[2] - s[1] for s in keys) / 1e6 / calls if keys and calls else None


def phase_metrics(ops: list, phases: list, spans: list, calls: int) -> dict:
    """The five phases' device ms a call (None where a phase launched
    nothing) and ``keys_host_ms``."""
    out = {}
    for metric, phase in PHASE_METRICS.items():
        mine = [e - s for (_, s, e, _), ph in zip(ops, phases) if ph == phase]
        out[metric] = sum(mine) / 1e6 / calls if mine and calls else None
    out["keys_host_ms"] = keys_host_ms(spans, calls)
    return out


def attribution(ops: list, phases: list, calls: int) -> dict:
    """The phases against what the harness puts under ``run_batched``: its
    device ms a call, the share of it outside every phase span, and the
    ``gfmm::`` launches a call by phase."""
    inside = [(e - s, ph) for (_, s, e, label), ph in zip(ops, phases) if label == "run_batched"]
    total = sum(d for d, _ in inside)
    gfmm = collections.Counter(ph for (name, _, _, _), ph in zip(ops, phases) if "gfmm::" in name)
    return {
        "run_batched_device_ms": total / 1e6 / calls if calls else None,
        "phase_none_share": sum(d for d, ph in inside if ph is None) / total if total else None,
        "gfmm_launches_by_phase": {str(k): v / calls for k, v in sorted(gfmm.items(), key=str)},
    }


def pair_costs(calls: list, on) -> dict:
    """Host µs inside ``run_batched`` a call, tracer off and on: each
    side's mean and median, and the median of the pairs' differences.
    ``calls`` are the window's, in issue order; ``on(index)`` tells the
    side, and consecutive indices 2j, 2j + 1 form a pair of both sides."""
    host = {c["index"]: c["return"] - c["issue"] for c in calls}
    by_side = {"on": [h for i, h in host.items() if on(i)],
               "off": [h for i, h in host.items() if not on(i)]}
    out = {f"{side}_{stat}_us": fn(v) * 1e6 for side, v in by_side.items()
           for stat, fn in (("mean", statistics.fmean), ("median", statistics.median))}
    diffs = [(host[j + 1] - host[j]) * (1 if on(j + 1) else -1)
             for j in range(0, max(host) + 1, 2) if j + 1 in host]
    out["pair_difference_median_us"] = statistics.median(diffs) * 1e6
    out["pairs"] = len(diffs)
    return out


# ----------------------------------------------------------------------
# the runs
# ----------------------------------------------------------------------
def _switched_on(index: int) -> bool:
    return index % 4 in (1, 2)


def tracing_cost(session, seconds: float) -> dict:
    """The tracer's host cost inside ``run_batched``, switched call by
    call over a ``Session.window`` with no profile (``pair_costs``)."""
    from cmpcbench import harness
    from repro_torch.obs.tracer import TRACER

    program = session.program

    def switched(state, inputs, index):
        (TRACER.enable if _switched_on(index) else TRACER.disable)()
        return program(state, inputs, index)

    session.program = switched
    TRACER.clear()
    try:
        win = session.window(seconds, False, harness.Sample(1, 0))
    finally:
        session.program = program
        TRACER.disable()
        TRACER.clear()
    return pair_costs(win["calls"], _switched_on)


def loop_costs(reps: int) -> dict:
    """Host µs, tracer off and on, of the 8 spans a call records (one
    around seven) and of one ``gf.split`` of a fixed key, each the mean
    of ``reps`` repeats in a bare loop."""
    from repro_torch.core import gf
    from repro_torch.obs.tracer import TRACER

    key = gf.prng_key(2 ** 31 + 11)

    def spans():
        with TRACER.span("outer"):
            for _ in range(7):
                with TRACER.span("inner"):
                    pass

    out = {}
    try:
        for what, fn in (("spans8", spans), ("split", lambda: gf.split(key, 2))):
            for side in ("off", "on"):
                TRACER.clear()
                (TRACER.enable if side == "on" else TRACER.disable)()
                fn()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                out[f"{what}_{side}_us"] = (time.perf_counter() - t0) / reps * 1e6
    finally:
        TRACER.disable()
        TRACER.clear()
    return out


@contextlib.contextmanager
def raw_events(kept: list):
    """While open, ``trace.stop_profile`` also appends the raw events to
    ``kept``: the launch times that ``trace.reduce_events`` drops."""
    from cmpcbench import trace

    stop = trace.stop_profile

    def keeping(prof):
        events = stop(prof)
        kept.extend(events)
        return events

    trace.stop_profile = keeping
    try:
        yield kept
    finally:
        trace.stop_profile = stop


def traced_window(session, seconds: float, sample) -> dict:
    """A traced ``Session.window`` with ``TRACER`` on; its profiled
    stretch reduced as the harness does, plus ``program`` (the stretch's
    wall spans) and ``op_phase``."""
    from repro_torch.obs.tracer import TRACER

    TRACER.clear()
    TRACER.enable()
    try:
        with raw_events([]) as events:
            traced = session.window(seconds, True, sample)["trace"]
    finally:
        TRACER.disable()
    w0, w1 = traced["window_ns"]
    traced["program"] = [s for s in program_spans(TRACER.events) if w0 <= s[1] and s[2] <= w1]
    traced["op_phase"] = op_phases(launch_times(events), traced["program"])
    TRACER.clear()
    return traced


def profile_cell(name: str, seed: int, seconds: float, cost_seconds: float, device,
                 root: Path = ROOT, loop_reps: int = 2000) -> dict:
    """Both measurements of one cell; the full record."""
    import torch
    from cmpcbench import harness, trace, traffic

    cell = harness.load_cell(name, False, root)
    session = harness.Session(cell, seed, device, None)
    session.warm(harness.WARM_CALLS)
    prof = trace.start_profile(device.type)  # the profiler's first start is slow
    session.warm(1)
    trace.stop_profile(prof)
    cost = None
    if cost_seconds:
        cost = {**tracing_cost(session, cost_seconds), **loop_costs(loop_reps)}
    sample = harness.Sample(harness.SAMPLE_CALLS, traffic.mix64(seed, 4))
    traced = traced_window(session, seconds, sample)
    checks = session.compare(sample)
    ops, phases, spans = traced["device"], traced["op_phase"], traced["program"]
    calls = traced["calls"]
    w0, w1 = traced["window_ns"]
    busy = sum(e - s for s, e in trace.busy_intervals(ops, w0, w1))
    by_name = collections.defaultdict(float)
    for (op, s, e, label), phase in zip(ops, phases):
        by_name[f"{phase or label} | {op[:120]}"] += (e - s) / 1e6 / calls
    return {
        "cell": name, "seed": seed, "correct": harness.checks_hold(checks), "checks": checks,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "calls": calls, "window_s": (w1 - w0) / 1e9,
        "device_idle": 100.0 * (1.0 - busy / (w1 - w0)) if ops else None,
        "metrics": phase_metrics(ops, phases, spans, calls),
        **attribution(ops, phases, calls),
        "modmatmul_launches": sum(traced["launches"].values()) / calls,
        "device_ms_by_span": device_ms_by_span(ops, phases, calls),
        "idle_gaps_by_span": sorted(idle_gaps_by_span(traced, spans), key=lambda g: -g[1]),
        "idle_gaps": sorted(([lab, s] for lab, s in trace.idle_gaps(traced)), key=lambda g: -g[1]),
        "program_records_per_call": len(spans) / calls,
        "tracing_cost": cost,
        "device_ms_by_phase_and_op": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--cost-seconds", type=float, default=30.0)
    ap.add_argument("--out", default=str(ROOT / "results" / "phases"))
    args = ap.parse_args(argv)
    build = ROOT / "build"  # the builds cmpcbench/run.py uses
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("phase_profile needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ok = True
    for name in args.workload:
        record = profile_cell(name, args.seed, args.seconds, args.cost_seconds, device)
        (out / f"{name}.json").write_text(json.dumps(record, indent=1))
        brief = {k: v for k, v in record.items() if k != "device_ms_by_phase_and_op"}
        brief["idle_gaps_by_span"] = record["idle_gaps_by_span"][:10]
        brief["idle_gaps"] = record["idle_gaps"][:10]
        print(json.dumps(brief), flush=True)
        ok &= record["correct"]
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
