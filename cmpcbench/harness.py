"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is comes from files found by name: its entry in
``BENCHMARK.json``, its configuration (the entry's ``file``), the
program the configuration names (``"program"``, by default
``private_matmul``) as two files, ``programs/<program>.py`` (the port's
side: ``prepare`` and ``call``) and ``references/<program>.py`` (the
benchmark's side: the mix fields it reads, the fixed state and each
call's inputs drawn from the seed, a call's work, the plain answer, its
control and the count of mismatches), its traffic mix
(``traffic/<traffic>.json``, checked by ``traffic.py``) and one reader
per metric (``metrics/<metric>.py``, a ``read(run)`` that returns a
number or None).  A new cell, mix, program or metric is new files and
entries.

The window draws new inputs for every call (host range ``draw``), hands
them to the program's ``call`` (host range ``run_batched``, whatever the
program) and keeps ``in_flight`` calls issued: the master issues call
i+1, then waits on call i's CUDA event (``wait``).  A call's latency runs
from the host clock just before its ``call`` to the return of that wait.

Once the window has closed, a sample of its calls drawn from the seed is
compared, all of each output, with the reference's plain answer, worked
out again from the same inputs and fixed state.
"""
from __future__ import annotations

import collections
import importlib.util
import json
import random
import sys
import time
from collections import deque
from pathlib import Path

import torch

from . import trace, traffic

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
SAMPLE_CALLS = 16  # window calls held for the comparison
WARM_CALLS = 4
SUBWINDOW_S = 2.0  # the profiled stretch; the profiler loses activity over tens of seconds
DEFAULT_PROGRAM = "private_matmul"  # of a configuration without "program"


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` of JAX or of the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.partition(".")[0] for name in sys.modules} & FORBIDDEN)


def load_module(path: Path, kind: str):
    spec = importlib.util.spec_from_file_location(f"cmpcbench_{kind}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(path: Path):
    return load_module(path, "metric").read


def load_cell(name: str, trace_on: bool, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    its program's two modules, its mix and the readers of the metrics
    this run reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config_file = {c["name"]: c["file"] for c in bench["configs"]}[cell["config"]]
    here = root / BENCH.name
    config = json.loads((root / config_file).read_text())
    program = config.get("program", DEFAULT_PROGRAM)
    ref = load_module(here / "references" / f"{program}.py", "reference")
    mix = traffic.check_mix(json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text()),
                            ref.FIELDS)
    metrics = [m for m in bench["per_layer" if trace_on else "end_to_end"]
               if name in m.get("workloads", [name])]
    readers = {m["name"]: (m["unit"], load_reader(here / "metrics" / f"{m['name']}.py"))
               for m in metrics}
    return {"name": name, "chips": cell["chips"], "config": config, "mix": mix, "readers": readers,
            "reference": ref, "program": load_module(here / "programs" / f"{program}.py", "program")}


def control_call(name: str, seed: int, device: torch.device, root: Path = ROOT):
    """The reference's control in the program's place, as a ``call``: the
    same work one precision lower, on the fixed state drawn again from
    ``seed``.  The check has to find it wrong."""
    cell = load_cell(name, False, root)
    ref, config = cell["reference"], cell["config"]
    fixed = ref.fixed(config, cell["mix"], seed, device)
    return lambda state, inputs, index: ref.control(config, fixed, inputs)


class Sample:
    """A uniform sample of the window's calls, drawn from the seed
    (reservoir sampling: at most ``size`` outputs held at a time)."""

    def __init__(self, size: int, seed: int):
        self.rng = random.Random(seed)
        self.size = size
        self.seen = 0
        self.slots = []

    def offer(self, index: int, y) -> None:
        self.seen += 1
        if len(self.slots) < self.size:
            self.slots.append((index, y))
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.slots[j] = (index, y)


def _mark(device: torch.device):
    """An event after the work queued so far (none on the CPU, where the
    work is done when the call returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """The cell's fixed state, the program's state and the calls of one
    run.  ``program``, a ``call(state, inputs, index)``, replaces the
    program's own ``call`` (the control and the planted faults)."""

    def __init__(self, cell: dict, seed: int, device: torch.device, program):
        self.cell, self.seed, self.device, self.mix = cell, seed, device, cell["mix"]
        self.config, self.ref = cell["config"], cell["reference"]
        self.fixed = self.ref.fixed(self.config, self.mix, seed, device)
        self.state = cell["program"].prepare(self.config, self.mix, self.fixed, device)
        self.program = program or cell["program"].call

    def inputs(self, stream: int, index: int):
        return self.ref.inputs(self.config, self.mix, self.fixed, self.seed, stream, index,
                               self.device)

    def issue(self, stream: int, index: int, ann) -> dict:
        with ann("draw"):
            inputs = self.inputs(stream, index)
            tokens, ops = self.ref.work(self.config, self.mix, inputs)
        t_issue = time.perf_counter()
        with ann("run_batched"):
            y = self.program(self.state, inputs, index)
        t_return = time.perf_counter()
        return {"index": index, "issue": t_issue, "return": t_return, "tokens": tokens,
                "ops": ops, "event": _mark(self.device), "y": y}

    @staticmethod
    def complete(call: dict, ann) -> None:
        with ann("wait"):
            if call["event"] is not None:
                call["event"].synchronize()
        call["done"] = time.perf_counter()

    def warm(self, calls: int) -> None:
        pending = deque()
        for j in range(calls):
            pending.append(self.issue(traffic.WARM_STREAM, j, trace.HostRanges()))
            if len(pending) >= self.mix["in_flight"]:
                self.complete(pending.popleft(), trace.HostRanges())
        _sync(self.device)

    def window(self, seconds: float, trace_on: bool, sample: Sample) -> dict:
        """Issue calls for ``seconds``; with ``trace_on``, profile a
        stretch in its middle, synchronized at both ends."""
        from repro_torch.kernels.modmatmul import kernel

        ann = trace.HostRanges()
        in_flight = self.mix["in_flight"]
        sub_len = min(SUBWINDOW_S, seconds / 3)
        sub_at = (seconds - sub_len) / 2
        state, prof, traced = "before", None, None
        pending, calls = deque(), []

        def finish(call):
            self.complete(call, ann)
            sample.offer(call["index"], call.pop("y"))
            call.pop("event")
            calls.append(call)

        def drain():
            while pending:
                finish(pending.popleft())
            _sync(self.device)

        def close_subwindow(n_calls):
            drain()
            ann.on = False
            window_ns = (sub_w0, time.time_ns())  # before the profiler's own stop
            traced = trace.reduce_events(trace.stop_profile(prof), ann.ranges, window_ns)
            traced["calls"] = n_calls
            traced["launches"] = dict(kernel.LAUNCHES_BY_KERNEL)
            traced["launch_shapes"] = {
                name: [[*shape, n] for shape, n in shapes.items()]
                for name, shapes in kernel.LAUNCH_SHAPES_BY_KERNEL.items() if shapes}
            return traced

        t0 = time.perf_counter()
        index = 0
        while time.perf_counter() - t0 < seconds:
            if trace_on and state == "before" and time.perf_counter() - t0 >= sub_at:
                drain()
                kernel.reset_launch_counts()
                prof = trace.start_profile(self.device.type)
                ann.on = True
                sub_w0 = time.time_ns()
                state, sub_t0, sub_first = "in", time.perf_counter(), index
            elif state == "in" and time.perf_counter() - sub_t0 >= sub_len:
                traced = close_subwindow(index - sub_first)
                state = "after"
            call = self.issue(traffic.CALL_STREAM, index, ann)
            call["profiled"] = state == "in"
            pending.append(call)
            index += 1
            if len(pending) >= in_flight:
                finish(pending.popleft())
        if state == "in":
            traced = close_subwindow(index - sub_first)
        drain()
        t1 = max(c["done"] for c in calls)
        for c in calls:
            for key in ("issue", "return", "done"):
                c[key] -= t0
        return {"window_s": t1 - t0, "calls": calls, "trace": traced}

    def compare(self, sample: Sample) -> dict:
        """All of each sampled call's output against the reference's answer."""
        wrong_calls = mismatched = 0
        for index, y in sorted(sample.slots, key=lambda s: s[0]):
            want = self.ref.expect(self.config, self.fixed, self.inputs(traffic.CALL_STREAM, index))
            bad = self.ref.mismatches(y, want)
            mismatched += bad
            wrong_calls += bad > 0
        return {
            "compared_calls": {"value": len(sample.slots), "min": 1},
            "wrong_calls": {"value": wrong_calls, "max": 0},
            "mismatched_residues": {"value": mismatched, "max": 0},
        }


def checks_hold(checks: dict) -> bool:
    return all(c["value"] >= c["min"] if "min" in c else c["value"] <= c["max"]
               for c in checks.values())


def breakdown(traced: dict, top: int = 10) -> dict:
    ops = sorted(trace.device_seconds_by_name(traced).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.idle_gaps(traced), key=lambda g: -g[1])[:top]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[label, s] for label, s in gaps]}


def run(name: str, seed: int, seconds: float, trace_on: bool, *, t_start: float,
        device: torch.device, root: Path = ROOT, program=None, log=None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``program``, a ``call(state, inputs, index)``, replaces the system
    under test (the control and the planted faults of the tests)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = load_cell(name, trace_on, root)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    session = Session(cell, seed, device, program)
    marks.append(("fixed state, program", time.perf_counter()))
    session.warm(WARM_CALLS)
    if trace_on:  # the profiler's first start is slow: not inside the window
        prof = trace.start_profile(device.type)
        session.warm(1)
        trace.stop_profile(prof)
    sample = Sample(SAMPLE_CALLS, traffic.mix64(seed, 4))
    marks.append(("warm calls", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    log("setup: " + ", ".join(f"{label} {b - a:.3f} s" for (_, a), (label, b) in zip(marks, marks[1:])))
    win = session.window(seconds, trace_on, sample)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = session.compare(sample)
    record = {"cell": name, "config": cell["config"], "mix": cell["mix"], "setup_s": setup_s,
              "window_s": win["window_s"], "calls": win["calls"], "trace": win["trace"]}
    metrics = {}
    for metric, (unit, read) in cell["readers"].items():
        value = read(record)
        if value is not None:
            metrics[metric] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": checks_hold(checks), "attempted": len(win["calls"]),
              "failed": checks["wrong_calls"]["value"], "metrics": metrics, "device": dev}
    if trace_on and win["trace"] is not None:
        traced = win["trace"]
        w0, w1 = traced["window_ns"]
        dev["window_s"] = (w1 - w0) / 1e9
        dev["busy_s"] = sum(e - s for s, e in trace.busy_intervals(traced["device"], w0, w1)) / 1e9
        placed = collections.Counter(op[3] for op in traced["device"])
        log(f"trace: {len(traced['device'])} device operations over {traced['calls']} calls, "
            f"by host range {dict(placed)}")
        result["breakdown"] = breakdown(traced)
    result["checks"] = checks
    return result
