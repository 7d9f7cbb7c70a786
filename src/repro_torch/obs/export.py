"""Exporters: Chrome/Perfetto ``trace.json`` and a flat JSONL log.

The Chrome trace-event JSON object format (loadable by Perfetto's UI
and ``chrome://tracing``) renders the tracer's two clocks as two
*processes*:

* pid 1 ``wall-clock`` — real-time spans (protocol phases, plan
  builds, kernel lowering events), one thread lane per OS thread,
* pid 2 ``simulated-replay`` — the scheduler's event-loop clock, one
  lane per simulated track: ``worker N`` lanes carry each worker's
  share->compute and exchange->response spans (the flame chart of
  workers x phases), ``replay K`` lanes carry whole-replay spans,
  barriers, BW attempts, and decode acceptance.

Simulated timestamps are unitless model time; the export maps one
simulated unit to one second (1e6 µs), so a replay with unit latency
renders on a readable scale.  Wall timestamps are rebased to the
earliest wall event.

``to_chrome`` also embeds a metrics snapshot under the top-level
``repro_metrics`` key — Perfetto ignores unknown top-level keys, and
``tools/trace_report.py`` reads it back for cache hit rates and byte
accounting.  ``validate_chrome`` is the schema check behind
``make trace-check`` and the tracer tests.

A copy of the JAX package's ``repro.obs.export`` (plain Python and numpy),
kept here so that the port imports nothing of that package.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple, Union

from .tracer import Tracer

WALL_PID = 1
SIM_PID = 2

# Fixed lane bases keep sim tids (and thus the exported JSON) stable
# across runs; lanes outside the table are enumerated deterministically
# after it.
_LANE_TID_BASE = {"sim": 10, "replay": 100, "pipeline": 500, "worker": 1000}
_UNKNOWN_LANE_BASE = 20000
_UNKNOWN_LANE_STRIDE = 1000


def _events_of(source: Union[Tracer, List[dict]]) -> List[dict]:
    return source.events if isinstance(source, Tracer) else list(source)


def _sim_tids(events: List[dict]) -> Dict[Tuple[str, int], int]:
    tracks = sorted(
        {tuple(e["track"]) for e in events if e["clock"] == "sim"}
    )
    lanes = sorted({lane for lane, _ in tracks})
    bases = dict(_LANE_TID_BASE)
    extra = _UNKNOWN_LANE_BASE
    for lane in lanes:
        if lane not in bases:
            bases[lane] = extra
            extra += _UNKNOWN_LANE_STRIDE
    return {(lane, idx): bases[lane] + idx for lane, idx in tracks}


def _wall_tids(events: List[dict]) -> Dict[int, int]:
    threads = sorted({e["track"] for e in events if e["clock"] == "wall"})
    return {t: i + 1 for i, t in enumerate(threads)}


def to_chrome(
    source: Union[Tracer, List[dict]],
    metrics: Optional[dict] = None,
) -> dict:
    """Render tracer records as a Perfetto-loadable trace object."""
    events = _events_of(source)
    sim_tid = _sim_tids(events)
    wall_tid = _wall_tids(events)
    wall_t0 = min(
        (e["t0"] if e["kind"] == "span" else e["t"]
         for e in events if e["clock"] == "wall"),
        default=0.0,
    )

    out: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": WALL_PID,
         "args": {"name": "wall-clock"}},
        {"name": "process_sort_index", "ph": "M", "pid": WALL_PID,
         "args": {"sort_index": 1}},
        {"name": "process_name", "ph": "M", "pid": SIM_PID,
         "args": {"name": "simulated-replay"}},
        {"name": "process_sort_index", "ph": "M", "pid": SIM_PID,
         "args": {"sort_index": 0}},
    ]
    for (lane, idx), tid in sorted(sim_tid.items(), key=lambda kv: kv[1]):
        out.append(
            {"name": "thread_name", "ph": "M", "pid": SIM_PID, "tid": tid,
             "args": {"name": f"{lane} {idx}"}}
        )
        out.append(
            {"name": "thread_sort_index", "ph": "M", "pid": SIM_PID,
             "tid": tid, "args": {"sort_index": tid}}
        )
    for thread, tid in wall_tid.items():
        out.append(
            {"name": "thread_name", "ph": "M", "pid": WALL_PID, "tid": tid,
             "args": {"name": f"thread {tid}"}}
        )

    for e in events:
        sim = e["clock"] == "sim"
        pid = SIM_PID if sim else WALL_PID
        tid = sim_tid[tuple(e["track"])] if sim else wall_tid[e["track"]]
        args = dict(e["attrs"])
        args["trace_id"] = e["id"]
        if e["parent"]:
            args["parent_id"] = e["parent"]
        if e["kind"] == "span":
            t0 = e["t0"] if sim else e["t0"] - wall_t0
            dur = max(0.0, e["t1"] - e["t0"])
            out.append(
                {"name": e["name"], "cat": e["clock"], "ph": "X",
                 "ts": t0 * 1e6, "dur": dur * 1e6, "pid": pid, "tid": tid,
                 "args": args}
            )
        else:
            t = e["t"] if sim else e["t"] - wall_t0
            out.append(
                {"name": e["name"], "cat": e["clock"], "ph": "i",
                 "ts": t * 1e6, "s": "t", "pid": pid, "tid": tid,
                 "args": args}
            )

    trace = {"traceEvents": out, "displayTimeUnit": "ms"}
    if metrics is not None:
        trace["repro_metrics"] = metrics
    if isinstance(source, Tracer) and source.dropped:
        trace["repro_dropped_events"] = source.dropped
    return trace


def write_chrome(
    path: str,
    source: Union[Tracer, List[dict]],
    metrics: Optional[dict] = None,
) -> dict:
    trace = to_chrome(source, metrics=metrics)
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return trace


def to_jsonl(source: Union[Tracer, List[dict]]) -> str:
    """Flat one-record-per-line event log (raw tracer records)."""
    lines = []
    for e in _events_of(source):
        rec = dict(e)
        if isinstance(rec.get("track"), tuple):
            rec["track"] = list(rec["track"])
        lines.append(json.dumps(rec, sort_keys=True))
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(path: str, source: Union[Tracer, List[dict]]) -> None:
    with open(path, "w") as f:
        f.write(to_jsonl(source))


# ----------------------------------------------------------------------
# schema validation (make trace-check / tests)
# ----------------------------------------------------------------------
_VALID_PH = {"X", "i", "M"}
_META_NAMES = {
    "process_name", "process_sort_index", "thread_name", "thread_sort_index",
}


def validate_chrome(trace: dict) -> List[str]:
    """Return schema problems (empty list == Perfetto-loadable).

    Checks the trace-event contract this exporter relies on: a
    ``traceEvents`` list; every event JSON-serializable with a known
    ``ph``; complete events with numeric non-negative durations and
    integer pid/tid; instants with a scope; metadata events naming
    processes/threads.
    """
    problems: List[str] = []
    if not isinstance(trace, dict):
        return ["trace is not a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as exc:
        problems.append(f"trace not JSON-serializable: {exc}")
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _VALID_PH:
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        if ph == "M":
            if e.get("name") not in _META_NAMES:
                problems.append(f"{where}: unknown metadata name {e.get('name')!r}")
            if not isinstance(e.get("args"), dict):
                problems.append(f"{where}: metadata without args object")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            problems.append(f"{where}: missing event name")
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                problems.append(f"{where}: {key} not an int")
        if not isinstance(e.get("ts"), (int, float)):
            problems.append(f"{where}: ts not numeric")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: complete event with bad dur {dur!r}")
        if ph == "i" and e.get("s") not in ("g", "p", "t"):
            problems.append(f"{where}: instant without a valid scope")
    return problems
