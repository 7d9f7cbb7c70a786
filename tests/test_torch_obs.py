"""The port's tracer on the Unix-epoch clock and the phase spans of
``protocol.run_batched``.

The wall stamps are integer ns from ``time.time_ns``, the clock of
``torch.profiler``'s events, so a phase span holds the runtime calls that
launched its device operations.  With tracing on, ``run_batched`` records
five phases in order and the two host-side key derivations; with tracing
off it records nothing and opens only the shared no-op span; Y is the
same either way.
"""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.core import protocol as tp
from repro_torch.core.constructions import build_scheme
from repro_torch.core.gf import Field
from repro_torch.core.planner import BlockShapes, get_plan
from repro_torch.obs import TRACER, Tracer, to_chrome, to_jsonl, validate_chrome
from repro_torch.obs.export import SIM_PID, WALL_PID
from repro_torch.obs.tracer import _DISABLED_SPAN

P = 65521
PHASES = [f"protocol.run_batched.{p}" for p in ("prep", "share", "multiply", "reduce", "decode")]


@pytest.fixture
def global_tracer():
    TRACER.clear()
    yield TRACER
    TRACER.disable()
    TRACER.clear()


def _case(batch=3, k=8, ma=4, mb=8):
    plan = get_plan(build_scheme("age", 2, 2, 2), BlockShapes(k, ma, mb, 2, 2), field=Field(P),
                    n_spare=2)
    rng = np.random.default_rng(11)
    a = rng.integers(0, P, (batch, k, ma))
    b = rng.integers(0, P, (batch, k, mb))
    return plan, a, b


def _oracle(a, b):
    prod = np.einsum("bki,bkj->bij", np.asarray(a, object), np.asarray(b, object))
    return (prod % P).astype(np.int64)


def _subsets(plan):
    """A Phase-2 sender set and a Phase-3 responder set other than the
    primary prefixes (the selections the ``prep`` span also covers)."""
    return dict(phase2_ids=np.arange(plan.n_total)[::-1][: plan.n_workers],
                phase3_ids=np.arange(plan.n_total)[2: 2 + plan.decode_threshold])


@pytest.mark.parametrize("subsets", [False, True], ids=["primary", "subsets"])
@pytest.mark.parametrize("fused", [False, True], ids=["unmasked", "masked"])
def test_run_batched_records_its_phases_in_order(global_tracer, fused, subsets):
    plan, a, b = _case()
    kw = dict(seed=7, fused_masks=fused, device="cpu", **(_subsets(plan) if subsets else {}))
    y_off, _ = tp.run_batched(plan, a, b, **kw)
    global_tracer.enable()
    before = time.time_ns()
    y_on, trace_on = tp.run_batched(plan, a, b, **kw)
    after = time.time_ns()
    global_tracer.disable()

    assert torch.equal(y_on, y_off) and y_on.dtype == torch.int64
    np.testing.assert_array_equal(y_on.numpy(), _oracle(a, b))
    assert trace_on == tp.batch_trace(plan, a.shape[0])

    spans = global_tracer.events
    assert all(e["kind"] == "span" and e["clock"] == "wall" for e in spans)
    (top,) = [e for e in spans if e["name"] == "protocol.run_batched"]
    assert top["parent"] == 0 and top["attrs"] == {"backend": "auto", "batch": 3}
    children = sorted((e for e in spans if e["parent"] == top["id"]), key=lambda e: e["t0"])
    assert [e["name"] for e in children] == [PHASES[0], "gf.split", *PHASES[1:]]
    share = children[2]
    splits = [e for e in spans if e["name"] == "gf.split"]
    assert sorted(e["parent"] for e in splits) == sorted([top["id"], share["id"]])
    assert len(spans) == 1 + len(PHASES) + 2
    for e in spans:
        assert type(e["t0"]) is int and type(e["t1"]) is int
        assert before <= e["t0"] <= e["t1"] <= after
        parent = next((q for q in spans if q["id"] == e["parent"]), None)
        if parent is not None:
            assert parent["t0"] <= e["t0"] and e["t1"] <= parent["t1"]
    for first, second in zip(children, children[1:]):
        assert first["t1"] <= second["t0"]


def test_tracing_off_records_nothing_and_opens_only_the_shared_noop(global_tracer, monkeypatch):
    plan, a, b = _case()
    opened = []
    span = global_tracer.span

    def counting_span(name, **attrs):
        out = span(name, **attrs)
        opened.append((name, out))
        return out

    monkeypatch.setattr(global_tracer, "span", counting_span)
    y, _ = tp.run_batched(plan, a, b, seed=2, device="cpu")
    np.testing.assert_array_equal(y.numpy(), _oracle(a, b))
    assert global_tracer.events == []
    assert [name for name, _ in opened] == [
        "protocol.run_batched", PHASES[0], "gf.split", PHASES[1], "gf.split", *PHASES[2:]]
    assert all(out is _DISABLED_SPAN for _, out in opened)


def test_wall_stamps_are_integer_ns_on_the_unix_epoch():
    tracer = Tracer().enable()
    before = time.time_ns()
    with tracer.span("outer"):
        tracer.event("mark")
    after = time.time_ns()
    mark, outer = tracer.events
    assert all(type(x) is int for x in (outer["t0"], outer["t1"], mark["t"]))
    assert before <= outer["t0"] <= mark["t"] <= outer["t1"] <= after


def test_exported_wall_microseconds_are_unchanged():
    """A fixed record on the ns clock exports to the µs the same record in
    seconds gave: rebased to the first wall stamp, 1 s = 1e6 µs."""
    base = 1_760_000_000_000_000_000
    records = [
        {"kind": "span", "clock": "wall", "name": "protocol.run_batched", "id": 1, "parent": 0,
         "track": 5, "t0": base + 1_000_000, "t1": base + 3_500_000, "attrs": {}},
        {"kind": "instant", "clock": "wall", "name": "mark", "id": 2, "parent": 1,
         "track": 5, "t": base + 2_000_000, "attrs": {}},
        {"kind": "span", "clock": "wall", "name": "first", "id": 3, "parent": 0,
         "track": 5, "t0": base, "t1": base + 250, "attrs": {}},
        {"kind": "span", "clock": "sim", "name": "replay", "id": 4, "parent": 0,
         "track": ("replay", 0), "t0": 1.5, "t1": 2.0, "attrs": {}},
    ]
    chrome = to_chrome(records)
    assert validate_chrome(chrome) == []
    timed = {e["name"]: e for e in chrome["traceEvents"] if e["ph"] in ("X", "i")}
    top = timed["protocol.run_batched"]
    assert (top["ts"], top["dur"]) == (1000.0, 2500.0)
    assert timed["mark"]["ts"] == 1000.0 + 1000.0 and timed["mark"]["pid"] == WALL_PID
    assert (timed["first"]["ts"], timed["first"]["dur"]) == (0.0, 0.25)
    assert (timed["replay"]["ts"], timed["replay"]["dur"]) == (1.5e6, 0.5e6)
    assert timed["replay"]["pid"] == SIM_PID
    # the reference's exporter on the same records in seconds (its clock)
    from repro.obs import to_chrome as reference_to_chrome

    in_seconds = [dict(e) for e in records]
    for e in in_seconds[:3]:
        for key in ("t0", "t1", "t"):
            if key in e:
                e[key] = 100.0 + (e[key] - base) / 1e9
    want = [e for e in reference_to_chrome(in_seconds)["traceEvents"] if e["ph"] in ("X", "i")]
    got = [e for e in chrome["traceEvents"] if e["ph"] in ("X", "i")]
    assert [e["ts"] for e in got] == pytest.approx([e["ts"] for e in want], abs=1e-6)
    assert [e.get("dur", 0) for e in got] == pytest.approx(
        [e.get("dur", 0) for e in want], abs=1e-6)
    assert [(e["name"], e["ph"], e["pid"], e["tid"], e["args"]) for e in got] == [
        (e["name"], e["ph"], e["pid"], e["tid"], e["args"]) for e in want]
    lines = [json.loads(line) for line in to_jsonl(records).splitlines()]
    assert lines[0]["t0"] == pytest.approx((base + 1_000_000) / 1e9)
    assert lines[0]["t1"] - lines[0]["t0"] == pytest.approx(2.5e-3, abs=1e-6)
    assert lines[1]["t"] == pytest.approx((base + 2_000_000) / 1e9)
    assert (lines[3]["t0"], lines[3]["t1"], lines[3]["track"]) == (1.5, 2.0, ["replay", 0])
