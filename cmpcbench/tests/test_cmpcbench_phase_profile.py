"""``cmpcbench/phase_profile.py``: device operations and idle gaps put down
to ``run_batched``'s phase spans, on hand-worked events, and the tool end to
end on a cell small enough for the CPU."""
import types

import pytest
import torch

from cmpcbench import phase_profile as pp
from cmpcbench import trace

from _tiny import CELL, tiny_root

CPU, CUDA = types.SimpleNamespace(name="CPU"), types.SimpleNamespace(name="CUDA")
PH = "protocol.run_batched."


class Ev:
    """The surface of a raw profiler event that the reduction reads."""

    def __init__(self, name, dev, start, dur, corr):
        self._v = (name, dev, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


HOST = [("draw", 100, 250), ("run_batched", 300, 900), ("wait", 950, 1600)]
SPANS = [  # [name, t0, t1, id, parent], completion-ordered as the tracer records them
    [PH + "prep", 310, 400, 2, 1],
    ["gf.split", 400, 450, 3, 1],
    ["gf.split", 460, 500, 5, 4],
    [PH + "share", 450, 600, 4, 1],
    [PH + "multiply", 600, 650, 6, 1],
    [PH + "reduce", 650, 800, 7, 1],
    [PH + "decode", 800, 890, 8, 1],
    ["protocol.run_batched", 300, 900, 1, 0],
    ["gf.split", 1000, 1010, 9, 0],  # a key split outside run_batched: not counted
]
# (device op, start, end, launched at; None: the runtime call was not recorded)
OPS = [
    ("distribution_kernel", 200, 300, 130),  # launched in draw
    ("remainder_kernel", 320, 410, 320),  # prep
    ("gfmm::skinny share", 440, 540, 470),  # inside share's gf.split: still share
    ("index_put_kernel", 540, 640, 520),  # share
    ("gfmm::mma", 640, 940, 610),  # multiply
    ("gfmm::skinny mix", 940, 1040, 660),  # reduce
    ("bitwise_and_kernel", 1040, 1140, 700),  # reduce
    ("gfmm::skinny decode", 1300, 1350, 810),  # decode
    ("copy_kernel", 1350, 1360, 895),  # in run_batched, outside every phase
    ("gfmm::lonely", 1400, 1450, None),
]
WINDOW = (50, 2050)
CALLS = 2


def _events():
    events = []
    for corr, (name, s, e, launch) in enumerate(OPS, start=1):
        if launch is not None:
            events.append(Ev("cudaLaunchKernel", CPU, launch, 5, corr))
        events.append(Ev(name, CUDA, s, e - s, corr))
    return events


def _traced():
    events = _events()
    traced = trace.reduce_events(events, HOST, WINDOW)
    return traced, pp.op_phases(pp.launch_times(events), SPANS)


def test_each_operation_takes_the_phase_that_launched_it():
    traced, phases = _traced()
    assert [op[0] for op in traced["device"]] == [op[0] for op in OPS]
    assert pp.launch_times(_events()) == [op[3] for op in OPS]
    assert phases == [None, PH + "prep", PH + "share", PH + "share", PH + "multiply",
                      PH + "reduce", PH + "reduce", PH + "decode", None, None]
    assert pp.device_ms_by_span(traced["device"], phases, CALLS) == pytest.approx({
        "draw": 50e-6, PH + "prep": 45e-6, PH + "share": 100e-6, PH + "multiply": 150e-6,
        PH + "reduce": 100e-6, PH + "decode": 25e-6, "run_batched": 5e-6, "unknown": 25e-6})


def test_idle_gaps_take_the_innermost_span_else_the_host_range():
    traced, _ = _traced()
    gaps = pp.idle_gaps_by_span(traced, SPANS)
    # gaps at 50-200, 300-320, 410-440, 1140-1300, 1360-1400, 1450-2050;
    # middles 125, 310, 425, 1220, 1380, 1750
    assert [g[0] for g in gaps] == ["draw", PH + "prep", "gf.split", "wait", "wait", "other"]
    assert [g[1] for g in gaps] == pytest.approx([150e-9, 20e-9, 30e-9, 160e-9, 40e-9, 600e-9])
    assert [g[1] for g in gaps] == [s for _, s in trace.idle_gaps(traced)]


def test_the_readings_by_hand():
    traced, phases = _traced()
    got = pp.phase_metrics(traced["device"], phases, SPANS, CALLS)
    assert got == pytest.approx({
        "prep_device_ms": 45e-6, "share_device_ms": 100e-6, "multiply_device_ms": 150e-6,
        "reduce_device_ms": 100e-6, "decode_device_ms": 25e-6,
        "keys_host_ms": 45e-6})  # gf.split 50 + 40 ns under run_batched, over 2 calls
    att = pp.attribution(traced["device"], phases, CALLS)
    assert att["run_batched_device_ms"] == pytest.approx(850e-6 / CALLS)
    assert att["phase_none_share"] == pytest.approx(10 / 850)
    assert att["gfmm_launches_by_phase"] == {
        "None": 0.5, PH + "decode": 0.5, PH + "multiply": 0.5, PH + "reduce": 0.5,
        PH + "share": 0.5}
    # nothing to read: no device operation, no span
    assert pp.phase_metrics([], [], [], CALLS) == dict.fromkeys(
        [*pp.PHASE_METRICS, "keys_host_ms"])
    assert pp.phase_metrics(traced["device"], phases, SPANS, 0)["share_device_ms"] is None


@pytest.mark.parametrize("spans, at, want", [
    ([["a", 0, 100, 1, 0], ["b", 10, 20, 2, 1]], [5, 10, 19, 20, 99, 100],
     ["a", "b", "b", "a", "a", None]),
    ([["a", 0, 10, 1, 0], ["c", 10, 20, 2, 0]], [-1, 9, 10, 20], [None, "a", "c", None]),
    ([["a", 0, 100, 1, 0], ["b", 50, 100, 2, 1]], [49, 50, 99, 100], ["a", "b", "b", None]),
    ([], [0], [None]),
], ids=["nested", "back-to-back", "ending-together", "none"])
def test_timeline_finds_the_innermost_span(spans, at, want):
    line = pp.timeline(spans)
    assert [pp.name_at(line, t) for t in at] == want
    assert pp.name_at(line, None) is None


def test_program_spans_keep_the_ns_clock_wall_spans_alone():
    records = [
        {"kind": "span", "clock": "wall", "name": "a", "id": 1, "parent": 0, "t0": 5, "t1": 9},
        {"kind": "span", "clock": "wall", "name": "old", "id": 2, "parent": 0,
         "t0": 0.5, "t1": 0.9},
        {"kind": "instant", "clock": "wall", "name": "i", "id": 3, "parent": 0, "t": 6},
        {"kind": "span", "clock": "sim", "name": "s", "id": 4, "parent": 0, "t0": 1.0, "t1": 2.0},
    ]
    assert pp.program_spans(records) == [["a", 5, 9, 1, 0]]


def test_pair_costs_by_hand():
    # host seconds inside run_batched, indices 0..5; on at 1, 2, 5
    calls = [{"index": i, "issue": 10.0 * i, "return": 10.0 * i + h}
             for i, h in enumerate([3e-6, 5e-6, 6e-6, 2e-6, 4e-6, 9e-6])]
    got = pp.pair_costs(calls, pp._switched_on)
    assert got["pairs"] == 3
    # pairs (off 3, on 5), (on 6, off 2), (off 4, on 9): differences 2, 4, 5 µs
    assert got["pair_difference_median_us"] == pytest.approx(4.0)
    assert got["on_mean_us"] == pytest.approx(20 / 3) and got["on_median_us"] == pytest.approx(6)
    assert got["off_mean_us"] == pytest.approx(3) and got["off_median_us"] == pytest.approx(3)
    # an odd call at the end has no partner and is left out of the pairs
    assert pp.pair_costs(calls[:5], pp._switched_on)["pairs"] == 2


def test_raw_events_keeps_what_the_harness_reduces():
    stop = trace.stop_profile
    with pp.raw_events([]) as kept:
        assert trace.stop_profile is not stop
        assert trace.stop_profile(None) == [] and kept == []
    assert trace.stop_profile is stop


def test_a_tiny_cell_end_to_end_on_the_cpu(tmp_path):
    root = tiny_root(tmp_path)
    record = pp.profile_cell(CELL, 2 ** 33 + 7, 0.3, 0.2, torch.device("cpu"), root, loop_reps=5)
    assert record["correct"] and record["device"] == "cpu" and record["calls"] > 0
    metrics = record["metrics"]
    assert metrics["keys_host_ms"] > 0
    assert all(metrics[m] is None for m in pp.PHASE_METRICS)  # no device trace on the CPU
    assert record["device_idle"] is None and record["device_ms_by_span"] == {}
    assert record["program_records_per_call"] == 8
    cost = record["tracing_cost"]
    assert cost["pairs"] >= 1 and cost["on_mean_us"] > 0 and cost["off_mean_us"] > 0
    for key in ("spans8_off_us", "spans8_on_us", "split_off_us", "split_on_us"):
        assert cost[key] > 0
    from repro_torch.obs.tracer import TRACER

    assert not TRACER.enabled and TRACER.events == []  # left as it was found
