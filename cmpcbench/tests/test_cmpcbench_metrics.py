"""The metric readers and the yardstick, against hand-worked values."""
import sys
from pathlib import Path

import pytest

from cmpcbench import harness, roofline, trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    return harness.load_reader(METRICS / f"{name}.py")


# (kernel, batch, m, k, n) -> (ops, bytes at 2 bytes a residue), worked by hand
LAUNCHES = {
    # nemo12b-wq.prefill: P2 multiply [68,1024,2560]@[68,2560,2048]
    ("int32_mma", 68, 1024, 2560, 2048): (730_144_440_320, 1_354_760_192),
    # ... and share B [17,6]@[4,6,5242880]: A read once
    ("int32_skinny", 4, 17, 6, 5_242_880): (4_278_190_080, 964_690_124),
    # dsv2lite-head.decode: share B [16,5]@[1,5,52428800], multiply [16,16,1024]@[16,1024,51200]
    ("int32_skinny", 1, 16, 5, 52_428_800): (8_388_608_000, 2_202_009_760),
    ("int32_mma", 16, 16, 1024, 51_200): (26_843_545_600, 1_704_460_288),
    # nemo12b-wq.decode: multiply [136,16,2560]@[136,2560,2048]
    ("int32_mma", 136, 16, 2560, 2048): (22_817_013_760, 1_446_117_376),
}


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_launch_counts_by_hand(launch):
    kernel, b, m, k, n = launch
    ops, nbytes = LAUNCHES[launch]
    assert roofline.launch_ops(b, m, k, n) == ops
    assert roofline.launch_bytes(kernel, b, m, k, n) == nbytes
    assert roofline.launch_bound_s(kernel, b, m, k, n) == max(ops / 1.979e15, nbytes / 3.35e12)


def test_the_prefill_multiply_is_bound_by_bytes_and_the_head_share_b_too():
    assert roofline.launch_bound_s("int32_mma", 68, 1024, 2560, 2048) == pytest.approx(4.04406e-4, rel=1e-5)
    assert roofline.launch_bound_s("int32_skinny", 1, 16, 5, 52_428_800) == pytest.approx(6.57316e-4, rel=1e-5)


@pytest.mark.parametrize("batch,k,ma,mb,ops", [(4, 5120, 2048, 4096, 343_597_383_680),
                                                (1, 2048, 32, 102_400, 13_421_772_800),
                                                (8, 5120, 32, 4096, 10_737_418_240)])
def test_call_ops_by_hand(batch, k, ma, mb, ops):
    assert roofline.call_ops(batch, k, ma, mb) == ops


def _traced():
    mma = "void gfmm::mma::modmatmul_int32_mma<true, false>(gfmm::Params, int)"
    sk = "void gfmm::modmatmul_int32_skinny<20, false>(gfmm::Params, bool)"
    glue = "void at::native::vectorized_elementwise_kernel<4, FillFunctor<int>>"
    ms = 1_000_000
    return {
        "window_ns": (0, 10 * ms), "calls": 2,
        "host": [["draw", 0, ms], ["run_batched", ms, 2 * ms], ["wait", 2 * ms, 10 * ms]],
        "device": [[glue, 1 * ms, 2 * ms, "run_batched"], [sk, 2 * ms, 3 * ms, "run_batched"],
                   [mma, 3 * ms, 7 * ms, "run_batched"], [glue, 8 * ms, 9 * ms, "draw"]],
        "launches": {"int32_mma": 1, "int32_skinny": 1, "int32_skinny_masked": 1},
        "launch_shapes": {"int32_mma": [[68, 1024, 2560, 2048, 1]],
                          "int32_skinny": [[4, 17, 6, 5_242_880, 1]],
                          "int32_skinny_masked": [[4, 17, 6, 5_242_880, 1]]},
    }


def test_trace_readers_on_a_hand_made_trace():
    run = {"trace": _traced(), "calls": [], "window_s": 1.0}
    assert reader("int32_mma_roofline")(run) == pytest.approx(100 * 4.04406e-4 / 4e-3, rel=1e-5)
    skinny = 2 * roofline.launch_bound_s("int32_skinny", 4, 17, 6, 5_242_880)
    assert reader("int32_skinny_roofline")(run) == pytest.approx(100 * skinny / 1e-3)
    assert reader("glue_device_ms")(run) == pytest.approx(0.5)  # 1 ms of fill over 2 calls
    assert reader("modmatmul_launches")(run) == 1.5
    assert reader("device_idle")(run) == pytest.approx(30.0)  # busy 1-7 and 8-9 of 10 ms
    gaps = sorted(trace.idle_gaps(run["trace"]), key=lambda g: -g[1])
    assert [g[0] for g in gaps] == ["draw", "wait", "wait"]


def test_readers_find_nothing_where_there_is_nothing():
    run = {"trace": None, "calls": [], "window_s": 0.0}
    for name in ("int32_mma_roofline", "int32_skinny_roofline", "glue_device_ms",
                 "modmatmul_launches", "device_idle", "call_mfu", "tokens_per_s",
                 "latency_p95_ms", "protocol_host_ms"):
        assert reader(name)(run) is None


def _closed_loop(service_s):
    """Host records of calls with two in flight on one device: call i is
    issued when call i-2 has completed, and served after call i-1."""
    calls, done = [], []
    for i, s in enumerate(service_s):
        issue = done[i - 2] if i >= 2 else 0.0
        done.append(max(issue, done[-1] if done else 0.0) + s)
        calls.append({"issue": issue, "return": issue + 1e-4, "done": done[-1], "tokens": 100,
                      "ops": 10 ** 9, "profiled": False})
    return {"calls": calls, "window_s": done[-1], "trace": None}


def test_one_stalled_call_moves_throughput_and_the_tail():
    steady = _closed_loop([0.01] * 20)
    stalled = _closed_loop([0.01] * 10 + [0.2] + [0.01] * 9)
    tps, p95 = reader("tokens_per_s"), reader("latency_p95_ms")
    assert tps(steady) == pytest.approx(2000 / 0.2)
    assert tps(stalled) < 0.55 * tps(steady)
    assert p95(stalled) > 5 * p95(steady)
    assert reader("call_mfu")(steady) == pytest.approx(100 * 20e9 / 0.2 / 1.979e15)


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "reproduce", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in [n for n in sys.modules if n.partition(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core.gf", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib", "repro"]
