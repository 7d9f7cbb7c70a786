"""The program ``private_moe`` (DeepSeek-V3's FFN stack held private) in a
tiny cell added to a copy of the benchmark from new files alone: it runs
end to end on the CPU and reads correct; with its timed path broken
underneath (a changed residue, a wrong expert id, a dropped routed pair,
a call's state left unchanged) or with its control in its place it reads
not correct.  Beside it: the benchmark's copy of the plain reference
against ``tests/plain_deepseek_v3_ffn.py``, a call's work, the
configuration's sizes, ``launched_ops_ratio`` against a hand-worked
count, and ``moe_profile.py``'s reduction."""
import importlib.util
import json
import time

import pytest
import torch

from _tiny import ROOT, tiny_root
from cmpcbench import harness, moe_profile, traffic

BENCH = ROOT / "cmpcbench"
CELL = "tiny-moe.decode"
SEED = 2 ** 35 + 29
CPU = torch.device("cpu")
CONFIG = {
    "source": "test", "program": "private_moe", "hidden_size": 64, "intermediate_size": 32,
    "moe_intermediate_size": 16, "n_shared_experts": 1, "num_experts_per_tok": 4, "n_group": 8,
    "topk_group": 2, "routed_scaling_factor": 2.5, "rms_norm_eps": 1e-6, "num_hidden_layers": 3,
    "first_k_dense_replace": 1,
    "private_moe": {"router_experts": 32, "experts_held": [0, 1, 2, 3, 4, 5, 6, 7],
                    "pad_bucket": 4,
                    "fixed_point": {"x_bits": 12, "a_bits": 12, "logit_bits": 13,
                                    "gate_up_bits": 12, "act_bits": 8, "gate_bits": 12},
                    "bias_half_range_log2": -7, "bias_step_log2": -16},
    "cmpc": {"method": "age", "s": 2, "t": 2, "z": 1, "p": 65521}}
MIX = {"tokens": 32, "in_flight": 2, "activations": "uniform"}
PROGRAM = harness.load_module(BENCH / "programs" / "private_moe.py", "program")
REFERENCE = harness.load_module(BENCH / "references" / "private_moe.py", "reference")
LAUNCHED = harness.load_module(BENCH / "metrics" / "launched_ops_ratio.py", "metric")


def moe_root(tmp):
    """``_tiny``'s copy of the benchmark plus the tiny configuration of
    ``private_moe``, its mix and its cell, each a new file or entry."""
    root = tiny_root(tmp)
    here = root / "cmpcbench"
    (here / "configs" / "tiny-moe.json").write_text(json.dumps(CONFIG))
    (here / "traffic" / "tiny-t32.json").write_text(json.dumps(MIX))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-moe", "source": "test",
                             "file": "cmpcbench/configs/tiny-moe.json", "reduced": [],
                             "why": "CPU test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-moe", "traffic": "tiny-t32",
                               "chips": 1, "why": "CPU test"})
    for metric in bench["per_layer"]:
        if metric["name"] == "launched_ops_ratio":
            metric["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_cell_runs_from_new_files_alone(tmp_path):
    root = moe_root(tmp_path)
    plain = harness.run(CELL, SEED, 0.6, False, t_start=time.perf_counter(), device=CPU, root=root)
    assert plain["correct"] and plain["attempted"] > 0
    assert plain["checks"]["compared_calls"]["value"] >= 1
    assert set(plain["metrics"]) == {"tokens_per_s", "latency_p95_ms", "setup_s"}
    traced = harness.run(CELL, SEED, 0.9, True, t_start=time.perf_counter(), device=CPU, root=root)
    # the CPU launches no compiled kernel: the reader finds nothing and says so
    assert traced["correct"] and "launched_ops_ratio" not in traced["metrics"]


def _session(tmp_path):
    return harness.Session(harness.load_cell(CELL, False, moe_root(tmp_path)), SEED, CPU, None)


def test_a_call_is_the_reference_stack(tmp_path):
    session = _session(tmp_path)
    call = session.issue(traffic.CALL_STREAM, 3, harness.trace.HostRanges())
    x, ids = call["y"]
    assert tuple(x.shape) == (32, 64) and tuple(ids.shape) == (2, 32, 4)
    want = REFERENCE.expect(session.config, session.fixed, session.inputs(traffic.CALL_STREAM, 3))
    assert REFERENCE.mismatches(call["y"], want) == 0
    # 2 x (dense 3·32·64·32, and per MoE layer the router 32·64·32, the
    # shared expert 3·32·64·16, the expected 32·4·8/32 = 32 pairs · 3·64·16)
    assert (call["tokens"], call["ops"]) == (32, 2 * (196608 + 2 * (65536 + 98304 + 98304)))


def test_the_benchmarks_reference_is_the_tests_plain_reference(tmp_path):
    path = ROOT / "tests" / "plain_deepseek_v3_ffn.py"
    spec = importlib.util.spec_from_file_location("plain_v3", path)
    plain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plain)
    session = _session(tmp_path)
    hidden = session.inputs(traffic.CALL_STREAM, 5)
    cfg = {"scales": CONFIG["private_moe"]["fixed_point"], "eps": 1e-6,
           "experts": CONFIG["private_moe"]["experts_held"], "top_k": 4, "n_group": 8,
           "topk_group": 2, "scaling": 2.5}
    p = CONFIG["cmpc"]["p"]
    for prod, mine in ((plain.product, REFERENCE.expect),
                       (plain.product_float32, REFERENCE.control)):
        want = plain.ffn_stack(hidden, session.fixed["dense"], session.fixed["moe"], cfg, p, prod)
        got = mine(session.config, session.fixed, hidden)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def _changed_residue(state, inputs, index):
    x, ids = PROGRAM.call(state, inputs, index)
    x = x.clone()
    x[0, 0] += 1
    return x, ids


def _wrong_expert_id(state, inputs, index):
    x, ids = PROGRAM.call(state, inputs, index)
    ids = ids.clone()
    ids[-1, 0, 0] = (ids[-1, 0, 0] + 1) % CONFIG["private_moe"]["router_experts"]
    return x, ids


def _dropped_routed_pair(state, inputs, index):
    """Each MoE sublayer loses its last routed pair after the load read."""
    for layer in state.stack.layers:
        if hasattr(layer, "_wait_load") and not hasattr(layer, "_dropping"):
            def dropping(event, wait=layer._wait_load):
                m, pairs = wait(event)
                return m, max(pairs - 1, 0)

            layer._wait_load, layer._dropping = dropping, True
    return PROGRAM.call(state, inputs, index)


def _state_unchanged(state, inputs, index):
    x, ids = PROGRAM.call(state, inputs, index)
    p = CONFIG["cmpc"]["p"]
    lifted = inputs.to(torch.int64)
    return torch.where(lifted > (p - 1) // 2, lifted - p, lifted), ids


@pytest.mark.parametrize("program", [_changed_residue, _wrong_expert_id, _dropped_routed_pair,
                                     _state_unchanged, "control"],
                         ids=["changed_residue", "wrong_expert_id", "dropped_routed_pair",
                              "state_unchanged", "control"])
def test_a_broken_program_is_not_correct(tmp_path, program):
    root = moe_root(tmp_path)
    if program == "control":
        program = harness.control_call(CELL, SEED, CPU, root)
    res = harness.run(CELL, SEED, 0.4, False, t_start=time.perf_counter(), device=CPU, root=root,
                      program=program)
    assert res["correct"] is False
    assert res["checks"]["mismatched_residues"]["value"] > 0
    assert res["failed"] >= 1


def test_the_configuration_states_its_cut():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["dsv3-moe"]
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["program"] == "private_moe"
    assert sorted(entry["reduced"]) == sorted(config["published"])
    assert config["published"] == {"num_hidden_layers": 61, "first_k_dense_replace": 3,
                                   "n_routed_experts": 256, "num_nextn_predict_layers": 1}
    pm = config["private_moe"]
    assert config["n_routed_experts"] == len(pm["experts_held"]) == 8
    assert pm["router_experts"] == config["published"]["n_routed_experts"]
    assert (config["hidden_size"], config["intermediate_size"], config["moe_intermediate_size"],
            config["num_experts_per_tok"], config["n_group"], config["topk_group"]) == (
        7168, 18432, 2048, 8, 8, 4)
    # the fixed weights: 1,989,148,672 residues, 7.96 GB as int32
    d, dense_f, f = 7168, 18432, 2048
    moe_layer = d * 256 + 8 * 3 * d * f + 3 * d * f
    assert (config["first_k_dense_replace"] * 3 * d * dense_f + 4 * moe_layer) == 1_989_148_672
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["dsv3-moe.decode"]["config"] == "dsv3-moe"
    traffic_file = BENCH / "traffic" / f"{cells['dsv3-moe.decode']['traffic']}.json"
    mix = json.loads(traffic_file.read_text())
    assert mix == {"tokens": 1024, "in_flight": 2, "activations": "uniform"}
    tokens, ops = REFERENCE.work(config, mix, None)
    # 2 x (3·1024·7168·18432
    #      + 4 · (1024·7168·256 + 3·1024·7168·2048 + 256 · 3·7168·2048))
    assert (tokens, ops) == (1024, 2 * (405874409472 + 4 * (1879048192 + 45097156608
                                                          + 11274289152)))


def test_launched_ops_ratio_against_a_hand_worked_count():
    run = {"trace": {"launch_shapes": {"int32_skinny": [[2, 17, 6, 100, 3]],
                                       "int32_mma": [[34, 8, 32, 16, 1]]}},
           "calls": [{"ops": 1000, "profiled": True}, {"ops": 500, "profiled": False},
                     {"ops": 3000, "profiled": True}]}
    # (2·2·17·6·100 · 3 + 2·34·8·32·16) / (1000 + 3000) = (122400 + 278528) / 4000
    assert LAUNCHED.read(run) == pytest.approx(400928 / 4000, rel=1e-15)
    assert LAUNCHED.read({"trace": None, "calls": run["calls"]}) is None
    assert LAUNCHED.read({"trace": {"launch_shapes": {}}, "calls": run["calls"]}) is None
    assert LAUNCHED.read({**run, "calls": [{"ops": 7, "profiled": False}]}) is None


def test_moe_profiles_reduction():
    ops = [["k1", 0, 2_000_000, "run_batched"], ["k2", 2_000_000, 3_000_000, "run_batched"],
           ["k3", 3_000_000, 7_000_000, "draw"]]
    spans = ["moe.shared", None, "ffn.dense"]
    phases = ["protocol.run_batched.share", None, "protocol.run_batched.multiply"]
    assert moe_profile.device_ms_by(ops, spans, 2) == {"ffn.dense": 2.0, "moe.shared": 1.0,
                                                      "run_batched": 0.5}
    assert moe_profile.span_by_phase(ops, spans, phases, 1) == {
        "ffn.dense": {"multiply": 4.0}, "moe.shared": {"share": 2.0},
        "run_batched": {"master": 1.0}}
    assert moe_profile.per_call({"a": 1, "b": 0}, {"a": 7, "b": 0}, 3) == {"a": 2.0, "b": 0.0}
    kept = moe_profile.layer_spans([["moe.route", 1, 2, 1, None],
                                    ["protocol.run_batched", 1, 2, 2, 1],
                                    ["ffn.dense", 3, 4, 3, None]])
    assert [s[0] for s in kept] == ["moe.route", "ffn.dense"]


def test_moe_profile_runs_on_the_cpu(tmp_path):
    """The tool's whole path at the tiny cell (no device operation on the
    CPU): its counters a call and the calls run again one at a time."""
    record = moe_profile.profile_cell(CELL, SEED, 0.6, CPU, root=moe_root(tmp_path))
    assert record["correct"] and record["device_idle"] is None
    counts = record["counters_a_call"]
    assert counts["moe.host_syncs"] == 2 and counts["moe.plans_built"] == 0
    assert all(r["routed_pairs"] == r["reference_pairs"] > 0 and r["mismatches"] == 0
               for r in record["rechecked"])
