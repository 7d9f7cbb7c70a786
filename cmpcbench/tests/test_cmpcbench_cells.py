"""BENCHMARK.json against the files the harness finds by name, and a cell
added from new files alone, run end to end on the CPU."""
import hashlib
import json
import re
import time

import pytest
import torch

from _tiny import CELL, ROOT, tiny_root
from cmpcbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace_on", [False, True])
def test_every_workload_resolves_to_its_files(cell, trace_on):
    spec = harness.load_cell(cell, trace_on)
    cfg = spec["config"]
    if "program" not in cfg:  # the default program reads these
        assert {"k", "mb"} <= set(cfg["private_matmul"])
        assert {"method", "s", "t", "z", "p"} <= set(cfg["cmpc"])
    program = cfg.get("program", harness.DEFAULT_PROGRAM)
    for side in ("programs", "references"):
        assert (ROOT / "cmpcbench" / side / f"{program}.py").is_file()
    entry = next(c for c in BENCH["configs"] if c["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell))
    for key in entry["reduced"]:
        assert cfg[key] != cfg["published"][key]
    metrics = BENCH["per_layer" if trace_on else "end_to_end"]
    assert set(spec["readers"]) == {m["name"] for m in metrics if cell in m.get("workloads", [cell])}
    assert spec["readers"]


def test_the_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "cmpcbench" / "traffic" / f"{w['traffic']}.json").exists()
    for c in BENCH["configs"]:
        assert c["file"].startswith("cmpcbench/") and (ROOT / c["file"]).exists()
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    n = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200 and n <= 24


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "cmpcbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_from_new_files_alone(tmp_path):
    root = tiny_root(tmp_path)
    before = _digests(ROOT)
    after = _digests(root)
    changed = [p for p in after if p in before and after[p] != before[p]]
    assert changed == []  # only new files, besides the new entries of BENCHMARK.json
    cpu = torch.device("cpu")
    plain = harness.run(CELL, 2 ** 33 + 5, 0.5, False, t_start=time.perf_counter(),
                        device=cpu, root=root)
    assert plain["correct"] and plain["attempted"] > 0
    assert set(plain["metrics"]) == {"tokens_per_s", "latency_p95_ms", "setup_s"}
    assert list(plain)[-1] == "checks"
    traced = harness.run(CELL, 2 ** 33 + 5, 0.6, True, t_start=time.perf_counter(),
                         device=cpu, root=root)
    assert traced["correct"] and set(traced["metrics"]) == {"window_calls"}
    assert traced["metrics"]["window_calls"]["value"] == traced["attempted"]
