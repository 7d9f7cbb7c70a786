"""A cell small enough for the CPU, added to a copy of the benchmark from
new files alone."""
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "tiny.decode"
CONFIG = {"source": "test", "private_matmul": {"k": 8, "mb": 8},
          "cmpc": {"method": "age", "s": 2, "t": 2, "z": 1, "p": 65521}}
MIX = {"batch": 2, "ma": 4, "in_flight": 2, "activations": "uniform"}
READER = '"""A metric a later change adds: calls in the window."""\n\n\ndef read(run):\n    return float(len(run["calls"]))\n'


def tiny_root(tmp: Path) -> Path:
    """A copy of the benchmark plus one configuration, one mix, one
    per-layer metric and one cell, each a new file or a new entry."""
    shutil.copytree(ROOT / "cmpcbench", tmp / "cmpcbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "cmpcbench" / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (tmp / "cmpcbench" / "traffic" / "tiny-b2x4.json").write_text(json.dumps(MIX))
    (tmp / "cmpcbench" / "metrics" / "window_calls.py").write_text(READER)
    bench["configs"].append({"name": "tiny", "source": "test", "file": "cmpcbench/configs/tiny.json",
                             "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": CELL, "config": "tiny", "traffic": "tiny-b2x4",
                               "chips": 1, "why": "CPU test"})
    bench["per_layer"].append({"name": "window_calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "harness", "moves": "tokens_per_s",
                               "workloads": [CELL]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
