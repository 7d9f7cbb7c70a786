"""Cells small enough for the CPU, added to a copy of the benchmark from
new files alone: one of the default program and one of ``two_step``, a
program of two private products whose two files are the tests' own."""
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
CELL = "tiny.decode"
TWO_STEP = "tiny-two-step.decode"
CONFIG = {"source": "test", "private_matmul": {"k": 8, "mb": 8},
          "cmpc": {"method": "age", "s": 2, "t": 2, "z": 1, "p": 65521}}
TWO_STEP_CONFIG = {"source": "test", "program": "two_step", "two_step": {"k": 8, "m1": 8, "m2": 6},
                   "cmpc": {"method": "age", "s": 2, "t": 2, "z": 1, "p": 65521}}
MIX = {"batch": 2, "ma": 4, "in_flight": 2, "activations": "uniform"}
READER = '"""A metric a later change adds: calls in the window."""\n\n\ndef read(run):\n    return float(len(run["calls"]))\n'


def tiny_root(tmp: Path) -> Path:
    """A copy of the benchmark plus two configurations (the second with
    its program's two files), one mix, one per-layer metric and two
    cells, each a new file or a new entry."""
    shutil.copytree(ROOT / "cmpcbench", tmp / "cmpcbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp / "cmpcbench"
    (here / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (here / "configs" / "tiny-two-step.json").write_text(json.dumps(TWO_STEP_CONFIG))
    shutil.copy(HERE / "two_step_program.py", here / "programs" / "two_step.py")
    shutil.copy(HERE / "two_step_reference.py", here / "references" / "two_step.py")
    (here / "traffic" / "tiny-b2x4.json").write_text(json.dumps(MIX))
    (here / "metrics" / "window_calls.py").write_text(READER)
    for name in ("tiny", "tiny-two-step"):
        bench["configs"].append({"name": name, "source": "test", "file": f"cmpcbench/configs/{name}.json",
                                 "reduced": [], "why": "CPU test"})
    for cell, config in ((CELL, "tiny"), (TWO_STEP, "tiny-two-step")):
        bench["workloads"].append({"name": cell, "config": config, "traffic": "tiny-b2x4",
                                   "chips": 1, "why": "CPU test"})
    bench["per_layer"].append({"name": "window_calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "harness", "moves": "tokens_per_s",
                               "workloads": [CELL, TWO_STEP]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
