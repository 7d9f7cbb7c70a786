"""On the card: the control, the reference's answer one precision lower
(``harness.control_call``) put in the program's place, at each cell's
own size, has to come out not correct.  Run on a machine with a CUDA
card: ``python -m pytest -q -s -m cuda cmpcbench/tests``."""
import json
import time

import pytest

from cmpcbench import harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [2 ** 31 + 11, 2 ** 32 + 101, 3 * 10 ** 9 + 7]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size_is_not_correct(cuda_device, cell, seed):
    res = harness.run(cell, seed, 1.0, False, t_start=time.perf_counter(), device=cuda_device,
                      program=harness.control_call(cell, seed, cuda_device))
    print(f"[control] {cell} seed={seed} " + json.dumps(res["checks"]))
    assert res["correct"] is False
    assert res["checks"]["wrong_calls"]["value"] == res["checks"]["compared_calls"]["value"]
