"""On the card: the control, the reference in float32 put in the
program's place, at each cell's own size, has to come out not correct;
and the sound program, on the same seeds, correct.  Run on a machine
with a CUDA card: ``python -m pytest -q -s -m cuda cmpcbench/tests``."""
import json
import time

import pytest

from cmpcbench import harness, reference

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [2 ** 31 + 11, 2 ** 32 + 101, 3 * 10 ** 9 + 7]


def control(plan, a, b, index):
    return reference.y_float32(a, b[0], plan.field.p)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size_is_not_correct(cuda_device, cell, seed):
    res = harness.run(cell, seed, 1.0, False, t_start=time.perf_counter(), device=cuda_device,
                      program=control)
    print(f"[control] {cell} seed={seed} " + json.dumps(res["checks"]))
    assert res["correct"] is False
    assert res["checks"]["wrong_calls"]["value"] == res["checks"]["compared_calls"]["value"]
