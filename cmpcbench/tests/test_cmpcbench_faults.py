"""The check that decides ``correct``: a run with the timed path broken
underneath, or with the control in the program's place, comes out not
correct.  A tiny cell on the CPU; the harness's look for a card is
skipped (``harness.run`` on the CPU device)."""
import time
import types

import pytest
import torch

from _tiny import CELL, ROOT, tiny_root
from cmpcbench import harness

PROGRAM = harness.load_module(ROOT / "cmpcbench" / "programs" / "private_matmul.py", "program")
SEED = 987654321987


def _sound(state, inputs, index):
    return PROGRAM.call(state, inputs, index)


def answer_altered(state, inputs, index):
    y = _sound(state, inputs, index).clone()
    y[0, 0, 0] = (y[0, 0, 0] + 1) % state.plan.field.p
    return y


def half_batch_left_out(state, inputs, index):
    """Only the first half of the products computed; the rest left at zero."""
    half = inputs.shape[0] // 2
    y = torch.zeros(inputs.shape[0], inputs.shape[2], state.b.shape[2], dtype=torch.int64,
                    device=inputs.device)
    y[:half] = _sound(types.SimpleNamespace(**{**vars(state), "b": state.b[:half]}),
                      inputs[:half], index)
    return y


class StateUnchanged:
    """Every call returns the first call's Y."""

    def __init__(self):
        self.y = None

    def __call__(self, state, inputs, index):
        if self.y is None:
            self.y = _sound(state, inputs, index)
        return self.y


@pytest.mark.parametrize("program", [answer_altered, half_batch_left_out, StateUnchanged(), "control"],
                         ids=["answer_altered", "half_batch_left_out", "state_unchanged", "control"])
def test_a_broken_timed_path_is_not_correct(tmp_path, program):
    root = tiny_root(tmp_path)
    cpu = torch.device("cpu")
    if program == "control":
        program = harness.control_call(CELL, SEED, cpu, root)
    res = harness.run(CELL, SEED, 0.3, False, t_start=time.perf_counter(),
                      device=cpu, root=root, program=program)
    assert res["correct"] is False
    assert res["checks"]["mismatched_residues"]["value"] > 0
    assert res["failed"] >= 1
