"""The check that decides ``correct``: a run with the timed path broken
underneath, or with the control in the program's place, comes out not
correct.  A tiny cell on the CPU; the harness's look for a card is
skipped (``harness.run`` on the CPU device)."""
import time

import pytest
import torch

from _tiny import CELL, tiny_root
from cmpcbench import harness, reference


def _sound(plan, a, b, index):
    return harness.protocol_program(a.device)(plan, a, b, index)


def answer_altered(plan, a, b, index):
    y = _sound(plan, a, b, index).clone()
    y[0, 0, 0] = (y[0, 0, 0] + 1) % plan.field.p
    return y


def half_batch_left_out(plan, a, b, index):
    """Only the first half of the products computed; the rest left at zero."""
    half = a.shape[0] // 2
    y = torch.zeros(a.shape[0], a.shape[2], b.shape[2], dtype=torch.int64, device=a.device)
    y[:half] = _sound(plan, a[:half], b[:half], index)
    return y


class StateUnchanged:
    """Every call returns the first call's Y."""

    def __init__(self):
        self.y = None

    def __call__(self, plan, a, b, index):
        if self.y is None:
            self.y = _sound(plan, a, b, index)
        return self.y


def control(plan, a, b, index):
    return reference.y_float32(a, b[0], plan.field.p)


@pytest.mark.parametrize("program", [answer_altered, half_batch_left_out, StateUnchanged(), control],
                         ids=["answer_altered", "half_batch_left_out", "state_unchanged", "control"])
def test_a_broken_timed_path_is_not_correct(tmp_path, program):
    root = tiny_root(tmp_path)
    res = harness.run(CELL, 987654321987, 0.3, False, t_start=time.perf_counter(),
                      device=torch.device("cpu"), root=root, program=program)
    assert res["correct"] is False
    assert res["checks"]["mismatched_residues"]["value"] > 0
    assert res["failed"] >= 1

