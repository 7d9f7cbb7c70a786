"""A configuration brings its own program: ``programs/<name>.py`` (the
port's side) and ``references/<name>.py`` (the benchmark's side), found
by the name in its ``"program"``.  The tests' ``two_step`` program, added
to a copy of the benchmark from new files alone, runs end to end on the
CPU and reads correct, and reads not correct with its timed path broken
underneath or with its control in its place."""
import ast
import time
import types

import pytest
import torch

from _tiny import HERE, MIX, ROOT, TWO_STEP, tiny_root
from cmpcbench import harness, traffic

BENCH = ROOT / "cmpcbench"
TWO_STEP_PROGRAM = harness.load_module(HERE / "two_step_program.py", "program")
SEED = 2 ** 35 + 17
CPU = torch.device("cpu")


def test_a_program_added_from_new_files_alone(tmp_path):
    root = tiny_root(tmp_path)
    cell = harness.load_cell(TWO_STEP, False, root)
    assert cell["config"]["program"] == "two_step"
    plain = harness.run(TWO_STEP, SEED, 0.5, False, t_start=time.perf_counter(), device=CPU,
                        root=root)
    assert plain["correct"] and plain["attempted"] > 0
    assert plain["checks"]["compared_calls"]["value"] >= 1
    assert set(plain["metrics"]) == {"tokens_per_s", "latency_p95_ms", "setup_s"}
    traced = harness.run(TWO_STEP, SEED, 0.6, True, t_start=time.perf_counter(), device=CPU,
                         root=root)
    assert traced["correct"] and set(traced["metrics"]) == {"window_calls"}


def test_a_call_carries_its_programs_work(tmp_path):
    session = harness.Session(harness.load_cell(TWO_STEP, False, tiny_root(tmp_path)), SEED, CPU,
                              None)
    call = session.issue(traffic.CALL_STREAM, 0, harness.trace.HostRanges())
    # batch 2 x ma 4 tokens; 2 * 2 * 4 * (8 * 8 + 8 * 6) operations
    assert (call["tokens"], call["ops"]) == (8, 1792)
    y1, y2 = call["y"]
    assert tuple(y1.shape) == (2, 4, 8) and tuple(y2.shape) == (2, 4, 6)


def _step_two_skipped(state, inputs, index):
    y1, _ = TWO_STEP_PROGRAM.call(state, inputs, index)
    return y1, y1


def _first_answer_altered(state, inputs, index):
    """Step one's Y changed in one residue before step two reads it."""

    def altered(plan, a, b, **kw):
        y, tr = state.run_batched(plan, a, b, **kw)
        if plan is state.plan1:
            y = y.clone()
            y[0, 0, 0] = (y[0, 0, 0] + 1) % plan.field.p
        return y, tr

    return TWO_STEP_PROGRAM.call(types.SimpleNamespace(**{**vars(state), "run_batched": altered}),
                                 inputs, index)


def _first_weight_for_all(state, inputs, index):
    """Step one's first weight broadcast over the batch."""
    b1 = state.b1[:1].expand_as(state.b1)
    return TWO_STEP_PROGRAM.call(types.SimpleNamespace(**{**vars(state), "b1": b1}), inputs, index)


@pytest.mark.parametrize("program", [_step_two_skipped, _first_answer_altered,
                                     _first_weight_for_all, "control"],
                         ids=["step_two_skipped", "first_answer_altered", "first_weight_for_all",
                              "control"])
def test_a_broken_two_step_program_is_not_correct(tmp_path, program):
    root = tiny_root(tmp_path)
    if program == "control":
        program = harness.control_call(TWO_STEP, SEED, CPU, root)
    res = harness.run(TWO_STEP, SEED, 0.3, False, t_start=time.perf_counter(), device=CPU,
                      root=root, program=program)
    assert res["correct"] is False
    assert res["checks"]["mismatched_residues"]["value"] > 0
    assert res["failed"] >= 1


def test_private_matmuls_draws_are_traffics():
    ref = harness.load_module(BENCH / "references" / "private_matmul.py", "reference")
    config = {"private_matmul": {"k": 16, "mb": 12}, "cmpc": {"p": 65521}}
    seed = 2 ** 40 + 3
    w = ref.fixed(config, MIX, seed, CPU)
    assert torch.equal(w, traffic.weight(seed, 16, 12, 65521, CPU))
    for stream, index in ((traffic.CALL_STREAM, 5), (traffic.WARM_STREAM, 0)):
        a = ref.inputs(config, MIX, w, seed, stream, index, CPU)
        assert torch.equal(a, traffic.activations(MIX, seed, stream, index, 16, 65521, CPU))
    assert ref.work(config, MIX, a) == (8, 2 * 2 * 16 * 4 * 12)
    want = ref.expect(config, w, a)
    assert ref.mismatches(want, want) == 0
    assert ref.mismatches(want[:1], want) == want.numel()


def _imported(path):
    """Top-level names of the modules ``path`` imports, with the
    ``cmpcbench`` modules it names walked in turn."""
    names, todo, seen = set(), [path], set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.partition(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add((node.module or "").partition(".")[0])
                if node.module == "cmpcbench":
                    todo += [BENCH / f"{a.name}.py" for a in node.names]
    return names


@pytest.mark.parametrize("path", [*sorted((BENCH / "references").glob("*.py")),
                                  HERE / "two_step_reference.py"], ids=lambda p: p.name)
def test_no_reference_imports_the_program_or_jax(path):
    names = _imported(path)
    assert "cmpcbench" in names or "torch" in names
    assert not names & {"repro_torch", "jax", "jaxlib", "flax", "repro"}


def test_the_harness_names_no_program_but_the_default():
    source = (BENCH / "harness.py").read_text()
    programs = {p.stem for p in (BENCH / "programs").glob("*.py")} | {"two_step"}
    assert harness.DEFAULT_PROGRAM in programs
    for name in programs - {harness.DEFAULT_PROGRAM}:
        assert name not in source
    tree = ast.parse(source)
    for node in ast.walk(tree):  # the port's launch counters, and no entry of it
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("repro_torch"):
            assert node.module == "repro_torch.kernels.modmatmul"


def test_every_program_has_both_files():
    programs = {p.stem for p in (BENCH / "programs").glob("*.py")}
    assert programs == {p.stem for p in (BENCH / "references").glob("*.py")}
    for name in programs:
        ref = harness.load_module(BENCH / "references" / f"{name}.py", "reference")
        prog = harness.load_module(BENCH / "programs" / f"{name}.py", "program")
        assert isinstance(ref.FIELDS, (set, frozenset)) and "in_flight" not in ref.FIELDS
        for fn in ("fixed", "inputs", "work", "expect", "control", "mismatches"):
            assert callable(getattr(ref, fn))
        assert callable(prog.prepare) and callable(prog.call)


def test_a_mix_holds_only_what_its_reference_reads():
    assert traffic.check_mix(dict(MIX), {"batch", "ma", "activations"}) == MIX
    with pytest.raises(ValueError, match="unknown fields"):
        traffic.check_mix({**MIX, "experts": 64}, {"batch", "ma", "activations"})
    assert traffic.check_mix({"in_flight": 1, "experts": 64}, {"experts"})
    with pytest.raises(ValueError, match="in_flight"):
        traffic.check_mix({"experts": 64}, {"experts"})
    with pytest.raises(ValueError, match="batch"):
        traffic.check_mix({**MIX, "batch": 0}, {"batch", "ma", "activations"})
