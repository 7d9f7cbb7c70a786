"""The port's side of ``two_step`` (see ``two_step_reference.py``): two
calls of ``protocol.run_batched``, the first with a distinct weight per
batch element, the second against a broadcast weight, on the first's Y
as its activations.

``_tiny.py`` writes this file into a copy of the benchmark as
``programs/two_step.py``.
"""
import types


def prepare(config, mix, fixed, device):
    from repro_torch.core import protocol
    from repro_torch.core.constructions import build_scheme
    from repro_torch.core.gf import Field
    from repro_torch.core.planner import BlockShapes, get_plan

    ts, cm = config["two_step"], config["cmpc"]
    scheme = build_scheme(cm["method"], cm["s"], cm["t"], cm["z"])

    def plan(k, mb):
        return get_plan(scheme, BlockShapes(k, mix["ma"], mb, cm["s"], cm["t"]),
                        field=Field(cm["p"]))

    return types.SimpleNamespace(
        run_batched=protocol.run_batched, plan1=plan(ts["k"], ts["m1"]),
        plan2=plan(ts["m1"], ts["m2"]), b1=fixed["w1"],
        b2=fixed["w2"].expand(mix["batch"], ts["m1"], ts["m2"]), device=device)


def call(state, inputs, index):
    kw = dict(backend="auto", fused_masks=False, device=state.device)
    y1, _ = state.run_batched(state.plan1, inputs, state.b1, seed=2 * index, **kw)
    y2, _ = state.run_batched(state.plan2, y1.transpose(1, 2), state.b2, seed=2 * index + 1, **kw)
    return y1, y2
