"""The port's side of ``private_matmul``: one call of
``repro_torch.core.protocol.run_batched`` (the entry behind
``secure_matmul_batched`` and ``PrivateLinear``) against the run's fixed
weight, handed in as a broadcast view ``w.expand(batch, k, mb)``.
``repro_torch`` is imported inside the functions only.
"""
import types


def prepare(config, mix, fixed, device):
    """The kernel library loaded, W's broadcast view, the plan and the entry."""
    from repro_torch.core import protocol
    from repro_torch.core.constructions import build_scheme
    from repro_torch.core.gf import Field
    from repro_torch.core.planner import BlockShapes, get_plan

    k, mb = config["private_matmul"]["k"], config["private_matmul"]["mb"]
    cm = config["cmpc"]
    if device.type == "cuda":
        from repro_torch.kernels.modmatmul import kernel

        kernel.load_library()
    shapes = BlockShapes(k, mix["ma"], mb, cm["s"], cm["t"])
    plan = get_plan(build_scheme(cm["method"], cm["s"], cm["t"], cm["z"]), shapes,
                    field=Field(cm["p"]))
    # every product of a call is against the one weight: a broadcast
    # view, as secure_matmul_batched hands it in
    return types.SimpleNamespace(run_batched=protocol.run_batched, plan=plan,
                                 b=fixed.expand(mix["batch"], k, mb), device=device)


def call(state, inputs, index):
    """Enqueue one call on the activations ``inputs``; Y, unsynchronised."""
    y, _ = state.run_batched(state.plan, inputs, state.b, seed=index, backend="auto",
                             fused_masks=False, device=state.device)
    return y
