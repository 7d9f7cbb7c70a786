"""The port's side of ``private_moe``: DeepSeek-V3's FFN stack held
private, ``repro_torch.core.moe.PrivateFFNStack`` over the configuration's
dense sublayers (``PrivateFFN``) and MoE sublayers (``PrivateMoE``, the
held experts ``private_moe.experts_held`` of ``private_moe.router_experts``),
every product one ``protocol.run_batched``.  ``repro_torch`` is imported
inside the functions only.
"""
import types


def prepare(config, mix, fixed, device):
    """The kernel library loaded, the sublayers over the fixed weights, and
    every plan a call of ``tokens`` tokens can need."""
    from repro_torch.core import moe

    if device.type == "cuda":
        from repro_torch.kernels.modmatmul import kernel

        kernel.load_library()
    pm, cm = config["private_moe"], config["cmpc"]
    products = moe.PrivateProducts(cm["method"], cm["s"], cm["t"], cm["z"], cm["p"],
                                   device=device)
    fp = moe.FixedPoint(**pm["fixed_point"], eps=config["rms_norm_eps"])
    layers = [moe.PrivateFFN(w["gate_up"], w["down"], products, fp) for w in fixed["dense"]]
    layers += [moe.PrivateMoE(w["router"], w["bias"], pm["experts_held"], w["gate_up"], w["down"],
                              w["shared_gate_up"], w["shared_down"], products,
                              top_k=config["num_experts_per_tok"], n_group=config["n_group"],
                              topk_group=config["topk_group"],
                              scaling=config["routed_scaling_factor"], fp=fp,
                              bucket=pm["pad_bucket"])
               for w in fixed["moe"]]
    stack = moe.PrivateFFNStack(layers, products)
    stack.prepare(mix["tokens"])
    return types.SimpleNamespace(stack=stack)


def call(state, inputs, index):
    """Enqueue one call on the hidden states ``inputs``; (X, expert ids),
    unsynchronised but for one load read a MoE sublayer."""
    return state.stack(inputs, seed=index)
