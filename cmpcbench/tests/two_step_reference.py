"""The benchmark's side of ``two_step``, a program of the CPU tests: two
private products in a row.  Step one multiplies each batch element's
activations by a weight of its own, W1[i] [k, m1]; the master passes
Y1[i] on as the next activations, and step two multiplies them by one
weight W2 [m1, m2] shared by the batch.  The answer is (Y1, Y2).

``_tiny.py`` writes this file into a copy of the benchmark as
``references/two_step.py``.
"""
import torch

from cmpcbench import reference, roofline, traffic

FIELDS = {"batch", "ma", "activations"}


def fixed(config, mix, seed, device):
    """W1 [batch, k, m1], a weight per batch element, and W2 [m1, m2]."""
    ts, p = config["two_step"], config["cmpc"]["p"]
    return {"w1": traffic.residues(seed, traffic.WEIGHT_STREAM, 1,
                                   (mix["batch"], ts["k"], ts["m1"]), p, device),
            "w2": traffic.residues(seed, traffic.WEIGHT_STREAM, 2, (ts["m1"], ts["m2"]), p, device)}


def inputs(config, mix, fixed, seed, stream, index, device):
    return traffic.activations(mix, seed, stream, index, config["two_step"]["k"],
                               config["cmpc"]["p"], device)


def work(config, mix, inputs):
    ts, batch, ma = config["two_step"], mix["batch"], mix["ma"]
    return (batch * ma, roofline.call_ops(batch, ts["k"], ma, ts["m1"])
            + roofline.call_ops(batch, ts["m1"], ma, ts["m2"]))


def _steps(product, config, fixed, a):
    p = config["cmpc"]["p"]
    y1 = torch.cat([product(a[i:i + 1], fixed["w1"][i], p) for i in range(a.shape[0])])
    return y1, product(y1.transpose(1, 2), fixed["w2"], p)


def expect(config, fixed, inputs):
    return _steps(reference.y_exact, config, fixed, inputs)


def control(config, fixed, inputs):
    return _steps(reference.y_float32, config, fixed, inputs)


def mismatches(output, expected) -> int:
    """Residues of both steps' answers that differ; every element of a
    step whose shape differs, and of both where the output is not a pair."""
    if not isinstance(output, tuple) or len(output) != len(expected):
        return sum(e.numel() for e in expected)
    return sum(e.numel() if tuple(o.shape) != tuple(e.shape)
               else int((o.to(torch.int64) != e).sum()) for o, e in zip(output, expected))
