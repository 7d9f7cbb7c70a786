"""The benchmark's side of the program ``private_matmul``: Y[i] = A[i]^T W
mod p, a batch of private products against one weight the model owner
fixes for the run.  A configuration without ``"program"`` names it.

It reads ``private_matmul`` (``k``, ``mb``: W's rows and columns) and
``cmpc.p`` of the configuration, and ``batch``, ``ma`` and
``activations`` of the mix.  Inputs come from ``traffic.py``, the plain
answer and its control from ``reference.py``, a call's operations from
``roofline.py``.  Nothing of the program is imported.
"""
import torch

from cmpcbench import reference, roofline, traffic

FIELDS = {"batch", "ma", "activations"}


def fixed(config, mix, seed, device):
    """The weight W [k, mb], drawn from the seed."""
    pm = config["private_matmul"]
    return traffic.weight(seed, pm["k"], pm["mb"], config["cmpc"]["p"], device)


def inputs(config, mix, fixed, seed, stream, index, device):
    """A call's activations A [batch, k, ma]."""
    return traffic.activations(mix, seed, stream, index, config["private_matmul"]["k"],
                               config["cmpc"]["p"], device)


def work(config, mix, inputs):
    """(tokens, operations) of one call: batch x ma, and 2 * batch * k * ma * mb."""
    pm = config["private_matmul"]
    return (mix["batch"] * mix["ma"],
            roofline.call_ops(mix["batch"], pm["k"], mix["ma"], pm["mb"]))


def expect(config, fixed, inputs):
    return reference.y_exact(inputs, fixed, config["cmpc"]["p"])


def control(config, fixed, inputs):
    return reference.y_float32(inputs, fixed, config["cmpc"]["p"])


def mismatches(output, expected) -> int:
    """Residues of ``output`` that differ from ``expected``; every element
    where the shapes differ."""
    if tuple(output.shape) != tuple(expected.shape):
        return expected.numel()
    return int((output.to(torch.int64) != expected).sum())
