"""The one generator of every traffic mix: what a call carries.

A mix is a file ``traffic/<name>.json`` of parameters:

* ``in_flight``  calls the master keeps issued ahead of the one it waits on
                 (read by the harness, in every mix);
* ``batch``      products per call (clients, or prompts, secured together),
* ``ma``         tokens per product (rows of A^T),
* ``activations`` how the client's activations are drawn; ``"uniform"``:
                 residues uniform in [0, p), the field's full range.

Besides ``in_flight``, a mix holds the fields that its configuration's
reference names in ``FIELDS`` (``references/<program>.py``), and no other.

Everything is drawn on the device from ``torch.Generator``s seeded from
the run's ``--seed`` and the call's index, so a seed gives the same
inputs, no input repeats within a run, and any call's activations can be
drawn again after the window for the reference.
"""
from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1
WEIGHT_STREAM = 1  # the weight's stream; calls use 2, warm-up calls 3
CALL_STREAM = 2
WARM_STREAM = 3
WHOLE_FIELDS = ("batch", "ma", "in_flight")


def mix64(*words: int) -> int:
    """A 63-bit seed from any whole numbers (splitmix64 over the words)."""
    x = 0x9E3779B97F4A7C15
    for w in words:
        x = (x ^ (w & MASK64)) & MASK64
        x = (x + 0x9E3779B97F4A7C15) & MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
        x ^= x >> 31
    return x >> 1


def check_mix(mix: dict, fields) -> dict:
    """``mix``, refused where it holds a field outside ``fields`` and
    ``in_flight``, or where a field read is not a valid value."""
    read = set(fields) | {"in_flight"}
    unknown = set(mix) - read
    if unknown:
        raise ValueError(f"traffic mix: unknown fields {sorted(unknown)}")
    for key in (k for k in WHOLE_FIELDS if k in read):
        if not isinstance(mix.get(key), int) or mix[key] < 1:
            raise ValueError(f"traffic mix: {key} must be a whole number >= 1")
    if "activations" in read and mix.get("activations") != "uniform":
        raise ValueError(f"traffic mix: unknown activation draw {mix.get('activations')!r}")
    return mix


def residues(seed: int, stream: int, index: int, shape, p: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(mix64(seed, stream, index))
    return torch.randint(0, p, tuple(shape), generator=gen, dtype=torch.int32, device=device)


def weight(seed: int, k: int, mb: int, p: int, device) -> torch.Tensor:
    """The model owner's weight W [k, mb], fixed for the run."""
    return residues(seed, WEIGHT_STREAM, 0, (k, mb), p, device)


def activations(mix: dict, seed: int, stream: int, index: int, k: int, p: int, device):
    """A call's activations A [batch, k, ma]."""
    return residues(seed, stream, index, (mix["batch"], k, mix["ma"]), p, device)
