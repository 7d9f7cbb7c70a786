"""Feed-forward blocks: the SwiGLU MLP.

The counterpart of ``repro.models.ffn``'s dense half.  The token-choice
MoE (``moe_params``, ``moe_ffn``) waits for the MoE models (ROADMAP
item 12).
"""
from __future__ import annotations

from typing import Dict

import torch

from .common import ParamInfo


def mlp_params(d: int, ff: int) -> Dict[str, ParamInfo]:
    return {
        "w_gate": ParamInfo((d, ff), ("embed", "ff")),
        "w_up": ParamInfo((d, ff), ("embed", "ff")),
        "w_down": ParamInfo((ff, d), ("ff", "embed")),
    }


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    return (
        torch.nn.functional.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    ) @ p["w_down"].to(dt)
