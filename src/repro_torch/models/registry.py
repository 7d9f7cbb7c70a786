"""Model registry: ``build_model(cfg)`` for the serving path.

The counterpart of ``repro.models.registry`` for the decoder families
``dense`` and ``moe``.  A :class:`Model` is a ``torch.nn.Module`` whose
parameters keep the reference's tree and names (``embed``,
``final_norm``, ``lm_head``, ``layers.attn.wq``, ``layers.mlp.w_gate``,
``layers.moe.router``, ``dense_layer_0.attn.w_dkv`` ...; the trunk
stacked along a leading layers axis), so the reference's weights load
one to one (``convert.decoder_params_from_reference`` then
``load_state_dict``).  It serves and does not train: its parameters hold
no gradients.  Every other family (vlm, encdec, ssm, hybrid) raises
``NotImplementedError`` naming ROADMAP item 12.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..core.protocol import resolve_device
from . import lm
from .common import ParamTree, map_tree, materialize


def _register(module: torch.nn.Module, tree: ParamTree) -> None:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            child = torch.nn.Module()
            _register(child, leaf)
            module.add_module(name, child)
        else:
            module.register_parameter(name, torch.nn.Parameter(leaf, requires_grad=False))


def _tree(module: torch.nn.Module) -> ParamTree:
    out: Dict[str, Any] = dict(module.named_parameters(recurse=False))
    out.update({name: _tree(child) for name, child in module.named_children()})
    return out


class Model(torch.nn.Module):
    """A decoder holding its parameters; the methods are the
    reference ``Model``'s serving callables with the parameters bound:
    ``prefill(batch, caches)``, ``decode_step(tokens, caches,
    positions)``, ``hidden_step(tokens, caches, positions)``,
    ``head_matrix()`` and ``init_cache(batch, max_len)``."""

    def __init__(self, cfg: ModelConfig, params: ParamTree):
        super().__init__()
        self.cfg = cfg
        _register(self, params)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def abstract_params(self) -> ParamTree:
        return lm.decoder_abstract(self.cfg)

    def params(self) -> ParamTree:
        """The parameters as the reference's nested dict."""
        return _tree(self)

    @torch.no_grad()
    def forward(self, batch):
        return lm.decoder_forward(self.cfg, self.params(), batch)[0]

    @torch.no_grad()
    def prefill(self, batch, caches):
        """(last logits [B, 1, V], caches)."""
        return lm.decoder_prefill(self.cfg, self.params(), batch, caches)

    @torch.no_grad()
    def decode_step(self, tokens, caches, positions):
        return lm.decoder_decode_step(self.cfg, self.params(), tokens, caches, positions)

    @torch.no_grad()
    def hidden_step(self, tokens, caches, positions):
        return lm.decoder_hidden_step(self.cfg, self.params(), tokens, caches, positions)

    @torch.no_grad()
    def head_matrix(self) -> torch.Tensor:
        return lm.head_matrix(self.cfg, self.params())

    def cache_abstract(self, batch: int, max_len: int):
        return lm.decoder_cache_abstract(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int):
        """Concrete initial caches on the model's device, all zero: the
        stacked GQA or MLA buffers and those of the dense prologue layers
        (the reference's -1e30 fill of ssm stabiliser leaves comes with
        the ssm families)."""
        return map_tree(lambda _, s: torch.zeros(s.shape, dtype=s.dtype, device=self.device),
                        self.cache_abstract(batch, max_len))


def build_model(cfg: ModelConfig, *, seed: int = 0, device=None) -> Model:
    """A decoder with weights drawn by ``materialize`` from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (default:
    the GPU), each weight in the dtype ``lm.stored_infos`` gives it."""
    lm._not_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = materialize(lm.stored_infos(cfg, lm.decoder_abstract(cfg)), gen, device)
    return Model(cfg, params)
