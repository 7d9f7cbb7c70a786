"""Model registry: ``build_model(cfg)`` for the serving path.

The counterpart of ``repro.models.registry`` for every family: the
decoders ``dense``, ``moe`` and ``vlm``, the encoder-decoder ``encdec``
and the recurrent ``ssm`` (xLSTM) and ``hybrid`` (Zamba2).  A
:class:`Model` is a ``torch.nn.Module`` whose parameters keep the
reference's tree and names (``embed``, ``final_norm``, ``lm_head``,
``layers.attn.wq``, ``layers.mlp.w_gate``, ``layers.moe.router``,
``dense_layer_0.attn.w_dkv``, ``enc_layers.attn.wq``,
``dec_layers.cross_attn.wk``, ``slstm.core.r_gates``,
``mamba.core.conv_w``, ``lora.b_q`` ...; each stack of blocks along a
leading layers axis, xLSTM's mLSTM blocks along ``[G, k-1]``), so the
reference's weights load one to one
(``convert.decoder_params_from_reference`` then ``load_state_dict``).
A serving model (``build_model``'s default) holds each weight in the
dtype ``lm.stored_infos`` gives it, records no gradients, and its
serving methods run under ``torch.no_grad``.  A trainable model
(``build_model(..., train=True)``) holds every weight in float32, the
reference's ``param_dtype``, with ``requires_grad``: ``loss(batch)``
is the reference's ``Model.loss`` on them (``loss`` below), and the
trainer's AdamW keeps float32 master weights.  An encoder-decoder
(:class:`EncDecModel`) and the recurrent models (:class:`RecurrentModel`)
have no split lm head: their ``hidden_step`` and ``head_matrix`` are
None, as the reference's.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.protocol import resolve_device
from . import hybrid, lm
from .common import ParamTree, ShapeDtype, chunked_softmax_xent, iter_leaves, map_tree, materialize

_RECURRENT = {  # family: (abstract, forward, cache_abstract)
    "ssm": (hybrid.xlstm_abstract, hybrid.xlstm_forward, hybrid.xlstm_cache_abstract),
    "hybrid": (hybrid.zamba_abstract, hybrid.zamba_forward, hybrid.zamba_cache_abstract),
}


def params_abstract(cfg: ModelConfig) -> ParamTree:
    """The ParamInfo tree of ``cfg``'s family."""
    lm._not_ported(cfg)
    if cfg.family in _RECURRENT:
        return _RECURRENT[cfg.family][0](cfg)
    return lm.encdec_abstract(cfg) if cfg.family == "encdec" else lm.decoder_abstract(cfg)


def cache_abstract(cfg: ModelConfig, batch: int, max_len: int) -> ParamTree:
    """The ShapeDtype cache tree of ``cfg``'s family: a decoder's
    stacked (and dense-prologue) KV or MLA buffers; an encoder-decoder's
    stacked self-attention buffers, ``enc_out`` [B, max_len, d] bfloat16
    (the encoder's output, zero-padded) and ``enc_len`` (its valid
    length), as the reference's registry adds them; xLSTM's stacked
    float32 sLSTM and mLSTM states; Zamba2's stacked shared-block KV
    buffers and bfloat16 Mamba2 states."""
    lm._not_ported(cfg)
    if cfg.family in _RECURRENT:
        return _RECURRENT[cfg.family][2](cfg, batch, max_len)
    if cfg.family != "encdec":
        return lm.decoder_cache_abstract(cfg, batch, max_len)
    caches = lm.encdec_cache_abstract(cfg, batch, max_len)
    caches["enc_out"] = ShapeDtype((batch, max_len, cfg.d_model), torch.bfloat16)
    caches["enc_len"] = ShapeDtype((), torch.int32)
    return caches


def batch_spec(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, ShapeDtype]:
    """Abstract inputs for one workload cell (no allocation), the
    reference's: int32 tokens (and train labels; tokens alone for the
    decoders and the recurrent families), bfloat16 frames of
    an encoder-decoder (decoder tokens ``max(T // 8, 16)``, 1 at
    decode) and a vlm's bfloat16 patch prefix of ``min(frontend_len,
    T // 4)`` (the tokens fill the rest; none at decode)."""
    b, t = shape.global_batch, shape.seq_len
    tok = lambda n: ShapeDtype((b, n), torch.int32)  # noqa: E731
    emb = lambda n: ShapeDtype((b, n, cfg.d_model), torch.bfloat16)  # noqa: E731
    if cfg.family == "encdec":
        dec_t = 1 if shape.kind == "decode" else max(t // 8, 16)
        spec = {"frames": emb(t), "tokens": tok(dec_t)}
    elif shape.kind == "decode":
        return {"tokens": tok(1)}
    elif cfg.family == "vlm":
        pt = min(cfg.frontend_len, t // 4)
        dec_t = t - pt
        spec = {"patches": emb(pt), "tokens": tok(dec_t)}
    else:
        dec_t = t
        spec = {"tokens": tok(t)}
    if shape.kind == "train":
        spec["labels"] = tok(dec_t)
    return spec


def loss(cfg: ModelConfig, params: ParamTree, batch) -> tuple:
    """The reference's ``Model.loss``: (scalar float32 loss, {"xent",
    "aux"}) of ``batch`` (``tokens`` and ``labels``, -1 ignored; a vlm's
    ``patches``; an encoder-decoder's ``frames``) under ``params``.  The
    decoders add the MoE aux term; the recurrent families' is zero
    (``_generic_loss``)."""
    lm._not_ported(cfg)
    if cfg.family in _RECURRENT:
        return _generic_loss(cfg, _RECURRENT[cfg.family][1], params, batch)
    if cfg.family == "encdec":
        return lm.encdec_loss(cfg, params, batch)
    return lm.decoder_loss(cfg, params, batch)


def _generic_loss(cfg, fwd, params, batch):
    hidden, _ = fwd(cfg, params, batch, head_mode="none")
    labels = torch.as_tensor(batch["labels"], device=hidden.device).long()
    xent = chunked_softmax_xent(hidden, lm._head(cfg, params), labels,
                                logit_scale=cfg.logit_scale, n_vocab=cfg.vocab_size)
    aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    return xent + aux, {"xent": xent, "aux": aux}


def _register(module: torch.nn.Module, tree: ParamTree, requires_grad: bool) -> None:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            child = torch.nn.Module()
            _register(child, leaf, requires_grad)
            module.add_module(name, child)
        else:
            module.register_parameter(name, torch.nn.Parameter(leaf, requires_grad=requires_grad))


def _tree(module: torch.nn.Module) -> ParamTree:
    out: Dict[str, Any] = dict(module.named_parameters(recurse=False))
    out.update({name: _tree(child) for name, child in module.named_children()})
    return out


class Model(torch.nn.Module):
    """A decoder holding its parameters; the methods are the
    reference ``Model``'s serving callables with the parameters bound:
    ``prefill(batch, caches)``, ``decode_step(tokens, caches,
    positions)``, ``hidden_step(tokens, caches, positions)``,
    ``head_matrix()``, ``init_cache(batch, max_len)`` and
    ``batch_spec(shape)``; and ``loss(batch)``, with gradients when the
    parameters require them (``train``)."""

    def __init__(self, cfg: ModelConfig, params: ParamTree, train: bool = False):
        super().__init__()
        self.cfg = cfg
        _register(self, params, train)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def abstract_params(self) -> ParamTree:
        return params_abstract(self.cfg)

    def params(self) -> ParamTree:
        """The parameters as the reference's nested dict."""
        return _tree(self)

    def loss(self, batch):
        """(loss, {"xent", "aux"}): ``loss`` on the model's parameters."""
        return loss(self.cfg, self.params(), batch)

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
        return cache_abstract(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int):
        """Concrete initial caches on the model's device, the
        reference's: every leaf named ``m`` (a recurrent stabiliser, the
        running max of an empty history) at -1e30, every other leaf at
        zero."""

        def leaf(name, s):
            fill = -1e30 if name.rsplit(".", 1)[-1] == "m" else 0
            return torch.full(s.shape, fill, dtype=s.dtype, device=self.device)

        return map_tree(leaf, self.cache_abstract(batch, max_len))

    def batch_spec(self, shape: ShapeConfig) -> Dict[str, ShapeDtype]:
        return batch_spec(self.cfg, shape)


class EncDecModel(Model):
    """An encoder-decoder: ``prefill`` encodes ``batch["frames"]`` and
    prefills the decoder with ``batch["tokens"]`` against it, keeping the
    encoder's output in the caches (``enc_out``, ``enc_len``) for
    ``decode_step``; ``forward`` is ``decode_stack(tokens,
    encode(frames))``.  It has no split lm head (``hidden_step`` and
    ``head_matrix`` are None), so the private head refuses it."""

    hidden_step = None
    head_matrix = None

    @torch.no_grad()
    def forward(self, batch):
        p = self.params()
        return lm.decode_stack(self.cfg, p, batch["tokens"], lm.encode(self.cfg, p, batch["frames"]))[0]

    @torch.no_grad()
    def prefill(self, batch, caches):
        """The reference's: the decoder is prefilled against the
        unpadded ``enc_out`` with no ``enc_len``; the caches keep it
        zero-padded to their length, in their dtype, and its length."""
        p = self.params()
        enc_out = lm.encode(self.cfg, p, batch["frames"])
        buf = caches["enc_out"]
        pad = buf.shape[1] - enc_out.shape[1]
        enc_buf = torch.nn.functional.pad(enc_out, (0, 0, 0, pad)).to(buf.dtype)
        logits, new = lm.decode_stack(self.cfg, p, batch["tokens"], enc_out,
                                      {"layers": caches["layers"]}, head_mode="last")
        enc_len = torch.tensor(enc_out.shape[1], dtype=torch.int32, device=buf.device)
        return logits, {**caches, "enc_out": enc_buf, "enc_len": enc_len, "layers": new["layers"]}

    @torch.no_grad()
    def decode_step(self, tokens, caches, positions):
        logits, new = lm.decode_stack(self.cfg, self.params(), tokens, caches["enc_out"],
                                      {"layers": caches["layers"]}, positions,
                                      enc_len=caches.get("enc_len"))
        return logits, {**caches, "layers": new["layers"]}


class RecurrentModel(Model):
    """xLSTM (``ssm``) or Zamba2 (``hybrid``), the reference's lambdas:
    ``forward(batch)`` the full-sequence logits; ``prefill(batch,
    caches)`` the last logits and the caches after the prompt (xLSTM
    scans and returns its states, not reading the caches passed in;
    Zamba2 also writes the shared block's KV caches); ``decode_step``
    one token from the caches (xLSTM ignores ``positions``).  No split
    lm head: ``hidden_step`` and ``head_matrix`` are None."""

    hidden_step = None
    head_matrix = None

    def _forward(self, *args, **kw):
        return _RECURRENT[self.cfg.family][1](self.cfg, self.params(), *args, **kw)

    @torch.no_grad()
    def forward(self, batch):
        return self._forward(batch)[0]

    @torch.no_grad()
    def prefill(self, batch, caches):
        return self._forward(batch, caches=caches, head_mode="last", prefill=True)

    @torch.no_grad()
    def decode_step(self, tokens, caches, positions):
        return self._forward({"tokens": tokens}, caches=caches, positions=positions)


def build_model(cfg: ModelConfig, *, seed: int = 0, device=None, train: bool = False,
                mesh=None) -> Model:
    """A model of ``cfg`` (an :class:`EncDecModel` for the encdec
    family, a :class:`RecurrentModel` for ssm and hybrid) with weights
    drawn by ``materialize`` from a ``torch.Generator`` seeded with
    ``seed``, on ``device`` (default: the GPU): to serve, each weight in
    the dtype ``lm.stored_infos`` gives it; to ``train``, every weight in
    float32 with ``requires_grad``.  On a ``mesh`` (every rank calling
    with the same seed) each leaf is placed as it is drawn: a DTensor by
    ``sharding.param_pspecs``, of which the rank keeps only its shard."""
    infos = params_abstract(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    then = None
    if mesh is not None:
        from ..distributed.sharding import param_shardings, place_leaf

        sh = dict(iter_leaves(param_shardings(infos, mesh)))
        then = lambda name, t: place_leaf(t, sh[name], mesh, device)  # noqa: E731
    params = materialize(infos if train else lm.stored_infos(cfg, infos), gen, device, then)
    cls = {"encdec": EncDecModel, **dict.fromkeys(_RECURRENT, RecurrentModel)}.get(cfg.family, Model)
    return cls(cfg, params, train)
