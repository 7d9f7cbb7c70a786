"""Language models for serving and training: the dense, MoE and vlm
decoders (with a private head), the encoder-decoder, and the recurrent
xLSTM and Zamba2.

The counterpart of ``repro.models`` for every ``family`` (``common``,
the GQA and MLA parts of ``attention`` with cross-attention, the MLP
and MoE of ``ffn``, the decoder and encoder-decoder parts of ``lm``,
``xlstm``, ``ssm``, ``hybrid`` and ``registry``).
"""
from .registry import Model, build_model  # noqa: F401
