"""Language models for private-head serving: the dense and MoE decoders.

The counterpart of ``repro.models`` for ``family`` in ``("dense",
"moe")`` (``common``, the GQA and MLA parts of ``attention``, the MLP
and MoE of ``ffn``, the decoder-only half of ``lm``, and ``registry``).
"""
from .registry import Model, build_model  # noqa: F401
