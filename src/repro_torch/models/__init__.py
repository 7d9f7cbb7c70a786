"""Language models for private-head serving: the dense, MoE and vlm
decoders and the encoder-decoder.

The counterpart of ``repro.models`` for ``family`` in ``("dense",
"moe", "vlm", "encdec")`` (``common``, the GQA and MLA parts of
``attention`` with cross-attention, the MLP and MoE of ``ffn``, the
decoder and encoder-decoder parts of ``lm``, and ``registry``).
"""
from .registry import Model, build_model  # noqa: F401
