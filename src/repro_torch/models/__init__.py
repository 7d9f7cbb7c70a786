"""Language models for private-head serving: the dense decoder.

The counterpart of ``repro.models`` for ``family == "dense"``
(``common``, the GQA half of ``attention``, the MLP of ``ffn``, the
decoder-only half of ``lm``, and ``registry``).
"""
from .registry import Model, build_model  # noqa: F401
