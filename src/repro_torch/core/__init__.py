"""Core library of the port: coded MPC (AGE-CMPC, PolyDot-CMPC) in PyTorch.

Layers (bottom-up), each the counterpart of the JAX package's module of
the same name:

* ``gf``             — GF(p) arithmetic (numpy host oracle + torch device path)
* ``powers``         — polynomial power-set combinatorics (numpy copy)
* ``constructions``  — Algorithm 1 / Algorithm 2 share builders (numpy copy)
* ``closed_form``    — Theorems 2 & 8 worker counts (copy)
* ``planner``        — CMPCPlan: evaluation points, interpolation matrices (copy)
* ``protocol``       — the batched three-phase engine on torch tensors
* ``layers``         — secure_matmul_batched over the reals
"""
from .constructions import Scheme, build_scheme  # noqa: F401
from .gf import Field, P_DEFAULT  # noqa: F401
from .planner import BlockShapes, CMPCPlan, get_plan  # noqa: F401
