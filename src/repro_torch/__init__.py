"""PyTorch/CUDA port of the coded-MPC system (AGE-/PolyDot-CMPC over GF(p)).

The counterpart of the JAX package ``repro``, module for module.  It
imports torch and numpy only.  Entry points (``core.protocol.run_batched``,
``share_batched``, ``core.layers.secure_matmul_batched``) run on the
CUDA device unless the caller passes ``device="cpu"``; with no GPU and
no device they raise.  The GF(p) matmuls go through hand-written Hopper
kernels (``kernels/modmatmul``, source in ``csrc/modmatmul.cu``).
"""
