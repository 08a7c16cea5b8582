"""njode_tpu_torch — the PyTorch/CUDA port of njode_tpu.

The package mirrors the JAX package's tree (``data/``, ``models/``,
``ops/``, ``training/``, ``utils/``) so each module's counterpart sits at
the same relative path. It imports neither ``jax`` nor ``njode_tpu``: the
JAX package is the reference the port is tested against, never a runtime
dependency.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CUDA device the NJODE training scan runs through the hand-written
kernels in ``ops/csrc/fused_scan.cu``; on the CPU the same functions run
their plain PyTorch versions.
"""

__version__ = "0.1.0"
