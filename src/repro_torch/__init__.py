"""PyTorch/CUDA port of the GLASU reproduction (``repro``).

A second package beside the JAX one, with the same layout and names
(``configs/``, ``data/``, ``graph/``, ``models/``, ``kernels/``, ``core/``,
``api/``, ``serve/``).
It imports torch and numpy, never jax and nothing of ``repro``. Entry
points run on the GPU unless the caller passes ``device="cpu"``; the
hand-written CUDA kernels under ``kernels/csrc/`` are compiled at first
launch, so importing the package needs neither CUDA nor a compiler.
"""
