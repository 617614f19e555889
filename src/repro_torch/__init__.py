"""PyTorch/CUDA port of the in-network fixed-point ML serving system.

Mirrors ``repro``'s layout (``core/``, ``kernels/``, ``obs/``, ``serve/``,
``launch/``, ``configs/``) and is held bit-exact against it.  It imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro``.  Its
entry points run on the card unless the caller passes ``device="cpu"``;
the hand-written CUDA kernels live in ``kernels/csrc`` and are built with
``nvcc`` at first use.
"""
