"""PyTorch/CUDA port of ``vlm_compression_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX package, mirroring its layout
(``ops/``, ``models/``, ``compression/``, ``common/``).  It imports torch,
numpy and the standard library only.  The JAX package stays the reference:
the ``tests/test_torch_*.py`` files hold each module of this package to its
JAX counterpart on the CPU.

Every Pallas kernel on a ported path is a hand-written CUDA C++ kernel for
``sm_90a`` under ``csrc/``, built with nvcc at first use (``ops/_cuda.py``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
