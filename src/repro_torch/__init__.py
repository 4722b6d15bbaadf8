"""repro_torch: the PyTorch and CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors ``repro`` module for module and imports neither JAX nor
``repro``. Entry points run on CUDA unless the caller passes
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""
