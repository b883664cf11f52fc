"""PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

The package mirrors ``repro``'s module layout (``configs/``, ``core/``,
``kernels/<name>/{ops,ref}.py``, ``models/``, ``launch/``) so each port sits
at the path of its reference.  It imports ``torch`` and never ``jax`` or
``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``; kernels launch on CUDA tensors and their plain PyTorch
versions run on CPU tensors.
"""
