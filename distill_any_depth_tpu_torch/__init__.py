"""PyTorch + CUDA port of distill_any_depth_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's path (``configs``, ``ops/``, ``models/``, ``utils/``,
``cli/``) and imports nothing from it. Hand-written kernels live in
``csrc/`` and are built with ``nvcc`` at first use (``ops/_build.py``).
"""
