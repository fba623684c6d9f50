"""PyTorch/CUDA port of the AgentServe serving system.

Mirrors the layout of the JAX package ``repro`` module for module.  It
imports ``torch`` and numpy only; every kernel the serving path runs is a
CUDA C++ kernel under ``kernels/csrc`` with a plain PyTorch version
beside it for CPU tensors.
"""
