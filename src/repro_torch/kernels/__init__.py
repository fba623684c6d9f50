"""Attention kernels of the port: CUDA sources under csrc/, their plain
PyTorch versions, the device-dispatching wrappers (ops) and the oracles
(ref)."""
