"""MoE grouped matmul: E independent products x[e] @ w[e].

The CUDA kernel (``csrc/moe_gmm.cu``) replaces the TPU kernel
``repro.kernels.moe_gmm.gmm_bcd``; the source's header says what bounds
it on the H100 and what the design does about that.  Both versions here
take x [E, C, d] and w [E, d, f] of one type (f32 or bf16) and return
[E, C, f] in that type, accumulated in f32.  The kernel reads x through
its strides, so an expert stride of 0 (the MoE layer's dense mode feeds
``x2d.expand(E, T, d)``) costs no copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])


def gmm_plain(x, w):
    """The plain PyTorch version: an f32 einsum, cast back to x's type."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def gmm_cuda(x, w):
    """Launch the CUDA kernel on the current stream.  The caller
    (``ops.moe_gmm``) has checked devices, types, shapes, strides and
    alignment; the strides of size-1 dims are never read."""
    lib = _build.load("moe_gmm")
    fn = lib.moe_gmm
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    E, C, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
            0 if x.dtype == torch.float32 else 1, E, C, d, f,
            x.stride(0), x.stride(1), w.stride(0), w.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: CUDA error {rc}")
    return out
