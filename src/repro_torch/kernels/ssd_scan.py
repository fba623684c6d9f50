"""Mamba-2 SSD chunked scan: the intra-chunk dual form plus the state
carried across chunks, in the model layout.

The CUDA kernel (``csrc/ssd_scan.cu``) replaces the TPU kernel
``repro.kernels.ssd_scan.ssd_scan_bhsd``; the source's header says what
bounds it on the H100 and what the design does about that: bf16 runs on
the tensor cores, one block per 16 columns of hd of a (batch row, head)
(``tc_plan``), f32 on the CUDA cores.  Both
versions here take x [B, S, nh, hd] and Bm/Cm [B, S, N] in f32 or bf16,
dt [B, S, nh] (post-softplus) and A [nh] (negative) in f32, and the
carried-in state h0 [B, nh, hd, N] in f32; they return y [B, S, nh, hd]
in x's type (no ``D`` term) and the final state [B, nh, hd, N] in f32.
Chunks start at multiples of ``chunk``; a short last chunk behaves as if
padded with dt = 0 (the TPU kernel's padding), which injects nothing.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_OCC_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
# (hd, N) pairs the CUDA kernel is instantiated for
SHAPES = ((64, 128), (32, 16))
MAX_CHUNK = 256
# the bf16 body: hd columns a block owns, rows of its query and key tiles,
# threads a block, the blocks an SM its launch bounds guarantee
TC_SLICE, TC_TILE, TC_THREADS, TC_MIN_BLOCKS = 16, 16, 256, 2
SM_SMEM_BYTES, BLOCK_RESERVED_BYTES = 233472, 1024     # H100, an SM


@dataclass(frozen=True)
class TcPlan:
    """The bf16 body's launch: ``grid`` (hd / slice, nh, B) of ``threads``
    threads with ``smem_bytes`` of dynamic shared memory each, at least
    ``resident_per_sm`` of them resident on an SM."""
    slice: int
    grid: tuple
    threads: int
    smem_bytes: int
    resident_per_sm: int

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    def waves(self, sms: int) -> int:
        return -(-self.blocks // (self.resident_per_sm * sms))


def tc_plan(B: int, nh: int, hd: int, N: int) -> TcPlan:
    """The bf16 body's block plan, from static shapes alone (never S, dt
    or a device value).  Shared memory holds a chunk of up to MAX_CHUNK
    rows of B [Q, N] and of the x slice [Q, 16] in bf16, the state [16, N]
    in f32 and as bf16 hi and lo halves, and s and dt [Q] in f32."""
    smem = (MAX_CHUNK * N * 2 + MAX_CHUNK * TC_SLICE * 2
            + TC_SLICE * N * (2 + 2 + 4) + 2 * MAX_CHUNK * 4)
    resident = min(TC_MIN_BLOCKS, 2048 // TC_THREADS,
                   SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES))
    return TcPlan(TC_SLICE, (hd // TC_SLICE, nh, B), TC_THREADS, smem,
                  resident)


def tc_occupancy(hd: int, N: int):
    """(dynamic shared memory a block, resident blocks an SM) of the bf16
    body on the current card, as the CUDA runtime reports them."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = _build.entry("ssd_scan", "ssd_scan_tc_occupancy", _OCC_ARGTYPES)(
        hd, N, ctypes.byref(smem), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"ssd_scan_tc_occupancy failed: CUDA error {rc}")
    return smem.value, blocks.value


def ssd_scan_plain(x, dt, A, Bm, Cm, h0, *, chunk: int):
    """The plain PyTorch version: the TPU kernel's chunk body (the JAX
    model's ``lax.scan`` body) as a loop over chunks, in f32 (the cumsum
    of dt * A in f64, rounded once), with the [Q, Q] decay built by a
    select before the exp."""
    B, S, nh, hd = x.shape
    Q = min(chunk, max(S, 1))
    pad = (-S) % Q
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, pad))
    ii = torch.arange(Q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    H = h0.float()
    ys = []
    for c0 in range(0, S + pad, Q):
        xq, Bq, Cq, dtq = (t[:, c0:c0 + Q] for t in (xf, Bf, Cf, dtf))
        # the cumsum in f64, rounded once (as the kernel's): over a 256-row
        # chunk |s| reaches ~10^3, where an f32 running sum drifts
        s = torch.cumsum((dtq * A.float()[None, None, :]).double(),
                         dim=1).float()                            # [B,Q,nh]
        dots = torch.einsum("bin,bjn->bij", Cq, Bq)                # [B,Q,Q]
        diff = torch.where(causal, s[:, :, None, :] - s[:, None, :, :],
                           float("-inf"))
        M = dots[..., None] * torch.exp(diff) * dtq[:, None, :, :]
        y = torch.einsum("bijh,bjhd->bihd", M, xq)
        y = y + torch.einsum("bin,bhdn,bih->bihd", Cq, H, torch.exp(s))
        w = torch.exp(s[:, -1:, :] - s) * dtq                       # [B,Q,nh]
        H = (H * torch.exp(s[:, -1, :])[:, :, None, None]
             + torch.einsum("bjh,bjhd,bjn->bhdn", w, xq, Bq))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S] if ys else xf[:, :0]
    return y.to(x.dtype), H


def ssd_inputs(gen, B, S, nh, hd, N, dtype, *, pad=0):
    """Scan inputs at the magnitude the model path feeds the kernel (|y|
    of order 1), drawn from ``gen`` on its device: post-softplus dt, A in
    [-16, -1) as A_log's init draws it, B and C scaled by N^-1/2, a
    nonzero carried-in state; the last ``pad`` rows have dt = 0 (a padded
    serving chunk).  For the card checks of the kernel against
    ``ssd_scan_plain``."""
    dev = gen.device
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    x = rnd(B, S, nh, hd).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, S, nh))
    if pad:
        dt[:, S - pad:] = 0
    A = -(1.0 + 15.0 * torch.rand(nh, generator=gen, device=dev))
    Bm = (rnd(B, S, N) * N ** -0.5).to(dtype)
    Cm = (rnd(B, S, N) * N ** -0.5).to(dtype)
    h0 = 0.1 * rnd(B, nh, hd, N)
    return x, dt, A, Bm, Cm, h0


def ssd_scan_cuda(x, dt, A, Bm, Cm, h0, *, chunk: int):
    """Launch the CUDA kernel on the current stream.  The caller
    (``ops.ssd_scan``) has checked devices, types and shapes; inputs are
    made contiguous here (a no-op on the model path)."""
    fn = _build.entry("ssd_scan", "ssd_scan", _ARGTYPES)
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    x, dt, A, Bm, Cm, h0 = (t.contiguous() for t in (x, dt, A, Bm, Cm, h0))
    if x.dtype == torch.bfloat16:
        # the tensor-core body copies x, B and C in 16-byte pieces
        x, Bm, Cm = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (x, Bm, Cm))
    y = torch.empty_like(x)
    h = torch.empty_like(h0)
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(),
            0 if x.dtype == torch.float32 else 1, B, S, nh, hd, N,
            min(chunk, max(S, 1)),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    return y, h
