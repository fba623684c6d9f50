"""MoE grouped matmul: E independent products x[e] @ w[e].

The CUDA kernels (``csrc/moe_gmm.cu``) replace the TPU kernel
``repro.kernels.moe_gmm.gmm_bcd``; the source's header says what bounds
them on the H100 and what the design does about that.  Both versions here
take x [E, C, d] and w [E, d, f] of one type (f32 or bf16) and return
[E, C, f] in that type, accumulated in f32.  The kernels read x through
its strides, so an expert stride of 0 (the MoE layer's dense mode feeds
``x2d.expand(E, T, d)``) costs no copy.

bf16 runs on the tensor cores (``wgmma`` fed by TMA): the block that owns
a work tile (128 columns of f, expert) runs every row of the call against
each weight tile it loads, so each weight byte is read from device memory
once per call up to C = 256 rows; persistent blocks, one an SM, take the
work tiles in turn.  f32 runs on the CUDA cores, whose exact f32 the identity
checks need.  ``gmm_plan`` says, from the shapes alone, which of the two
runs and, for bf16, with what tiles and stages; ``gmm_cuda`` passes that
plan to the kernel.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

# the tensor-core kernel's tile (csrc/moe_gmm.cu, `gmm_tc_kernel`)
TC_ROWS = 64          # rows of a C-tile: wgmma's M
TC_MAX_TILES = 4      # C-tiles of a row group: 256 rows a pass over w
TC_N = 128            # f columns of a block: 64 per consumer warpgroup
TC_K = 64             # d per stage: one 128-byte swizzled row of bf16
TC_EPI_PITCH = 144    # bytes between the rows of an epilogue tile
SMEM_MAX = 232_448    # dynamic shared memory a block may opt in to

_ARGTYPES = {
    "moe_gmm": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]),
    "moe_gmm_tc": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p]),
    "moe_gmm_tc_smem": [ctypes.c_int] * 2,
}


@dataclass(frozen=True)
class GmmPlan:
    """How one bf16 call is cut into work tiles: a tile is ``n_tile``
    columns of one expert's output and ``group_rows`` rows of it per pass,
    in C-tiles of ``tile_rows``; its block walks ``passes`` row groups in
    turn, reading its weights once per pass.  ``grid`` counts the tiles
    (f tiles, 1, experts), which min(tiles, SMs) persistent blocks take
    in turn.  A stage carries ``k_tile`` of d.  An f32 plan says only that
    the CUDA-core kernel runs: its entry picks its own tile."""
    tensor_cores: bool
    tile_rows: Optional[int] = None
    group_rows: Optional[int] = None
    passes: Optional[int] = None
    n_tile: Optional[int] = None
    k_tile: Optional[int] = None
    stages: Optional[int] = None
    smem_bytes: Optional[int] = None
    grid: Optional[Tuple[int, int, int]] = None

    @property
    def tiles(self) -> Optional[int]:
        """C-tiles in a row group."""
        if not self.tensor_cores:
            return None
        return self.group_rows // self.tile_rows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tc_smem_bytes(tiles: int, stages: int) -> int:
    """The tensor-core kernel's dynamic shared memory (``tc_smem_bytes``
    in the source): 1024 bytes of alignment slack, the stages (x rows and
    two [64, 64] weight boxes), two epilogue tiles and 16 bytes of
    barriers a stage."""
    return (1024 + stages * (tiles * TC_ROWS * 128 + TC_K * TC_N * 2)
            + 2 * TC_ROWS * TC_EPI_PITCH + 16 * stages)


def tc_stages(tiles: int) -> int:
    """d tiles in flight: 3 for one C-tile (C <= 64), 4 for more.  On an
    H100 at OLMoE's widths one C-tile ran 1-3% faster with 3 stages than
    with 4 at every C from 1 to 40, up and down; at C 160 and 256 4 stages
    were the fastest or within 1% of it (PERF.md §6 gives the times)."""
    return 3 if tiles == 1 else 4


@lru_cache(maxsize=1024)
def gmm_plan(E: int, C: int, d: int, f: int, dtype) -> GmmPlan:
    """The plan of one call, from its shapes and type alone (never a
    tensor).  bf16: the tensor-core kernel, C-tiles of 64 rows, up to 4 in
    a row group (above 256 rows the passes share the C-tiles evenly), and
    ``tc_stages`` of them in flight.  f32: the CUDA-core kernel."""
    if dtype == torch.float32:
        return GmmPlan(False)
    if dtype != torch.bfloat16:
        raise TypeError(f"gmm_plan: f32 or bf16, got {dtype}")
    n_tiles = max(1, _cdiv(C, TC_ROWS))
    tiles = _cdiv(n_tiles, _cdiv(n_tiles, TC_MAX_TILES))
    rows, stages = tiles * TC_ROWS, tc_stages(tiles)
    # the kernel walks ceil(C / rows) row groups
    return GmmPlan(True, TC_ROWS, rows, max(1, _cdiv(C, rows)), TC_N, TC_K,
                   stages, tc_smem_bytes(tiles, stages),
                   (_cdiv(f, TC_N), 1, E))


def gmm_plain(x, w):
    """The plain PyTorch version: an f32 einsum, cast back to x's type."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def _entry(name: str):
    """The C entry ``name`` of ``csrc/moe_gmm.cu`` with its argument types
    set (once: a call then converts its arguments only)."""
    return _build.entry("moe_gmm", name, _ARGTYPES[name])


def gmm_cuda(x, w):
    """Launch the CUDA kernel that ``gmm_plan`` picks on the current
    stream.  The caller (``ops.moe_gmm``) has checked devices, types,
    shapes, strides and alignment; the strides of size-1 dims are never
    read.  TMA takes no zero stride, so for bf16 an operand whose rows
    repeat (a row stride of 0) is copied first; an expert stride of 0 is
    read in place."""
    E, C, d = x.shape
    f = w.shape[2]
    plan = gmm_plan(E, C, d, f, x.dtype)
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.tensor_cores:
        if C > 1 and x.stride(1) == 0:
            x = x.contiguous()
        if d > 1 and w.stride(1) == 0:
            w = w.contiguous()
        rc = _entry("moe_gmm_tc")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
            x.stride(0), x.stride(1), w.stride(0), w.stride(1), plan.tiles,
            plan.stages, stream)
    else:
        rc = _entry("moe_gmm")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), 0, E, C, d, f,
            x.stride(0), x.stride(1), w.stride(0), w.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: CUDA error {rc}")
    return out
