"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches its own
failure:

1. device  — the card's name, count and power limit; fails without CUDA.
2. build   — compiles every CUDA kernel from ``src/repro_torch/kernels/
             csrc`` (one nvcc per source, in parallel) and prints
             ptxas's register / shared-memory / spill lines.
3. parity  — each kernel against its plain PyTorch version at the main
             path's shapes (Qwen2.5-3B heads 16/2/128 and SmolLM-360M
             heads 15/5/64, S_max 8192, ragged lengths to 8000, prefill
             chunks at offsets 0 and > 0; slab: a strided cache view;
             paged: page 64, shuffled tables in which two rows share
             pages), f32 within 1e-4 and bf16 within 2e-2 max abs error.
             The paged kernels are also held against the slab kernels on
             the same logical rows (0 where the tile order is the same).
4. timing  — each kernel, its plain version and one library call
             (``scaled_dot_product_attention`` with the equivalent
             boolean mask on the valid slice, already gathered for the
             paged kernels, timed only here) with CUDA events over many
             launches, beside the bound max(flops / 989e12,
             bytes / 3.35e12) computed from these inputs (keys each row
             needs, every input byte read once, block-table entries
             included).
5. identity — float32 full-width Qwen2.5-3B cut to 4 layers, served by
             the engine on a 3-agent react workload on the slab layout;
             every session's stream must equal the port's isolated
             greedy oracle.
6. slice   — full-width, full-depth Qwen2.5-3B in bf16 through
             ``repro_torch.launch.serve``'s closed loop (4 agents, react,
             max_seq 8192) on the slab layout; every session must finish
             with all its tokens, the slab kernels' launch counts must be
             > 0 and the paged kernels' 0.
7. profile — the slice engine's own forwards (a K=8 decode megastep, a
             cold chunk, a resume batch): wall time, device time and
             device time by kernel from ``torch.profiler``.
8-10.      — identity, slice and profile again on the paged layout (page
             64, radix prefix cache): the slice runs with
             ``--kv-layout paged``, its paged kernels' launch counts must
             be > 0 and the slab kernels' 0, and it prints the pool's
             prefix hits, partial hits, page copies and peak pages.

Mamba-2 (the SSD chunked scan, ``ssd_scan``):

3-4.       — parity and timing of the scan kernel at mamba2-780m widths
             (48 heads of 64, d_state 128, chunk 256): S in {1, 50, 160,
             256, 1000} with a nonzero carried-in state and a tail of
             dt = 0 rows, f32 within 2e-4 and bf16 within 2e-2 on y and
             on the state; timed at a 160-token cold chunk and a 4 x 64
             resume batch beside the bound max(flops / 989e12,
             bytes / 3.35e12) (per batch row and chunk of Q rows, with
             T = Q(Q+1)/2 causal pairs: 2TN flops for C B^T, shared by the
             heads, and 2T hd + 4Q hd N per head; x, dt, B, C, h0 and A
             read once, y and h written once).  No single PyTorch call
             computes the scan.
11. identity_ssm — float32 mamba2-780m widths cut to 4 layers, and a
             small hybrid (attention + Mamba-2), on agents of one system
             prompt arriving 1 s apart: slab and paged engine streams
             equal under the fixed-chunk ``chunked`` policy with the exact
             prefix cache on both legs, each leg restoring a state
             snapshot; then the paged leg with the radix index, every
             stream equal to the isolated greedy oracle (a mismatch prints
             the oracle's top-2 logit margin at the first diverging step).
12-15. slice_ssm, profile_ssm and their paged twins — full-width,
             full-depth mamba2-780m in bf16 through
             ``repro_torch.launch.serve``'s closed loop (4 agents, react,
             max_seq 8192): every session finishes, ``ssd_scan``
             launches > 0 and the four attention kernels' 0; the pool line
             prints the state copies; then the profile of its forwards.

The last lines are the kernel list, the nvidia-smi line, the kernel JSON
line and the result JSON line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SLICE_TOKEN_SCALE = 1.0
PAGE = 64
SLAB_KERNELS = ("flash_prefill", "flash_decode")
PAGED_KERNELS = ("flash_prefill_paged", "flash_decode_paged")
SSM_KERNELS = ("ssd_scan",)
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SOURCES = {
    "flash_prefill": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                      "src/repro/kernels/prefill_attention.py:243"),
    "flash_decode": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:133"),
    "flash_prefill_paged": (
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention.py:264"),
    "flash_decode_paged": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                           "src/repro/kernels/decode_attention.py:82"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:67"),
}


def log(*a):
    print(*a, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{torch.cuda.device_count()} | nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build():
    from repro_torch.kernels import _build
    names = _build.kernel_names()
    t0 = time.perf_counter()
    _build.build(names)
    log(f"[build] {names} in {time.perf_counter() - t0:.1f} s "
        f"-> {_build.BUILD_DIR}")
    for n, info in sorted(_build.BUILD_INFO.items()):
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem")):
                log(f"[build] {n}: {line.strip()}")
    for n in names:
        _build.load(n)


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _i32(vals):
    return torch.tensor(vals, dtype=torch.int32, device="cuda")


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def phase_parity():
    """Kernel vs plain version; returns the worst error per kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.prefill_attention import prefill_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"flash_prefill": 0.0, "flash_decode": 0.0}
    S, B = 8192, 6
    lens = [1, 37, 1000, 3500, 8000, 5000]
    for H, Hk, hd in ((16, 2, 128), (15, 5, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            # a strided cache view: every other KV head of a wider buffer
            wide_k = _rand(gen, (B, S, 2 * Hk, hd), dtype)
            wide_v = _rand(gen, (B, S, 2 * Hk, hd), dtype)
            for kc, vc, what in ((wide_k[:, :, :Hk].contiguous(),
                                  wide_v[:, :, :Hk].contiguous(), "contig"),
                                 (wide_k[:, :, ::2], wide_v[:, :, ::2],
                                  "strided")):
                q = _rand(gen, (B, 1, H, hd), dtype)
                L = _i32(lens)
                err = _max_err(ops.flash_decode(q, kc, vc, L),
                               decode_attention_plain(q, kc, vc, L))
                torch.cuda.synchronize()
                log(f"[parity] decode {H}/{Hk}/{hd} {str(dtype)[6:]} {what} "
                    f"lens={lens} max_abs_err={err:.3e}")
                assert err <= TOL[dtype], ("flash_decode", err)
                worst["flash_decode"] = max(worst["flash_decode"], err)
                for Sq in (16, 56, 160, 320):
                    for off in (0, 3000):
                        M = 3
                        qo = _i32([off, off + 17, off // 2])
                        ln = qo + Sq
                        si = _i32([5, 0, 3])
                        qq = _rand(gen, (M, Sq, H, hd), dtype)
                        out = ops.flash_prefill(qq, kc, vc, qo, ln,
                                                slot_idx=si)
                        err = _max_err(out, prefill_attention_plain(
                            qq, kc, vc, qo, ln, slot_idx=si))
                        torch.cuda.synchronize()
                        log(f"[parity] prefill {H}/{Hk}/{hd} "
                            f"{str(dtype)[6:]} {what} Sq={Sq} off={off} "
                            f"max_abs_err={err:.3e}")
                        assert err <= TOL[dtype], ("flash_prefill", err)
                        worst["flash_prefill"] = max(worst["flash_prefill"],
                                                     err)
    return worst


def shared_tables(rng, lengths, pmax: int, num_pages: int):
    """Block tables [rows, pmax] over a shuffled arena of ``num_pages``
    usable pages of PAGE rows (page ``num_pages`` is the scratch page):
    rows 0 and 1 share their first two pages, every other mapped page is
    distinct, and entries past a row's length point at the scratch page."""
    perm = rng.permutation(num_pages)
    bt = np.full((len(lengths), pmax), num_pages, np.int32)
    nxt = 0
    for r, n in enumerate(lengths):
        need = -(-int(n) // PAGE)
        bt[r, :need] = perm[nxt:nxt + need]
        nxt += need
    bt[1, :2] = bt[0, :2]
    return torch.tensor(bt, device="cuda")


def phase_parity_paged():
    """The paged kernels vs their plain versions (and vs the slab kernels
    on the gathered rows); returns the worst error per kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_plain, paged_gather)
    from repro_torch.kernels.prefill_attention import (
        prefill_attention_paged_plain)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    worst = {"flash_prefill_paged": 0.0, "flash_decode_paged": 0.0}
    S, B = 8192, 6
    pmax, P = S // PAGE, B * (S // PAGE)
    lens = [3500, 1000, 1, 37, 8000, 5000]
    for H, Hk, hd in ((16, 2, 128), (15, 5, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            ka = _rand(gen, (P + 1, PAGE, Hk, hd), dtype)
            va = _rand(gen, (P + 1, PAGE, Hk, hd), dtype)
            bt = shared_tables(rng, lens, pmax, P)
            kg, vg = paged_gather(ka, bt), paged_gather(va, bt)
            q = _rand(gen, (B, 1, H, hd), dtype)
            L = _i32(lens)
            got = ops.flash_decode_paged(q, ka, va, L, bt)
            err = _max_err(got, decode_attention_paged_plain(q, ka, va, L, bt))
            vs_slab = _max_err(got, ops.flash_decode(q, kg, vg, L))
            torch.cuda.synchronize()
            log(f"[parity] decode_paged {H}/{Hk}/{hd} {str(dtype)[6:]} "
                f"page={PAGE} lens={lens} max_abs_err={err:.3e} "
                f"vs_slab_kernel={vs_slab:.3e}")
            assert err <= TOL[dtype], ("flash_decode_paged", err)
            worst["flash_decode_paged"] = max(worst["flash_decode_paged"], err)
            rows = _i32([5, 0, 3])
            bt_m = bt[rows.long()].contiguous()
            for Sq in (16, 56, 160, 320):
                for off in (0, 3000):
                    qo = _i32([off, off + 17, off // 2])
                    ln = qo + Sq
                    qq = _rand(gen, (3, Sq, H, hd), dtype)
                    out = ops.flash_prefill_paged(qq, ka, va, qo, ln, bt_m)
                    err = _max_err(out, prefill_attention_paged_plain(
                        qq, ka, va, qo, ln, bt_m))
                    vs_slab = _max_err(out, ops.flash_prefill(
                        qq, kg, vg, qo, ln, slot_idx=rows))
                    torch.cuda.synchronize()
                    log(f"[parity] prefill_paged {H}/{Hk}/{hd} "
                        f"{str(dtype)[6:]} page={PAGE} Sq={Sq} off={off} "
                        f"max_abs_err={err:.3e} vs_slab_kernel={vs_slab:.3e}")
                    assert err <= TOL[dtype], ("flash_prefill_paged", err)
                    worst["flash_prefill_paged"] = max(
                        worst["flash_prefill_paged"], err)
    return worst


def _time_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_timing():
    """Times at the slice's shapes (bf16, Qwen2.5-3B heads, 6 slots of
    8192 rows).  Decode: one step over ragged lengths.  Prefill: one
    160-token cold chunk at offset 3000 (the cycle budget's chunk deep in
    a ~3k-token prompt)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.prefill_attention import prefill_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtype, es = torch.bfloat16, 2
    H, Hk, hd, S, B = 16, 2, 128, 8192, 6
    G = H // Hk
    kc = _rand(gen, (B, S, Hk, hd), dtype)
    vc = _rand(gen, (B, S, Hk, hd), dtype)
    res = {}

    lens = [1, 37, 1000, 3500, 8000, 5000]
    q = _rand(gen, (B, 1, H, hd), dtype)
    L = _i32(lens)
    Lmax = max(lens)
    kt = kc[:, :Lmax].transpose(1, 2)                  # [B, Hk, L, hd] views
    vt = vc[:, :Lmax].transpose(1, 2)
    mask = (torch.arange(Lmax, device="cuda")[None, :]
            < L[:, None])[:, None, None, :]           # [B, 1, 1, L]
    qt = q.transpose(1, 2)                             # [B, H, 1, hd]
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=True)
    n_keys = sum(lens)
    flops = 4 * n_keys * H * hd
    nbytes = (2 * n_keys * Hk * hd + 2 * B * H * hd) * es + 4 * B
    bound, by = _bound_ms(flops, nbytes, dtype)
    res["flash_decode"] = dict(
        ms=_time_ms(lambda: ops.flash_decode(q, kc, vc, L)),
        plain_ms=_time_ms(lambda: decode_attention_plain(q, kc, vc, L)),
        library_ms=_time_ms(lib), bound_ms=bound, bound_by=by,
        shape=f"B={B} H/Hk/hd={H}/{Hk}/{hd} lens={lens} bf16")

    M, Sq, off = 1, 160, 3000
    qq = _rand(gen, (M, Sq, H, hd), dtype)
    qo, ln, si = _i32([off]), _i32([off + Sq]), _i32([2])
    Lk = off + Sq
    kt = kc[2:3, :Lk].transpose(1, 2)
    vt = vc[2:3, :Lk].transpose(1, 2)
    q_pos = off + torch.arange(Sq, device="cuda")
    pmask = (torch.arange(Lk, device="cuda")[None, :]
             <= q_pos[:, None])[None, None]           # [1, 1, Sq, Lk]
    qt = qq.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=pmask,
                                                 enable_gqa=True)
    pairs = sum(off + i + 1 for i in range(Sq))      # causal keys per query
    flops = 4 * pairs * H * hd
    nbytes = (2 * Lk * Hk * hd + 2 * M * Sq * H * hd) * es + 12 * M
    bound, by = _bound_ms(flops, nbytes, dtype)
    res["flash_prefill"] = dict(
        ms=_time_ms(lambda: ops.flash_prefill(qq, kc, vc, qo, ln,
                                              slot_idx=si)),
        plain_ms=_time_ms(lambda: prefill_attention_plain(
            qq, kc, vc, qo, ln, slot_idx=si)),
        library_ms=_time_ms(lib), bound_ms=bound, bound_by=by,
        shape=f"M={M} Sq={Sq} offset={off} H/Hk/hd={H}/{Hk}/{hd} G={G} bf16")
    for name, r in res.items():
        log(f"[timing] {name} {r['shape']}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")

    # resume-batch shape of the slice: 4 rows of 64 tokens deep in context
    M, Sq = 4, 64
    qq = _rand(gen, (M, Sq, H, hd), dtype)
    offs = [3100, 3600, 4200, 2900]
    qo, ln, si = _i32(offs), _i32([o + Sq for o in offs]), _i32([0, 1, 2, 3])
    ms = _time_ms(lambda: ops.flash_prefill(qq, kc, vc, qo, ln, slot_idx=si))
    pairs = sum(o + i + 1 for o in offs for i in range(Sq))
    bound, by = _bound_ms(4 * pairs * H * hd,
                          (2 * sum(o + Sq for o in offs) * Hk * hd
                           + 2 * M * Sq * H * hd) * es, dtype)
    log(f"[timing] flash_prefill resume M=4 Sq=64 offsets={offs}: "
        f"kernel_ms={ms:.4f} bound_ms={bound:.5f} ({by})")
    return res


def phase_timing_paged():
    """The paged kernels at the slab timing's shapes (bf16, Qwen2.5-3B
    heads, 6 slots of 8192 rows, page 64, shuffled tables).  Library: SDPA
    on the valid slice gathered beforehand (the call alone is timed).
    The bound counts the block-table entries each row reads."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_plain, paged_gather)
    from repro_torch.kernels.prefill_attention import (
        prefill_attention_paged_plain)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    dtype, es = torch.bfloat16, 2
    H, Hk, hd, S, B = 16, 2, 128, 8192, 6
    G = H // Hk
    pmax, P = S // PAGE, B * (S // PAGE)
    ka = _rand(gen, (P + 1, PAGE, Hk, hd), dtype)
    va = _rand(gen, (P + 1, PAGE, Hk, hd), dtype)
    lens = [1, 37, 1000, 3500, 8000, 5000]
    bt = shared_tables(rng, [S] * B, pmax, P)          # every row mapped
    res = {}

    q = _rand(gen, (B, 1, H, hd), dtype)
    L = _i32(lens)
    Lmax = max(lens)
    kt = paged_gather(ka, bt)[:, :Lmax].transpose(1, 2).contiguous()
    vt = paged_gather(va, bt)[:, :Lmax].transpose(1, 2).contiguous()
    mask = (torch.arange(Lmax, device="cuda")[None, :]
            < L[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=True)
    n_keys = sum(lens)
    pages = sum(-(-n // PAGE) for n in lens)
    bound, by = _bound_ms(4 * n_keys * H * hd,
                          (2 * n_keys * Hk * hd + 2 * B * H * hd) * es
                          + 4 * B + 4 * pages, dtype)
    res["flash_decode_paged"] = dict(
        ms=_time_ms(lambda: ops.flash_decode_paged(q, ka, va, L, bt)),
        plain_ms=_time_ms(lambda: decode_attention_paged_plain(q, ka, va, L,
                                                               bt)),
        library_ms=_time_ms(lib), bound_ms=bound, bound_by=by,
        shape=f"B={B} H/Hk/hd={H}/{Hk}/{hd} lens={lens} page={PAGE} bf16")

    Sq, off = 160, 3000
    qq = _rand(gen, (1, Sq, H, hd), dtype)
    qo, ln = _i32([off]), _i32([off + Sq])
    bt_1 = bt[2:3].contiguous()
    Lk = off + Sq
    kt = paged_gather(ka, bt_1)[:, :Lk].transpose(1, 2).contiguous()
    vt = paged_gather(va, bt_1)[:, :Lk].transpose(1, 2).contiguous()
    q_pos = off + torch.arange(Sq, device="cuda")
    pmask = (torch.arange(Lk, device="cuda")[None, :]
             <= q_pos[:, None])[None, None]
    qt = qq.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=pmask,
                                                 enable_gqa=True)
    pairs = sum(off + i + 1 for i in range(Sq))
    bound, by = _bound_ms(4 * pairs * H * hd,
                          (2 * Lk * Hk * hd + 2 * Sq * H * hd) * es + 12
                          + 4 * -(-Lk // PAGE), dtype)
    res["flash_prefill_paged"] = dict(
        ms=_time_ms(lambda: ops.flash_prefill_paged(qq, ka, va, qo, ln, bt_1)),
        plain_ms=_time_ms(lambda: prefill_attention_paged_plain(
            qq, ka, va, qo, ln, bt_1)),
        library_ms=_time_ms(lib), bound_ms=bound, bound_by=by,
        shape=f"M=1 Sq={Sq} offset={off} H/Hk/hd={H}/{Hk}/{hd} G={G} "
              f"page={PAGE} bf16")
    for name, r in res.items():
        log(f"[timing] {name} {r['shape']}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")

    M, Sq = 4, 64
    qq = _rand(gen, (M, Sq, H, hd), dtype)
    offs = [3100, 3600, 4200, 2900]
    qo, ln = _i32(offs), _i32([o + Sq for o in offs])
    bt_m = bt[:M].contiguous()
    ms = _time_ms(lambda: ops.flash_prefill_paged(qq, ka, va, qo, ln, bt_m))
    pairs = sum(o + i + 1 for o in offs for i in range(Sq))
    keys = sum(o + Sq for o in offs)
    bound, by = _bound_ms(4 * pairs * H * hd,
                          (2 * keys * Hk * hd + 2 * M * Sq * H * hd) * es
                          + 4 * sum(-(-(o + Sq) // PAGE) for o in offs), dtype)
    log(f"[timing] flash_prefill_paged resume M=4 Sq=64 offsets={offs} "
        f"page={PAGE}: kernel_ms={ms:.4f} bound_ms={bound:.5f} ({by})")
    return res


# mamba2-780m's scan widths
SSD_NH, SSD_HD, SSD_N, SSD_CHUNK = 48, 64, 128, 256


def phase_parity_ssm():
    """The scan kernel vs its plain version at mamba2-780m widths."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_inputs, ssd_scan_plain
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1, 50, 160, 256, 1000):
            pad = S // 5
            args = ssd_inputs(gen, 2, S, SSD_NH, SSD_HD, SSD_N, dtype,
                              pad=pad)
            y, h = ops.ssd_scan(*args, chunk=SSD_CHUNK)
            yp, hp = ssd_scan_plain(*args, chunk=SSD_CHUNK)
            ey, eh = _max_err(y, yp), _max_err(h, hp)
            torch.cuda.synchronize()
            log(f"[parity] ssd_scan nh/hd/N={SSD_NH}/{SSD_HD}/{SSD_N} "
                f"chunk={SSD_CHUNK} {str(dtype)[6:]} B=2 S={S} "
                f"dt=0 tail={pad} max_abs_err y={ey:.3e} h={eh:.3e} "
                f"(max|y|={yp.float().abs().max().item():.3f} "
                f"max|h|={hp.abs().max().item():.3f})")
            assert bool(torch.isfinite(y.float()).all()), "ssd_scan: y"
            assert ey <= SSD_TOL[dtype] and eh <= SSD_TOL[dtype], \
                ("ssd_scan", S, ey, eh)
            worst = max(worst, ey, eh)
    return {"ssd_scan": worst}


def ssd_bound(B, S, chunk, es):
    """(flops, bytes) the scan needs at least: per (batch row, chunk of Q
    rows) C B^T over the causal triangle of T = Q(Q+1)/2 pairs once (B
    and C are shared by the heads), and per head the triangle's product
    with x, C H_in^T and the state update; x, dt, B, C, h0 and A read
    once, y and h written once."""
    flops = 0
    for c0 in range(0, S, chunk):
        Q = min(chunk, S - c0)
        T = Q * (Q + 1) // 2
        flops += B * (2 * T * SSD_N
                      + SSD_NH * (2 * T * SSD_HD + 4 * Q * SSD_HD * SSD_N))
    nbytes = (2 * B * S * SSD_NH * SSD_HD * es        # x read, y written
              + B * S * SSD_NH * 4 + SSD_NH * 4       # dt, A
              + 2 * B * S * SSD_N * es                # B, C
              + 2 * B * SSD_NH * SSD_HD * SSD_N * 4)  # h0 read, h written
    return flops, nbytes


def phase_timing_ssm():
    """The scan kernel and its plain version in bf16 at the slice's
    shapes: one 160-token cold chunk (B = 1) and a 4 x 64 resume batch."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_inputs, ssd_scan_plain
    gen = torch.Generator(device="cuda").manual_seed(5)
    dtype, es = torch.bfloat16, 2
    res = {}
    for what, B, S in (("cold chunk", 1, 160), ("resume batch", 4, 64)):
        args = ssd_inputs(gen, B, S, SSD_NH, SSD_HD, SSD_N, dtype)
        bound, by = _bound_ms(*ssd_bound(B, S, SSD_CHUNK, es), dtype)
        r = dict(ms=_time_ms(lambda: ops.ssd_scan(*args, chunk=SSD_CHUNK)),
                 plain_ms=_time_ms(lambda: ssd_scan_plain(
                     *args, chunk=SSD_CHUNK)),
                 library_ms=None, bound_ms=bound, bound_by=by)
        log(f"[timing] ssd_scan {what} B={B} S={S} nh/hd/N="
            f"{SSD_NH}/{SSD_HD}/{SSD_N} bf16: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms=none (no single "
            f"PyTorch call) bound_ms={bound:.5f} ({by})")
        if what == "cold chunk":
            res["ssd_scan"] = r
    return res


def free_device_memory() -> None:
    """Release what a finished phase dropped.  An engine holds reference
    cycles (its telemetry gauges call back into it), so after ``del`` its
    cache and weights stay allocated until the cyclic collector runs:
    collect, then empty the cache so the next phase's peak memory is its
    own."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_identity(paged: bool):
    from repro_torch.configs.base import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.oracle import oracle_streams
    from repro_torch.serving.workload import make_workload
    torch.backends.cuda.matmul.allow_tf32 = False       # full f32 products
    tag = "identity_paged" if paged else "identity"
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=4,
                              kv_layout="paged" if paged else "slab",
                              kv_page_size=PAGE)
    log(f"[{tag}] {cfg.name} full width, depth cut to "
        f"{cfg.num_layers} of 36 layers, float32, {cfg.kv_layout} layout")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32)
    kw = dict(num_slots=5, max_seq=2048)
    ecfg = EngineConfig(cycle_budget=160, granularity=16,
                        control_interval_s=0.1, autotune_chunks=False,
                        record_events=True, **kw)
    # paged: seed 9's second agent cuts the system prompt shorter than the
    # first (a radix hit inside a registered prefix), its third longer (a
    # partial hit)
    mk = lambda: make_workload(3, workload="react",
                               vocab_size=cfg.vocab_size, token_scale=0.25,
                               seed=9 if paged else 3)
    eng = ServingEngine(cfg, params, "agentserve", ecfg,
                        dtype=torch.float32, device="cuda")
    sessions = mk()
    rep = eng.run(sessions)
    streams = {}
    for ev in eng.event_log:
        streams.setdefault(ev.session_id, []).append(ev.token)
    oracle = oracle_streams(cfg, params, mk(), dtype=torch.float32,
                            device="cuda", **kw)
    for s in sessions:
        want = sum(t.decode_len for t in s.turns)
        assert s.output_tokens() == want, (s.session_id, s.output_tokens())
        assert streams[s.session_id] == oracle[s.session_id], \
            (s.session_id, streams[s.session_id], oracle[s.session_id])
    extra = ""
    if paged:
        st = eng.pool.stats
        extra = (f" | prefix_hits={st['prefix_hits']} "
                 f"partial_hits={st['prefix_partial_hits']} "
                 f"page_copies={st['page_copies']}")
    log(f"[{tag}] {len(sessions)} sessions, "
        f"{sum(len(v) for v in streams.values())} tokens equal the "
        f"isolated greedy oracle | {rep.row()}{extra}")
    del eng, params
    free_device_memory()


def hybrid_config():
    """A small hybrid (attention + Mamba-2, one of each per group) at
    widths both kernels take: attention heads of 64, Mamba-2 heads of 64
    with d_state 128."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    return ModelConfig(
        name="hybrid-4l", family="hybrid", num_layers=4, d_model=512,
        num_heads=8, num_kv_heads=2, d_ff=1024, vocab_size=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk_size=256),
        hybrid_period=2, hybrid_attn_index=0, tie_embeddings=True,
        source="small hybrid of mamba2-780m's Mamba-2 widths")


def first_divergence_margin(cfg, params, session, got, kw):
    """Re-run the oracle for one session and return (step, top-2 logit
    margin there) at the first step where ``got`` leaves its stream."""
    from repro_torch.serving.engine import get_executables
    from repro_torch.serving.kvcache import KVCachePool
    cfg = dataclasses.replace(cfg, kv_layout="slab")
    ex = get_executables(cfg)
    pool = KVCachePool(cfg, kw["num_slots"], kw["max_seq"], torch.float32,
                       "cuda")
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device="cuda")
    step, length = 0, 0

    def margin(logits):
        top = torch.topk(logits.float().reshape(-1), 2).values
        return (top[0] - top[1]).item()
    for turn in session.turns:
        pt = torch.tensor(np.asarray(turn.prefill_tokens, np.int32)[None],
                          device="cuda")
        logits, pool.cache = ex.prefill(params, pool.cache, pt, i32(0),
                                        i32(length), i32(pt.shape[1] - 1))
        length += pt.shape[1]
        for i in range(turn.decode_len):
            tok = int(logits.float().reshape(-1).argmax())
            if step >= len(got) or got[step] != tok:
                return step, margin(logits)
            step += 1
            if i == turn.decode_len - 1:
                break
            t = torch.zeros((kw["num_slots"],), dtype=torch.int32,
                            device="cuda")
            ln = torch.zeros_like(t)
            t[0], ln[0] = tok, length
            logits, pool.cache = ex.decode(params, pool.cache, t, ln)
            logits = logits[0]
            length += 1
    return step, float("nan")


def phase_identity_ssm(hybrid: bool):
    """Slab vs paged engine streams (fixed chunks, exact prefix cache on
    both legs), then the paged leg with the radix index vs the oracle."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.oracle import oracle_streams
    from repro_torch.serving.workload import shared_prefix_workload
    torch.backends.cuda.matmul.allow_tf32 = False       # full f32 products
    tag = "identity_hybrid" if hybrid else "identity_ssm"
    base = (hybrid_config() if hybrid else
            dataclasses.replace(get_config("mamba2-780m"), num_layers=4))
    log(f"[{tag}] {base.name}: d_model {base.d_model}, {base.num_layers} "
        f"layers ({'attention + Mamba-2' if hybrid else 'of 48'}), float32")
    params = init_params(base, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32)
    kw = dict(num_slots=5, max_seq=2048)
    mk = lambda: shared_prefix_workload(
        3, num_templates=1, vocab_size=base.vocab_size, token_scale=0.25,
        seed=4, stagger_s=1.0)

    def run(layout, prefix_cache, policy):
        cfg = dataclasses.replace(base, kv_layout=layout, kv_page_size=PAGE)
        ecfg = EngineConfig(cycle_budget=160, granularity=16,
                            control_interval_s=0.1, autotune_chunks=False,
                            record_events=True, prefix_cache=prefix_cache,
                            **kw)
        eng = ServingEngine(cfg, params, policy, ecfg, dtype=torch.float32,
                            device="cuda")
        sessions = mk()
        rep = eng.run(sessions)
        streams = {}
        for ev in eng.event_log:
            streams.setdefault(ev.session_id, []).append(ev.token)
        for s in sessions:
            want = sum(t.decode_len for t in s.turns)
            assert s.output_tokens() == want, (tag, layout, s.session_id)
        st = eng.pool.stats
        log(f"[{tag}] {layout} {policy} prefix_cache={prefix_cache}: "
            f"{sum(len(v) for v in streams.values())} tokens | "
            f"prefix_hits={st['prefix_hits']} "
            f"partial_hits={st['prefix_partial_hits']} "
            f"state_copies={st['state_copies']} | {rep.row()}")
        del eng
        return streams, st

    slab, st_s = run("slab", "exact", "chunked")
    paged, st_p = run("paged", "exact", "chunked")
    assert paged == slab, f"{tag}: slab and paged streams differ"
    for st in (st_s, st_p):
        assert st["prefix_hits"] > 0 and st["state_copies"] > 0, st
    radix, st_r = run("paged", "radix", "chunked")
    oracle = oracle_streams(base, params, mk(), dtype=torch.float32,
                            device="cuda", **kw)
    for s in mk():
        got, want = radix[s.session_id], oracle[s.session_id]
        if got != want:
            step, m = first_divergence_margin(base, params, s, got, kw)
            raise AssertionError(
                f"{tag}: session {s.session_id} leaves the oracle at step "
                f"{step}; the oracle's top-2 logit margin there is {m:.3e}")
    log(f"[{tag}] slab == paged (exact), paged radix == oracle for "
        f"{len(oracle)} sessions, {sum(len(v) for v in oracle.values())} "
        f"tokens")
    del params
    free_device_memory()


def phase_slice(paged: bool, arch: str = "qwen2.5-3b"):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ssm = arch == "mamba2-780m"
    tag = ("slice_ssm" if ssm else "slice") + ("_paged" if paged else "")
    layout = (["--kv-layout", "paged", "--kv-page-size", str(PAGE)]
              if paged else [])
    args = serve.parse_args([
        "--full", "--arch", arch, "--agents", "4",
        "--workload", "react", "--max-seq", "8192",
        "--token-scale", str(SLICE_TOKEN_SCALE)] + layout)
    torch.cuda.reset_peak_memory_stats()
    log(f"[{tag}] {arch} full width and depth, bfloat16, 4 agents, "
        f"react, token_scale={SLICE_TOKEN_SCALE}, max_seq=8192, "
        f"{'paged (page %d, radix)' % PAGE if paged else 'slab'} layout")
    ops.reset_launches()
    t0 = time.perf_counter()
    (eng, sessions, rep), = serve.closed_loop(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for s in sessions:
        want = sum(t.decode_len for t in s.turns)
        assert s.output_tokens() == want, (s.session_id, s.output_tokens(),
                                           want)
    own, other = ((PAGED_KERNELS, SLAB_KERNELS) if paged
                  else (SLAB_KERNELS, PAGED_KERNELS))
    if ssm:
        own, other = SSM_KERNELS, SLAB_KERNELS + PAGED_KERNELS
    else:
        other = other + SSM_KERNELS
    for name in own:
        assert launches[name] > 0, f"{name} was never launched on the path"
    for name in other:
        assert launches[name] == 0, f"{name} was launched on the {tag} path"
    toks = sum(s.output_tokens() for s in sessions)
    prompt = sum(len(t.prefill_tokens) for s in sessions for t in s.turns)
    log(f"[{tag}] {serve.ServingReport.HEADER}")
    log(f"[{tag}] {rep.row()}")
    st = eng.pool.stats
    if paged:
        log(f"[{tag}] pool: prefix_hits={st['prefix_hits']} "
            f"partial_hits={st['prefix_partial_hits']} "
            f"misses={st['prefix_misses']} page_copies={st['page_copies']} "
            f"state_copies={st['state_copies']} "
            f"pages_in_use_peak={eng.pool.pages_peak} of "
            f"{eng.pool.num_pages} pages of {PAGE} rows "
            f"arena_bytes={eng.pool.arena_bytes()} "
            f"evictions={st['evictions']} "
            f"kv_deferred={eng.hotpath_stats['kv_deferred']}")
    elif ssm:
        log(f"[{tag}] pool: prefix_hits={st['prefix_hits']} "
            f"misses={st['prefix_misses']} "
            f"state_copies={st['state_copies']} "
            f"parks={st['parks']}")
    log(f"[{tag}] sessions={len(sessions)} output_tokens={toks} "
        f"prompt_tokens={prompt} run_wall_s={rep.wall_time_s:.3f} "
        f"output_tok_s={toks / rep.wall_time_s:.2f} "
        f"build_and_run_s={wall:.1f} "
        f"max_memory_allocated_GB={torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"launches={launches}")
    return launches, eng


def _device_us(e):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


def phase_profile(eng, paged: bool, tag: str = "profile"):
    """Where a slice step's time goes: the slice engine's own forwards,
    timed with the host clock around a synchronize and traced with
    torch.profiler over the device alone (time by kernel, busy share).
    Paged: every slot maps its own pages, in order."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import (forward_decode_megastep,
                                    forward_prefill, forward_resume_batch)
    cfg, params, cache = eng.mcfg, eng.params, eng.pool.cache
    B = eng.ecfg.num_slots
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    tag = tag + ("_paged" if paged else "")
    bt, one = None, {"slot_idx": i32([0])}
    if paged:
        pmax = eng.pool.pages_per_slot
        bt = torch.arange(B * pmax, dtype=torch.int32,
                          device="cuda").reshape(B, pmax)
        one = {"block_tables": bt[:1]}
    work = {
        "decode megastep K=8, 6 lanes at 3500 rows": lambda: (
            forward_decode_megastep(params, cfg, i32([0] * B), cache,
                                    i32([3500] * B),
                                    torch.ones(B, dtype=torch.bool,
                                               device="cuda"), num_steps=8,
                                    block_tables=bt)),
        "cold chunk 160 tokens at offset 3000": lambda: forward_prefill(
            params, cfg, torch.zeros((1, 160), dtype=torch.int32,
                                     device="cuda"), cache, i32([3000]),
            **one),
        "resume batch 4 x 64 tokens at 3000-4200": lambda: (
            forward_resume_batch(params, cfg,
                                 torch.zeros((4, 64), dtype=torch.int32,
                                             device="cuda"), cache,
                                 i32([0, 1, 2, 3]),
                                 i32([3100, 3600, 4200, 2900]),
                                 i32([63] * 4), block_tables=bt)),
    }
    for what, fn in work.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if _device_us(e) > 0]
        busy = sum(_device_us(e) for e in ev) / 1e3
        top = sorted(ev, key=_device_us, reverse=True)[:6]
        log(f"[{tag}] {what}: wall_ms={wall * 1e3:.2f} "
            f"device_ms={busy:.2f} device_busy={busy / (wall * 1e3):.1%}")
        for e in top:
            log(f"[{tag}]    {_device_us(e) / 1e3:9.3f} ms  "
                f"x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    name, smi = phase_device()
    phase_build()
    worst = phase_parity()
    worst.update(phase_parity_paged())
    worst.update(phase_parity_ssm())
    timing = phase_timing()
    timing.update(phase_timing_paged())
    timing.update(phase_timing_ssm())
    phase_identity(paged=False)
    launches, eng = phase_slice(paged=False)
    phase_profile(eng, paged=False)
    del eng
    free_device_memory()
    phase_identity(paged=True)
    launches_paged, eng = phase_slice(paged=True)
    phase_profile(eng, paged=True)
    del eng
    free_device_memory()
    phase_identity_ssm(hybrid=False)
    phase_identity_ssm(hybrid=True)
    launches_ssm, eng = phase_slice(paged=False, arch="mamba2-780m")
    phase_profile(eng, paged=False, tag="profile_ssm")
    del eng
    free_device_memory()
    launches_ssm_paged, eng = phase_slice(paged=True, arch="mamba2-780m")
    phase_profile(eng, paged=True, tag="profile_ssm")
    # each kernel's launches are those of the slice that runs its path
    # (the scan: the slab Mamba-2 slice; its paged twin's count is in the
    # slice_ssm_paged line)
    launches.update({k: launches_paged[k] for k in PAGED_KERNELS})
    launches.update({k: launches_ssm[k] for k in SSM_KERNELS})
    log("kernels: " + "; ".join(
        f"{k} parity=ok max_abs_err={worst[k]:.3e} launches={launches[k]}"
        for k in SOURCES))
    print(smi)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0],
         "replaces": SOURCES[k][1], "launches": launches[k],
         "max_abs_err": worst[k], "ms": timing[k]["ms"],
         "plain_ms": timing[k]["plain_ms"], "bound_ms": timing[k]["bound_ms"],
         "bound_by": timing[k]["bound_by"],
         "library_ms": timing[k]["library_ms"]} for k in SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
