"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches its own
failure:

1. device  — the card's name, count and power limit; fails without CUDA.
2. build   — compiles every CUDA kernel from ``src/repro_torch/kernels/
             csrc`` (one nvcc per source, in parallel) and prints
             ptxas's register / shared-memory / spill lines, and the
             count of tensor-core instructions in each built library's
             SASS (``cuobjdump -sass``): HGMMA (wgmma; > 0 for
             prefill_attention and moe_gmm) and HMMA (mma.sync; > 0 for
             ssd_scan).
3. parity  — each kernel against its plain PyTorch version at the main
             path's shapes (Qwen2.5-3B heads 16/2/128, SmolLM-360M heads
             15/5/64 and OLMoE-1B-7B heads 16/16/128, S_max 8192, ragged
             lengths to 8000, prefill chunks of 1 to 320 tokens at
             offsets 0 and > 0; slab: a strided cache view; paged: page
             64, shuffled tables in which two rows share pages), f32
             within 1e-4 and bf16 within 2e-2 max abs error; the bf16
             prefill's split merge against its plain form.  The paged
             kernels are also held against the slab kernels on the same
             logical rows.
4. timing  — each kernel, its plain version and one library call
             (``scaled_dot_product_attention`` with the equivalent
             boolean mask on the valid slice, already gathered for the
             paged kernels, timed only here) with CUDA events over many
             launches, beside the bound max(flops / 989e12,
             bytes / 3.35e12) computed from these inputs (keys each row
             needs, every input byte read once, block-table entries
             included); the prefill entries also at the resume batch's
             shape (4 x 64 tokens).
5. identity — float32 full-width Qwen2.5-3B cut to 4 layers, served by
             the engine on a 3-agent react workload on the slab layout;
             every session's stream must equal the port's isolated
             greedy oracle.
6. slice   — full-width, full-depth Qwen2.5-3B in bf16 through
             ``repro_torch.launch.serve``'s closed loop (4 agents, react,
             max_seq 8192) on the slab layout; every session must finish
             with all its tokens, the slab kernels' launch counts must be
             > 0 and the paged kernels' 0.  Prefill parity covers chunks
             of 1, 2, 4, 6 and 8 tokens: the spec verify's widths.
7. profile — the slice engine's own forwards (a K=8 decode megastep, a
             cold chunk, a resume batch): wall time, device time and
             device time by kernel from ``torch.profiler``.
8-10.      — identity, slice and profile again on the paged layout (page
             64, radix prefix cache): the slice runs with
             ``--kv-layout paged``, its paged kernels' launch counts must
             be > 0 and the slab kernels' 0, and it prints the pool's
             prefix hits, partial hits, page copies and peak pages.

Speculative decode (n-gram draft and multi-query verify, ``spec_k`` 4;
the verify reads the cache through kernel 1 or 4 at Sq = k):

11a. identity_spec and its paged twin — phase 5's f32 identity check
             with ``spec_k=4``: every stream equals the isolated greedy
             oracle (a mismatch prints the oracle's top-2 margin), spec
             steps > 0; the counters and launch counts are printed.
11b. slice_spec — phase 6's slice through ``--spec-k 4``: every session
             finishes, the slab kernels launch and the paged ones do not,
             spec steps > 0; prints the report row, spec steps, proposed
             and accepted drafts, the acceptance rate and tokens per
             model call.  The same engine then serves three agents with
             constant prompts (greedy attractors of this model): drafts
             are accepted (> 0) and rolled back (accepted < proposed),
             every session finishes, only the slab kernels launch.
11c. profile_spec — one spec step at K = 4 over the slice's 6 lanes at
             3500 rows (after a direct call shows it launches kernel 1
             once per layer and nothing else), beside the K=8 megastep.
11d. identity_spec_hybrid — the small hybrid (f32, slab, ``chunked``):
             spec-on streams equal spec-off streams; one step called
             directly launches kernel 7 twice per Mamba-2 layer and kernel
             1 twice per attention layer (the verify and the fenced
             re-run at the accepted length).

Mamba-2 (the SSD chunked scan, ``ssd_scan``):

3-4.       — parity and timing of the scan kernel at mamba2-780m widths
             (48 heads of 64, d_state 128, chunk 256): S in {1, 50, 160,
             256, 1000} with a nonzero carried-in state and a tail of
             dt = 0 rows, f32 within 2e-4 and bf16 within 2e-2 on y and
             on the state (bf16 runs the tensor-core body); timed at a
             160-token cold chunk and a 4 x 64 resume batch (CUDA events
             and the profiler's device time; the block plan and waves
             first) beside the bound max(flops / 989e12,
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

MoE (the grouped matmul of the experts, ``moe_gmm``):

3-4.       — parity of the grouped matmul at OLMoE-1B-7B's expert widths
             (64 experts, d 2048, f 1024): up and down products for C in
             {1, 6, 25, 40, 50, 160, 256}, dense mode's expert-stride-0
             view at C 6, 160 and 256, Mixtral-8x22B's up product (8
             experts, d 6144, f 16384) at C 6 and 160, and the JAX kernel
             test's shapes, f32 within 1e-4 and bf16 within 2e-2; a row's
             bf16 output bitwise the same at C 1, 6, 25, 40, 160 and 256
             and under a stride-0 view and its contiguous copy.  Timed in
             bf16, up and down at C 1, 6, 25, 40, 160 and 256 (the up
             product through the stride-0 view where dense mode sends it:
             C 6, 160, 256), with CUDA events and the profiler's device
             time, beside its plain version, one ``torch.bmm`` (timed only
             here) and the bound max(2ECdf / 989e12, bytes / 3.35e12) (x
             read once, the [C, d] tokens under the broadcast; w read
             once; the output written once).
16-17. identity_moe and its paged twin — float32 OLMoE-1B-7B widths cut
             to 4 layers, engine ``moe_mode="dense"``, 3 agents, slab then
             paged (radix): every stream equals the isolated greedy oracle
             (a mismatch prints the oracle's top-2 margin).
18-19. slice_moe and profile_moe — full-width, full-depth OLMoE-1B-7B in
             bf16 through ``repro_torch.launch.serve``'s closed loop (4
             agents, react, max_seq 8192, slab, the engine's default
             ``moe_mode="dense"``): every session finishes, ``moe_gmm`` and
             the slab attention kernels launch, the others do not, and
             ``moe_gmm`` launches 48 times per forward (3 per layer); then
             the profile of its forwards under "dense" and again under
             "gmm" on the same weights.  Every earlier slice asserts that
             ``moe_gmm`` never launched.

int8 KV cache (the four ``_quant`` attention entries; the int8 cache has
no engine path, as in the JAX package, so a model-level greedy loop,
``greedy_drive``, serves it through the forwards: cold prompts in
160-token ``forward_prefill`` chunks, one ``forward_resume_batch`` per
later turn, ``forward_decode_megastep`` K=8 over the lanes):

3-4.       — parity of ``flash_prefill_quant``, ``flash_decode_quant`` and
             their paged forms against their plain versions at the
             attention parity shapes (int8 values and scales from
             ``quantize_kv``, a strided view of both; paged: page 64,
             shuffled shared tables, also against the slab entries on the
             gathered rows), prefill at every parity chunk length
             (spec-verify 1, 2 and 8 included), f32 within 1e-4 (the
             CUDA-core body), bf16 within 2e-2 (the prefill entries: the
             tensor-core body on int8 tiles); timed at the attention
             timing shapes beside the plain version, one SDPA call on K/V
             dequantised beforehand (the dequantisation is not timed; no
             single PyTorch call reads int8, so the JSON line's
             library_ms is null) and the bound from int8 values and
             scales; the prefill entries also by profiler device time,
             with their split count, at the cold chunk and at the 4 x 64
             resume batch.
20-21. identity_int8 and its paged twin — float32 Qwen2.5-3B widths cut
             to 4 layers, 3 react sessions at token scale 0.25:
             ``greedy_drive`` on the card and on the CPU (plain versions) in lock-step
             through ``QuantLedger`` (the quantiser's rounding flips
             counted, then shared): equal tokens, logits within 1e-3.
22-23. slice_int8, slice_int8_paged and profile_int8 — full-width,
             full-depth Qwen2.5-3B in bf16, 6 lanes at token scale 1.0,
             max_seq 8192: every session gets all its tokens, only the
             layout's two int8 entries launch; cache bytes against a bf16
             cache's, ms per megastep and cold chunk, output tok/s, peak
             memory, the share of greedy tokens equal to the same
             loop's over a bf16 cache (printed), and the device time by
             kernel of one megastep and one cold chunk.

Training (kernel 9, whole-sequence flash attention, under the
``FlashAttention`` autograd Function) and sliding-window decode:

3-4.       — ``parity_flash``: kernel 9 against its plain version at the
             card tests' head shapes (query groups 8, 3, 7, 4 and 1; hd 64
             and 128), f32 and bf16, causal at S 2048 with and without a
             window of 256, non-causal and causal at the ragged S 1000: o
             within TOL, the row statistics m within 1e-4 and l within
             1e-4 relative; then the Function's dq, dk, dv against
             autograd through the plain version in f32 (1e-4).
             ``parity_window_decode``: the four decode entries with
             windows 64 and 1024 against their plain versions (lengths 1,
             below, at and above the window; slab and paged).
             ``parity_split_decode``: the four decode entries, which split
             each row over fixed 256-key chunks and merge them, against
             their plain versions at query groups 8, 3, 1 and 12
             (48/4/128), lengths at the chunk edges, windows 0 and 1000;
             every row's output bitwise equal alone, in the batch and
             over twice the capacity; the merge kernel against its plain
             form.  The decode timings add the profiler's device time
             (chunk kernel + merge), the chunk and block counts, and the
             device time at the other chunk sizes of 128, 256 and 512.
             ``timing_flash``: kernel 9 at B 4, S 2048, causal, SmolLM-360M
             heads 15/5/64 and Qwen2.5-3B heads 16/2/128 in f32 and bf16,
             beside its plain version, one SDPA call (``is_causal``,
             ``enable_gqa``; timed only here) and the bound max(flops /
             peak of the type, bytes / 3.35e12), causal flops 2 B H S^2 hd;
             and the four decode entries at window 1024 against window 0.
24. identity_train — 4 train steps of the smollm-360m smoke config (f32,
             remat) on the card and on the CPU from the same weights and
             batches: losses and gradient norms within 1e-4 relative,
             final parameters within 1e-5 but for at most 0.1% of
             elements (Adam's sign at rounding-level gradients); then the
             mixtral-8x22b smoke config (window 64) prefills 100 tokens
             and decodes a 24-step megastep on both layouts, card tokens
             equal to the CPU's.
25. slice_train — full-width, full-depth SmolLM-360M training through
             ``repro_torch.launch.train`` (8 steps of 4 x 2048 tokens, f32,
             remat): kernel 9 launches 2 x 32 x 8 times and no other kernel
             launches; the loss falls; then one profiled step's device
             time split into kernel 9, the attention backward, the MLP and
             projection matmuls, the logits and CE, the optimizer and the
             rest.  ``timing_flash`` gives kernel 9's profiler device time
             beside its CUDA-event time.
26. forward_testbed — the paper's Qwen2.5-7B and Llama3-8B at full
             width and depth in bf16 (random weights): one 160-token cold
             chunk at offset 3000 (finite logits) and one K=8 megastep over
             6 lanes of 8192 rows, wall and device time, top kernels and
             peak memory.

The last lines are the kernel list, the nvidia-smi line, the kernel JSON
line and the result JSON line.
"""
from __future__ import annotations

import contextlib
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
SPEC_K = 4                       # draft-and-verify width of the spec phases
SLAB_KERNELS = ("flash_prefill", "flash_decode")
PAGED_KERNELS = ("flash_prefill_paged", "flash_decode_paged")
SSM_KERNELS = ("ssd_scan",)
MOE_KERNELS = ("moe_gmm",)
INT8_KERNELS = ("flash_prefill_quant", "flash_decode_quant")
INT8_PAGED_KERNELS = ("flash_prefill_paged_quant", "flash_decode_paged_quant")
FLASH_KERNELS = ("flash_attention",)
DECODE_KERNELS = ("flash_decode", "flash_decode_paged", "flash_decode_quant",
                  "flash_decode_paged_quant")
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
    "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                "src/repro/kernels/moe_gmm.py:42"),
    "flash_prefill_quant": (
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention.py:253"),
    "flash_prefill_paged_quant": (
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention.py:279"),
    # no TPU kernel: the XLA int8 branch of the JAX decode functions
    "flash_decode_quant": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                           "src/repro/models/attention.py:472"),
    "flash_decode_paged_quant": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/models/attention.py:338"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:86"),
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
    # tensor-core instructions in each built library's SASS
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    hgmma, hmma = {}, {}
    for n in names:
        sass = subprocess.run([cuobjdump, "-sass", str(_build._target(n))],
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()
        hgmma[n] = sum("HGMMA" in line for line in sass)
        hmma[n] = sum("HMMA" in line for line in sass)
    log(f"[build] HGMMA instructions in SASS: {hgmma}")
    log(f"[build] HMMA (mma.sync) instructions in SASS: {hmma}")
    assert hgmma["prefill_attention"] > 0 and hgmma["moe_gmm"] > 0, hgmma
    assert hmma["ssd_scan"] > 0, hmma


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _i32(vals):
    return torch.tensor(vals, dtype=torch.int32, device="cuda")


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


# Qwen2.5-3B, SmolLM-360M and OLMoE-1B-7B heads (H, Hk, hd): query
# groups 8, 3 and 1
PARITY_HEADS = ((16, 2, 128), (15, 5, 64), (16, 16, 128))
# prefill chunk lengths: spec-verify blocks (1 and every even spec level
# up to 8), resumes, cold chunks
PARITY_SQ = (1, 2, 4, 6, 8, 16, 56, 160, 320)


def phase_parity():
    """Kernel vs plain version; returns the worst error per kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.prefill_attention import prefill_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"flash_prefill": 0.0, "flash_decode": 0.0}
    S, B = 8192, 6
    lens = [1, 37, 1000, 3500, 8000, 5000]
    for H, Hk, hd in PARITY_HEADS:
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
                for Sq in PARITY_SQ:
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
    worst["flash_prefill"] = max(worst["flash_prefill"], parity_merge())
    return worst


def parity_merge():
    """The bf16 entries' split merge kernel against its plain form on
    partial states of 7 splits, some empty (m = -1e30, l = 0)."""
    from repro_torch.kernels.prefill_attention import (merge_partials_cuda,
                                                       merge_partials_plain)
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    for hd in (64, 128):
        splits, M, Sq, H = 7, 3, 160, 16
        part_o = torch.randn(splits, M, Sq, H, hd, generator=gen,
                             device="cuda")
        m = 8 * torch.randn(splits, M, Sq, H, generator=gen, device="cuda")
        l = 1 + torch.rand(splits, M, Sq, H, generator=gen, device="cuda")
        empty = torch.rand(splits, M, Sq, H, generator=gen,
                           device="cuda") < 0.3
        empty[0] = False
        part_o[empty] = 0
        part_ml = torch.stack([m.masked_fill(empty, -1e30),
                               l.masked_fill(empty, 0)], dim=-1)
        for dtype in (torch.bfloat16, torch.float32):
            err = _max_err(merge_partials_cuda(part_o, part_ml, dtype),
                           merge_partials_plain(part_o, part_ml, dtype))
            torch.cuda.synchronize()
            log(f"[parity] prefill merge hd={hd} splits={splits} "
                f"{str(dtype)[6:]} max_abs_err={err:.3e}")
            assert err <= TOL[dtype], ("prefill merge", err)
            worst = max(worst, err)
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
    for H, Hk, hd in PARITY_HEADS:
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
            for Sq in PARITY_SQ:
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


# device traces taken by _device_ms, and those thrown away for lost events
TRACES = {"taken": 0, "lost": 0}


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


def _device_ms(fn, iters=40, part=None, traces=3):
    """Device time per call of every kernel fn launches (torch.profiler):
    the kernels' own time, where _time_ms also sees the host's launch
    rate.  ``part``: also return the time of the kernels whose name holds
    that word.  The device trace can drop launches, more often when the
    calls start as the tracer does: they begin 20 ms after it, and a trace
    that lost events is thrown away and taken again, at most ``traces``
    times, so that no sum is read from an incomplete trace."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        # every call launches each of its kernels as often: a count that
        # is not a multiple of the calls means the trace lost events
        lost = {e.key: e.count for e in ev
                if (_device_us(e) or 0) > 0 and e.count % iters}
        TRACES["taken"] += 1
        if not lost:
            break
        TRACES["lost"] += 1
        log(f"[timing] device trace lost events ({iters} calls): {lost}; "
            f"trace thrown away")
    assert not lost, ("device trace lost events", iters, lost)
    total = sum(_device_us(e) or 0 for e in ev) / iters / 1e3
    if part is None:
        return total
    return total, sum(_device_us(e) or 0 for e in ev
                      if part in e.key) / iters / 1e3


def _log_timing(name, r):
    dev = (f" device_ms={r['device_ms']:.4f}" if "device_ms" in r else "")
    log(f"[timing] {name} {r['shape']}: kernel_ms={r['ms']:.4f}{dev} "
        f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
        f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")


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
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
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
        shape=f"B={B} H/Hk/hd={H}/{Hk}/{hd} lens={lens} bf16",
        **decode_split_info(lambda c: lambda: decode_attention_cuda(
            q, kc, vc, L, chunk=c), S, lens, Hk, G))

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
        device_ms=_device_ms(lambda: ops.flash_prefill(qq, kc, vc, qo, ln,
                                                       slot_idx=si)),
        plain_ms=_time_ms(lambda: prefill_attention_plain(
            qq, kc, vc, qo, ln, slot_idx=si)),
        library_ms=_time_ms(lib), bound_ms=bound, bound_by=by,
        shape=f"M={M} Sq={Sq} offset={off} H/Hk/hd={H}/{Hk}/{hd} G={G} bf16")
    for name, r in res.items():
        _log_timing(name, r)
    _log_split("timing", "flash_decode", res["flash_decode"])

    # resume-batch shape of the slice: 4 rows of 64 tokens deep in context
    M, Sq = 4, 64
    qq = _rand(gen, (M, Sq, H, hd), dtype)
    qo, ln, si = _i32(RESUME_OFFS), _i32([o + Sq for o in RESUME_OFFS]), \
        _i32([0, 1, 2, 3])
    lib = resume_sdpa(qq, kc[:M], vc[:M])
    r = dict(ms=_time_ms(lambda: ops.flash_prefill(qq, kc, vc, qo, ln,
                                                   slot_idx=si)),
             device_ms=_device_ms(lambda: ops.flash_prefill(
                 qq, kc, vc, qo, ln, slot_idx=si)),
             plain_ms=_time_ms(lambda: prefill_attention_plain(
                 qq, kc, vc, qo, ln, slot_idx=si)),
             library_ms=_time_ms(lib), shape=f"resume M={M} Sq={Sq} "
             f"offsets={RESUME_OFFS} H/Hk/hd={H}/{Hk}/{hd} G={G} bf16")
    r["bound_ms"], r["bound_by"] = resume_bound(H, Hk, hd, es, 12 * M)
    res["flash_prefill@resume"] = r
    _log_timing("flash_prefill@resume", r)
    return res


# the resume batch's rows: 4 x 64 tokens deep in context
RESUME_OFFS = [3100, 3600, 4200, 2900]


def resume_sdpa(qq, kc, vc):
    """One SDPA call on the resume batch: q [M, Sq, H, hd] against cache
    rows kc/vc [M, >= L, Hk, hd] (row m's, already gathered), each row
    masked to its own causal keys."""
    import torch.nn.functional as F
    M, Sq = qq.shape[:2]
    Lk = max(RESUME_OFFS) + Sq
    kt = kc[:, :Lk].transpose(1, 2)
    vt = vc[:, :Lk].transpose(1, 2)
    q_pos = (torch.tensor(RESUME_OFFS, device="cuda")[:, None]
             + torch.arange(Sq, device="cuda")[None, :])          # [M, Sq]
    mask = (torch.arange(Lk, device="cuda")[None, None, :]
            <= q_pos[:, :, None])[:, None]                      # [M,1,Sq,Lk]
    qt = qq.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def resume_bound(H, Hk, hd, es, extra_bytes):
    """The resume batch's bound: its causal (query, key) pairs, each
    row's keys read once, q and the output once, plus ``extra_bytes``
    (index words, table entries)."""
    Sq, M = 64, len(RESUME_OFFS)
    pairs = sum(o + i + 1 for o in RESUME_OFFS for i in range(Sq))
    keys = sum(o + Sq for o in RESUME_OFFS)
    return _bound_ms(4 * pairs * H * hd,
                     (2 * keys * Hk * hd + 2 * M * Sq * H * hd) * es
                     + extra_bytes, torch.bfloat16)


def phase_timing_paged():
    """The paged kernels at the slab timing's shapes (bf16, Qwen2.5-3B
    heads, 6 slots of 8192 rows, page 64, shuffled tables).  Library: SDPA
    on the valid slice gathered beforehand (the call alone is timed).
    The bound counts the block-table entries each row reads."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_cuda, decode_attention_paged_plain,
        paged_gather)
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
        shape=f"B={B} H/Hk/hd={H}/{Hk}/{hd} lens={lens} page={PAGE} bf16",
        **decode_split_info(lambda c: lambda: decode_attention_paged_cuda(
            q, ka, va, L, bt, chunk=c), pmax * PAGE, lens, Hk, G))

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
        device_ms=_device_ms(lambda: ops.flash_prefill_paged(qq, ka, va, qo,
                                                             ln, bt_1)),
        plain_ms=_time_ms(lambda: prefill_attention_paged_plain(
            qq, ka, va, qo, ln, bt_1)),
        library_ms=_time_ms(lib), bound_ms=bound, bound_by=by,
        shape=f"M=1 Sq={Sq} offset={off} H/Hk/hd={H}/{Hk}/{hd} G={G} "
              f"page={PAGE} bf16")
    for name, r in res.items():
        _log_timing(name, r)
    _log_split("timing", "flash_decode_paged", res["flash_decode_paged"])

    M, Sq = 4, 64
    qq = _rand(gen, (M, Sq, H, hd), dtype)
    qo, ln = _i32(RESUME_OFFS), _i32([o + Sq for o in RESUME_OFFS])
    bt_m = bt[:M].contiguous()
    lib = resume_sdpa(qq, paged_gather(ka, bt_m).contiguous(),
                      paged_gather(va, bt_m).contiguous())
    r = dict(ms=_time_ms(lambda: ops.flash_prefill_paged(qq, ka, va, qo, ln,
                                                         bt_m)),
             device_ms=_device_ms(lambda: ops.flash_prefill_paged(
                 qq, ka, va, qo, ln, bt_m)),
             plain_ms=_time_ms(lambda: prefill_attention_paged_plain(
                 qq, ka, va, qo, ln, bt_m)),
             library_ms=_time_ms(lib), shape=f"resume M={M} Sq={Sq} "
             f"offsets={RESUME_OFFS} H/Hk/hd={H}/{Hk}/{hd} G={G} "
             f"page={PAGE} bf16")
    r["bound_ms"], r["bound_by"] = resume_bound(
        H, Hk, hd, es,
        8 * M + 4 * sum(-(-(o + Sq) // PAGE) for o in RESUME_OFFS))
    res["flash_prefill_paged@resume"] = r
    _log_timing("flash_prefill_paged@resume", r)
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
    """The scan kernel (bf16: the tensor-core body) and its plain version
    at the slice's shapes: one 160-token cold chunk (B = 1) and a 4 x 64
    resume batch.  The kernel's CUDA-event time and its profiler device
    time (its own time: the event time also sees the host's launch rate),
    beside each shape's bound; first the block plan (grid, shared memory,
    blocks resident an SM as the CUDA runtime reports them, waves)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import (ssd_inputs, ssd_scan_plain,
                                              tc_occupancy, tc_plan)
    gen = torch.Generator(device="cuda").manual_seed(5)
    dtype, es = torch.bfloat16, 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smem, resident = tc_occupancy(SSD_HD, SSD_N)
    res = {}
    for what, B, S in (("cold chunk", 1, 160), ("resume batch", 4, 64)):
        plan = tc_plan(B, SSD_NH, SSD_HD, SSD_N)
        assert smem == plan.smem_bytes and resident >= plan.resident_per_sm
        log(f"[timing] ssd_scan {what} plan: grid {plan.grid} = "
            f"{plan.blocks} blocks of {plan.threads} threads, "
            f"{smem} B shared memory, {resident} resident an SM (the plan "
            f"{plan.resident_per_sm}) on {sms} SMs: {plan.waves(sms)} "
            f"wave(s)")
        args = ssd_inputs(gen, B, S, SSD_NH, SSD_HD, SSD_N, dtype)
        bound, by = _bound_ms(*ssd_bound(B, S, SSD_CHUNK, es), dtype)
        fn = lambda: ops.ssd_scan(*args, chunk=SSD_CHUNK)
        r = dict(ms=_time_ms(fn), device_ms=_device_ms(fn),
                 plain_ms=_time_ms(lambda: ssd_scan_plain(
                     *args, chunk=SSD_CHUNK)),
                 library_ms=None, bound_ms=bound, bound_by=by)
        log(f"[timing] ssd_scan {what} B={B} S={S} nh/hd/N="
            f"{SSD_NH}/{SSD_HD}/{SSD_N} bf16: kernel_ms={r['ms']:.4f} "
            f"device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms=none (no single PyTorch call) "
            f"bound_ms={bound:.5f} ({by})")
        if what == "cold chunk":
            res["ssd_scan"] = r
    return res


# OLMoE-1B-7B's expert widths
MOE_E, MOE_D, MOE_F = 64, 2048, 1024


def _gmm_inputs(gen, E, C, d, f, dtype, *, broadcast=False):
    """x ~ N(0, 1) and w ~ N(0, 1/d), the magnitudes of the model path;
    ``broadcast``: x is dense mode's expert-stride-0 view of [C, d]."""
    if broadcast:
        x = _rand(gen, (C, d), dtype).expand(E, C, d)
    else:
        x = _rand(gen, (E, C, d), dtype)
    w = (torch.randn((E, d, f), generator=gen, device="cuda")
         * d ** -0.5).to(dtype)
    return x, w


def phase_parity_moe():
    """The grouped matmul vs its plain version: OLMoE's up/gate and down
    products over the C of each serving call, dense mode's stride-0 view,
    Mixtral-8x22B's up product, and the JAX kernel test's shapes; then the
    bf16 rows' invariance to C and to the stride-0 view."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import gmm_plain
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = ([("up", MOE_E, C, MOE_D, MOE_F, False)
              for C in (1, 6, 25, 40, 50, 160, 256)]
             + [("down", MOE_E, C, MOE_F, MOE_D, False)
                for C in (1, 6, 25, 40, 50, 160, 256)]
             + [("up stride-0", MOE_E, C, MOE_D, MOE_F, True)
                for C in (6, 160, 256)]
             + [("mixtral up", 8, C, 6144, 16384, False) for C in (6, 160)]
             + [("jax test", E, C, d, f, False)
                for E, C, d, f in ((4, 32, 64, 96), (2, 50, 48, 40),
                                   (8, 16, 128, 256))])
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for what, E, C, d, f, bc in cases:
            x, w = _gmm_inputs(gen, E, C, d, f, dtype, broadcast=bc)
            got = ops.moe_gmm(x, w)
            err = _max_err(got, gmm_plain(x, w))
            torch.cuda.synchronize()
            log(f"[parity_moe] {what} E/C/d/f={E}/{C}/{d}/{f} "
                f"{str(dtype)[6:]} x_strides={tuple(x.stride())} "
                f"max_abs_err={err:.3e}")
            assert got.shape == (E, C, f) and got.dtype == dtype
            assert err <= TOL[dtype], ("moe_gmm", what, E, C, d, f, err)
            worst = max(worst, err)
            del x, w, got
    parity_gmm_invariance(gen)
    parity_gmm_rounding(gen)
    return {"moe_gmm": worst}


def parity_gmm_rounding(gen):
    """How many bf16 outputs of the kernel, of its plain version (an f32
    einsum) and of ``torch.bmm`` (one tensor-core chain over all of d) are
    off the f64 product rounded to bf16, at OLMoE's up product, C 160."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import gmm_plain
    x, w = _gmm_inputs(gen, MOE_E, 160, MOE_D, MOE_F, torch.bfloat16)
    exact = torch.einsum("ecd,edf->ecf", x.double(), w.double()).bfloat16()
    off = {k: (v != exact).sum().item() for k, v in (
        ("kernel", ops.moe_gmm(x, w)), ("plain", gmm_plain(x, w)),
        ("torch.bmm", torch.bmm(x, w)))}
    log(f"[parity_moe] bf16 outputs off the f64 product of {exact.numel()} "
        f"(up, C=160): {off}")


def parity_gmm_invariance(gen):
    """bf16: the first c rows of a 256-row call, run alone at each serving
    C, give the same bits; so do a stride-0 view and its contiguous copy."""
    from repro_torch.kernels import ops
    for what, d, f in (("up", MOE_D, MOE_F), ("down", MOE_F, MOE_D)):
        x, w = _gmm_inputs(gen, MOE_E, 256, d, f, torch.bfloat16)
        full = ops.moe_gmm(x, w)
        for c in (1, 6, 25, 40, 160, 256):
            same = torch.equal(ops.moe_gmm(x[:, :c].contiguous(), w),
                               full[:, :c])
            log(f"[parity_moe] {what} rows of C=256 alone at C={c}: "
                f"bitwise equal={same}")
            assert same, ("moe_gmm row invariance", what, c)
        view = x[0].expand(MOE_E, 256, d)
        same = torch.equal(ops.moe_gmm(view, w),
                           ops.moe_gmm(view.contiguous(), w))
        log(f"[parity_moe] {what} stride-0 view vs its copy: bitwise "
            f"equal={same}")
        assert same, ("moe_gmm stride-0 invariance", what)


def gmm_bound(E, C, d, f, es, broadcast):
    """(flops, bytes) of one call: 2ECdf; x read once (the [C, d] tokens
    under dense mode's broadcast), w read once, the output written once."""
    x_bytes = (C if broadcast else E * C) * d * es
    return 2 * E * C * d * f, x_bytes + E * d * f * es + E * C * f * es


# (C, up through dense mode's stride-0 view): gmm decode, dense decode,
# gmm cold chunk, gmm resume batch, dense cold chunk, dense resume batch
GMM_TIMING_C = ((1, False), (6, True), (25, False), (40, False), (160, True),
                (256, True))


def phase_timing_moe():
    """The kernel, its plain version and one ``torch.bmm`` (the library
    call computing the same function, timed here only) in bf16 at OLMoE's
    serving calls, up and down: CUDA events per call, and the profiler's
    device time of the kernel and of the bmm.  The kernel line's entry is
    the up product at dense decode (C 6, stride-0 view)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import gmm_plain, gmm_plan
    gen = torch.Generator(device="cuda").manual_seed(7)
    dtype, es = torch.bfloat16, 2
    res = {}
    for what, d, f in (("up", MOE_D, MOE_F), ("down", MOE_F, MOE_D)):
        for C, up_bc in GMM_TIMING_C:
            bc = up_bc and what == "up"
            x, w = _gmm_inputs(gen, MOE_E, C, d, f, dtype, broadcast=bc)
            bound, by = _bound_ms(*gmm_bound(MOE_E, C, d, f, es, bc), dtype)
            plan = gmm_plan(MOE_E, C, d, f, dtype)
            r = dict(ms=_time_ms(lambda: ops.moe_gmm(x, w)),
                     device_ms=_device_ms(lambda: ops.moe_gmm(x, w)),
                     plain_ms=_time_ms(lambda: gmm_plain(x, w)),
                     library_ms=_time_ms(lambda: torch.bmm(x, w)),
                     library_device_ms=_device_ms(lambda: torch.bmm(x, w)),
                     bound_ms=bound, bound_by=by)
            log(f"[timing_moe] moe_gmm {what} C={C} "
                f"{'stride-0 ' if bc else ''}E/d/f={MOE_E}/{d}/{f} bf16: "
                f"kernel_ms={r['ms']:.4f} device_ms={r['device_ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} "
                f"library_ms={r['library_ms']:.4f} device "
                f"{r['library_device_ms']:.4f} (torch.bmm) "
                f"bound_ms={bound:.5f} ({by}); device/bound="
                f"{r['device_ms'] / bound:.2f}; C-tiles={plan.tiles} "
                f"stages={plan.stages} work tiles={plan.grid[0] * MOE_E}")
            if what == "up" and C == 6:
                res["moe_gmm"] = r
            del x, w
    return res


def _quant_rand(gen, shape, dtype):
    """int8 values and scales (in ``dtype``) of an N(0, 1) cache."""
    from repro_torch.models.attention import quantize_kv
    return quantize_kv(_rand(gen, shape, dtype))


def phase_parity_int8():
    """The four int8 entries against their plain versions at the parity
    shapes of the attention kernels; the paged ones also against the
    slab ones on the gathered rows.  Returns the worst error per entry."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_quant_plain, decode_attention_quant_plain,
        paged_gather)
    from repro_torch.kernels.prefill_attention import (
        prefill_attention_paged_quant_plain, prefill_attention_quant_plain)
    gen = torch.Generator(device="cuda").manual_seed(8)
    rng = np.random.default_rng(8)
    worst = dict.fromkeys(INT8_KERNELS + INT8_PAGED_KERNELS, 0.0)
    S, B = 8192, 6
    pmax, P = S // PAGE, B * (S // PAGE)

    def check(name, err, dtype, what):
        torch.cuda.synchronize()
        log(f"[parity_int8] {name} {what} max_abs_err={err:.3e}")
        assert err <= TOL[dtype], (name, what, err)
        worst[name] = max(worst[name], err)

    lens = [1, 37, 1000, 3500, 8000, 5000]
    for H, Hk, hd in PARITY_HEADS:
        for dtype in (torch.bfloat16, torch.float32):
            dt = f"{H}/{Hk}/{hd} {str(dtype)[6:]}"
            # slab: contiguous values and scales, then a strided view of
            # both (every other KV head of a wider buffer)
            wk, wks = _quant_rand(gen, (B, S, 2 * Hk, hd), dtype)
            wv, wvs = _quant_rand(gen, (B, S, 2 * Hk, hd), dtype)
            views = (("contig", [x[:, :, :Hk].contiguous()
                                 for x in (wk, wks, wv, wvs)]),
                     ("strided", [x[:, :, ::2] for x in (wk, wks, wv, wvs)]))
            for what, kv in views:
                q, L = _rand(gen, (B, 1, H, hd), dtype), _i32(lens)
                check("flash_decode_quant",
                      _max_err(ops.flash_decode_quant(q, *kv, L),
                               decode_attention_quant_plain(q, *kv, L)),
                      dtype, f"{dt} {what} lens={lens}")
                for Sq in PARITY_SQ:
                    for off in (0, 3000):
                        qo = _i32([off, off + 17, off // 2])
                        ln, si = qo + Sq, _i32([5, 0, 3])
                        qq = _rand(gen, (3, Sq, H, hd), dtype)
                        got = ops.flash_prefill_quant(qq, *kv, qo, ln,
                                                      slot_idx=si)
                        check("flash_prefill_quant", _max_err(
                            got, prefill_attention_quant_plain(
                                qq, *kv, qo, ln, slot_idx=si)),
                            dtype, f"{dt} {what} Sq={Sq} off={off}")
            del wk, wks, wv, wvs, views
            # paged: page 64, shuffled tables in which two rows share pages
            plens = [3500, 1000, 1, 37, 8000, 5000]
            ka, kas = _quant_rand(gen, (P + 1, PAGE, Hk, hd), dtype)
            va, vas = _quant_rand(gen, (P + 1, PAGE, Hk, hd), dtype)
            arenas = (ka, kas, va, vas)
            bt = shared_tables(rng, plens, pmax, P)
            lin = [paged_gather(a, bt) for a in arenas]
            q, L = _rand(gen, (B, 1, H, hd), dtype), _i32(plens)
            got = ops.flash_decode_paged_quant(q, *arenas, L, bt)
            check("flash_decode_paged_quant", _max_err(
                got, decode_attention_paged_quant_plain(q, *arenas, L, bt)),
                dtype, f"{dt} page={PAGE} lens={plens} vs_slab_kernel="
                f"{_max_err(got, ops.flash_decode_quant(q, *lin, L)):.3e}")
            rows = _i32([5, 0, 3])
            bt_m = bt[rows.long()].contiguous()
            for Sq in PARITY_SQ:
                for off in (0, 3000):
                    qo = _i32([off, off + 17, off // 2])
                    ln = qo + Sq
                    qq = _rand(gen, (3, Sq, H, hd), dtype)
                    got = ops.flash_prefill_paged_quant(qq, *arenas, qo, ln,
                                                        bt_m)
                    slab = ops.flash_prefill_quant(qq, *lin, qo, ln,
                                                   slot_idx=rows)
                    check("flash_prefill_paged_quant", _max_err(
                        got, prefill_attention_paged_quant_plain(
                            qq, *arenas, qo, ln, bt_m)),
                        dtype, f"{dt} page={PAGE} Sq={Sq} off={off} "
                        f"vs_slab_kernel={_max_err(got, slab):.3e}")
            del arenas, lin, ka, kas, va, vas
    return worst


def int8_bytes(keys: int, Hk: int, hd: int, es: int) -> int:
    """Bytes of ``keys`` int8 K and V rows with their two scales (in a
    type of ``es`` bytes) per KV head."""
    return 2 * keys * Hk * (hd + es)


def phase_timing_int8():
    """The int8 entries at the kernel table's shapes (bf16 model,
    Qwen2.5-3B heads, 6 slots of 8192 rows; paged: page 64, shuffled
    tables): the kernel (CUDA events; the prefill entries also their
    profiler device time and split count), its plain version and one SDPA
    call on K/V dequantised to bf16 beforehand (the dequantisation is not
    timed).  No single PyTorch call reads int8, so ``library_ms`` is None
    and the SDPA time is kept apart as ``sdpa_dequant_ms``.  The bound
    counts int8 values and scales read once, q read and the output
    written once, the index words, and the attention's flops plus one
    dequantising multiply per K and V element.  The prefill entries are
    also timed at the slice's 4 x 64 resume batch."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_quant_cuda, decode_attention_paged_quant_plain,
        decode_attention_quant_cuda, decode_attention_quant_plain,
        paged_gather)
    from repro_torch.kernels.prefill_attention import (
        _dense_splits, prefill_attention_paged_quant_plain,
        prefill_attention_quant_plain)
    gen = torch.Generator(device="cuda").manual_seed(9)
    rng = np.random.default_rng(9)
    dtype, es = torch.bfloat16, 2
    H, Hk, hd, S, B = 16, 2, 128, 8192, 6
    G = H // Hk
    pmax, P = S // PAGE, B * (S // PAGE)
    deq = lambda x, s: (x.float() * s.float()).to(dtype)

    def sdpa_ms(qx, kx, vx, m):
        return _time_ms(lambda: F.scaled_dot_product_attention(
            qx, kx, vx, attn_mask=m, enable_gqa=True))

    def prefill_timing(fn, plain, qx, cap):
        """Events, device time and split count of a prefill entry."""
        return dict(ms=_time_ms(fn), device_ms=_device_ms(fn),
                    plain_ms=_time_ms(plain),
                    splits=_dense_splits(qx, Hk, cap))
    res = {}
    lens = [1, 37, 1000, 3500, 8000, 5000]
    n_keys, Lmax = sum(lens), max(lens)
    q, L = _rand(gen, (B, 1, H, hd), dtype), _i32(lens)
    mask = (torch.arange(Lmax, device="cuda")[None, :]
            < L[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    dec_flops = 4 * n_keys * H * hd + 2 * n_keys * Hk * hd
    dec_bytes = int8_bytes(n_keys, Hk, hd, es) + 2 * B * H * hd * es + 4 * B
    Sq, off = 160, 3000
    Lk = off + Sq
    pairs = sum(off + i + 1 for i in range(Sq))
    pre_flops = 4 * pairs * H * hd + 2 * Lk * Hk * hd
    pre_bytes = int8_bytes(Lk, Hk, hd, es) + 2 * Sq * H * hd * es + 12
    qq = _rand(gen, (1, Sq, H, hd), dtype)
    qo, ln = _i32([off]), _i32([off + Sq])
    q_pos = off + torch.arange(Sq, device="cuda")
    pmask = (torch.arange(Lk, device="cuda")[None, :]
             <= q_pos[:, None])[None, None]
    qqt = qq.transpose(1, 2)
    # the slice's resume batch: 4 rows of 64 tokens deep in context
    qr = _rand(gen, (4, 64, H, hd), dtype)
    qro, lro = _i32(RESUME_OFFS), _i32([o + 64 for o in RESUME_OFFS])
    keys_r = sum(o + 64 for o in RESUME_OFFS)
    res_flops = (4 * sum(o + i + 1 for o in RESUME_OFFS for i in range(64))
                 * H * hd + 2 * keys_r * Hk * hd)
    res_bytes = int8_bytes(keys_r, Hk, hd, es) + 2 * 4 * 64 * H * hd * es

    # slab
    kq, ks = _quant_rand(gen, (B, S, Hk, hd), dtype)
    vq, vs = _quant_rand(gen, (B, S, Hk, hd), dtype)
    kv = (kq, ks, vq, vs)
    kt = deq(kq[:, :Lmax], ks[:, :Lmax]).transpose(1, 2)
    vt = deq(vq[:, :Lmax], vs[:, :Lmax]).transpose(1, 2)
    bound, by = _bound_ms(dec_flops, dec_bytes, dtype)
    res["flash_decode_quant"] = dict(
        ms=_time_ms(lambda: ops.flash_decode_quant(q, *kv, L)),
        plain_ms=_time_ms(lambda: decode_attention_quant_plain(q, *kv, L)),
        library_ms=None, sdpa_dequant_ms=sdpa_ms(qt, kt, vt, mask),
        bound_ms=bound, bound_by=by,
        shape=f"B={B} H/Hk/hd={H}/{Hk}/{hd} lens={lens} int8 K/V, bf16",
        **decode_split_info(lambda c: lambda: decode_attention_quant_cuda(
            q, *kv, L, chunk=c), S, lens, Hk, G))
    si = _i32([2])
    kt = deq(kq[2:3, :Lk], ks[2:3, :Lk]).transpose(1, 2)
    vt = deq(vq[2:3, :Lk], vs[2:3, :Lk]).transpose(1, 2)
    bound, by = _bound_ms(pre_flops, pre_bytes, dtype)
    res["flash_prefill_quant"] = dict(
        **prefill_timing(
            lambda: ops.flash_prefill_quant(qq, *kv, qo, ln, slot_idx=si),
            lambda: prefill_attention_quant_plain(qq, *kv, qo, ln,
                                                  slot_idx=si), qq, S),
        library_ms=None, sdpa_dequant_ms=sdpa_ms(qqt, kt, vt, pmask),
        bound_ms=bound, bound_by=by,
        shape=f"M=1 Sq={Sq} offset={off} H/Hk/hd={H}/{Hk}/{hd} G={G} "
              f"int8 K/V, bf16")
    sir = _i32([0, 1, 2, 3])
    bound, by = _bound_ms(res_flops, res_bytes + 12 * 4, dtype)
    res["flash_prefill_quant@resume"] = dict(
        **prefill_timing(
            lambda: ops.flash_prefill_quant(qr, *kv, qro, lro, slot_idx=sir),
            lambda: prefill_attention_quant_plain(qr, *kv, qro, lro,
                                                  slot_idx=sir), qr, S),
        library_ms=None,
        sdpa_dequant_ms=_time_ms(resume_sdpa(qr, deq(kq[:4], ks[:4]),
                                             deq(vq[:4], vs[:4]))),
        bound_ms=bound, bound_by=by,
        shape=f"resume M=4 Sq=64 offsets={RESUME_OFFS} H/Hk/hd={H}/{Hk}/"
              f"{hd} G={G} int8 K/V, bf16")
    del kv, kq, ks, vq, vs, kt, vt

    # paged: every row maps its pages from a shuffled arena
    arenas = [*_quant_rand(gen, (P + 1, PAGE, Hk, hd), dtype),
              *_quant_rand(gen, (P + 1, PAGE, Hk, hd), dtype)]
    bt = shared_tables(rng, [S] * B, pmax, P)
    lin = [paged_gather(a, bt) for a in arenas]
    kt = deq(lin[0][:, :Lmax], lin[1][:, :Lmax]).transpose(1, 2)
    vt = deq(lin[2][:, :Lmax], lin[3][:, :Lmax]).transpose(1, 2)
    pages = sum(-(-n // PAGE) for n in lens)
    bound, by = _bound_ms(dec_flops, dec_bytes + 4 * pages, dtype)
    res["flash_decode_paged_quant"] = dict(
        ms=_time_ms(lambda: ops.flash_decode_paged_quant(q, *arenas, L, bt)),
        plain_ms=_time_ms(lambda: decode_attention_paged_quant_plain(
            q, *arenas, L, bt)),
        library_ms=None, sdpa_dequant_ms=sdpa_ms(qt, kt, vt, mask),
        bound_ms=bound, bound_by=by,
        shape=f"B={B} H/Hk/hd={H}/{Hk}/{hd} lens={lens} page={PAGE} "
              f"int8 K/V, bf16",
        **decode_split_info(
            lambda c: lambda: decode_attention_paged_quant_cuda(
                q, *arenas, L, bt, chunk=c), pmax * PAGE, lens, Hk, G))
    bt_1 = bt[2:3].contiguous()
    kt = deq(lin[0][2:3, :Lk], lin[1][2:3, :Lk]).transpose(1, 2)
    vt = deq(lin[2][2:3, :Lk], lin[3][2:3, :Lk]).transpose(1, 2)
    bound, by = _bound_ms(pre_flops, pre_bytes + 4 * -(-Lk // PAGE), dtype)
    res["flash_prefill_paged_quant"] = dict(
        **prefill_timing(
            lambda: ops.flash_prefill_paged_quant(qq, *arenas, qo, ln, bt_1),
            lambda: prefill_attention_paged_quant_plain(
                qq, *arenas, qo, ln, bt_1), qq, pmax * PAGE),
        library_ms=None, sdpa_dequant_ms=sdpa_ms(qqt, kt, vt, pmask),
        bound_ms=bound, bound_by=by,
        shape=f"M=1 Sq={Sq} offset={off} H/Hk/hd={H}/{Hk}/{hd} G={G} "
              f"page={PAGE} int8 K/V, bf16")
    bt_4 = bt[:4].contiguous()
    bound, by = _bound_ms(
        res_flops, res_bytes + 8 * 4 + 4 * sum(-(-(o + 64) // PAGE)
                                               for o in RESUME_OFFS), dtype)
    res["flash_prefill_paged_quant@resume"] = dict(
        **prefill_timing(
            lambda: ops.flash_prefill_paged_quant(qr, *arenas, qro, lro,
                                                  bt_4),
            lambda: prefill_attention_paged_quant_plain(
                qr, *arenas, qro, lro, bt_4), qr, pmax * PAGE),
        library_ms=None,
        sdpa_dequant_ms=_time_ms(resume_sdpa(
            qr, deq(lin[0][:4], lin[1][:4]), deq(lin[2][:4], lin[3][:4]))),
        bound_ms=bound, bound_by=by,
        shape=f"resume M=4 Sq=64 offsets={RESUME_OFFS} H/Hk/hd={H}/{Hk}/"
              f"{hd} G={G} page={PAGE} int8 K/V, bf16")
    for name, r in res.items():
        dev = (f" device_ms={r['device_ms']:.4f} splits={r['splits']}"
               if "splits" in r else "")
        log(f"[timing_int8] {name} {r['shape']}: kernel_ms={r['ms']:.4f}"
            f"{dev} plain_ms={r['plain_ms']:.4f} library_ms=none (no single "
            f"PyTorch call reads int8) sdpa_on_dequantised_kv_ms="
            f"{r['sdpa_dequant_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
        if "chunks" in r:
            _log_split("timing_int8", name, r)
    return res


def free_device_memory() -> None:
    """Release what a finished phase dropped.  An engine holds reference
    cycles (its telemetry gauges call back into it), so after ``del`` its
    cache and weights stay allocated until the cyclic collector runs:
    collect, then empty the cache so the next phase's peak memory is its
    own."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_identity(paged: bool, arch: str = "qwen2.5-3b", spec_k: int = 0):
    """f32 engine streams == the isolated greedy oracle (the engine's
    default ``moe_mode`` "dense", which keeps lanes independent).
    ``spec_k``: the engine decodes by draft-and-verify (identity_spec);
    its spec steps must be > 0, and its launch counts are logged.  A
    second leg then serves agents whose prompts drive the random model's
    greedy stream into a repeating attractor (``attractor_tokens``), so
    drafts are accepted (> 0) and rolled back, streams equal to the
    oracle."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.oracle import oracle_streams
    from repro_torch.serving.workload import make_workload
    torch.backends.cuda.matmul.allow_tf32 = False       # full f32 products
    tag = ("identity_moe" if arch == "olmoe-1b-7b" else
           "identity_spec" if spec_k else "identity") + (
        "_paged" if paged else "")
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=4,
                              kv_layout="paged" if paged else "slab",
                              kv_page_size=PAGE)
    log(f"[{tag}] {cfg.name} full width, depth cut to "
        f"{cfg.num_layers} of {full.num_layers} layers, float32, "
        f"{cfg.kv_layout} layout")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32)
    kw = dict(num_slots=5, max_seq=2048)
    ecfg = EngineConfig(cycle_budget=160, granularity=16,
                        control_interval_s=0.1, autotune_chunks=False,
                        record_events=True, moe_mode="dense", spec_k=spec_k,
                        **kw)

    def serve(mk):
        """Run the engine on ``mk()``'s sessions; every stream must equal
        the oracle's.  Returns (engine, report, streams, launches)."""
        eng = ServingEngine(cfg, params, "agentserve", ecfg,
                            dtype=torch.float32, device="cuda")
        sessions = mk()
        ops.reset_launches()
        rep = eng.run(sessions)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        streams = {}
        for ev in eng.event_log:
            streams.setdefault(ev.session_id, []).append(ev.token)
        oracle = oracle_streams(cfg, params, mk(), dtype=torch.float32,
                                device="cuda", **kw)
        for s in sessions:
            want = sum(t.decode_len for t in s.turns)
            assert s.output_tokens() == want, (s.session_id,
                                               s.output_tokens())
            got = streams[s.session_id]
            if got != oracle[s.session_id]:
                step, m = first_divergence_margin(cfg, params, s, got, kw)
                raise AssertionError(
                    f"{tag}: session {s.session_id} leaves the oracle at "
                    f"step {step}; the oracle's top-2 logit margin there is "
                    f"{m:.3e}")
        return eng, rep, streams, launches

    # paged: seed 9's second agent cuts the system prompt shorter than the
    # first (a radix hit inside a registered prefix), its third longer (a
    # partial hit)
    eng, rep, streams, launches = serve(lambda: make_workload(
        3, workload="react", vocab_size=cfg.vocab_size, token_scale=0.25,
        seed=9 if paged else 3))
    extra = ""
    if paged:
        st = eng.pool.stats
        extra = (f" | prefix_hits={st['prefix_hits']} "
                 f"partial_hits={st['prefix_partial_hits']} "
                 f"page_copies={st['page_copies']}")
    if spec_k:
        assert eng.hotpath_stats["spec_steps"] > 0, (tag, "no spec step")
        extra += f" | {spec_line(eng)} | launches={launches}"
    log(f"[{tag}] {len(streams)} sessions, "
        f"{sum(len(v) for v in streams.values())} tokens equal the "
        f"isolated greedy oracle | {rep.row()}{extra}")
    if spec_k:
        toks = attractor_tokens(cfg, params, 3)
        eng, rep, streams, _ = serve(
            lambda: repetition_sessions(toks))
        hs = eng.hotpath_stats
        assert hs["spec_accepted"] > 0, (tag, "no draft accepted", toks)
        assert hs["spec_accepted"] < hs["spec_proposed"], (tag, "no rollback")
        log(f"[{tag}] repetition leg (constant prompts of tokens {toks}): "
            f"{sum(len(v) for v in streams.values())} tokens equal the "
            f"isolated greedy oracle | {rep.row()} | {spec_line(eng)}")
    del eng, params
    free_device_memory()


def attractor_tokens(cfg, params, n: int):
    """Prompt tokens whose constant runs drive a random model's greedy
    stream into a repeating attractor: greedy decode from 32 constant
    64-token prompts in one batch, and the ``n`` prompt tokens whose
    streams most often repeat a token three times running."""
    from repro_torch.models import forward_decode, forward_prefill, init_cache
    cfg = dataclasses.replace(cfg, kv_layout="slab")
    cands = np.linspace(0, cfg.vocab_size - 1, 32).astype(np.int32)
    B, plen, steps = len(cands), 64, 32
    dtype = params["final_norm"].dtype
    cache = init_cache(cfg, B, 128, dtype, "cuda")
    prompts = torch.tensor(np.repeat(cands[:, None], plen, 1), device="cuda")
    lengths = torch.zeros(B, dtype=torch.int32, device="cuda")
    logits, cache, lengths = forward_prefill(params, cfg, prompts, cache,
                                             lengths)
    out = []
    for _ in range(steps):
        toks = logits.argmax(-1).to(torch.int32)
        out.append(toks)
        logits, cache, lengths = forward_decode(params, cfg, toks, cache,
                                                lengths)
    S = torch.stack(out, 1).cpu().numpy()
    runs = ((S[:, 2:] == S[:, 1:-1]) & (S[:, 1:-1] == S[:, :-2])).mean(1)
    return [int(cands[i]) for i in np.argsort(-runs, kind="stable")[:n]]


def repetition_sessions(tokens, first_id: int = 0):
    """One agent per token: a 64-token prompt of that token, a 40-token
    burst, then a 16-token resume of it and another burst.  Session ids
    count from ``first_id``."""
    from repro_torch.serving.request import AgentTurn, Session
    return [Session(session_id=first_id + i, turns=[
        AgentTurn(np.full(64, t, np.int32), 40, 0.05),
        AgentTurn(np.full(16, t, np.int32), 40, 0.0)])
        for i, t in enumerate(tokens)]


def spec_line(eng) -> str:
    """The engine's speculative-decode counters, one log fragment."""
    hs = eng.hotpath_stats
    return (f"spec_steps={hs['spec_steps']} "
            f"spec_proposed={hs['spec_proposed']} "
            f"spec_accepted={hs['spec_accepted']} "
            f"spec_acceptance_rate={eng.stats()['spec_acceptance_rate']:.4f} "
            f"tokens_per_model_call={eng.tokens_per_model_call():.4f}")


def phase_identity_spec_hybrid():
    """Spec-on engine streams == spec-off (f32, the small hybrid, slab,
    fixed-chunk ``chunked`` policy): a hybrid's stream is
    schedule-independent only up to its SSD chunk boundaries, so the
    reference is the same engine without speculation.  Then one step,
    called directly on the engine's cache, shows the fenced re-run:
    kernel 7 launches twice per Mamba-2 layer (the verify, then the
    re-run at the accepted length) and kernel 1 twice per attention
    layer."""
    from repro_torch.kernels import ops
    from repro_torch.models import forward_spec_step, init_params
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.workload import make_workload
    torch.backends.cuda.matmul.allow_tf32 = False       # full f32 products
    tag = "identity_spec_hybrid"
    cfg = hybrid_config()
    log(f"[{tag}] {cfg.name}: d_model {cfg.d_model}, {cfg.num_layers} "
        f"layers (attention + Mamba-2), float32, slab, chunked, "
        f"spec_k={SPEC_K}")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32)
    kw = dict(num_slots=5, max_seq=2048)

    def run(spec_k):
        ecfg = EngineConfig(cycle_budget=160, granularity=16,
                            control_interval_s=0.1, autotune_chunks=False,
                            record_events=True, spec_k=spec_k, **kw)
        eng = ServingEngine(cfg, params, "chunked", ecfg,
                            dtype=torch.float32, device="cuda")
        sessions = make_workload(3, workload="react",
                                 vocab_size=cfg.vocab_size, token_scale=0.25,
                                 seed=3)
        rep = eng.run(sessions)
        streams = {}
        for ev in eng.event_log:
            streams.setdefault(ev.session_id, []).append(ev.token)
        for s in sessions:
            want = sum(t.decode_len for t in s.turns)
            assert s.output_tokens() == want, (tag, spec_k, s.session_id)
        return eng, streams, rep

    _, off, _ = run(0)
    eng, on, rep = run(SPEC_K)
    for sid, want in off.items():
        got = on[sid]
        if got != want:
            step = next((i for i, (a, b) in enumerate(zip(got, want))
                         if a != b), min(len(got), len(want)))
            raise AssertionError(f"{tag}: session {sid}'s spec-on stream "
                                 f"leaves the spec-off stream at step {step}")
    assert eng.hotpath_stats["spec_steps"] > 0, (tag, "no spec step")
    B = kw["num_slots"]
    n_ssm = sum(cfg.layer_kind(j) == "ssm" for j in range(cfg.num_layers))
    lanes = torch.ones(B, dtype=torch.bool, device="cuda")
    ops.reset_launches()
    forward_spec_step(params, cfg,
                      torch.zeros((B, kw["max_seq"]), dtype=torch.int32,
                                  device="cuda"),
                      _i32([0] * B), eng.pool.cache, _i32([100] * B), lanes,
                      num_draft=SPEC_K)
    torch.cuda.synchronize()
    one = dict(ops.LAUNCHES)
    assert one["ssd_scan"] == 2 * n_ssm, one
    assert one["flash_prefill"] == 2 * (cfg.num_layers - n_ssm), one
    log(f"[{tag}] spec-on == spec-off for {len(off)} sessions, "
        f"{sum(len(v) for v in off.values())} tokens | {rep.row()} | "
        f"{spec_line(eng)} | one step: ssd_scan x{one['ssd_scan']}, "
        f"flash_prefill x{one['flash_prefill']} (verify + fenced re-run)")
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
    ex = get_executables(cfg, "dense")
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


def phase_slice(paged: bool, arch: str = "qwen2.5-3b", spec_k: int = 0):
    """``spec_k``: the launcher's ``--spec-k`` (slice_spec); the engine's
    spec steps must be > 0, and its counters are logged."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ssm, moe = arch == "mamba2-780m", arch == "olmoe-1b-7b"
    tag = ("slice_ssm" if ssm else "slice_moe" if moe else
           "slice_spec" if spec_k else "slice") + ("_paged" if paged else "")
    layout = (["--kv-layout", "paged", "--kv-page-size", str(PAGE)]
              if paged else [])
    if spec_k:
        layout += ["--spec-k", str(spec_k)]
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
    attn = PAGED_KERNELS if paged else SLAB_KERNELS
    own = SSM_KERNELS if ssm else attn + (MOE_KERNELS if moe else ())
    for name in SOURCES:
        if name in own:
            assert launches[name] > 0, f"{name} was never launched on the path"
        else:
            assert launches[name] == 0, f"{name} was launched on the {tag} path"
    if moe:
        # every OLMoE layer is attention + MoE: one attention launch and
        # three expert products (up, gate, down) per layer per forward
        L = eng.mcfg.num_layers
        forwards, rest = divmod(sum(launches[k] for k in attn), L)
        assert rest == 0 and launches["moe_gmm"] == 3 * L * forwards, \
            (launches, L)
        log(f"[{tag}] forwards={forwards}: moe_gmm launches "
            f"{launches['moe_gmm']} = {3 * L} per forward")
    toks = sum(s.output_tokens() for s in sessions)
    prompt = sum(len(t.prefill_tokens) for s in sessions for t in s.turns)
    log(f"[{tag}] {serve.ServingReport.HEADER}")
    log(f"[{tag}] {rep.row()}")
    if spec_k:
        assert eng.hotpath_stats["spec_steps"] > 0, (tag, "no spec step")
        log(f"[{tag}] {spec_line(eng)} "
            f"megasteps={eng.hotpath_stats['megasteps']} "
            f"fused_steps={eng.hotpath_stats['fused_steps']}")
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


def phase_profile(eng, paged: bool, tag: str = "profile",
                  moe_mode: str = "dense"):
    """Where a slice step's time goes: the slice engine's own forwards,
    timed with the host clock around a synchronize and traced with
    torch.profiler over the device alone (time by kernel, busy share).
    Paged: every slot maps its own pages, in order.  ``moe_mode``: the
    MoE FFN path of the forwards (the engine's is "dense")."""
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
    one["moe_mode"] = moe_mode
    profile_work(tag, forward_work(cfg, params, cache, B, bt, one, moe_mode))


def forward_work(cfg, params, cache, B: int, bt, one, moe_mode: str):
    """The profiled forwards over a serving cache of ``B`` slots (``bt``:
    the paged layout's tables; ``one``: how the cold chunk names its
    slot): a K=8 decode megastep over every lane at 3500 rows, a 160-token
    cold chunk at offset 3000, a 4 x 64 resume batch."""
    from repro_torch.models import (forward_decode_megastep,
                                    forward_prefill, forward_resume_batch)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    return {
        f"decode megastep K=8, {B} lanes at 3500 rows": lambda: (
            forward_decode_megastep(params, cfg, i32([0] * B), cache,
                                    i32([3500] * B),
                                    torch.ones(B, dtype=torch.bool,
                                               device="cuda"), num_steps=8,
                                    block_tables=bt, moe_mode=moe_mode)),
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
                                 i32([63] * 4), block_tables=bt,
                                 moe_mode=moe_mode)),
    }


def phase_slice_spec_repetition(eng):
    """slice_spec's engine (bf16, full width and depth, slab) serves
    three more agents whose constant prompts (``attractor_tokens`` of
    this model) drive its greedy stream into an attractor: drafts must be
    accepted (> 0) and rolled back (accepted < proposed), every session
    must finish with all its tokens, and only the slab kernels run.  The
    session ids follow the slice's, so no acceptance EMA carries over."""
    from repro_torch.kernels import ops
    tag = "slice_spec_repetition"
    toks = attractor_tokens(eng.mcfg, eng.params, 3)
    sessions = repetition_sessions(toks, first_id=1000)
    before = {k: eng.hotpath_stats[k]
              for k in ("spec_steps", "spec_proposed", "spec_accepted")}
    h = eng._h_tpmc                  # tokens per model call, engine-wide
    calls0, sum0 = h.total, h.sum
    ops.reset_launches()
    rep = eng.run(sessions)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    for s in sessions:
        want = sum(t.decode_len for t in s.turns)
        assert s.output_tokens() == want, (tag, s.session_id,
                                           s.output_tokens(), want)
    d = {k: eng.hotpath_stats[k] - v for k, v in before.items()}
    assert d["spec_steps"] > 0, (tag, "no spec step", d)
    assert d["spec_accepted"] > 0, (tag, "no draft accepted", toks, d)
    assert d["spec_accepted"] < d["spec_proposed"], (tag, "no rollback", d)
    assert set(launches) <= set(SLAB_KERNELS), (tag, launches)
    assert launches.get("flash_prefill", 0) > 0, (tag, launches)
    emitted = sum(s.output_tokens() for s in sessions)
    tpmc = (h.sum - sum0) / (h.total - calls0)
    log(f"[{tag}] constant prompts of tokens {toks}: "
        f"{len(sessions)} sessions, {emitted} tokens | {rep.row()} "
        f"(its last column counts the slice too) | "
        f"spec_steps={d['spec_steps']} spec_proposed={d['spec_proposed']} "
        f"spec_accepted={d['spec_accepted']} "
        f"spec_acceptance_rate={d['spec_accepted'] / d['spec_proposed']:.4f}"
        f" tokens_per_model_call={tpmc:.4f} | launches={launches}")


def phase_profile_spec(eng):
    """One draft-and-verify step at K = 4 over the slice_spec engine's 6
    lanes at 3500 rows, beside the K=8 megastep the plain path runs
    there: wall, device time and top kernels.  A direct call first shows
    that the verify runs kernel 1 once per layer and no decode kernel."""
    from repro_torch.kernels import ops
    from repro_torch.models import forward_spec_step
    cfg, params, cache = eng.mcfg, eng.params, eng.pool.cache
    B = eng.ecfg.num_slots
    hist = torch.zeros((B, eng.ecfg.max_seq), dtype=torch.int32,
                       device="cuda")
    lanes = torch.ones(B, dtype=torch.bool, device="cuda")
    spec = lambda: forward_spec_step(params, cfg, hist, _i32([0] * B), cache,
                                     _i32([3500] * B), lanes,
                                     num_draft=SPEC_K)
    ops.reset_launches()
    spec()
    torch.cuda.synchronize()
    one = {k: v for k, v in ops.LAUNCHES.items() if v}
    assert one == {"flash_prefill": cfg.num_layers}, one
    work = {f"spec step K={SPEC_K}, {B} lanes at 3500 rows": spec}
    mega = forward_work(cfg, params, cache, B, None, {}, "dense")
    work.update((k, v) for k, v in mega.items() if "megastep" in k)
    profile_work("profile_spec", work)


def phase_forward_testbed():
    """The paper's dense testbed models at full width and depth in bf16,
    random weights: one 160-token cold chunk at offset 3000 and one K=8
    decode megastep over 6 lanes of 8192 rows (wall, device time, top
    kernels, peak memory); the chunk's logits must be finite."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import forward_prefill, init_cache, init_params
    B = 6
    for arch in ("qwen2.5-7b", "llama3-8b"):
        cfg = get_config(arch)
        tag = f"forward_testbed {arch}"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             torch.bfloat16)
        cache = init_cache(cfg, B, 8192, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        nbytes = lambda tree: sum(
            nbytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
            for v in tree.values())
        log(f"[{tag}] {cfg.num_layers} layers, d_model {cfg.d_model}, heads "
            f"{cfg.num_heads}/{cfg.num_kv_heads}/{cfg.head_dim}, bf16: "
            f"weights {nbytes(params) / 1e9:.2f} GB, cache {B} x 8192 rows "
            f"{nbytes(cache) / 1e9:.2f} GB, made in "
            f"{time.perf_counter() - t0:.1f} s")
        logits, _, _ = forward_prefill(
            params, cfg, torch.zeros((1, 160), dtype=torch.int32,
                                     device="cuda"), cache, _i32([3000]),
            slot_idx=_i32([0]))
        assert torch.isfinite(logits.float()).all(), (tag, "logits")
        work = forward_work(cfg, params, cache, B, None,
                            {"slot_idx": _i32([0])}, "dense")
        profile_work(tag, {k: v for k, v in work.items()
                           if "resume" not in k})
        log(f"[{tag}] max_memory_allocated_GB="
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        del params, cache, logits, work
        free_device_memory()


def profile_work(tag: str, work) -> None:
    """For each named callable: one warm call, one call timed with the
    host clock around a synchronize, and one traced with torch.profiler
    over the device alone (device time by kernel, busy share)."""
    from torch.profiler import ProfilerActivity, profile
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


def _on(tree, device):
    """A copy of a weight tree on ``device``."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def greedy_drive(cfg, params, sessions, *, device, dtype, kv_quant: bool,
                 max_seq: int, chunk: int = 160, steps: int = 8,
                 seed: int = 0):
    """Serve ``sessions`` greedily through the model-level forwards, one
    cache lane each (the int8 cache has no engine path, as in the JAX
    package).  Turn 0: each lane's cold prompt in ``chunk``-token
    ``forward_prefill`` calls; later turns: one ``forward_resume_batch``
    over the lanes that have the turn (rows padded to the longest, logits
    at each row's last real token).  Then ``forward_decode_megastep`` of
    ``steps`` (fewer only to end the shortest burst) over the lanes still
    decoding, the others inactive.  As in the port's oracle, a turn's
    last token is not fed back.  Paged: each lane maps its own pages from
    a shuffled arena (``seed``).  Returns (streams [lane][tokens], the
    logits of every prefill and resume call (CPU, f32), stats)."""
    from repro_torch.models import (forward_decode_megastep, forward_prefill,
                                    forward_resume_batch, init_cache)
    B = len(sessions)
    cache = init_cache(cfg, B, max_seq, dtype, device, kv_quant=kv_quant)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    bt = None
    if cfg.kv_layout == "paged":
        pmax = max_seq // cfg.kv_page_size
        perm = np.random.default_rng(seed).permutation(B * pmax)
        bt = torch.tensor(perm.reshape(B, pmax).astype(np.int32),
                          device=device)
    lengths = [0] * B
    streams = [[] for _ in range(B)]
    logits_log, chunk_s, mega_s = [], [], []
    t0 = time.perf_counter()
    for ti in range(max(len(s.turns) for s in sessions)):
        lanes = [b for b, s in enumerate(sessions) if ti < len(s.turns)]
        prompts = [np.asarray(sessions[b].turns[ti].prefill_tokens, np.int32)
                   for b in lanes]
        if ti == 0:
            last = []
            for b, toks in zip(lanes, prompts):
                kw = ({"block_tables": bt[b:b + 1]} if bt is not None
                      else {"slot_idx": i32([b])})
                for c0 in range(0, len(toks), chunk):
                    piece = torch.tensor(toks[None, c0:c0 + chunk],
                                         device=device)
                    sync()
                    tc = time.perf_counter()
                    logits, cache, _ = forward_prefill(
                        params, cfg, piece, cache, i32([lengths[b]]), **kw)
                    sync()
                    chunk_s.append(time.perf_counter() - tc)
                    lengths[b] += piece.shape[1]
                last.append(logits[0])
            logits = torch.stack(last)
        else:
            toks = np.zeros((len(lanes), max(map(len, prompts))), np.int32)
            for r, x in enumerate(prompts):
                toks[r, :len(x)] = x
            logits, cache = forward_resume_batch(
                params, cfg, torch.tensor(toks, device=device), cache,
                i32(lanes), i32([lengths[b] for b in lanes]),
                i32([len(x) - 1 for x in prompts]), block_tables=bt)
            for b, x in zip(lanes, prompts):
                lengths[b] += len(x)
        logits_log.append(logits.float().cpu())
        cur, remaining = [0] * B, [0] * B
        for b, tok in zip(lanes, logits.float().argmax(-1).tolist()):
            streams[b].append(tok)
            cur[b] = tok
            remaining[b] = sessions[b].turns[ti].decode_len - 1
        cur_t, len_t = i32(cur), i32(lengths)
        while any(remaining):
            active = [r > 0 for r in remaining]
            K = min(steps, min(r for r in remaining if r > 0))
            tm = time.perf_counter()
            seq, cur_t, cache, len_t = forward_decode_megastep(
                params, cfg, cur_t, cache, len_t,
                torch.tensor(active, device=device), num_steps=K,
                block_tables=bt)
            seq = seq.tolist()                      # waits for the device
            if K == steps:
                mega_s.append(time.perf_counter() - tm)
            for b in range(B):
                if active[b]:
                    streams[b].extend(seq[i][b] for i in range(K))
                    remaining[b] -= K
                    lengths[b] += K
    sync()
    stats = dict(wall_s=time.perf_counter() - t0, chunk_s=chunk_s,
                 megastep_s=mega_s, cache=cache, block_tables=bt)
    for s, got in zip(sessions, streams):
        want = sum(t.decode_len for t in s.turns)
        assert len(got) == want, (s.session_id, len(got), want)
    return streams, logits_log, stats


def _assert_int8_launches(launches, paged: bool, tag: str) -> None:
    own = INT8_PAGED_KERNELS if paged else INT8_KERNELS
    for name in SOURCES:
        if name in own:
            assert launches[name] > 0, f"{tag}: {name} was never launched"
        else:
            assert launches[name] == 0, f"{tag}: {name} was launched"


class QuantLedger:
    """Lock-step check of the int8 quantiser across two devices.

    ``quantize_kv`` rounds ``x / s`` to the nearest integer, so a
    one-ulp difference upstream (cuBLAS against the CPU's matmuls) can
    round a value near a half-integer the other way.  One such flip moves
    a key or value by a whole quantisation step, and at the first
    positions of a prompt (few keys) the change reaches the next layer's
    K/V and flips more: two devices that quantise independently do not
    keep logits within 1e-3.  So the card run records every call of the
    model's quantiser (``record``), and the CPU run (``adopt``) checks
    its own result against the card's record of the same call: scales
    within 3e-5 relative, pre-rounding values ``x / s`` within 1e-2 of a
    step, so the int8 values differ by at most one where ``x / s``
    straddles a half-integer (counted as flips), and no flip where the
    two pre-rounding values are equal (that would be another rounding
    rule).  It then continues from the card's values, so the two runs
    read equal caches and every other difference shows in the logits."""

    def __init__(self):
        self.calls, self.values, self.flips = [], 0, 0
        self.max_dr = self.max_ds = 0.0

    @contextlib.contextmanager
    def patched(self, make):
        from repro_torch.models import blocks
        real = blocks.quantize_kv
        blocks.quantize_kv = make(real)
        try:
            yield
        finally:
            blocks.quantize_kv = real

    def record(self, real):
        def quantize(x):
            q, sc = real(x)
            self.calls.append((q.cpu(), sc.cpu(),
                               (x.float() / sc.float()).cpu()))
            return q, sc
        return quantize

    def adopt(self, real):
        calls = iter(self.calls)

        def quantize(x):
            q, sc = real(x)
            q_card, s_card, r_card = next(calls)
            assert q.shape == q_card.shape, (q.shape, q_card.shape)
            r = x.float() / sc.float()
            dr = (r - r_card).abs().max().item()
            ds = ((sc.float() - s_card).abs() / s_card.abs()).max().item()
            assert dr <= 1e-2 and ds <= 3e-5, (dr, ds)
            flip = q != q_card
            assert not (flip & (r == r_card)).any(), "a flip at equal x / s"
            self.values += q.numel()
            self.flips += int(flip.sum())
            self.max_dr, self.max_ds = max(self.max_dr, dr), max(self.max_ds,
                                                                  ds)
            return q_card.to(x.device), s_card.to(x.device)
        return quantize


def phase_identity_int8(paged: bool):
    """float32 Qwen2.5-3B widths cut to 4 layers over an int8 cache: the
    greedy loop on the card (the int8 kernels) and on the CPU (their
    plain versions), from the same weights, in lock-step through
    ``QuantLedger``: equal tokens, and the logits of every prefill and
    resume call within 1e-3.  On the slab layout the CPU also runs once
    quantising on its own, and the line shows where that run leaves the
    card's (printed, not asserted)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving.workload import make_workload
    torch.backends.cuda.matmul.allow_tf32 = False       # full f32 products
    tag = "identity_int8" + ("_paged" if paged else "")
    full = get_config("qwen2.5-3b")
    cfg = dataclasses.replace(full, num_layers=4,
                              kv_layout="paged" if paged else "slab",
                              kv_page_size=PAGE)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32)
    cpu_params = _on(params, "cpu")
    sessions = make_workload(3, workload="react", vocab_size=cfg.vocab_size,
                             token_scale=0.25, seed=3)
    kw = dict(dtype=torch.float32, kv_quant=True, max_seq=2048)
    ledger = QuantLedger()
    ops.reset_launches()
    with ledger.patched(ledger.record):
        card, card_logits, st = greedy_drive(cfg, params, sessions,
                                             device="cuda", **kw)
    launches = dict(ops.LAUNCHES)
    _assert_int8_launches(launches, paged, tag)
    own = INT8_PAGED_KERNELS if paged else INT8_KERNELS
    t0 = time.perf_counter()
    with ledger.patched(ledger.adopt):
        cpu, cpu_logits, _ = greedy_drive(cfg, cpu_params, sessions,
                                          device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    err = max(_max_err(a, b) for a, b in zip(card_logits, cpu_logits))
    log(f"[{tag}] {cfg.name} full width, {cfg.num_layers} of "
        f"{full.num_layers} layers, float32, int8 {cfg.kv_layout} cache: "
        f"{len(sessions)} sessions, {sum(map(len, card))} tokens; card "
        f"{st['wall_s']:.1f} s, cpu {cpu_s:.1f} s | quantiser: "
        f"{len(ledger.calls)} calls, {ledger.values} values, "
        f"{ledger.flips} rounding flips, max |x/s card - cpu|="
        f"{ledger.max_dr:.2e} (limit 1e-2), max scale rel diff="
        f"{ledger.max_ds:.2e} (limit 3e-5) | logits of {len(card_logits)} "
        f"prefill/resume calls max_abs_err={err:.3e} (limit 1e-3) | "
        f"launches {({k: launches[k] for k in own})}")
    for b, (a, c) in enumerate(zip(card, cpu)):
        if a != c:
            i = next(i for i, (x, y) in enumerate(zip(a, c)) if x != y)
            raise AssertionError(f"{tag}: lane {b} leaves the CPU stream at "
                                 f"token {i} of {len(a)}")
    assert err <= 1e-3, (tag, err)
    if not paged:
        own, own_logits, _ = greedy_drive(cfg, cpu_params, sessions,
                                          device="cpu", **kw)
        first = [next((i for i, (x, y) in enumerate(zip(a, c)) if x != y),
                      None) for a, c in zip(card, own)]
        log(f"[{tag}] the CPU quantising on its own: logits of the first "
            f"call max_abs_err={_max_err(card_logits[0], own_logits[0]):.3e}; "
            f"first token that differs, per lane: {first} of "
            f"{[len(a) for a in card]}")
    del params, cpu_params
    free_device_memory()


def phase_slices_int8():
    """Full-width, full-depth Qwen2.5-3B in bf16 over an int8 cache,
    driven by ``greedy_drive`` (6 lanes, react, token scale 1.0, max_seq
    8192) on the slab layout, then the paged one (page 64); each run's
    launches are counted from zero and only its layout's int8 entries may
    launch.  Then the same loop over a bf16 slab cache, for the share
    of greedy tokens that agree (printed, not asserted: int8 changes the
    logits in the reference as well), and the profile of one megastep and
    one cold chunk on each int8 cache.  Returns each layout's launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import (forward_decode_megastep, forward_prefill,
                                    init_params)
    from repro_torch.serving.workload import make_workload
    base = get_config("qwen2.5-3b")
    B, max_seq = 6, 8192
    params = init_params(base, torch.Generator(device="cuda").manual_seed(0),
                         torch.bfloat16)
    sessions = make_workload(B, workload="react", vocab_size=base.vocab_size,
                             token_scale=SLICE_TOKEN_SCALE, seed=3)
    prompt = sum(len(t.prefill_tokens) for s in sessions for t in s.turns)
    kw = dict(device="cuda", dtype=torch.bfloat16, max_seq=max_seq)
    out, runs = {}, {}
    for paged in (False, True):
        tag = "slice_int8" + ("_paged" if paged else "")
        cfg = dataclasses.replace(base, kv_layout="paged" if paged else
                                  "slab", kv_page_size=PAGE)
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        streams, _, st = greedy_drive(cfg, params, sessions, kv_quant=True,
                                      **kw)
        launches = dict(ops.LAUNCHES)
        _assert_int8_launches(launches, paged, tag)
        toks = sum(map(len, streams))
        leaves = [(n, t) for layer in st["cache"].values()
                  for n, t in layer.items()]
        q8 = sum(t.numel() * t.element_size() for _, t in leaves)
        bf16 = sum(t.numel() * 2 for n, t in leaves if n in ("k", "v"))
        log(f"[{tag}] {base.name} full width and depth, bfloat16, int8 "
            f"{cfg.kv_layout} cache{' (page %d)' % PAGE if paged else ''}, "
            f"{B} lanes, react, token_scale={SLICE_TOKEN_SCALE}, "
            f"max_seq={max_seq}: sessions={B} output_tokens={toks} "
            f"prompt_tokens={prompt} wall_s={st['wall_s']:.3f} "
            f"output_tok_s={toks / st['wall_s']:.2f}")
        log(f"[{tag}] cache_bytes={q8} (int8 values + scales) vs "
            f"bf16_cache_bytes={bf16} ratio={q8 / bf16:.4f} | "
            f"megastep K=8 ms p50={1e3 * np.median(st['megastep_s']):.2f} "
            f"(n={len(st['megastep_s'])}) | cold chunk 160 ms "
            f"p50={1e3 * np.median(st['chunk_s']):.2f} "
            f"(n={len(st['chunk_s'])}) | max_memory_allocated_GB="
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} | "
            f"launches={launches}")
        out[paged] = launches
        runs[paged] = (cfg, streams, st)
    ref, _, st = greedy_drive(dataclasses.replace(base, kv_layout="slab"),
                              params, sessions, kv_quant=False, **kw)
    del st
    for paged, (cfg, streams, st) in runs.items():
        agree = sum(x == y for a, b in zip(streams, ref) for x, y in zip(a, b))
        log(f"[slice_int8{'_paged' if paged else ''}] greedy tokens equal to "
            f"the bf16 slab cache's at the same position: {agree} of "
            f"{sum(map(len, ref))} ({agree / sum(map(len, ref)):.1%})")
        cache, bt = st["cache"], st["block_tables"]
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
        one = ({"block_tables": bt[:1]} if paged else {"slot_idx": i32([0])})
        profile_work("profile_int8" + ("_paged" if paged else ""), {
            "decode megastep K=8, 6 lanes at 3500 rows": lambda: (
                forward_decode_megastep(
                    params, cfg, i32([0] * B), cache, i32([3500] * B),
                    torch.ones(B, dtype=torch.bool, device="cuda"),
                    num_steps=8, block_tables=bt)),
            "cold chunk 160 tokens at offset 3000": lambda: forward_prefill(
                params, cfg, torch.zeros((1, 160), dtype=torch.int32,
                                         device="cuda"), cache, i32([3000]),
                **one)})
    del params, runs, ref
    free_device_memory()
    return out


# ---------------------------------------------------------------------------
# training (kernel 9) and sliding-window decode
# ---------------------------------------------------------------------------

# the card tests' head shapes (tests/test_torch_gpu.py HEADS), hd 64 and 128
FLASH_HEADS = ((16, 2, 128), (15, 5, 64), (28, 4, 128), (8, 2, 64),
               (16, 16, 128))
TRAIN_ARGS = ["--full-config", "--arch", "smollm-360m", "--steps", "8",
              "--batch", "4", "--seq", "2048", "--lr", "1e-3",
              "--log-every", "1"]


def phase_parity_flash():
    """Kernel 9 against its plain version (causal at S 2048 with and
    without a window of 256, non-causal and causal at the ragged S 1000):
    o within TOL, m within 1e-4, l within 1e-4 relative.  Then the
    FlashAttention Function's dq, dk, dv (kernel 9 forward, matmul
    backward) against autograd through the plain version, f32, 1e-4."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.attention import train_attention
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    for H, Hk, hd in FLASH_HEADS:
        for dtype in (torch.bfloat16, torch.float32):
            for causal, window, S in ((True, 0, 2048), (True, 256, 2048),
                                      (False, 0, 1000), (True, 0, 1000)):
                B = 2 if S == 1000 else 1
                q = _rand(gen, (B, S, H, hd), dtype)
                k, v = (_rand(gen, (B, S, Hk, hd), dtype) for _ in range(2))
                o, m, l = ops.flash_attention(q, k, v, causal=causal,
                                              window=window)
                po, pm, pl = flash_attention_plain(q, k, v, causal=causal,
                                                   window=window)
                err, em = _max_err(o, po), _max_err(m, pm)
                el = ((l - pl).abs() / pl).max().item()
                torch.cuda.synchronize()
                log(f"[parity_flash] {H}/{Hk}/{hd} {str(dtype)[6:]} B={B} "
                    f"S={S} causal={causal} window={window} "
                    f"max_abs_err o={err:.3e} m={em:.3e} l_rel={el:.3e}")
                assert err <= TOL[dtype] and em <= 1e-4 and el <= 1e-4, \
                    ("flash_attention", err, em, el)
                worst = max(worst, err)
    for H, Hk, hd in ((15, 5, 64), (16, 2, 128)):
        for window in (0, 256):
            q, do = (_rand(gen, (2, 1000, H, hd), torch.float32)
                     for _ in range(2))
            k, v = (_rand(gen, (2, 1000, Hk, hd), torch.float32)
                    for _ in range(2))
            grads = []
            for fn in (lambda *a: train_attention(*a, window=window),
                       lambda *a: flash_attention_plain(*a,
                                                        window=window)[0]):
                leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
                fn(*leaves).backward(do)
                grads.append([x.grad for x in leaves])
            errs = [_max_err(a, b) for a, b in zip(*grads)]
            torch.cuda.synchronize()
            log(f"[parity_flash] grads {H}/{Hk}/{hd} f32 B=2 S=1000 "
                f"window={window}: max_abs_err dq={errs[0]:.3e} "
                f"dk={errs[1]:.3e} dv={errs[2]:.3e} (limit 1e-4)")
            assert max(errs) <= 1e-4, ("flash_attention grads", errs)
    return {"flash_attention": worst}


def phase_parity_window_decode():
    """The four decode entries with a window (64, 1024) against their
    plain versions at S_max 8192: lengths 1, below, at and above the
    window and two long ones; slab, paged (page 64, shuffled tables with
    shared pages), bf16 and f32 values and int8 ones.  Returns the worst
    error per entry."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_plain, decode_attention_paged_quant_plain,
        decode_attention_plain, decode_attention_quant_plain)
    from repro_torch.models.attention import quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(6)
    rng = np.random.default_rng(6)
    worst = {k: 0.0 for k in DECODE_KERNELS}
    S, B = 8192, 6
    pmax, P = S // PAGE, B * (S // PAGE)
    for H, Hk, hd in PARITY_HEADS:
        for dtype in (torch.bfloat16, torch.float32):
            kc, vc = (_rand(gen, (B, S, Hk, hd), dtype) for _ in range(2))
            ka, va = (_rand(gen, (P + 1, PAGE, Hk, hd), dtype)
                      for _ in range(2))
            (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
            (kaq, kas), (vaq, vas) = quantize_kv(ka), quantize_kv(va)
            q = _rand(gen, (B, 1, H, hd), dtype)
            for w in (64, 1024):
                lens = [1, w - 1, w, w + 1, 5000, 8000]
                L = _i32(lens)
                bt = shared_tables(rng, lens, pmax, P)
                errs = {
                    "flash_decode": _max_err(
                        ops.flash_decode(q, kc, vc, L, window=w),
                        decode_attention_plain(q, kc, vc, L, w)),
                    "flash_decode_paged": _max_err(
                        ops.flash_decode_paged(q, ka, va, L, bt, window=w),
                        decode_attention_paged_plain(q, ka, va, L, bt, w)),
                    "flash_decode_quant": _max_err(
                        ops.flash_decode_quant(q, kq, ks, vq, vs, L,
                                               window=w),
                        decode_attention_quant_plain(q, kq, ks, vq, vs, L,
                                                     w)),
                    "flash_decode_paged_quant": _max_err(
                        ops.flash_decode_paged_quant(q, kaq, kas, vaq, vas,
                                                     L, bt, window=w),
                        decode_attention_paged_quant_plain(
                            q, kaq, kas, vaq, vas, L, bt, w))}
                torch.cuda.synchronize()
                log(f"[parity_window_decode] {H}/{Hk}/{hd} "
                    f"{str(dtype)[6:]} window={w} lens={lens} max_abs_err "
                    + " ".join(f"{k}={e:.3e}" for k, e in errs.items()))
                for name, e in errs.items():
                    assert e <= TOL[dtype], (name, w, e)
                    worst[name] = max(worst[name], e)
    return worst


# the parity heads and StarCoder2-15B's (48, 4, 128): query group 12
SPLIT_HEADS = PARITY_HEADS + ((48, 4, 128),)


def split_decode_entries(kv, window: int = 0):
    """The four decode entries over one set of caches: name -> (kernel,
    plain version), each called as f(q, L, bt).  kv: slab caches, their
    int8 form, page arenas and their int8 form (bt: the block tables,
    unused by the slab entries)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_plain, decode_attention_paged_quant_plain,
        decode_attention_plain, decode_attention_quant_plain)
    kc, vc = kv["slab"]
    qv, pa, pq = kv["quant"], kv["paged"], kv["paged_quant"]
    return {
        "flash_decode": (
            lambda q, L, bt: ops.flash_decode(q, kc, vc, L, window=window),
            lambda q, L, bt: decode_attention_plain(q, kc, vc, L, window)),
        "flash_decode_paged": (
            lambda q, L, bt: ops.flash_decode_paged(q, *pa, L, bt,
                                                    window=window),
            lambda q, L, bt: decode_attention_paged_plain(q, *pa, L, bt,
                                                          window)),
        "flash_decode_quant": (
            lambda q, L, bt: ops.flash_decode_quant(q, *qv, L,
                                                    window=window),
            lambda q, L, bt: decode_attention_quant_plain(q, *qv, L,
                                                          window)),
        "flash_decode_paged_quant": (
            lambda q, L, bt: ops.flash_decode_paged_quant(q, *pq, L, bt,
                                                          window=window),
            lambda q, L, bt: decode_attention_paged_quant_plain(
                q, *pq, L, bt, window))}


def phase_parity_split_decode():
    """The decode entries' split over fixed key chunks: the four entries
    against their plain versions at query groups 8, 3, 1 and 12 (the
    parity heads and 48/4/128), S_max 8192, lengths at the chunk edges
    and the full capacity, window 0 and 1000; each entry's output for
    every row bitwise equal computed alone, in the batch of 6 and over a
    cache (tables) of twice the capacity; the merge kernel against its
    plain form.  Returns the worst error per entry."""
    from repro_torch.kernels.decode_attention import (
        DECODE_CHUNK, decode_merge_cuda, decode_merge_plain,
        decode_partials_plain)
    from repro_torch.models.attention import quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(12)
    rng = np.random.default_rng(12)
    worst = dict.fromkeys(DECODE_KERNELS, 0.0)
    C, S, B = DECODE_CHUNK, 8192, 6
    pmax, P = S // PAGE, B * (S // PAGE)
    lens = [1, C - 1, C, C + 1, 8000, S]
    L = _i32(lens)
    for H, Hk, hd in SPLIT_HEADS:
        for dtype in (torch.bfloat16, torch.float32):
            kc, vc = (_rand(gen, (B, S, Hk, hd), dtype) for _ in range(2))
            ka, va = (_rand(gen, (P + 1, PAGE, Hk, hd), dtype)
                      for _ in range(2))
            kv = dict(slab=(kc, vc), quant=(*quantize_kv(kc),
                                            *quantize_kv(vc)),
                      paged=(ka, va), paged_quant=(*quantize_kv(ka),
                                                   *quantize_kv(va)))
            bt = shared_tables(rng, [S] * B, pmax, P)
            # twice the capacity: zero rows past S, scratch-page entries
            big = dict(kv)
            for key in ("slab", "quant"):
                big[key] = tuple(torch.cat([t, torch.zeros_like(t)], dim=1)
                                 for t in kv[key])
            bt2 = torch.cat([bt, torch.full_like(bt, P)], dim=1)
            q = _rand(gen, (B, 1, H, hd), dtype)
            dt = f"{H}/{Hk}/{hd} {str(dtype)[6:]}"
            for window in (0, 1000):
                small = split_decode_entries(kv, window)
                large = split_decode_entries(big, window)
                alone = [split_decode_entries(dict(
                    kv, slab=tuple(t[b:b + 1] for t in kv["slab"]),
                    quant=tuple(t[b:b + 1] for t in kv["quant"])), window)
                    for b in range(B)]
                for name, (kern, plain) in small.items():
                    got = kern(q, L, bt)
                    err = _max_err(got, plain(q, L, bt))
                    same = torch.equal(large[name][0](q, L, bt2), got) and all(
                        torch.equal(alone[b][name][0](
                            q[b:b + 1], L[b:b + 1],
                            bt[b:b + 1].contiguous())[0], got[b])
                        for b in range(B))
                    torch.cuda.synchronize()
                    log(f"[parity_split_decode] {name} {dt} window={window} "
                        f"lens={lens} max_abs_err={err:.3e} "
                        f"bitwise_alone_batch_2x_capacity={same}")
                    assert err <= TOL[dtype], (name, dt, window, err)
                    assert same, (name, dt, window, "not invariant")
                    worst[name] = max(worst[name], err)
            del kv, big, kc, vc, ka, va
    # the merge kernel against its plain form, on plain partials
    for hd in (64, 128):
        H, Hk = 48, 4
        q = torch.randn(B, 1, H, hd, generator=gen, device="cuda")
        kc, vc = (torch.randn(B, S, Hk, hd, generator=gen, device="cuda")
                  for _ in range(2))
        for window in (0, 1000):
            parts = decode_partials_plain(q, kc, vc, L, window)
            for dtype in (torch.bfloat16, torch.float32):
                err = _max_err(
                    decode_merge_cuda(*parts, L, S, dtype, window),
                    decode_merge_plain(*parts, L, S, dtype, window))
                torch.cuda.synchronize()
                log(f"[parity_split_decode] merge hd={hd} H={H} "
                    f"window={window} {str(dtype)[6:]} max_abs_err={err:.3e}")
                assert err <= TOL[dtype], ("decode merge", err)
    return worst


def decode_split_info(launch, cap: int, lens, Hk: int, G: int, window=0):
    """The split plan and device times of one decode call: ``launch(chunk)``
    gives a callable that launches the entry's kernel with that chunk (the
    wrapper, no op count).  Chunks per row, blocks (launched, and live:
    the chunks holding a live key), and the profiler's device time (chunk
    kernel + merge) at DECODE_CHUNK and at the other chunks of 128, 256
    and 512 keys."""
    from repro_torch.kernels.decode_attention import (DECODE_CHUNK,
                                                      decode_chunks)
    groups = -(-G // 8)
    live = sum(-(-n // DECODE_CHUNK) - (max(0, n - window) // DECODE_CHUNK
                                         if window > 0 else 0) for n in lens)
    device_ms, merge_ms = _device_ms(launch(DECODE_CHUNK), part="merge")
    return dict(
        chunks=decode_chunks(cap),
        blocks=decode_chunks(cap) * Hk * groups * len(lens),
        live_blocks=live * Hk * groups, device_ms=device_ms,
        merge_ms=merge_ms,
        device_ms_by_chunk={c: _device_ms(launch(c)) for c in (128, 256, 512)
                            if c != DECODE_CHUNK})


def _log_split(tag, name, r):
    from repro_torch.kernels.decode_attention import DECODE_CHUNK
    log(f"[{tag}] {name} split: {DECODE_CHUNK} keys a chunk, chunks "
        f"{r['chunks']}, "
        f"blocks {r['blocks']} ({r['live_blocks']} live), device_ms "
        f"{r['device_ms']:.4f} (main + merge; merge {r['merge_ms']:.4f}); "
        f"other chunks: "
        + ", ".join(f"{c} keys {v:.4f}"
                    for c, v in r["device_ms_by_chunk"].items()))


def phase_timing_flash():
    """Kernel 9 at the training slice's shapes, B 4, S 2048, causal:
    SmolLM-360M heads 15/5/64 and Qwen2.5-3B heads 16/2/128, in f32 (the
    slice's type) and bf16, beside its plain version, one SDPA call
    (``is_causal``, ``enable_gqa``; timed only here) and the bound
    max(flops / peak, bytes / 3.35e12) with causal flops 2 B H S^2 hd
    (half of the full 4 B H S^2 hd) and q, k, v read once, o, m and l
    written once.  The kernel line's entry is SmolLM-360M's in f32.
    Then the four decode entries at window 1024 against window 0 at
    the decode timing shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(7)
    res = {}
    B, S = 4, 2048
    for arch, (H, Hk, hd) in (("smollm-360m", (15, 5, 64)),
                              ("qwen2.5-3b", (16, 2, 128))):
        for dtype in (torch.float32, torch.bfloat16):
            es = torch.finfo(dtype).bits // 8
            q = _rand(gen, (B, S, H, hd), dtype)
            k, v = (_rand(gen, (B, S, Hk, hd), dtype) for _ in range(2))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            flops = 2 * B * H * S * S * hd
            nbytes = (2 * B * S * H * hd + 2 * B * S * Hk * hd) * es \
                + 2 * B * H * S * 4
            bound, by = _bound_ms(flops, nbytes, dtype)
            r = dict(
                ms=_time_ms(lambda: ops.flash_attention(q, k, v), iters=20),
                device_ms=_device_ms(lambda: ops.flash_attention(q, k, v),
                                     iters=20),
                plain_ms=_time_ms(lambda: flash_attention_plain(q, k, v),
                                  iters=5, warmup=1),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), iters=20),
                bound_ms=bound, bound_by=by)
            log(f"[timing_flash] {arch} heads {H}/{Hk}/{hd} "
                f"{str(dtype)[6:]} B={B} S={S} causal: kernel_ms="
                f"{r['ms']:.4f} device_ms={r['device_ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} sdpa_ms="
                f"{r['library_ms']:.4f} bound_ms={bound:.5f} ({by}) "
                f"tflops={flops / r['ms'] / 1e9:.2f}")
            if arch == "smollm-360m" and dtype == torch.float32:
                res["flash_attention"] = r
    # windowed decode at the decode timing shapes (Qwen heads, bf16)
    dtype, H, Hk, hd, Smax, B = torch.bfloat16, 16, 2, 128, 8192, 6
    lens = [1, 37, 1000, 3500, 8000, 5000]
    L = _i32(lens)
    q = _rand(gen, (B, 1, H, hd), dtype)
    kc, vc = (_rand(gen, (B, Smax, Hk, hd), dtype) for _ in range(2))
    from repro_torch.models.attention import quantize_kv
    (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
    pmax = Smax // PAGE
    bt = torch.arange(B * pmax, dtype=torch.int32,
                      device="cuda").reshape(B, pmax)
    ka, va = (x.reshape(B * pmax, PAGE, Hk, hd) for x in (kc, vc))
    kaq, kas, vaq, vas = (x.reshape(B * pmax, PAGE, Hk, x.shape[-1])
                          for x in (kq, ks, vq, vs))
    calls = {
        "flash_decode": lambda w: ops.flash_decode(q, kc, vc, L, window=w),
        "flash_decode_paged": lambda w: ops.flash_decode_paged(
            q, ka, va, L, bt, window=w),
        "flash_decode_quant": lambda w: ops.flash_decode_quant(
            q, kq, ks, vq, vs, L, window=w),
        "flash_decode_paged_quant": lambda w: ops.flash_decode_paged_quant(
            q, kaq, kas, vaq, vas, L, bt, window=w)}
    for name, fn in calls.items():
        t0 = _time_ms(lambda: fn(0))
        t1 = _time_ms(lambda: fn(1024))
        log(f"[timing_window_decode] {name} heads {H}/{Hk}/{hd} bf16 B={B} "
            f"lens={lens}: window=0 {t0:.4f} ms, window=1024 {t1:.4f} ms "
            f"({t1 / t0:.3f}x)")
    return res


def phase_identity_train():
    """Four ``make_train_step`` steps of the smollm-360m smoke config in
    f32, remat on, from the same weights and synthetic batches on the
    card (kernel 9) and on the CPU (its plain version): per-step loss and
    grad_norm within 1e-4 relative; every final parameter within 1e-5,
    except at most 0.1% of elements, where a gradient at the rounding
    level lets Adam's normalised step take the other sign (each step moves
    an element by about lr, so those stay within 2 lr per step).  Then
    the mixtral-8x22b smoke config (window 64) in f32: a 100-token
    prompt and a 24-step decode megastep on both layouts, card tokens
    equal to the CPU's."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import (forward_decode_megastep, forward_prefill,
                                    init_cache, init_params)
    from repro_torch.models.common import tree_leaves
    from repro_torch.training.data import DataConfig, SyntheticCorpus
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False       # full f32 products
    cfg = get_smoke_config("smollm-360m")
    steps, lr = 4, 1e-3
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps)
    base = init_params(cfg, torch.Generator().manual_seed(0))
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                      batch_size=4)).batches()
    batches = [torch.from_numpy(next(data)["tokens"]) for _ in range(steps)]
    runs = {}
    for dev in ("cuda", "cpu"):
        params = _on(base, dev)
        opt = init_opt_state(opt_cfg, params)
        step = make_train_step(cfg, opt_cfg, remat=True)
        ops.reset_launches()
        stats = []
        for b in batches:
            params, opt, st = step(params, opt, {"tokens": b.to(dev)})
            stats.append((float(st["loss"]), float(st["grad_norm"])))
        runs[dev] = (stats, [p.cpu() for p in tree_leaves(params)],
                     ops.LAUNCHES["flash_attention"])
    (card, card_p, n9), (cpu, cpu_p, n9_cpu) = runs["cuda"], runs["cpu"]
    want9 = 2 * cfg.num_layers * steps
    assert n9 == want9 and n9_cpu == 0, (n9, want9, n9_cpu)
    rel = max(max(abs(a - b) / abs(b) for a, b in zip(x, y))
              for x, y in zip(card, cpu))
    diffs = torch.cat([(a - b).abs().reshape(-1)
                       for a, b in zip(card_p, cpu_p)])
    over = int((diffs > 1e-5).sum())
    log(f"[identity_train] {cfg.name} f32 remat, {steps} steps of 4 x 256 "
        f"tokens, lr {lr}: loss card {[round(x[0], 6) for x in card]} "
        f"cpu {[round(x[0], 6) for x in cpu]}; loss/grad_norm max rel diff "
        f"{rel:.3e} (limit 1e-4); params max abs diff "
        f"{diffs.max().item():.3e}, {over} of {diffs.numel()} over 1e-5 "
        f"(limit 0.1%); flash_attention launches {n9} = 2 x "
        f"{cfg.num_layers} layers x {steps} steps")
    assert rel <= 1e-4, rel
    assert over <= 1e-3 * diffs.numel(), over
    assert diffs.max().item() <= 2 * lr * steps + 1e-5, diffs.max().item()

    mix = get_smoke_config("mixtral-8x22b")
    assert mix.sliding_window == 64
    mparams = init_params(mix, torch.Generator().manual_seed(0))
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, mix.vocab_size, (2, 100)).astype(np.int32))
    for layout in ("slab", "paged"):
        cfg_l = dataclasses.replace(mix, kv_layout=layout, kv_page_size=16)
        out = {}
        for dev in ("cuda", "cpu"):
            p = _on(mparams, dev)
            cache = init_cache(cfg_l, 2, 256, device=dev)
            kw = {}
            if layout == "paged":
                kw["block_tables"] = torch.arange(
                    32, dtype=torch.int32, device=dev).reshape(2, 16)
            logits, cache, lens = forward_prefill(
                p, cfg_l, toks.to(dev), cache,
                torch.zeros(2, dtype=torch.int32, device=dev), **kw)
            seq, _, _, _ = forward_decode_megastep(
                p, cfg_l, logits.argmax(-1).int(), cache, lens,
                torch.ones(2, dtype=torch.bool, device=dev), num_steps=24,
                **kw)
            out[dev] = seq.cpu()
        log(f"[identity_window] {mix.name} (window {mix.sliding_window}) "
            f"f32 {layout}: 100-token prompt, 24 megastep tokens x 2 lanes, "
            f"card == cpu: {torch.equal(out['cuda'], out['cpu'])}")
        assert torch.equal(out["cuda"], out["cpu"]), layout
    free_device_memory()


MM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul")


def _train_category(e, vocab: int) -> str:
    """Which part of a train step a CPU op's kernels belong to, from its
    name, its input shapes and its ancestors' names."""
    names = []
    x = e
    while x is not None:
        names.append(x.name)
        x = x.cpu_parent
    joined = " | ".join(names).lower()
    shapes = [s for s in (e.input_shapes or []) if s]
    if "optimizer" in names:
        return "optimizer"
    if "flashattentionbackward" in joined:
        return "attention backward (FlashAttentionBackward)"
    if ("log_softmax" in joined or "gather" in joined or (
            e.name in MM_OPS and any(vocab in s for s in shapes))):
        return "logits and CE"
    if e.name in MM_OPS:
        return "MLP and projection matmuls"
    return "other (norms, rope, activations, embedding, grads' sums)"


def split_train_step(events, vocab: int):
    """Device ms of one profiled train step by part: kernel 9 by kernel
    name, every other kernel by the CPU op that launched it
    (``_train_category``); kernels no op claims count as other."""
    from torch.autograd import DeviceType
    total = k9 = 0.0
    parts = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            us = _device_us(e)
            total += us
            if "flash_attention" in e.name:
                k9 += us
        elif e.device_type == DeviceType.CPU:
            for kern in e.kernels:
                if "flash_attention" not in kern.name:
                    c = _train_category(e, vocab)
                    parts[c] = parts.get(c, 0.0) + kern.duration
    parts = {"kernel 9 (flash_attention)": k9, **parts}
    rest = "other (norms, rope, activations, embedding, grads' sums)"
    parts[rest] = parts.get(rest, 0.0) + total - sum(parts.values())
    return total / 1e3, {k: v / 1e3 for k, v in parts.items()}


def phase_slice_train():
    """Full-width, full-depth SmolLM-360M training through
    ``repro_torch.launch.train`` (``parse_args`` and ``run``, what its
    ``main`` calls): 8 AdamW steps of 4 x 2048 tokens, f32, remat.
    Kernel 9 must launch 2 x 32 x 8 times (remat recomputes each layer's
    forward) and no other kernel at all; the loss must fall from the
    first step to the last.  Then one more step of the same model,
    profiled: device time by part and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import init_params
    from repro_torch.training import train_step as ts_mod
    from repro_torch.training.data import DataConfig, SyntheticCorpus
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    args = train.parse_args(TRAIN_ARGS)
    cfg = get_config(args.arch)
    log(f"[slice_train] {cfg.name} full width and depth ({cfg.num_layers} "
        f"layers, d {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}"
        f"/{cfg.head_dim}, vocab {cfg.vocab_size}), f32 params, remat, "
        f"{args.steps} steps of {args.batch} x {args.seq} tokens, lr "
        f"{args.lr}")
    ops.reset_launches()
    rec = train.run(args)
    launches = dict(ops.LAUNCHES)
    want = 2 * cfg.num_layers * args.steps
    assert launches["flash_attention"] == want, (launches, want)
    for name in SOURCES:
        if name not in FLASH_KERNELS:
            assert launches[name] == 0, f"{name} was launched on slice_train"
    losses = rec["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    log(f"[slice_train] losses {[round(x, 4) for x in losses]}: first "
        f"{losses[0]:.4f} last {losses[-1]:.4f} | step ms p50="
        f"{1e3 * np.median(rec['step_s']):.1f} (each: "
        f"{[round(1e3 * x, 1) for x in rec['step_s']]}) | train tok/s="
        f"{rec['tok_s']:.0f} | max_memory_allocated_GB={rec['peak_gb']:.2f} "
        f"| flash_attention launches {launches['flash_attention']} = 2 x "
        f"{cfg.num_layers} x {args.steps}")
    free_device_memory()

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=1, total_steps=args.steps)
    opt = init_opt_state(opt_cfg, params)
    step = ts_mod.make_train_step(cfg, opt_cfg, remat=True)
    batch = {"tokens": torch.from_numpy(next(SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch)).batches())["tokens"]).cuda()}
    params, opt, _ = step(params, opt, batch)             # warm
    torch.cuda.synchronize()
    real = ts_mod.apply_updates

    def marked(*a, **k):
        with record_function("optimizer"):
            return real(*a, **k)
    ts_mod.apply_updates = marked
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            step(params, opt, batch)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ts_mod.apply_updates = real
    busy, parts = split_train_step(prof.events(), cfg.padded_vocab)
    step_ms = 1e3 * float(np.median(rec["step_s"]))
    log(f"[profile_train] one step: device_ms={busy:.2f}; against the "
        f"slice's step wall p50 {step_ms:.1f} ms device_busy="
        f"{busy / step_ms:.1%} (the profiled step's own wall, profiler on: "
        f"{wall * 1e3:.1f} ms)")
    for k, v in sorted(parts.items(), key=lambda kv: -kv[1]):
        log(f"[profile_train]    {v:10.3f} ms  {v / busy:6.1%}  {k}")
    del params, opt, prof
    free_device_memory()
    return launches


def main() -> int:
    t_start = time.perf_counter()

    def stamp(what):
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")
    name, smi = phase_device()
    phase_build()
    worst = phase_parity()
    worst.update(phase_parity_paged())
    worst.update(phase_parity_ssm())
    t_moe = time.perf_counter()
    worst.update(phase_parity_moe())
    log(f"[time] parity_moe took {time.perf_counter() - t_moe:.1f} s")
    worst.update(phase_parity_int8())
    worst.update(phase_parity_flash())
    for k, e in phase_parity_window_decode().items():
        worst[k] = max(worst[k], e)
    for k, e in phase_parity_split_decode().items():
        worst[k] = max(worst[k], e)
    stamp("parity")
    timing = phase_timing()
    timing.update(phase_timing_paged())
    timing.update(phase_timing_ssm())
    t_moe = time.perf_counter()
    timing.update(phase_timing_moe())
    log(f"[time] timing_moe took {time.perf_counter() - t_moe:.1f} s")
    timing.update(phase_timing_int8())
    timing.update(phase_timing_flash())
    free_device_memory()
    log(f"[timing] device traces: {TRACES['taken']} taken, "
        f"{TRACES['lost']} thrown away for lost events")
    stamp("timing")
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
    stamp("Qwen2.5-3B slices")
    phase_identity(paged=False, spec_k=SPEC_K)
    phase_identity(paged=True, spec_k=SPEC_K)
    _, eng = phase_slice(paged=False, spec_k=SPEC_K)
    phase_slice_spec_repetition(eng)
    phase_profile_spec(eng)
    del eng
    free_device_memory()
    stamp("speculative decode")
    phase_identity_ssm(hybrid=False)
    phase_identity_ssm(hybrid=True)
    phase_identity_spec_hybrid()
    launches_ssm, eng = phase_slice(paged=False, arch="mamba2-780m")
    phase_profile(eng, paged=False, tag="profile_ssm")
    del eng
    free_device_memory()
    launches_ssm_paged, eng = phase_slice(paged=True, arch="mamba2-780m")
    phase_profile(eng, paged=True, tag="profile_ssm")
    del eng
    free_device_memory()
    stamp("mamba2-780m slices")
    phase_identity(paged=False, arch="olmoe-1b-7b")
    phase_identity(paged=True, arch="olmoe-1b-7b")
    launches_moe, eng = phase_slice(paged=False, arch="olmoe-1b-7b")
    phase_profile(eng, paged=False, tag="profile_moe", moe_mode="dense")
    phase_profile(eng, paged=False, tag="profile_moe_gmm", moe_mode="gmm")
    del eng
    free_device_memory()
    stamp("OLMoE-1B-7B slice")
    phase_identity_int8(paged=False)
    phase_identity_int8(paged=True)
    int8 = phase_slices_int8()
    stamp("int8 slices")
    phase_identity_train()
    launches_train = phase_slice_train()
    stamp("training slice")
    phase_forward_testbed()
    stamp("testbed forwards")
    # each kernel's launches are those of the slice that runs its path
    # (the scan: the slab Mamba-2 slice; its paged twin's count is in the
    # slice_ssm_paged line; the grouped matmul: slice_moe; the int8
    # entries: slice_int8 and slice_int8_paged; kernel 9: slice_train)
    launches.update({k: launches_paged[k] for k in PAGED_KERNELS})
    launches.update({k: launches_ssm[k] for k in SSM_KERNELS})
    launches.update({k: launches_moe[k] for k in MOE_KERNELS})
    launches.update({k: int8[False][k] for k in INT8_KERNELS})
    launches.update({k: int8[True][k] for k in INT8_PAGED_KERNELS})
    launches.update({k: launches_train[k] for k in FLASH_KERNELS})
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
