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
             heads 15/5/64, S_max 8192, ragged lengths, prefill chunks at
             offsets 0 and > 0, a strided cache view), f32 within 1e-4
             and bf16 within 2e-2 max abs error.
4. timing  — each kernel, its plain version and one library call
             (``scaled_dot_product_attention`` with the equivalent
             boolean mask on the valid slice, timed only here) with CUDA
             events over many launches, beside the bound
             max(flops / 989e12, bytes / 3.35e12) computed from these
             inputs (keys each row needs, every input byte read once).
5. identity — float32 full-width Qwen2.5-3B cut to 4 layers, served by
             the engine on a 3-agent react workload; every session's
             stream must equal the port's isolated greedy oracle.
6. slice   — full-width, full-depth Qwen2.5-3B in bf16 through
             ``repro_torch.launch.serve``'s closed loop (4 agents, react,
             max_seq 8192); every session must finish with all its
             tokens and both kernels' launch counts must be > 0.
7. profile — the slice engine's own forwards (a K=8 decode megastep, a
             cold chunk, a resume batch): wall time, device time and
             device time by kernel from ``torch.profiler``.

The last lines are the kernel list, the nvidia-smi line, the kernel JSON
line and the result JSON line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SLICE_TOKEN_SCALE = 1.0


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


def phase_identity():
    from repro_torch.configs.base import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.oracle import oracle_streams
    from repro_torch.serving.workload import make_workload
    torch.backends.cuda.matmul.allow_tf32 = False       # full f32 products
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=4)
    log(f"[identity] {cfg.name} full width, depth cut to "
        f"{cfg.num_layers} of 36 layers, float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32)
    kw = dict(num_slots=5, max_seq=2048)
    ecfg = EngineConfig(cycle_budget=160, granularity=16,
                        control_interval_s=0.1, autotune_chunks=False,
                        record_events=True, **kw)
    mk = lambda: make_workload(3, workload="react",
                               vocab_size=cfg.vocab_size, token_scale=0.25,
                               seed=3)
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
    log(f"[identity] {len(sessions)} sessions, "
        f"{sum(len(v) for v in streams.values())} tokens equal the "
        f"isolated greedy oracle | {rep.row()}")
    del eng, params
    torch.cuda.empty_cache()


def phase_slice():
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args([
        "--full", "--arch", "qwen2.5-3b", "--agents", "4",
        "--workload", "react", "--max-seq", "8192",
        "--token-scale", str(SLICE_TOKEN_SCALE)])
    torch.cuda.reset_peak_memory_stats()
    log(f"[slice] qwen2.5-3b full width and depth, bfloat16, 4 agents, "
        f"react, token_scale={SLICE_TOKEN_SCALE}, max_seq=8192")
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
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
    toks = sum(s.output_tokens() for s in sessions)
    prompt = sum(len(t.prefill_tokens) for s in sessions for t in s.turns)
    log(f"[slice] {serve.ServingReport.HEADER}")
    log(f"[slice] {rep.row()}")
    log(f"[slice] sessions={len(sessions)} output_tokens={toks} "
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


def phase_profile(eng):
    """Where a slice step's time goes: the slice engine's own forwards,
    timed with the host clock around a synchronize and traced with
    torch.profiler over the device alone (time by kernel, busy share)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import (forward_decode_megastep,
                                    forward_prefill, forward_resume_batch)
    cfg, params, cache = eng.mcfg, eng.params, eng.pool.cache
    B = eng.ecfg.num_slots
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    work = {
        "decode megastep K=8, 6 lanes at 3500 rows": lambda: (
            forward_decode_megastep(params, cfg, i32([0] * B), cache,
                                    i32([3500] * B),
                                    torch.ones(B, dtype=torch.bool,
                                               device="cuda"), num_steps=8)),
        "cold chunk 160 tokens at offset 3000": lambda: forward_prefill(
            params, cfg, torch.zeros((1, 160), dtype=torch.int32,
                                     device="cuda"), cache, i32([3000]),
            slot_idx=i32([0])),
        "resume batch 4 x 64 tokens at 3000-4200": lambda: (
            forward_resume_batch(params, cfg,
                                 torch.zeros((4, 64), dtype=torch.int32,
                                             device="cuda"), cache,
                                 i32([0, 1, 2, 3]),
                                 i32([3100, 3600, 4200, 2900]),
                                 i32([63] * 4))),
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
        log(f"[profile] {what}: wall_ms={wall * 1e3:.2f} "
            f"device_ms={busy:.2f} device_busy={busy / (wall * 1e3):.1%}")
        for e in top:
            log(f"[profile]    {_device_us(e) / 1e3:9.3f} ms  "
                f"x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    name, smi = phase_device()
    phase_build()
    worst = phase_parity()
    timing = phase_timing()
    phase_identity()
    launches, eng = phase_slice()
    phase_profile(eng)
    src = {"flash_prefill": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                             "src/repro/kernels/prefill_attention.py:243"),
           "flash_decode": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                            "src/repro/kernels/decode_attention.py:133")}
    log("kernels: " + "; ".join(
        f"{k} parity=ok max_abs_err={worst[k]:.3e} launches={launches[k]}"
        for k in src))
    print(smi)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src[k][0],
         "replaces": src[k][1], "launches": launches[k],
         "max_abs_err": worst[k], "ms": timing[k]["ms"],
         "plain_ms": timing[k]["plain_ms"], "bound_ms": timing[k]["bound_ms"],
         "bound_by": timing[k]["bound_by"],
         "library_ms": timing[k]["library_ms"]} for k in src]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
