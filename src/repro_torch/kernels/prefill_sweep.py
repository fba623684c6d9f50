"""Device time of the bf16 chunk-prefill kernels over key tiles and split
counts, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.prefill_sweep

At the cold-chunk shape (1 x 160 tokens at offset 3000) and the resume
batch (4 x 64 tokens at offsets 2900-4200), Qwen2.5-3B heads 16/2/128,
6 slots of 8192 rows (paged: page 64), it times ``flash_prefill`` and
``flash_prefill_paged`` with ``torch.profiler`` (device time of the main
kernel and of the merge, per call) for each split count, once with the
source as it is (key tiles of 64) and once with a copy built with
``kTcBK = 128``.  The split plan is overridden for the sweep only; the
line marked ``plan`` is the count ``prefill_splits`` picks.  Each line
also gives the largest difference from the plain version.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch


def _device_us(fn, n: int = 40):
    """Device time per call of fn's kernels: (main, merge) in us."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    main = merge = 0.0
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0))
        if "prefill_merge" in e.key:
            merge += t / n
        elif "prefill_tc" in e.key:
            main += t / n
    return main, merge


def _build_tile(tile: int):
    """The prefill source built with key tiles of ``tile`` (64: the
    repo's own build)."""
    from repro_torch.kernels import _build
    if tile == 64:
        return _build.load("prefill_attention")
    src = (_build.CSRC / "prefill_attention.cu").read_text()
    assert "constexpr int kTcBK = 64;" in src
    out = _build.BUILD_DIR / f"prefill_attention_bk{tile}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "src.cu").write_text(
        src.replace("constexpr int kTcBK = 64;", f"constexpr int kTcBK = {tile};"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                    str(out / "lib.so"), str(out / "src.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(out / "lib.so"))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("prefill_sweep: needs a CUDA card")
    from repro_torch.kernels import ops
    from repro_torch.kernels import prefill_attention as pa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[sweep] {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    H, Hk, hd, S, B, page = 16, 2, 128, 8192, 6, 64
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    kc, vc = rnd(B, S, Hk, hd), rnd(B, S, Hk, hd)
    ka, va = (c.reshape(B * S // page, page, Hk, hd) for c in (kc, vc))
    bt = torch.arange(B * S // page, dtype=torch.int32,
                      device="cuda").reshape(B, S // page)
    offs = [3100, 3600, 4200, 2900]
    shapes = [("cold", rnd(1, 160, H, hd), i32([3000]), i32([3160]),
               i32([2])),
              ("resume", rnd(4, 64, H, hd), i32(offs),
               i32([o + 64 for o in offs]), i32([0, 1, 2, 3]))]
    plan, load = pa.prefill_splits, pa._build.load
    try:
        for tile in (64, 128):
            lib = _build_tile(tile)
            pa._FNS.clear()
            pa._build.load = lambda name, _lib=lib: _lib
            for tag, q, qo, ln, si in shapes:
                M, Sq = q.shape[:2]
                bt_m = bt[si.long()].contiguous()
                planned = plan(M, Sq, Hk, H // Hk, S,
                               torch.cuda.get_device_properties(0)
                               .multi_processor_count)
                for sp in sorted({planned, 1, 2, 3, 4, 5, 6, 8}):
                    pa.prefill_splits = lambda *a, _s=sp: _s
                    slab = lambda: ops.flash_prefill(q, kc, vc, qo, ln,
                                                     slot_idx=si)
                    paged = lambda: ops.flash_prefill_paged(q, ka, va, qo,
                                                            ln, bt_m)
                    err = (slab().float() - pa.prefill_attention_plain(
                        q, kc, vc, qo, ln, slot_idx=si).float()).abs().max()
                    times = [_device_us(f) for f in (slab, paged)]
                    print(f"[sweep] key_tile={tile} {tag} splits={sp}"
                          f"{' plan' if sp == planned else ''} "
                          f"max_abs_err={err.item():.3e} " + " ".join(
                              f"{n}_main_us={a:.1f} {n}_merge_us={b:.1f}"
                              for n, (a, b) in zip(("slab", "paged"), times)),
                          flush=True)
    finally:
        pa.prefill_splits, pa._build.load = plan, load
        pa._FNS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
