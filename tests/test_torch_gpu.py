"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode).  The module imports only torch, numpy, pytest and the port,
so it collects on a machine that has no JAX.  ``tests/conftest.py``
imports JAX, so on such a machine run it without the conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_paged_plain, decode_attention_plain, paged_gather)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_paged_quant_plain, decode_attention_quant_plain)
from repro_torch.kernels.prefill_attention import (  # noqa: E402
    prefill_attention_paged_plain, prefill_attention_paged_quant_plain,
    prefill_attention_plain, prefill_attention_quant_plain)
from repro_torch.kernels.prefill_attention import (  # noqa: E402
    merge_partials_cuda, merge_partials_plain, prefill_splits)
from repro_torch.kernels.ssd_scan import ssd_inputs  # noqa: E402
from repro_torch.models.attention import quantize_kv  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (16, 16, 128): OLMoE-1B-7B's heads, query group 1
HEADS = [(16, 2, 128), (15, 5, 64), (28, 4, 128), (8, 2, 64), (16, 16, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _i32(v):
    return torch.tensor(v, dtype=torch.int32, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hk,hd", HEADS)
def test_cuda_kernels_match_plain(cuda, dtype, H, Hk, hd):
    """Each slab CUDA kernel against its plain version on the card,
    through a strided (non-contiguous) cache view and a permuted slot
    order."""
    tol, dt = TOL[dtype], getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(H + hd)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    B, S = 4, 1024
    wide_k, wide_v = rnd(B, S, 2 * Hk, hd), rnd(B, S, 2 * Hk, hd)
    for kc, vc in ((wide_k[:, :, :Hk].contiguous(),
                    wide_v[:, :, :Hk].contiguous()),
                   (wide_k[:, :, ::2], wide_v[:, :, ::2])):
        q, lens = rnd(B, 1, H, hd), _i32([1, 37, 500, 1024])
        assert _err(ops.flash_decode(q, kc, vc, lens),
                    decode_attention_plain(q, kc, vc, lens)) <= tol
        for Sq, window in ((3, 0), (40, 0), (130, 48)):
            qo = _i32([0, 300, 17])
            ln, slots = qo + Sq, _i32([3, 0, 2])
            qq = rnd(3, Sq, H, hd)
            got = ops.flash_prefill(qq, kc, vc, qo, ln, window=window,
                                    slot_idx=slots)
            want = prefill_attention_plain(qq, kc, vc, qo, ln, window=window,
                                           slot_idx=slots)
            assert _err(got, want) <= tol
    torch.cuda.synchronize()


def shared_tables(rng, lengths, pmax: int, page: int, num_pages: int):
    """Block tables [rows, pmax] over a shuffled arena of ``num_pages``
    usable pages (page ``num_pages`` is the scratch page): rows 0 and 1
    share their first two pages, every other mapped page is distinct,
    and entries past a row's length point at the scratch page."""
    perm = rng.permutation(num_pages)
    bt = np.full((len(lengths), pmax), num_pages, np.int32)
    nxt = 0
    for r, n in enumerate(lengths):
        need = -(-int(n) // page)
        bt[r, :need] = perm[nxt:nxt + need]
        nxt += need
    bt[1, :2] = bt[0, :2]
    return bt


@pytest.mark.gpu
@pytest.mark.parametrize("page", [64, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hk,hd", HEADS)
def test_cuda_paged_kernels_match_plain(cuda, page, dtype, H, Hk, hd):
    """The paged CUDA kernels against their plain versions, through a
    permuted table in which two rows share pages and unmapped entries
    point at the scratch page; and against the slab kernels on the
    gathered rows."""
    tol, dt = TOL[dtype], getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(H + hd + page)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    rng = np.random.default_rng(page + hd)
    pmax = 1024 // page
    lens = [2 * page + 5, 2 * page + 37, 1, 500, 1024]
    B = len(lens)
    P = B * pmax
    ka, va = rnd(P + 1, page, Hk, hd), rnd(P + 1, page, Hk, hd)
    bt = torch.tensor(shared_tables(rng, lens, pmax, page, P), device="cuda")
    L = _i32(lens)
    q = rnd(B, 1, H, hd)
    got = ops.flash_decode_paged(q, ka, va, L, bt)
    assert _err(got, decode_attention_paged_plain(q, ka, va, L, bt)) <= tol
    kg, vg = paged_gather(ka, bt), paged_gather(va, bt)
    assert _err(got, ops.flash_decode(q, kg, vg, L)) <= tol
    for Sq, window in ((3, 0), (40, 0), (130, 48)):
        rows = _i32([3, 0, 1])
        qo = _i32([0, 2 * page, 17])
        ln = qo + Sq
        bt_m = bt[rows.long()].contiguous()
        qq = rnd(3, Sq, H, hd)
        got = ops.flash_prefill_paged(qq, ka, va, qo, ln, bt_m, window=window)
        want = prefill_attention_paged_plain(qq, ka, va, qo, ln, bt_m,
                                             window=window)
        assert _err(got, want) <= tol
        slab = ops.flash_prefill(qq, kg, vg, qo, ln, window=window,
                                 slot_idx=rows)
        assert _err(got, slab) <= tol
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_paged_wrappers_reject_bad_tables(cuda):
    ka = torch.zeros(9, 48, 2, 64, device="cuda")
    q = torch.zeros(2, 1, 4, 64, device="cuda")
    L = _i32([3, 5])
    with pytest.raises(ValueError, match="page sizes"):
        ops.flash_decode_paged(q, ka, ka, L, _i32([[0], [1]]))
    ka = torch.zeros(9, 64, 2, 64, device="cuda")
    with pytest.raises(TypeError):
        ops.flash_decode_paged(q, ka, ka, L, _i32([[0], [1]]).long())
    with pytest.raises(ValueError, match="rows"):
        ops.flash_decode_paged(q, ka, ka, L, _i32([[0]]))


# ---------------------------------------------------------------------------
# bf16 chunk prefill on the tensor cores (wgmma, TMA tiles, split keys)
# ---------------------------------------------------------------------------

PREFILL_SQ = (1, 2, 8, 16, 56, 64, 160, 320)
PREFILL_S = 8448            # room for a 320-token chunk at offset 8000


def _prefill_rows(off: int):
    """Three rows' offsets around ``off``: a chunk that straddles 64-row
    pages and tiles, one near the start and one just below ``off``."""
    return [off, off // 2 + 7, max(off - 61, 0)]


def _splits(q, Hk, cap):
    M, Sq, H, _ = q.shape
    return prefill_splits(M, Sq, Hk, H // Hk, cap,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hk,hd", HEADS)
def test_cuda_bf16_prefill_matches_plain(cuda, H, Hk, hd):
    """The bf16 slab kernel against its plain version on every chunk
    length of the serving path (spec-verify 2..8 to 320-token chunks) at
    offsets 0, 3000 and 8000, windows 0 and 256, a permuted slot order,
    contiguous and strided cache views; the plan takes one split for the
    largest and many for the smallest; two calls give the same bits."""
    tol, dt = TOL["bfloat16"], torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(7 * H + hd)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    B, S = 4, PREFILL_S
    wide_k, wide_v = rnd(B, S, 2 * Hk, hd), rnd(B, S, 2 * Hk, hd)
    splits = set()
    for kc, vc in ((wide_k[:, :, :Hk].contiguous(),
                    wide_v[:, :, :Hk].contiguous()),
                   (wide_k[:, :, ::2], wide_v[:, :, ::2])):
        for Sq in PREFILL_SQ:
            for off in (0, 3000, 8000):
                for window in (0, 256):
                    qo = _i32(_prefill_rows(off))
                    ln, slots = qo + Sq, _i32([3, 0, 2])
                    qq = rnd(3, Sq, H, hd)
                    got = ops.flash_prefill(qq, kc, vc, qo, ln, window=window,
                                            slot_idx=slots)
                    want = prefill_attention_plain(qq, kc, vc, qo, ln,
                                                   window=window,
                                                   slot_idx=slots)
                    assert _err(got, want) <= tol, (Sq, off, window)
                    splits.add(_splits(qq, Hk, S))
        # a batch that fills the card alone: one split, no merge
        qq = rnd(8, 320, H, hd)
        qo = _i32([0, 3000, 8000, 100, 5000, 64, 7000, 2500])
        ln, slots = qo + 320, _i32([0, 1, 2, 3, 3, 2, 1, 0])
        got = ops.flash_prefill(qq, kc, vc, qo, ln, slot_idx=slots)
        assert _err(got, prefill_attention_plain(qq, kc, vc, qo, ln,
                                                 slot_idx=slots)) <= tol
        assert torch.equal(got, ops.flash_prefill(qq, kc, vc, qo, ln,
                                                  slot_idx=slots))
        splits.add(_splits(qq, Hk, S))
    assert 1 in splits and max(splits) > 1, splits
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("page", [16, 64, 128])
@pytest.mark.parametrize("H,Hk,hd", HEADS)
def test_cuda_bf16_prefill_paged_matches_plain(cuda, page, H, Hk, hd):
    """The bf16 paged kernel against its plain version and against the
    slab kernel on the gathered rows: pages of 16 (four boxes a tile),
    64 (one) and 128 (half a page a tile), shuffled tables in which two
    rows share pages and unmapped entries name the scratch page, chunks
    that straddle pages, every chunk length, windows 0 and 256."""
    tol, dt = TOL["bfloat16"], torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(H + hd + page)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    rng = np.random.default_rng(page + hd)
    S = PREFILL_S
    pmax = S // page
    lens = [8000 + 320] * 3 + [100]
    B = len(lens)
    P = B * pmax
    ka, va = rnd(P + 1, page, Hk, hd), rnd(P + 1, page, Hk, hd)
    bt = torch.tensor(shared_tables(rng, lens, pmax, page, P), device="cuda")
    kg, vg = paged_gather(ka, bt), paged_gather(va, bt)
    for Sq in PREFILL_SQ:
        for off in (0, 3000, 8000):
            for window in (0, 256):
                rows = _i32([2, 0, 1])
                qo = _i32(_prefill_rows(off))
                ln = qo + Sq
                bt_m = bt[rows.long()].contiguous()
                qq = rnd(3, Sq, H, hd)
                got = ops.flash_prefill_paged(qq, ka, va, qo, ln, bt_m,
                                              window=window)
                want = prefill_attention_paged_plain(qq, ka, va, qo, ln,
                                                     bt_m, window=window)
                assert _err(got, want) <= tol, (Sq, off, window)
                slab = ops.flash_prefill(qq, kg, vg, qo, ln, window=window,
                                         slot_idx=rows)
                assert _err(got, slab) <= tol, (Sq, off, window)
    assert torch.equal(got, ops.flash_prefill_paged(qq, ka, va, qo, ln, bt_m,
                                                    window=window))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_prefill_merge_matches_plain(cuda, dtype, hd):
    """The split merge kernel alone against ``merge_partials_plain`` on
    partial states with empty splits (m = -1e30, l = 0) among them."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(hd)
    splits, M, Sq, H = 7, 3, 37, 16
    part_o = torch.randn(splits, M, Sq, H, hd, generator=gen, device="cuda")
    m = 8 * torch.randn(splits, M, Sq, H, generator=gen, device="cuda")
    l = 1 + torch.rand(splits, M, Sq, H, generator=gen, device="cuda")
    empty = torch.rand(splits, M, Sq, H, generator=gen, device="cuda") < 0.3
    empty[0] = False
    part_o[empty] = 0
    part_ml = torch.stack([m.masked_fill(empty, -1e30),
                           l.masked_fill(empty, 0)], dim=-1)
    got = merge_partials_cuda(part_o, part_ml, dt)
    torch.cuda.synchronize()
    want = merge_partials_plain(part_o, part_ml, dt)
    assert _err(got, want) <= {"float32": 1e-5, "bfloat16": 2e-2}[dtype]


# ---------------------------------------------------------------------------
# the SSD chunked scan
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 64, 256])
@pytest.mark.parametrize("hd,N", [(64, 128), (32, 16)])
def test_cuda_ssd_scan_matches_plain(cuda, dtype, chunk, hd, N):
    """The kernel against its plain version, S not a multiple of the
    chunk (and shorter than one), y and the final state."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    tol, dt_ = TOL[dtype], getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(chunk + hd + N)
    for S in (1, chunk - 3 if chunk > 3 else 2, 2 * chunk + 7):
        args = ssd_inputs(gen, 2, S, 6, hd, N, dt_)
        before = ops.LAUNCHES["ssd_scan"]
        y, h = ops.ssd_scan(*args, chunk=chunk)
        assert ops.LAUNCHES["ssd_scan"] == before + 1
        yp, hp = ssd_scan_plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert y.dtype == dt_ and h.dtype == torch.float32
        assert bool(torch.isfinite(y.float()).all())
        assert _err(y, yp) <= tol, (S, _err(y, yp))
        assert _err(h, hp) <= tol, (S, _err(h, hp))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_padding_fence(cuda, dtype):
    """Trailing rows with dt = 0 (a padded serving chunk) leave the state
    bit for bit as the unpadded call does, and the real rows' y too."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    x, dt, A, Bm, Cm, h0 = ssd_inputs(gen, 2, 200, 8, 64, 128,
                                      getattr(torch, dtype))
    fenced = dt.clone()
    fenced[:, 150:] = 0
    y, h = ops.ssd_scan(x, fenced, A, Bm, Cm, h0, chunk=256)
    ys, hs = ops.ssd_scan(x[:, :150], dt[:, :150], A, Bm[:, :150],
                          Cm[:, :150], h0, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(h, hs)
    assert torch.equal(y[:, :150], ys)


@pytest.mark.gpu
def test_cuda_ssd_scan_rejects_what_it_does_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(12)
    args = ssd_inputs(gen, 1, 8, 2, 16, 8, torch.float32)
    with pytest.raises(ValueError, match="hd, N"):
        ops.ssd_scan(*args, chunk=8)
    args = ssd_inputs(gen, 1, 300, 2, 64, 128, torch.float32)
    with pytest.raises(ValueError, match="256"):
        ops.ssd_scan(*args, chunk=300)


# the bf16 body runs on the tensor cores; its state is held ten times
# closer than y (it is carried across chunks, calls and turns)
SSD_H_TOL = TOL["bfloat16"] / 10


@pytest.mark.gpu
@pytest.mark.parametrize("hd,N", [(64, 128), (32, 16)])
@pytest.mark.parametrize("B", [1, 4])
def test_cuda_ssd_scan_tc_matches_plain(cuda, hd, N, B):
    """The bf16 tensor-core body against the plain version at both
    instantiated widths, S from 1 to 1000 (one to four 256-row chunks,
    tile edges on both sides of 16 and 256), with a tail of dt = 0 rows:
    one launch a call, y within the bf16 tolerance, the state ten times
    closer."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    gen = torch.Generator(device="cuda").manual_seed(hd + N + B)
    for S in (1, 15, 16, 17, 64, 160, 256, 257, 1000):
        args = ssd_inputs(gen, B, S, 8, hd, N, torch.bfloat16, pad=S // 5)
        before = ops.LAUNCHES["ssd_scan"]
        y, h = ops.ssd_scan(*args, chunk=256)
        assert ops.LAUNCHES["ssd_scan"] == before + 1
        yp, hp = ssd_scan_plain(*args, chunk=256)
        torch.cuda.synchronize()
        assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
        assert bool(torch.isfinite(y.float()).all())
        assert _err(y, yp) <= TOL["bfloat16"], (S, _err(y, yp))
        assert _err(h, hp) <= SSD_H_TOL, (S, _err(h, hp))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(1, 17), (2, 50), (1, 161)])
def test_cuda_ssd_scan_tc_reads_nothing_past_the_last_row(cuda, B, S):
    """x, dt, B and C at the front of allocations whose tails hold NaN (0 *
    NaN is NaN): no product may take a row past the last, at S not a
    multiple of 16."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    gen = torch.Generator(device="cuda").manual_seed(S)
    x, dt, A, Bm, Cm, h0 = ssd_inputs(gen, B, S, 8, 64, 128, torch.bfloat16)

    def nan_tail(t):
        buf = torch.full((t.numel() + 16384,), float("nan"), dtype=t.dtype,
                         device="cuda")
        buf[:t.numel()] = t.flatten()
        return buf[:t.numel()].view(t.shape)
    y, h = ops.ssd_scan(nan_tail(x), nan_tail(dt), A, nan_tail(Bm),
                        nan_tail(Cm), h0, chunk=256)
    yp, hp = ssd_scan_plain(x, dt, A, Bm, Cm, h0, chunk=256)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y.float()).all())
    assert bool(torch.isfinite(h).all())
    assert _err(y, yp) <= TOL["bfloat16"] and _err(h, hp) <= SSD_H_TOL


@pytest.mark.gpu
def test_cuda_ssd_scan_tc_carries_the_state_across_calls(cuda):
    """160 rows and then 96 from the first call's state, against one call
    of 256 (mamba2-780m widths)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    x, dt, A, Bm, Cm, h0 = ssd_inputs(gen, 1, 256, 48, 64, 128,
                                      torch.bfloat16)
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=256)
    part = lambda a, b: [t[:, a:b].contiguous() for t in (x, dt, Bm, Cm)]
    x1, dt1, B1, C1 = part(0, 160)
    x2, dt2, B2, C2 = part(160, 256)
    y1, h1 = ops.ssd_scan(x1, dt1, A, B1, C1, h0, chunk=256)
    y2, h2 = ops.ssd_scan(x2, dt2, A, B2, C2, h1, chunk=256)
    torch.cuda.synchronize()
    assert _err(torch.cat([y1, y2], dim=1), y) <= TOL["bfloat16"]
    assert _err(h2, h) <= SSD_H_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_padding_fence_resume_batch(cuda, dtype):
    """The padding fence at the resume batch's shape (B 4, S 64,
    mamba2-780m widths): rows 40-63 with dt = 0 leave the state and the
    real rows' y bit for bit as a call of 40 rows."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, dt, A, Bm, Cm, h0 = ssd_inputs(gen, 4, 64, 48, 64, 128,
                                      getattr(torch, dtype))
    fenced = dt.clone()
    fenced[:, 40:] = 0
    y, h = ops.ssd_scan(x, fenced, A, Bm, Cm, h0, chunk=256)
    ys, hs = ops.ssd_scan(x[:, :40], dt[:, :40], A, Bm[:, :40],
                          Cm[:, :40], h0, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(h, hs)
    assert torch.equal(y[:, :40], ys)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,N", [(64, 128), (32, 16)])
def test_cuda_ssd_scan_tc_plan_matches_the_card(cuda, hd, N):
    """``tc_plan``'s shared memory is the kernel's, and the card keeps at
    least the plan's blocks resident an SM: a mamba2-780m cold chunk's 192
    blocks in one wave."""
    from repro_torch.kernels.ssd_scan import tc_occupancy, tc_plan
    plan = tc_plan(1, 48, hd, N)
    smem, resident = tc_occupancy(hd, N)
    assert smem == plan.smem_bytes
    assert resident >= plan.resident_per_sm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if (hd, N) == (64, 128):
        assert plan.blocks >= 132 and plan.blocks <= resident * sms


# ---------------------------------------------------------------------------
# the MoE grouped matmul
# ---------------------------------------------------------------------------

def _gmm_inputs(gen, E, C, d, f, dt):
    """x ~ N(0, 1), w ~ N(0, 1/d): the model's magnitudes."""
    x = torch.randn(E, C, d, generator=gen, device="cuda").to(dt)
    w = (torch.randn(E, d, f, generator=gen, device="cuda")
         * d ** -0.5).to(dt)
    return x, w


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", [
    (4, 32, 64, 96), (2, 50, 48, 40), (8, 16, 128, 256),   # the JAX test's
    (64, 1, 2048, 1024), (64, 6, 2048, 1024), (64, 25, 2048, 1024),
    (64, 160, 1024, 2048), (3, 7, 24, 8), (5, 33, 40, 136), (2, 65, 8, 16),
])
def test_cuda_moe_gmm_matches_plain(cuda, dtype, E, C, d, f):
    """The kernel against its plain version: each C-tile size, ragged C,
    d and f, and a launch counted per call."""
    from repro_torch.kernels.moe_gmm import gmm_plain
    tol, dt = TOL[dtype], getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(E + C + d + f)
    x, w = _gmm_inputs(gen, E, C, d, f, dt)
    before = ops.LAUNCHES["moe_gmm"]
    got = ops.moe_gmm(x, w)
    assert ops.LAUNCHES["moe_gmm"] == before + 1
    want = gmm_plain(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (E, C, f)
    assert _err(got, want) <= tol, _err(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [6, 37, 160])
def test_cuda_moe_gmm_expert_stride_zero(cuda, dtype, T):
    """Dense mode's broadcast view [E, T, d] (expert stride 0) is read in
    place and gives the product of its copy; a strided w view too."""
    from repro_torch.kernels.moe_gmm import gmm_plain
    tol, dt = TOL[dtype], getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(T)
    x2d = torch.randn(T, 256, generator=gen, device="cuda").to(dt)
    wide = (torch.randn(8, 256, 2 * 128, generator=gen, device="cuda")
            / 16).to(dt)
    x, w = x2d.expand(8, T, 256), wide[:, :, 64:192]
    assert x.stride(0) == 0 and not w.is_contiguous()
    got = ops.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert _err(got, gmm_plain(x.contiguous(), w.contiguous())) <= tol
    assert torch.equal(got, ops.moe_gmm(x.contiguous(), w.contiguous()))


@pytest.mark.gpu
def test_cuda_moe_gmm_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 4, 12, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.moe_gmm(x, torch.zeros(2, 12, 8, device="cuda"))
    x = torch.zeros(2, 4, 16, device="cuda")
    with pytest.raises(ValueError, match="unit stride"):
        ops.moe_gmm(x, torch.zeros(2, 8, 16, device="cuda").transpose(1, 2))
    with pytest.raises(TypeError):
        ops.moe_gmm(x, torch.zeros(2, 16, 8, device="cuda",
                                   dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# the int8 attention entries (values with per-(position, head) scales)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hk,hd", HEADS)
def test_cuda_quant_kernels_match_plain(cuda, dtype, H, Hk, hd):
    """The int8 slab entries against their plain versions at the
    serving shapes (S_max 8192, ragged lengths to 8000, chunks at offsets
    0 and > 0), through a strided view of values and scales (every other
    KV head) and a permuted slot order, with a window."""
    tol, dt = TOL[dtype], getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(H + hd + 1)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    B, S = 6, 8192
    wk, wks = quantize_kv(rnd(B, S, 2 * Hk, hd))
    wv, wvs = quantize_kv(rnd(B, S, 2 * Hk, hd))
    for kq, ks, vq, vs in ((wk[:, :, :Hk].contiguous(),
                            wks[:, :, :Hk].contiguous(),
                            wv[:, :, :Hk].contiguous(),
                            wvs[:, :, :Hk].contiguous()),
                           (wk[:, :, ::2], wks[:, :, ::2], wv[:, :, ::2],
                            wvs[:, :, ::2])):
        q, lens = rnd(B, 1, H, hd), _i32([1, 37, 1000, 3500, 8000, 5000])
        assert _err(ops.flash_decode_quant(q, kq, ks, vq, vs, lens),
                    decode_attention_quant_plain(q, kq, ks, vq, vs,
                                                 lens)) <= tol
        for Sq, window in ((3, 0), (40, 0), (130, 48)):
            qo = _i32([0, 3000, 17])
            ln, slots = qo + Sq, _i32([5, 0, 2])
            qq = rnd(3, Sq, H, hd)
            got = ops.flash_prefill_quant(qq, kq, ks, vq, vs, qo, ln,
                                          window=window, slot_idx=slots)
            want = prefill_attention_quant_plain(qq, kq, ks, vq, vs, qo, ln,
                                                 window=window,
                                                 slot_idx=slots)
            assert _err(got, want) <= tol
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("page", [64, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hk,hd", HEADS)
def test_cuda_paged_quant_kernels_match_plain(cuda, page, dtype, H, Hk, hd):
    """The int8 paged entries against their plain versions at the
    serving shapes (8192 rows per table, lengths to 8000) through a
    shuffled table with shared pages, and against the int8 slab entries
    on the gathered rows."""
    tol, dt = TOL[dtype], getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(H + hd + page + 1)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    rng = np.random.default_rng(page + hd + 1)
    pmax = 8192 // page
    lens = [3500, 2 * page + 37, 1, 37, 8000, 5000]
    B = len(lens)
    P = B * pmax
    kq, ks = quantize_kv(rnd(P + 1, page, Hk, hd))
    vq, vs = quantize_kv(rnd(P + 1, page, Hk, hd))
    bt = torch.tensor(shared_tables(rng, lens, pmax, page, P), device="cuda")
    L = _i32(lens)
    q = rnd(B, 1, H, hd)
    got = ops.flash_decode_paged_quant(q, kq, ks, vq, vs, L, bt)
    assert _err(got, decode_attention_paged_quant_plain(
        q, kq, ks, vq, vs, L, bt)) <= tol
    g = [paged_gather(a, bt) for a in (kq, ks, vq, vs)]
    assert _err(got, ops.flash_decode_quant(q, *g, L)) <= tol
    for Sq, window in ((3, 0), (40, 0), (130, 48)):
        rows = _i32([5, 0, 1])
        qo = _i32([0, 3000, 17])
        ln = qo + Sq
        bt_m = bt[rows.long()].contiguous()
        qq = rnd(3, Sq, H, hd)
        got = ops.flash_prefill_paged_quant(qq, kq, ks, vq, vs, qo, ln, bt_m,
                                            window=window)
        want = prefill_attention_paged_quant_plain(qq, kq, ks, vq, vs, qo, ln,
                                                   bt_m, window=window)
        assert _err(got, want) <= tol
        slab = ops.flash_prefill_quant(qq, *g, qo, ln, window=window,
                                       slot_idx=rows)
        assert _err(got, slab) <= tol
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_quant_wrappers_reject_what_they_do_not_take(cuda):
    q = torch.zeros(2, 1, 4, 64, device="cuda")
    kq = torch.zeros(2, 32, 2, 64, dtype=torch.int8, device="cuda")
    ks = torch.ones(2, 32, 2, 1, device="cuda")
    L = _i32([3, 5])
    with pytest.raises(TypeError, match="int8"):
        ops.flash_decode_quant(q, kq.float(), ks, kq.float(), ks, L)
    with pytest.raises(TypeError, match="scales"):
        ops.flash_decode_quant(q, kq, ks.bfloat16(), kq, ks.bfloat16(), L)
    with pytest.raises(TypeError, match="scales"):
        ops.flash_decode_quant(q, kq, ks[..., :1, :], kq, ks[..., :1, :], L)
    wide = torch.zeros(2, 32, 2, 72, dtype=torch.int8, device="cuda")
    before = ops.LAUNCHES["flash_decode_quant"]
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_decode_quant(q, wide[..., 8:], ks, wide[..., 8:], ks, L)
    # the scales are read as scalars: a strided scale view is taken
    wks = torch.ones(2, 32, 4, 3, device="cuda")[..., ::2, :1]
    out = ops.flash_decode_quant(q, kq, wks, kq, wks, L)
    torch.cuda.synchronize()
    assert out.shape == q.shape
    assert ops.LAUNCHES["flash_decode_quant"] == before + 1


# ---------------------------------------------------------------------------
# whole-sequence flash attention (kernel 9) and its autograd Function
# ---------------------------------------------------------------------------

# (causal, window, Sq, Sk): ragged lengths that are no multiple of a tile
FLASH_CASES = [(True, 0, 1000, 1000), (True, 256, 1000, 1000),
               (False, 0, 700, 1000), (True, 0, 333, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hk,hd", HEADS)
def test_cuda_flash_attention_matches_plain(cuda, dtype, H, Hk, hd):
    """Kernel 9 against its plain version: causal, windowed, non-causal
    and Sq < Sk; the output and the row statistics m (1e-4) and l (1e-4
    relative), which the backward reads."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    tol, dt = TOL[dtype], getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(H + hd + 5)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    for causal, window, Sq, Sk in FLASH_CASES:
        q, k, v = rnd(2, Sq, H, hd), rnd(2, Sk, Hk, hd), rnd(2, Sk, Hk, hd)
        before = ops.LAUNCHES["flash_attention"]
        o, m, l = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert ops.LAUNCHES["flash_attention"] == before + 1
        po, pm, pl = flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
        torch.cuda.synchronize()
        assert o.dtype == dt and m.dtype == l.dtype == torch.float32
        assert _err(o, po) <= tol, (causal, window, _err(o, po))
        assert _err(m, pm) <= 1e-4
        assert ((l - pl).abs() / pl).max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hk,hd", [(15, 5, 64), (16, 2, 128)])
@pytest.mark.parametrize("window", [0, 64])
def test_cuda_flash_attention_grads_match_plain(cuda, H, Hk, hd, window):
    """The Function's dq, dk, dv on the card (kernel 9 forward, matmul
    backward) against autograd through the plain version, f32, 1e-4."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.attention import train_attention
    gen = torch.Generator(device="cuda").manual_seed(hd + window)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda")
    q, k, v, do = mk(2, 300, H, hd), mk(2, 300, Hk, hd), mk(2, 300, Hk, hd), \
        mk(2, 300, H, hd)
    got, want = [], []
    for fn, out in ((lambda *a: train_attention(*a, window=window), got),
                    (lambda *a: flash_attention_plain(
                        *a, window=window)[0], want)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fn(*leaves).backward(do)
        out.extend(x.grad for x in leaves)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _err(a, b) <= 1e-4, _err(a, b)


# ---------------------------------------------------------------------------
# sliding-window decode (the four decode entries)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [64, 1024])
@pytest.mark.parametrize("H,Hk,hd", HEADS)
def test_cuda_window_decode_matches_plain(cuda, dtype, window, H, Hk, hd):
    """Each decode entry with a window against its plain version: lengths
    1, below, at and above the window, slab and paged (page 64, shuffled
    tables with shared pages), bf16 values and int8 ones."""
    tol, dt = TOL[dtype], getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(H + hd + window)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    rng = np.random.default_rng(window + hd)
    page, S = 64, 2048
    lens = [1, window - 1, window, window + 1, 2000, 3 * window // 2 + 5]
    B, pmax = len(lens), S // page
    P = B * pmax
    L, q = _i32(lens), rnd(B, 1, H, hd)
    kc, vc = rnd(B, S, Hk, hd), rnd(B, S, Hk, hd)
    assert _err(ops.flash_decode(q, kc, vc, L, window=window),
                decode_attention_plain(q, kc, vc, L, window)) <= tol
    kq, ks = quantize_kv(kc)
    vq, vs = quantize_kv(vc)
    assert _err(ops.flash_decode_quant(q, kq, ks, vq, vs, L, window=window),
                decode_attention_quant_plain(q, kq, ks, vq, vs, L,
                                             window)) <= tol
    ka, va = rnd(P + 1, page, Hk, hd), rnd(P + 1, page, Hk, hd)
    bt = torch.tensor(shared_tables(rng, lens, pmax, page, P), device="cuda")
    assert _err(ops.flash_decode_paged(q, ka, va, L, bt, window=window),
                decode_attention_paged_plain(q, ka, va, L, bt,
                                             window)) <= tol
    kaq, kas = quantize_kv(ka)
    vaq, vas = quantize_kv(va)
    assert _err(ops.flash_decode_paged_quant(q, kaq, kas, vaq, vas, L, bt,
                                             window=window),
                decode_attention_paged_quant_plain(q, kaq, kas, vaq, vas, L,
                                                   bt, window)) <= tol
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_mixtral_smoke_window_decode_equals_cpu(cuda, paged):
    """The mixtral-8x22b smoke config (window 64) in f32: a 100-token
    prompt, then a 24-step decode megastep on the card and on the CPU
    from the same weights: equal tokens."""
    import dataclasses
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import (forward_decode_megastep, forward_prefill,
                                    init_cache, init_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                              kv_layout="paged" if paged else "slab",
                              kv_page_size=16)
    assert cfg.sliding_window == 64
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    runs = []
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        cache = init_cache(cfg, 2, 256, device=dev)
        i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)
        kw = {}
        if paged:
            kw["block_tables"] = torch.arange(
                2 * 16, dtype=torch.int32, device=dev).reshape(2, 16)
        logits, cache, lens = forward_prefill(p, cfg, toks.to(dev), cache,
                                              i32(0, 0), **kw)
        first = logits.argmax(-1).int()
        seq, _, _, _ = forward_decode_megastep(
            p, cfg, first, cache, lens, torch.ones(2, dtype=torch.bool,
                                                   device=dev),
            num_steps=24, **kw)
        runs.append(seq.cpu())
    assert torch.equal(runs[0], runs[1])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# the decode entries' split over fixed key chunks
# ---------------------------------------------------------------------------

from repro_torch.kernels.decode_attention import (  # noqa: E402
    DECODE_CHUNK, decode_merge_cuda, decode_merge_plain,
    decode_partials_plain)

# the card tests' heads and StarCoder2-15B's (48, 4, 128): query group 12
SPLIT_HEADS = HEADS + [(48, 4, 128)]


def _split_inputs(dt, Hk, hd, S, page, seed):
    """Slab caches [6, S, Hk, hd], their int8 form, and page arenas of
    ``page`` rows (with their int8 form) behind shuffled tables of S //
    page entries, rows 0 and 1 sharing pages."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    rng = np.random.default_rng(seed)
    B, pmax = 6, S // page
    P = B * pmax
    kc, vc = rnd(B, S, Hk, hd), rnd(B, S, Hk, hd)
    ka, va = rnd(P + 1, page, Hk, hd), rnd(P + 1, page, Hk, hd)
    bt = torch.tensor(shared_tables(rng, [S] * B, pmax, page, P),
                      device="cuda")
    return dict(slab=(kc, vc), quant=(*quantize_kv(kc), *quantize_kv(vc)),
                paged=(ka, va), paged_quant=(*quantize_kv(ka),
                                             *quantize_kv(va)), bt=bt)


def _split_entries(x, window):
    """name -> (kernel, plain version), each called as f(q, L, bt) with
    ``x`` from ``_split_inputs`` (bt: the block tables, unused by the slab
    entries)."""
    kc, vc = x["slab"]
    qv, pa, pq = x["quant"], x["paged"], x["paged_quant"]
    return {
        "flash_decode": (
            lambda q, L, bt: ops.flash_decode(q, kc, vc, L, window=window),
            lambda q, L, bt: decode_attention_plain(q, kc, vc, L, window)),
        "flash_decode_quant": (
            lambda q, L, bt: ops.flash_decode_quant(q, *qv, L,
                                                    window=window),
            lambda q, L, bt: decode_attention_quant_plain(q, *qv, L,
                                                          window)),
        "flash_decode_paged": (
            lambda q, L, bt: ops.flash_decode_paged(q, *pa, L, bt,
                                                    window=window),
            lambda q, L, bt: decode_attention_paged_plain(q, *pa, L, bt,
                                                          window)),
        "flash_decode_paged_quant": (
            lambda q, L, bt: ops.flash_decode_paged_quant(q, *pq, L, bt,
                                                          window=window),
            lambda q, L, bt: decode_attention_paged_quant_plain(
                q, *pq, L, bt, window)),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hk,hd", SPLIT_HEADS)
def test_cuda_split_decode_matches_plain(cuda, dtype, window, H, Hk, hd):
    """Each of the four decode entries against its plain version at
    lengths at the chunk edges and the full capacity (4 chunks), with and
    without a window, query groups 1 to 12."""
    tol, dt = TOL[dtype], getattr(torch, dtype)
    C, S, page = DECODE_CHUNK, 4 * DECODE_CHUNK, 64
    seed = H + Hk + hd + window
    x = _split_inputs(dt, Hk, hd, S, page, seed)
    L = _i32([1, C - 1, C, C + 1, 3 * C + 5, S])
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn(6, 1, H, hd, generator=gen, device="cuda").to(dt)
    for name, (kern, plain) in _split_entries(x, window).items():
        err = _err(kern(q, L, x["bt"]), plain(q, L, x["bt"]))
        assert err <= tol, (name, err)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hk,hd", [(16, 2, 128), (15, 5, 64),
                                     (48, 4, 128)])
def test_cuda_split_decode_is_batch_and_capacity_invariant(cuda, dtype,
                                                           window, H, Hk,
                                                           hd):
    """Each entry's output for a row is bitwise the same computed alone,
    in a batch of 6, and over a cache (or tables) of twice the
    capacity."""
    dt = getattr(torch, dtype)
    C, S, page = DECODE_CHUNK, 4 * DECODE_CHUNK, 16
    seed = 7 * H + hd + window
    x = _split_inputs(dt, Hk, hd, S, page, seed)
    big = dict(x)
    for key in ("slab", "quant"):
        big[key] = tuple(torch.cat([t, torch.zeros_like(t)], dim=1)
                         for t in x[key])
    scratch = x["paged"][0].shape[0] - 1
    big["bt"] = torch.cat([x["bt"], torch.full_like(x["bt"], scratch)],
                          dim=1)
    L = _i32([C + 1, 1, S, C - 1, 2 * C, 3 * C + 5])
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn(6, 1, H, hd, generator=gen, device="cuda").to(dt)
    small, large = _split_entries(x, window), _split_entries(big, window)
    for name in small:
        batch = small[name][0](q, L, x["bt"])
        over = large[name][0](q, L, big["bt"])
        assert torch.equal(over, batch), name
        for b in range(6):
            row = dict(x, bt=x["bt"][b:b + 1].contiguous())
            for key in ("slab", "quant"):
                row[key] = tuple(t[b:b + 1] for t in x[key])
            alone = _split_entries(row, window)[name][0](
                q[b:b + 1], L[b:b + 1], row["bt"])
            assert torch.equal(alone[0], batch[b]), (name, b)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_decode_merge_matches_plain(cuda, dtype, window, hd):
    """The decode merge kernel against its plain form on the partials of
    ``decode_partials_plain``, lengths at the chunk edges (empty chunks
    included)."""
    dt = getattr(torch, dtype)
    C, S, H, Hk = DECODE_CHUNK, 4 * DECODE_CHUNK, 12, 2
    gen = torch.Generator(device="cuda").manual_seed(hd + window)
    q = torch.randn(6, 1, H, hd, generator=gen, device="cuda")
    kc = torch.randn(6, S, Hk, hd, generator=gen, device="cuda")
    vc = torch.randn(6, S, Hk, hd, generator=gen, device="cuda")
    L = _i32([1, C - 1, C, C + 1, 3 * C + 5, S])
    part_o, part_ml = decode_partials_plain(q, kc, vc, L, window)
    got = decode_merge_cuda(part_o, part_ml, L, S, dt, window)
    want = decode_merge_plain(part_o, part_ml, L, S, dt, window)
    torch.cuda.synchronize()
    assert _err(got, want) <= TOL[dtype]


# ---------------------------------------------------------------------------
# the MoE grouped matmul on the tensor cores (bf16) and its tile plan
# ---------------------------------------------------------------------------

# (E, C, d, f, x through an expert-stride-0 view): OLMoE's up and down at
# each serving C (the up product at dense mode's C through the view),
# ragged C, d and f, two row groups (C > 256), one expert
GMM_TC_CASES = (
    [(64, C, 2048, 1024, C in (6, 160, 256)) for C in (1, 6, 25, 40, 160, 256)]
    + [(64, C, 1024, 2048, False) for C in (1, 6, 25, 40, 160, 256)]
    + [(4, 32, 64, 96, False), (2, 50, 48, 40, False), (3, 7, 24, 8, True),
       (5, 33, 40, 136, False), (2, 65, 8, 16, True), (3, 300, 24, 8, False),
       (2, 600, 136, 200, True), (1, 5, 64, 72, False)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f,bc", GMM_TC_CASES)
def test_cuda_moe_gmm_serving_shapes(cuda, dtype, E, C, d, f, bc):
    """bf16 (tensor cores) and f32 (CUDA cores) against the plain version
    at the serving shapes, ragged shapes and stride-0 views; one launch
    counted per call."""
    from repro_torch.kernels.moe_gmm import gmm_plain
    tol, dt = TOL[dtype], getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(3 * E + C + d + f)
    x, w = _gmm_inputs(gen, E, C, d, f, dt)
    if bc:
        x = x[0].expand(E, C, d)
    before = ops.LAUNCHES["moe_gmm"]
    got = ops.moe_gmm(x, w)
    assert ops.LAUNCHES["moe_gmm"] == before + 1
    want = gmm_plain(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (E, C, f)
    assert _err(got, want) <= tol, _err(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d,f", [(2048, 1024), (1024, 2048), (40, 136)])
def test_cuda_moe_gmm_rows_are_batch_invariant(cuda, d, f):
    """bf16: a row's output is the same bits at every C (the first c rows
    of a 256-row call run alone), and under a stride-0 view and its
    contiguous copy: the contraction order does not depend on C."""
    gen = torch.Generator(device="cuda").manual_seed(d + f)
    x, w = _gmm_inputs(gen, 8, 256, d, f, torch.bfloat16)
    full = ops.moe_gmm(x, w)
    for c in (1, 6, 25, 40, 160, 256):
        assert torch.equal(ops.moe_gmm(x[:, :c].contiguous(), w),
                           full[:, :c]), c
    view = x[0].expand(8, 256, d)
    assert torch.equal(ops.moe_gmm(view, w), ops.moe_gmm(view.contiguous(), w))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_moe_gmm_plan_matches_the_kernel(cuda):
    """``gmm_plan``'s shared-memory figure is the kernel's own, and every
    plan of a serving shape launches."""
    from repro_torch.kernels.moe_gmm import _entry, gmm_plan
    smem = _entry("moe_gmm_tc_smem")
    props = torch.cuda.get_device_properties(0)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    for C in (1, 6, 25, 40, 65, 160, 256, 300, 1000):
        plan = gmm_plan(64, C, 2048, 1024, torch.bfloat16)
        assert smem(plan.tiles, plan.stages) == plan.smem_bytes <= limit


@pytest.mark.gpu
def test_cuda_moe_gmm_tc_repeated_rows(cuda):
    """bf16: a view whose rows repeat (row stride 0; TMA takes no zero
    stride, so the wrapper copies it) gives its copy's and the plain
    version's result."""
    from repro_torch.kernels.moe_gmm import gmm_plain
    gen = torch.Generator(device="cuda").manual_seed(23)
    x, w = _gmm_inputs(gen, 4, 1, 64, 136, torch.bfloat16)
    rep = x.expand(4, 9, 64)
    assert rep.stride(1) == 0
    got = ops.moe_gmm(rep, w)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.moe_gmm(rep.contiguous(), w))
    assert _err(got, gmm_plain(rep, w)) <= TOL["bfloat16"]


# ---------------------------------------------------------------------------
# the int8 prefill entries with bf16 q: the tensor-core body on int8 tiles
# ---------------------------------------------------------------------------

def _int8_leaves(rnd, B, S, Hk, hd):
    """int8 values and bf16 scales of two [B, S, 2 Hk, hd] buffers: the
    contiguous first Hk heads, and every other head (a strided view)."""
    wk, wks = quantize_kv(rnd(B, S, 2 * Hk, hd))
    wv, wvs = quantize_kv(rnd(B, S, 2 * Hk, hd))
    wide = (wk, wks, wv, wvs)
    return ([x[:, :, :Hk].contiguous() for x in wide],
            [x[:, :, ::2] for x in wide])


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hk,hd", HEADS)
def test_cuda_int8_bf16_prefill_matches_plain(cuda, H, Hk, hd):
    """The int8 slab entry with bf16 q against its plain version on every
    chunk length of the serving path (spec-verify 1, 2 and 8 to 320-token
    chunks) at offsets 0, 3000 and 8000, windows 0 and 256, a permuted
    slot order, contiguous and strided value and scale views; the plan
    takes one split for the largest batch and many for the smallest; two
    calls give the same bits."""
    tol, dt = TOL["bfloat16"], torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(11 * H + hd)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    B, S = 4, PREFILL_S
    splits = set()
    for kv in _int8_leaves(rnd, B, S, Hk, hd):
        for Sq in PREFILL_SQ:
            for off in (0, 3000, 8000):
                for window in (0, 256):
                    qo = _i32(_prefill_rows(off))
                    ln, slots = qo + Sq, _i32([3, 0, 2])
                    qq = rnd(3, Sq, H, hd)
                    got = ops.flash_prefill_quant(qq, *kv, qo, ln,
                                                  window=window,
                                                  slot_idx=slots)
                    want = prefill_attention_quant_plain(
                        qq, *kv, qo, ln, window=window, slot_idx=slots)
                    assert _err(got, want) <= tol, (Sq, off, window)
                    splits.add(_splits(qq, Hk, S))
        qq = rnd(8, 320, H, hd)
        qo = _i32([0, 3000, 8000, 100, 5000, 64, 7000, 2500])
        ln, slots = qo + 320, _i32([0, 1, 2, 3, 3, 2, 1, 0])
        got = ops.flash_prefill_quant(qq, *kv, qo, ln, slot_idx=slots)
        assert _err(got, prefill_attention_quant_plain(
            qq, *kv, qo, ln, slot_idx=slots)) <= tol
        assert torch.equal(got, ops.flash_prefill_quant(qq, *kv, qo, ln,
                                                        slot_idx=slots))
        splits.add(_splits(qq, Hk, S))
    assert 1 in splits and max(splits) > 1, splits
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hk,hd", HEADS)
def test_cuda_int8_bf16_prefill_ignores_what_lies_past_the_length(cuda, H,
                                                                  Hk, hd):
    """NaN scales and garbage values at and past every row's length (in
    the last live tile and beyond) change nothing: the entry gives the
    plain version's answer on a copy zeroed there, at one split and at
    several."""
    tol, dt = TOL["bfloat16"], torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(13 * H + hd)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    kv, _ = _int8_leaves(rnd, 3, 2048, Hk, hd)
    for Sq, offs in ((1, [0, 37, 1500]), (8, [5, 700, 1990]),
                     (100, [0, 61, 1900]), (320, [0, 1000, 1700])):
        qo = _i32(offs)
        ln = qo + Sq
        bad = [x.clone() for x in kv]
        clean = [x.clone() for x in kv]
        for x, c in zip(bad, clean):
            for r, n in enumerate(ln.tolist()):
                x[r, n:] = 127 if x.dtype == torch.int8 else float("nan")
                c[r, n:] = 0
        qq = rnd(3, Sq, H, hd)
        got = ops.flash_prefill_quant(qq, *bad, qo, ln)
        assert torch.isfinite(got).all(), Sq
        assert _err(got, prefill_attention_quant_plain(qq, *clean, qo,
                                                       ln)) <= tol, Sq
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("page", [16, 64, 128])
@pytest.mark.parametrize("H,Hk,hd", HEADS)
def test_cuda_int8_bf16_prefill_paged_matches_plain(cuda, page, H, Hk, hd):
    """The int8 paged entry with bf16 q against its plain version and
    against the int8 slab entry on the gathered rows: pages of 16, 64 and
    128, shuffled tables in which two rows share pages and unmapped
    entries name the scratch page, every chunk length, windows 0 and
    256."""
    tol, dt = TOL["bfloat16"], torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(H + hd + page + 3)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    rng = np.random.default_rng(page + hd + 3)
    S = PREFILL_S
    pmax = S // page
    lens = [8000 + 320] * 3 + [100]
    P = len(lens) * pmax
    kq, ks = quantize_kv(rnd(P + 1, page, Hk, hd))
    vq, vs = quantize_kv(rnd(P + 1, page, Hk, hd))
    arenas = (kq, ks, vq, vs)
    bt = torch.tensor(shared_tables(rng, lens, pmax, page, P), device="cuda")
    lin = [paged_gather(a, bt) for a in arenas]
    for Sq in PREFILL_SQ:
        for off in (0, 3000, 8000):
            for window in (0, 256):
                rows = _i32([2, 0, 1])
                qo = _i32(_prefill_rows(off))
                ln = qo + Sq
                bt_m = bt[rows.long()].contiguous()
                qq = rnd(3, Sq, H, hd)
                got = ops.flash_prefill_paged_quant(qq, *arenas, qo, ln, bt_m,
                                                    window=window)
                want = prefill_attention_paged_quant_plain(
                    qq, *arenas, qo, ln, bt_m, window=window)
                assert _err(got, want) <= tol, (Sq, off, window)
                slab = ops.flash_prefill_quant(qq, *lin, qo, ln,
                                               window=window, slot_idx=rows)
                assert _err(got, slab) <= tol, (Sq, off, window)
    assert torch.equal(got, ops.flash_prefill_paged_quant(
        qq, *arenas, qo, ln, bt_m, window=window))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the speculative decode step: card == CPU
# ---------------------------------------------------------------------------

def _spec_cfg(family, layout):
    from repro_torch.configs.base import ModelConfig, SSMConfig
    kw = dict(name=f"spec-{family}-card", family=family, num_layers=2,
              d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
              vocab_size=512, source="test", kv_layout=layout,
              kv_page_size=64)
    if family == "hybrid":
        kw.update(ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                head_dim=32, chunk_size=32),
                  hybrid_period=2, hybrid_attn_index=0)
    return ModelConfig(**kw)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_cuda_forward_spec_step_matches_cpu(cuda, family, layout):
    """``forward_spec_step`` in f32 on the card (kernel 1 or 4 at Sq = k,
    kernel 7 on the hybrid) against the same step on the CPU (their
    plain versions): tokens, accepts, next tokens, lengths and history
    exact; the cache below the scratch row and page within 1e-4, the
    Mamba-2 states within 2e-4.  Lane 0's history proposes the model's
    own greedy continuation, lane 2 is inactive."""
    import repro_torch.models as tm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _spec_cfg(family, layout)
    B, S, P, k = 4, 256, 40, 4
    V = cfg.vocab_size
    params = tm.init_params(cfg, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    prompt = torch.tensor(rng.integers(0, V, (B, P)), dtype=torch.int32)
    pmax = S // cfg.kv_page_size
    bt = (None if layout == "slab" else torch.tensor(
        rng.permutation(B * pmax).reshape(B, pmax), dtype=torch.int32))

    def prefilled(dev):
        p = _tree_to(params, dev)
        kw = {} if bt is None else {"block_tables": bt.to(dev)}
        cache = tm.init_cache(cfg, B, S, device=dev)
        logits, cache, _ = tm.forward_prefill(
            p, cfg, prompt.to(dev), cache,
            torch.zeros(B, dtype=torch.int32, device=dev), **kw)
        return p, cache, logits, kw

    p, cache, logits, kw = prefilled("cpu")
    tokens = logits.argmax(-1).to(torch.int32)
    lengths = torch.full((B,), P, dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    cont, *_ = tm.forward_decode_megastep(
        p, cfg, tokens, _tree_to(cache, "cpu"), lengths,
        torch.ones(B, dtype=torch.bool), num_steps=k, **kw)
    hist = torch.zeros((B, S), dtype=torch.int32)
    hist[:, :P] = prompt
    hist[0, 2:4] = prompt[0, P - 2:]
    hist[0, 4] = tokens[0]
    hist[0, 5:4 + k] = cont[:k - 1, 0]
    out = {}
    for dev in ("cpu", "cuda"):
        p, cache, _, kw = prefilled(dev)
        out[dev] = tm.forward_spec_step(
            p, cfg, hist.to(dev, copy=True), tokens.to(dev), cache,
            lengths.to(dev), active.to(dev), num_draft=k, **kw)
    torch.cuda.synchronize()
    (ct, cacc, cnt, ch, cc, clen), (gt, gacc, gnt, gh, gc, glen) = (
        out["cpu"], out["cuda"])
    assert int(cacc[0]) == k and int(cacc[2]) == 0
    for a, b in ((ct, gt), (cacc, gacc), (cnt, gnt), (clen, glen)):
        assert torch.equal(a, b.cpu())
    assert torch.equal(ch[:, :-1], gh.cpu()[:, :-1])
    for name, layer in cc.items():
        for leaf, a in layer.items():
            b = gc[name][leaf].cpu()
            if leaf in ("k", "v"):
                # all but the scratch row (slab) or scratch page (paged)
                a, b = (a[:, :, :-1], b[:, :, :-1]) if bt is None else (
                    a[:, :-1], b[:, :-1])
                assert _err(a, b) <= 1e-4, (name, leaf)
            else:
                assert _err(a, b) <= 2e-4, (name, leaf)
