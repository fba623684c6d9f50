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
from repro_torch.kernels.prefill_attention import (  # noqa: E402
    prefill_attention_paged_plain, prefill_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_inputs  # noqa: E402

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
