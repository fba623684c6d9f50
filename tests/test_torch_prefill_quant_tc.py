"""The int8 chunk-prefill entries' tensor-core arithmetic, on the CPU.

With bf16 q, ``flash_prefill_quant`` and ``flash_prefill_paged_quant`` run
the bf16 tensor-core body of ``csrc/prefill_attention.cu`` on int8 tiles:
each int8 value becomes a bf16 value exactly, S = (q . Kq) * ks in f32,
P is taken against the running max tile by tile, the row sum l sums the
unscaled P, and P V takes bf16(P * vs); keys at or past a row's length
get value 0 and scale 0.  That order is written out here in PyTorch
(``tc_quant_emulation``) and held, at the bf16 tolerance 2e-2, against
the JAX Pallas kernels 5 and 6 (``flash_prefill_quant_bhsd``,
``flash_prefill_paged_quant_bhsd``) in interpret mode and against the
port's plain versions: query groups 8, 3 and 1, Sq 1, 8 and 64, a
window, and last tiles that run past the length, with NaN scales there.

The wrappers' plumbing is checked without a card: the int8 entries get
the bf16 entries' split count at the same shapes, f32 one split, and the
maps' outer extents.  The layout TMA reads the int8 value leaves in is
checked on CPU tensors' metadata.  The kernel itself runs on the card
only: tests/test_torch_gpu.py holds it against the plain versions.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import prefill_attention as pa  # noqa: E402
from repro_torch.kernels.decode_attention import paged_gather  # noqa: E402
from repro_torch.models.attention import quantize_kv  # noqa: E402

BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def _quant(rng, *shape):
    """int8 values and bf16 scales of an N(0, 1) tensor made with numpy."""
    x = torch.tensor(rng.standard_normal(shape).astype(np.float32))
    return quantize_kv(x.to(torch.bfloat16))


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def tc_quant_emulation(q, kq, ks, vq, vs, q_offset, lengths, *, window=0,
                       slot_idx=None):
    """The int8 tensor-core body's arithmetic in PyTorch: q [M, Sq, H, hd]
    bf16; kq/vq int8 and ks/vs bf16 [B, S, Hk, *]; one split, key tiles of
    ``pa.KEY_TILE``, scores in log2 units -> [M, Sq, H, hd] bf16."""
    M, Sq, H, hd = q.shape
    S, Hk = kq.shape[1], kq.shape[2]
    G = H // Hk
    c = math.log2(math.e) / math.sqrt(hd)
    rows = slot_idx.long() if slot_idx is not None else torch.arange(M)
    out = torch.empty(M, Sq, H, hd)
    for m in range(M):
        L, off = min(int(lengths[m]), S), int(q_offset[m])
        r = int(rows[m])
        live = torch.arange(S) < L
        # past the length: value 0 and scale 0, whatever the cache holds
        kf = torch.where(live[:, None, None], kq[r].float(), 0.0)
        vf = torch.where(live[:, None, None], vq[r].float(), 0.0)
        ksf = torch.where(live[:, None], ks[r, :, :, 0].float(), 0.0)
        vsf = torch.where(live[:, None], vs[r, :, :, 0].float(), 0.0)
        qg = q[m].float().reshape(Sq, Hk, G, hd)
        q_pos = off + torch.arange(Sq)[:, None, None, None]
        mx = torch.full((Sq, Hk, G, 1), pa.NEG_INF)
        lsum = torch.zeros(Sq, Hk, G, 1)
        acc = torch.zeros(Sq, Hk, G, hd)
        for k0 in range(0, -(-L // pa.KEY_TILE) * pa.KEY_TILE, pa.KEY_TILE):
            keys = torch.arange(k0, k0 + pa.KEY_TILE)
            keys = keys[keys < S]
            s = torch.einsum("ihgd,khd->ihgk", qg, kf[keys])
            s = s * (ksf[keys].T[None, :, None, :] * c)
            ok = (keys < L) & (keys <= q_pos)
            if window > 0:
                ok = ok & (keys > q_pos - window)
            s = torch.where(ok, s, torch.tensor(pa.NEG_INF))
            m_new = torch.maximum(mx, s.amax(dim=-1, keepdim=True))
            corr = torch.exp2(mx - m_new)
            p = torch.exp2(s - m_new)
            lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
            pv = (p * vsf[keys].T[None, :, None, :]).to(torch.bfloat16).float()
            acc = acc * corr + torch.einsum("ihgk,khd->ihgd", pv, vf[keys])
            mx = m_new
        out[m] = (acc / lsum.clamp_min(1e-30)).reshape(Sq, H, hd)
    return out.to(torch.bfloat16)


def _poison_past_length(leaves, lengths, rows):
    """Copies of (kq, ks, vq, vs) with garbage values and NaN scales at
    and past each row's length in the cache rows it reads."""
    out = [x.clone() for x in leaves]
    for x in out:
        for r, n in zip(rows, lengths):
            x[int(r), int(n):] = 127 if x.dtype == torch.int8 else float("nan")
    return out


# (H, Hk, hd, Sq, q_offset per row, window): query groups 8, 3 and 1;
# every row's last tile runs past its length
SLAB_CASES = {
    "g8-Sq64": (16, 2, 128, 64, [0, 100], 0),
    "g8-Sq1": (16, 2, 128, 1, [5, 190], 0),
    "g8-Sq8-window": (16, 2, 128, 8, [130, 61], 40),
    "g3-Sq8": (15, 5, 64, 8, [37, 150], 0),
    "g3-Sq64-window": (15, 5, 64, 64, [120, 3], 48),
    "g1-Sq64": (16, 16, 128, 64, [0, 70], 0),
    "g1-Sq1-window": (16, 16, 128, 1, [200, 9], 16),
}


@pytest.mark.parametrize("case", list(SLAB_CASES))
def test_tc_quant_arithmetic_matches_jax_kernel_and_plain(case):
    """The emulated tensor-core order against the JAX kernel 5 (interpret
    mode) and the plain version on the rows it reads through slot_idx, and
    the same answer with NaN scales past every row's length."""
    H, Hk, hd, Sq, qoff, window = SLAB_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    S = 256
    kq, ks = _quant(rng, 3, S, Hk, hd)
    vq, vs = _quant(rng, 3, S, Hk, hd)
    q = _t(rng.standard_normal((2, Sq, H, hd)).astype(np.float32)).to(
        torch.bfloat16)
    qoff = _t(np.asarray(qoff, np.int32))
    lens = qoff + Sq
    rows = _t(np.asarray([2, 0], np.int32))
    got = tc_quant_emulation(q, kq, ks, vq, vs, qoff, lens, window=window,
                             slot_idx=rows)
    r = rows.long()
    want = jops.flash_prefill_quant(
        jnp.asarray(_np(q)), *(jnp.asarray(_np(x[r]))
                               for x in (kq, ks, vq, vs)),
        jnp.asarray(qoff.numpy()), jnp.asarray(lens.numpy()), window=window,
        interpret=True)
    assert np.abs(got.float().numpy() - np.asarray(want)).max() <= BF16_TOL
    plain = ops.flash_prefill_quant(q, kq, ks, vq, vs, qoff, lens,
                                    window=window, slot_idx=rows)
    assert (got.float() - plain.float()).abs().max().item() <= BF16_TOL
    bad = _poison_past_length((kq, ks, vq, vs), lens, rows)
    again = tc_quant_emulation(q, *bad, qoff, lens, window=window,
                               slot_idx=rows)
    assert torch.equal(again, got)


@pytest.mark.parametrize("page,H,Hk,hd,Sq,window", [
    (32, 16, 2, 128, 8, 0), (16, 15, 5, 64, 64, 40), (32, 16, 16, 128, 1, 0)])
def test_tc_quant_arithmetic_paged_matches_jax_kernel(page, H, Hk, hd, Sq,
                                                      window):
    """The emulated order on the rows gathered through shuffled tables
    (two rows share pages; unmapped entries name the scratch page) against
    the JAX kernel 6 in interpret mode and the port's paged plain
    version."""
    rng = np.random.default_rng(page + H + Sq + window)
    pmax = 128 // page
    qoff = np.asarray([2 * page - 3, 0, 61], np.int32)
    lens = (qoff + Sq).astype(np.int32)
    P = 3 * pmax
    kq, ks = _quant(rng, P + 1, page, Hk, hd)
    vq, vs = _quant(rng, P + 1, page, Hk, hd)
    perm = rng.permutation(P)
    bt = np.full((3, pmax), P, np.int32)
    nxt = 0
    for r, n in enumerate(np.maximum(lens, 2 * page)):
        need = -(-int(n) // page)
        bt[r, :need] = perm[nxt:nxt + need]
        nxt += need
    bt[1, :2] = bt[0, :2]
    q = _t(rng.standard_normal((3, Sq, H, hd)).astype(np.float32)).to(
        torch.bfloat16)
    arenas = (kq, ks, vq, vs)
    lin = [paged_gather(a, _t(bt)) for a in arenas]
    got = tc_quant_emulation(q, *lin, _t(qoff), _t(lens), window=window)
    want = jops.flash_prefill_paged_quant(
        jnp.asarray(_np(q)), *(jnp.asarray(_np(a)) for a in arenas),
        jnp.asarray(qoff), jnp.asarray(lens), jnp.asarray(bt),
        window=window, interpret=True)
    assert np.abs(got.float().numpy() - np.asarray(want)).max() <= BF16_TOL
    plain = ops.flash_prefill_paged_quant(q, *arenas, _t(qoff), _t(lens),
                                          _t(bt), window=window)
    assert (got.float() - plain.float()).abs().max().item() <= BF16_TOL


# ---------------------------------------------------------------------------
# the wrappers' plan, without a card
# ---------------------------------------------------------------------------

def _launches(monkeypatch):
    """Record what the prefill wrappers hand to the C entries, on a card
    of 132 SMs, instead of launching."""
    calls = []
    monkeypatch.setattr(pa, "_sm_count", lambda device: 132)
    monkeypatch.setattr(pa, "_launch", lambda entry, q, leaves, index, ints,
                        splits=None: calls.append((entry, ints, splits)))
    return calls


@pytest.mark.parametrize("M,Sq,H,Hk,hd", [
    (1, 160, 16, 2, 128), (4, 64, 16, 2, 128), (3, 2, 16, 2, 128),
    (3, 8, 15, 5, 64), (2, 56, 16, 16, 128), (6, 320, 16, 2, 128)])
def test_int8_entries_take_the_bf16_split_plan(monkeypatch, M, Sq, H, Hk,
                                               hd):
    """At each shape the int8 slab and paged entries get the split count
    of the bf16 entries (``prefill_splits`` of the same static shapes);
    f32 q runs unsplit; the maps' outer extent (cache rows or physical
    pages) ends the ints as for bf16."""
    calls = _launches(monkeypatch)
    S, page, B = 8192, 64, 6
    pmax, P = S // page, B * (S // page) + 1
    idx = torch.zeros(M, dtype=torch.int32)
    bt = torch.zeros(M, pmax, dtype=torch.int32)
    kc = torch.zeros(B, S, Hk, hd, dtype=torch.bfloat16)
    ka = torch.zeros(P, page, Hk, hd, dtype=torch.bfloat16)
    kq = torch.zeros(B, S, Hk, hd, dtype=torch.int8)
    ksc = torch.zeros(B, S, Hk, 1, dtype=torch.bfloat16)
    aq = torch.zeros(P, page, Hk, hd, dtype=torch.int8)
    asc = torch.zeros(P, page, Hk, 1, dtype=torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(M, Sq, H, hd, dtype=dtype)
        calls.clear()
        pa.prefill_attention_cuda(q, kc, kc, idx, idx, slot_idx=idx)
        pa.prefill_attention_paged_cuda(q, ka, ka, idx, idx, bt)
        pa.prefill_attention_quant_cuda(q, kq, ksc.to(dtype), kq,
                                        ksc.to(dtype), idx, idx, slot_idx=idx)
        pa.prefill_attention_paged_quant_cuda(q, aq, asc.to(dtype), aq,
                                              asc.to(dtype), idx, idx, bt)
        entries = [c[0] for c in calls]
        assert entries == ["flash_prefill", "flash_prefill_paged",
                           "flash_prefill_quant", "flash_prefill_paged_quant"]
        want = (pa.prefill_splits(M, Sq, Hk, H // Hk, S, 132)
                if dtype == torch.bfloat16 else 1)
        assert [c[2] for c in calls] == [want] * 4
        assert calls[2][1] == calls[0][1] and calls[3][1] == calls[1][1]
        assert calls[2][1][-1] == B and calls[3][1][-1] == P


# ---------------------------------------------------------------------------
# the layout TMA reads the int8 value leaves in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 128])
def test_tma_layout_of_int8_value_leaves(hd):
    """The int8 value leaves pass: a contiguous slab, every other KV head
    of a wider buffer (a head stride of 2 hd bytes, as the strided parity
    views), a slot stripe and a page arena.  A view whose base is off 16
    bytes raises.  The scale leaves [.., Hk, 1] (a position stride of 2 Hk
    bytes) would not pass, which is why the kernel reads them by plain
    loads."""
    Hk = 2
    wide = torch.zeros(3, 256, 2 * Hk, hd, dtype=torch.int8)
    for ok in (wide[:, :, :Hk].contiguous(), wide[:, :, ::2], wide[1:],
               torch.zeros(17, 64, Hk, hd, dtype=torch.int8)):
        pa.check_tma_layout(ok, "flash_prefill_quant")
    flat = torch.zeros(3 * 256 * Hk * hd + 16, dtype=torch.int8)
    for shift in (1, 8):
        off = flat[shift:shift + 3 * 256 * Hk * hd].view(3, 256, Hk, hd)
        with pytest.raises(ValueError, match="16 bytes"):
            pa.check_tma_layout(off, "flash_prefill_quant")
    with pytest.raises(ValueError, match="16 bytes"):
        pa.check_tma_layout(wide[..., 8:], "flash_prefill_quant")
    _, scales = quantize_kv(torch.zeros(3, 256, Hk, hd, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="16 bytes"):
        pa.check_tma_layout(scales, "flash_prefill_quant")
