"""The bf16 chunk-prefill kernel's split key range, on the CPU.

The tensor-core kernel of ``csrc/prefill_attention.cu`` cuts each block's
live key tiles into consecutive shares, one per split, and a second
kernel merges the splits' partial softmax states.  Here the plan
(``tile_bounds``, ``split_share``, ``prefill_splits``) is held against the
TPU kernel's ``_tile_bounds``, and the merge's plain form
(``merge_partials_plain``) over per-split partials against the one-pass
plain version and the JAX Pallas kernels in interpret mode (f32, 3e-5 as
tests/test_kernels.py).  The layout TMA needs is checked on CPU tensors'
metadata.  The kernels themselves run on the card only:
tests/test_torch_gpu.py holds them against these plain forms.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _hyp import given, settings, st  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.prefill_attention import _tile_bounds  # noqa: E402
from test_hotpath_parity import PREFILL_CASES  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.prefill_attention import (  # noqa: E402
    KEY_TILE, MAX_SPLITS, NEG_INF, TILE_ROWS, check_tma_layout,
    merge_partials_plain, prefill_attention_plain, prefill_splits,
    split_share, tile_bounds)

F32 = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def split_partials(q, k, v, q_offset, lengths, splits: int, window: int = 0):
    """What the kernel writes to its scratch, in plain PyTorch: for each
    (row m, query tile, split s), softmax state of the split's share of
    the tile's live keys -- the unnormalised f32 accumulator and (m, l),
    m in log2 units; an empty share leaves (-1e30, 0, 0).  k/v: [M, S,
    Hk, hd], row m's cache rows."""
    M, Sq, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qpt = TILE_ROWS // G
    c = math.log2(math.e) / math.sqrt(hd)
    part_o = torch.zeros(splits, M, Sq, H, hd)
    part_ml = torch.zeros(splits, M, Sq, H, 2)
    part_ml[..., 0] = NEG_INF
    for m in range(M):
        L, off = min(int(lengths[m]), S), int(q_offset[m])
        for i_lo in range(0, Sq, qpt):
            i_hi = min(i_lo + qpt, Sq)
            first, live = tile_bounds(off, L, i_lo, i_hi, window)
            for s in range(splits):
                lo, hi = split_share(first, live, splits, s)
                if lo == hi:
                    continue
                keys = torch.arange(lo * KEY_TILE, min(hi * KEY_TILE, L))
                n = i_hi - i_lo
                qs = q[m, i_lo:i_hi].float().reshape(n, Hk, G, hd)
                sc = torch.einsum("ihgd,khd->ihgk", qs, k[m, keys].float()) * c
                q_pos = off + torch.arange(i_lo, i_hi)[:, None]
                ok = keys[None, :] <= q_pos
                if window > 0:
                    ok = ok & (keys[None, :] > q_pos - window)
                sc = torch.where(ok[:, None, None], sc, torch.tensor(NEG_INF))
                mx = sc.max(dim=-1).values
                p = torch.exp2(sc - mx[..., None])
                o = torch.einsum("ihgk,khd->ihgd", p, v[m, keys].float())
                part_o[s, m, i_lo:i_hi] = o.reshape(n, H, hd)
                part_ml[s, m, i_lo:i_hi, :, 0] = mx.reshape(n, H)
                part_ml[s, m, i_lo:i_hi, :, 1] = p.sum(dim=-1).reshape(n, H)
    return part_o, part_ml


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None, database=None)
@given(st.integers(1, 3), st.integers(1, 130),
       st.sampled_from([1, 2, 3, 4, 7, 8, 16, 64]),
       st.lists(st.integers(0, 3000), min_size=3, max_size=3),
       st.lists(st.integers(0, 200), min_size=3, max_size=3),
       st.sampled_from([0, 1, 63, 64, 256, 1000]), st.integers(1, MAX_SPLITS))
def test_split_plan_covers_each_live_tile_once_in_order(M, Sq, G, offs, extra,
                                                         window, splits):
    """For every block (row, query tile), the live tiles are those of the
    TPU kernel's ``_tile_bounds`` (on a query tile clipped at the chunk's
    end, as the kernel clips it), and the splits' shares, in split order,
    are exactly those tiles: none twice, none missed, none out of order."""
    qpt = TILE_ROWS // G
    offs = np.asarray(offs[:M], np.int32)
    for m in range(M):
        length = int(offs[m]) + Sq + extra[m]
        for i_lo in range(0, Sq, qpt):
            i_hi = min(i_lo + qpt, Sq)
            first, live = tile_bounds(int(offs[m]), length, i_lo, i_hi, window)
            clipped = np.asarray([min(length, int(offs[m]) + i_hi)], np.int32)
            jf, jl = _tile_bounds(offs[m:m + 1], clipped, 0, i_lo // qpt,
                                  block_q=qpt, block_k=KEY_TILE, causal=True,
                                  window=window)
            assert (first, first + live - 1) == (int(jf), int(jl))
            tiles = []
            for s in range(splits):
                lo, hi = split_share(first, live, splits, s)
                assert lo <= hi
                tiles.extend(range(lo, hi))
            assert tiles == list(range(first, first + live))


def test_split_count_is_a_function_of_static_shapes():
    """At most two blocks per SM on the 132 SMs of an H100: the cold
    chunk (1 x 160 tokens, 16/2 heads) takes 6 splits of its 40 blocks,
    the resume batch (4 x 64) 4 of its 64, and a batch that fills the
    card alone one; never more splits than the cache has tiles or
    ``MAX_SPLITS``."""
    assert prefill_splits(1, 160, 2, 8, 8192, 132) == 6
    assert prefill_splits(4, 64, 2, 8, 8192, 132) == 4
    assert prefill_splits(6, 320, 2, 8, 8192, 132) == 1
    assert prefill_splits(3, 320, 2, 8, 8192, 132) == 1
    assert prefill_splits(1, 1, 2, 8, 8192, 132) == MAX_SPLITS
    assert prefill_splits(1, 1, 2, 8, 100, 132) == 2
    for args in ((1, 160, 2, 8), (4, 64, 2, 8), (2, 8, 16, 1), (1, 56, 5, 3)):
        blocks = -(-args[1] // (TILE_ROWS // args[3])) * args[2] * args[0]
        assert prefill_splits(*args, 8192, 132) * blocks <= max(264, blocks)
    for M in range(1, 9):
        assert prefill_splits(M + 1, 64, 2, 8, 8192, 132) <= \
            prefill_splits(M, 64, 2, 8, 8192, 132)


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("splits", [1, 3, 7])
def test_merge_of_split_partials_matches_one_pass_softmax(splits, G, window):
    """``merge_partials_plain`` over the splits' partials, empty shares
    included (7 splits of at most 5 live tiles), equals the one-pass
    plain version."""
    M, Sq, Hk, hd, S = 3, 70, 2, 16, 320
    rng = np.random.default_rng(100 * splits + 10 * G + window)
    q = _t(rng.standard_normal((M, Sq, G * Hk, hd)).astype(np.float32))
    k = _t(rng.standard_normal((M, S, Hk, hd)).astype(np.float32))
    v = _t(rng.standard_normal((M, S, Hk, hd)).astype(np.float32))
    qo = _t(np.asarray([0, 100, 250], np.int32))
    ln = qo + Sq
    part_o, part_ml = split_partials(q, k, v, qo, ln, splits, window)
    if splits == 7:
        assert (part_ml[..., 0] == NEG_INF).any()        # empty shares
    got = merge_partials_plain(part_o, part_ml, torch.float32)
    want = prefill_attention_plain(q, k, v, qo, ln, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


def _paged(kc, vc, page, rng):
    """The slab rows kc/vc [B, S, Hk, hd] in a shuffled arena of pages
    (the last page is scratch) and their block tables [B, S / page]."""
    B, S = kc.shape[:2]
    pmax = S // page
    perm = rng.permutation(B * pmax)
    ka = np.zeros((B * pmax + 1, page) + kc.shape[2:], np.float32)
    va = np.zeros_like(ka)
    bt = perm.reshape(B, pmax).astype(np.int32)
    for b in range(B):
        for j in range(pmax):
            ka[bt[b, j]] = kc[b, j * page:(j + 1) * page]
            va[bt[b, j]] = vc[b, j * page:(j + 1) * page]
    return ka, va, bt


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_merge_of_split_partials_matches_jax_kernels(case, layout):
    """The merged splits equal the JAX Pallas kernels
    ``flash_prefill_bhsd`` (slab) and ``flash_prefill_paged_bhsd`` (pages
    of 32, shuffled) in interpret mode on every serving case, 3 and 5
    splits."""
    H, Hk, Sq, window, qoff, lens = PREFILL_CASES[case]
    S, hd, B = 256, 32, 3
    rng = np.random.default_rng(sum(map(ord, case)) + len(layout))
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hk, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hk, hd)).astype(np.float32)
    qoff, lens = np.asarray(qoff, np.int32), np.asarray(lens, np.int32)
    if layout == "slab":
        splits = 3
        want = jops.flash_prefill(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(qoff),
                                  jnp.asarray(lens), window=window,
                                  block_q=32, block_k=32, interpret=True)
    else:
        splits = 5
        ka, va, bt = _paged(kc, vc, 32, rng)
        want = jops.flash_prefill_paged(jnp.asarray(q), jnp.asarray(ka),
                                        jnp.asarray(va), jnp.asarray(qoff),
                                        jnp.asarray(lens), jnp.asarray(bt),
                                        window=window, block_q=32,
                                        interpret=True)
        # the port's paged plain version reads the same rows
        np.testing.assert_allclose(
            ops.flash_prefill_paged(_t(q), _t(ka), _t(va), _t(qoff),
                                    _t(lens), _t(bt), window=window).numpy(),
            np.asarray(want), **F32)
    part_o, part_ml = split_partials(_t(q), _t(kc), _t(vc), qoff, lens,
                                     splits, window)
    got = merge_partials_plain(part_o, part_ml, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# the layout TMA reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_tma_layout_check_on_tensor_metadata(dtype):
    """Caches TMA can read pass: contiguous, every other KV head of a
    wider buffer, a slot stripe; a base off 16 bytes, a head stride that
    is not whole 16 bytes, or hd not innermost raise ``ValueError``."""
    es = torch.empty((), dtype=dtype).element_size()
    wide = torch.zeros(4, 128, 4, 64, dtype=dtype)
    for ok in (wide, wide[:, :, ::2], wide[1:3], wide[:, 64:]):
        check_tma_layout(ok, "flash_prefill")
    flat = torch.zeros(4 * 128 * 2 * 64 + 16, dtype=dtype)
    off = flat[1:1 + 4 * 128 * 2 * 64].view(4, 128, 2, 64)
    odd_head = torch.zeros(4, 128, 2, 64 + 16 // es + 1, dtype=dtype)[..., :64]
    for bad in (off, odd_head, wide[..., :2, :].transpose(2, 3)):
        with pytest.raises(ValueError, match="16 bytes"):
            check_tma_layout(bad, "flash_prefill")
