"""The flash-decode kernels' split over fixed key chunks, on the CPU.

The kernels of ``csrc/decode_attention.cu`` cut each row's keys into
chunks of ``DECODE_CHUNK`` keys counted from the cache's static capacity
(``decode_chunks``), give each (chunk, KV head, head group, row) a block,
and merge a row's chunks in chunk order.  Here the plan, the chunks'
partial softmax states (``decode_partials_plain``) merged by
``decode_merge_plain``, and query groups above 8 are held against the
one-pass plain version, the JAX Pallas kernels in interpret mode and the
JAX XLA decode (f32, 3e-5 as tests/test_kernels.py).  The Pallas kernels
take no window, so windowed cases are held against the XLA
``decode_attention``'s window branch.  The kernels themselves run on the
card only: tests/test_torch_gpu.py holds them against these plain forms.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _hyp import given, settings, st  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.attention import (  # noqa: E402
    decode_attention as j_decode, decode_attention_paged as j_decode_paged)

from repro_torch.kernels.decode_attention import (  # noqa: E402
    DECODE_CHUNK, NEG_INF, decode_attention_paged_plain,
    decode_attention_plain, decode_attention_quant_plain, decode_chunks,
    decode_merge_plain, decode_partials_plain, paged_gather)
from repro_torch.kernels.prefill_attention import (  # noqa: E402
    merge_partials_plain)
from repro_torch.models.attention import (  # noqa: E402
    decode_attention, decode_attention_paged, quantize_kv)

F32 = dict(rtol=3e-5, atol=3e-5)
C = DECODE_CHUNK
S = 2 * C                      # the cache's capacity in these tests
# lengths at the chunk edges and the full capacity
LENS = [1, C - 1, C, C + 1, S]
HK, HD = 2, 32


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port_out, jax_out):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), **F32)


def split_decode(q, k, v, lengths, window=0):
    """The kernels' function in plain PyTorch: partials per chunk, then
    the merge."""
    return decode_merge_plain(*decode_partials_plain(q, k, v, lengths,
                                                     window),
                              lengths, k.shape[1], q.dtype, window)


def _inputs(seed, G, rows=len(LENS), cap=S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, 1, G * HK, HD)).astype(np.float32)
    kc = rng.standard_normal((rows, cap, HK, HD)).astype(np.float32)
    vc = rng.standard_normal((rows, cap, HK, HD)).astype(np.float32)
    return q, kc, vc


def shuffled_tables(rng, rows: int, pmax: int):
    """Block tables [rows, pmax] over a shuffled arena of rows * pmax
    pages, rows 0 and 1 sharing their first page."""
    bt = rng.permutation(rows * pmax).astype(np.int32).reshape(rows, pmax)
    bt[1, 0] = bt[0, 0]
    return bt


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(cap=st.integers(1, 1 << 17), tiles=st.integers(1, 64))
def test_chunk_plan_covers_the_capacity(cap, tiles):
    """The chunk count is a function of the static capacity alone: the
    fewest chunks of ``chunk`` keys that cover ``cap`` rows."""
    chunk = 32 * tiles
    n = decode_chunks(cap, chunk)
    assert (n - 1) * chunk < cap <= n * chunk
    assert decode_chunks(cap) == decode_chunks(cap, DECODE_CHUNK)
    assert DECODE_CHUNK % 32 == 0


def test_empty_chunk_partial_is_zero_state():
    """A chunk with no live key -- past the length, or wholly below the
    window -- holds (acc, m, l) = (0, -1e30, 0)."""
    q, kc, vc = (_t(a) for a in _inputs(1, 3, rows=2))
    lens = _t(np.asarray([1, C + 40], np.int32))
    part_o, part_ml = decode_partials_plain(q, kc, vc, lens, window=24)
    assert part_o.shape == (decode_chunks(S), 2, 1, 3 * HK, HD)
    for c, b in ((1, 0), (0, 1)):          # past the length; below the window
        assert torch.equal(part_o[c, b], torch.zeros_like(part_o[c, b]))
        assert (part_ml[c, b, ..., 0] == NEG_INF).all()
        assert (part_ml[c, b, ..., 1] == 0).all()
    assert (part_ml[0, 0, ..., 1] > 0).all()
    assert (part_ml[1, 1, ..., 1] > 0).all()


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("G", [1, 3, 8, 12])
def test_split_matches_plain_and_jax(G, window):
    """Slab: the split and merge equal the one-pass plain version and JAX
    (the interpret-mode Pallas kernel at window 0, the XLA window branch
    at window 24) at lengths at the chunk edges."""
    q, kc, vc = _inputs(10 * G + window, G)
    lens = np.asarray(LENS, np.int32)
    got = split_decode(_t(q), _t(kc), _t(vc), _t(lens), window)
    np.testing.assert_allclose(
        got.numpy(), decode_attention_plain(_t(q), _t(kc), _t(vc), _t(lens),
                                            window).numpy(), **F32)
    if window == 0:
        want = jops.flash_decode(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(lens),
                                 block_k=128, interpret=True)
    else:
        want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                        jnp.asarray(lens), window=window)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("G", [1, 3, 8, 12])
def test_split_paged_matches_plain_and_jax(G, page, window):
    """Paged, on shuffled tables with a shared page: the split over the
    gathered rows equals the paged plain version and JAX (the
    interpret-mode paged Pallas kernel at window 0, the XLA paged decode
    at window 24)."""
    rng = np.random.default_rng(100 * G + page + window)
    rows, pmax = len(LENS), S // page
    q = rng.standard_normal((rows, 1, G * HK, HD)).astype(np.float32)
    ka = rng.standard_normal((rows * pmax, page, HK, HD)).astype(np.float32)
    va = rng.standard_normal((rows * pmax, page, HK, HD)).astype(np.float32)
    bt = shuffled_tables(rng, rows, pmax)
    lens = np.asarray(LENS, np.int32)
    got = split_decode(_t(q), paged_gather(_t(ka), _t(bt)),
                       paged_gather(_t(va), _t(bt)), _t(lens), window)
    np.testing.assert_allclose(
        got.numpy(), decode_attention_paged_plain(
            _t(q), _t(ka), _t(va), _t(lens), _t(bt), window).numpy(), **F32)
    args = (jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va))
    if window == 0:
        want = jops.flash_decode_paged(*args, jnp.asarray(lens),
                                       jnp.asarray(bt), interpret=True)
    else:
        want = j_decode_paged(*args, jnp.asarray(bt), jnp.asarray(lens),
                              window=window)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 24])
def test_decode_merge_equals_prefill_merge(window):
    """The decode merge, which takes each row's live chunks in order,
    computes the function of the prefill split's merge over all chunks
    (empty ones weigh 0)."""
    q, kc, vc = (_t(a) for a in _inputs(3 + window, 8))
    lens = _t(np.asarray(LENS, np.int32))
    part_o, part_ml = decode_partials_plain(q, kc, vc, lens, window)
    np.testing.assert_allclose(
        decode_merge_plain(part_o, part_ml, lens, S, torch.float32,
                           window).numpy(),
        merge_partials_plain(part_o, part_ml, torch.float32).numpy(), **F32)


@pytest.mark.parametrize("G", [3, 12])
def test_split_int8_matches_plain(G):
    """int8: the split over the dequantised cache equals the int8 plain
    version."""
    q, kc, vc = (_t(a) for a in _inputs(7 + G, G))
    (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
    lens = _t(np.asarray(LENS, np.int32))
    got = split_decode(q, kq.float() * ks.float(), vq.float() * vs.float(),
                       lens)
    np.testing.assert_allclose(
        got.numpy(),
        decode_attention_quant_plain(q, kq, ks, vq, vs, lens).numpy(), **F32)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("G", [1, 12])
def test_split_is_batch_and_capacity_invariant(G, window):
    """A row's split output is bitwise the same computed alone, in a batch
    of 6, and over a cache of twice the capacity: chunk boundaries depend
    on none of them."""
    q, kc, vc = (_t(a) for a in _inputs(50 + G + window, G, rows=6))
    lens = _t(np.asarray([C + 1, 1, S, C - 1, C, 300], np.int32))
    batch = split_decode(q, kc, vc, lens, window)
    big_k = torch.zeros((6, 2 * S, HK, HD))
    big_v = torch.zeros((6, 2 * S, HK, HD))
    big_k[:, :S], big_v[:, :S] = kc, vc
    big = split_decode(q, big_k, big_v, lens, window)
    for b in range(6):
        alone = split_decode(q[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                             lens[b:b + 1], window)
        assert torch.equal(alone[0], batch[b])
        assert torch.equal(big[b], batch[b])


@pytest.mark.parametrize("window", [0, 24])
def test_group_12_model_decode_matches_jax(window):
    """Query group 12 (StarCoder2-15B's 48/4 heads, cut to 12/1) through
    the model's slab and paged decode attention on the CPU equals JAX's
    ``decode_attention`` and ``decode_attention_paged``."""
    rng = np.random.default_rng(12 + window)
    G, hk, page = 12, 1, 64
    rows, pmax = len(LENS), S // page
    q = rng.standard_normal((rows, 1, G * hk, HD)).astype(np.float32)
    kc = rng.standard_normal((rows, S, hk, HD)).astype(np.float32)
    vc = rng.standard_normal((rows, S, hk, HD)).astype(np.float32)
    lens = np.asarray(LENS, np.int32)
    _close(decode_attention(_t(q), _t(kc), _t(vc), _t(lens), window=window),
           j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(lens), window=window))
    bt = shuffled_tables(rng, rows, pmax)
    ka = kc.reshape(rows * pmax, page, hk, HD)
    va = vc.reshape(rows * pmax, page, hk, HD)
    _close(decode_attention_paged(_t(q), _t(ka), _t(va), _t(bt), _t(lens),
                                  window=window),
           j_decode_paged(jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
                          jnp.asarray(bt), jnp.asarray(lens), window=window))
