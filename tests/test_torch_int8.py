"""The port's int8 KV cache against the JAX package, on the CPU.

* ``quantize_kv`` is bit-equal to JAX's in f32 and bf16, all-zero rows
  (the 1e-8 scale floor) and exact half-integer ties (half to even)
  included.
* The plain versions of the int8 prefill entries equal the JAX Pallas
  kernels 5 and 6 in interpret mode (1e-4, the JAX kernel test's limit):
  causal, query groups 8, 3 and 1, a window, offsets 0 and > 0,
  ``slot_idx``, shuffled tables with shared pages.  The plain int8
  decode versions equal JAX ``decode_attention`` /
  ``decode_attention_paged`` with ``k_scale``/``v_scale`` (3e-5), the
  CPU-only windowed path included.
* The int8 writers write what JAX's write, and ``init_cache(kv_quant=
  True)`` has JAX's leaves, shapes and dtypes on both layouts.
* Every serving forward over an int8 cache (prefill, resume batch,
  decode, fused decode, megastep) equals JAX on both layouts for TINY,
  the qwen2.5-3b smoke config at its published query group 8, a tiny
  hybrid and the olmoe smoke config under "dense": logits, every
  written k/v/ks/vs row and state leaf, and the sampled tokens; an
  inactive lane writes only its scratch row or page.

The quantiser rounds ``x / s``, so a one-ulp difference upstream (torch
against XLA matmuls) can round a value near a half-integer the other
way.  The forward tests record every JAX quantiser call (an ordered
``jax.debug.callback``) and hold the port's same call to it: scales
within 3e-5, int8 values equal except a difference of 1 where JAX's
pre-rounding ``x / s`` lies within 1e-4 of a half-integer (the flips,
counted and printed).  The port then continues from JAX's values, so a
flip cannot cascade through later layers and every other difference
shows in the logits and the caches.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from conftest import TINY  # noqa: E402

import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import paged_gather  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
KERNEL_TOL = 1e-4
B, S_MAX, PS = 3, 64, 8


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def _quant_np(rng, *shape):
    """int8 values and f32 scales (numpy) of an N(0, 1) tensor, through
    the JAX quantiser."""
    q, s = jattn.quantize_kv(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32)))
    return np.asarray(q), np.asarray(s)


def shared_tables(rng, lengths, pmax: int, page: int, num_pages: int):
    """[rows, pmax] tables over a shuffled arena of ``num_pages`` usable
    pages (page ``num_pages`` is the scratch page): rows 0 and 1 share
    their first two pages, other mapped pages are distinct, and entries
    past a row's length point at the scratch page."""
    perm = rng.permutation(num_pages)
    bt = np.full((len(lengths), pmax), num_pages, np.int32)
    nxt = 0
    for r, n in enumerate(lengths):
        need = -(-int(n) // page)
        bt[r, :need] = perm[nxt:nxt + need]
        nxt += need
    bt[1, :2] = bt[0, :2]
    return bt


# ---------------------------------------------------------------------------
# the quantiser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 40, 3, 32))
         * rng.uniform(0.01, 30.0, (6, 40, 3, 1))).astype(np.float32)
    x[0, 0] = 0.0                      # all-zero rows: the 1e-8 floor
    x[1, :, 1] = 0.0
    # max |x| = 127 makes s = 1, so x / s lands exactly on half-integers
    x[2, 3, 0] = np.tile(np.float32([127, 2.5, -3.5, 0.5, -0.5, 1.5,
                                     126.5, -126.5]), 4)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jattn.quantize_kv(jx)
    tq, ts = tattn.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == tx.dtype
    assert tuple(ts.shape) == (6, 40, 3, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    # ties go to the even neighbour; a zero row has the floored scale
    assert tq[2, 3, 0, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]
    assert ts[0, 0].float().eq(torch.tensor(1e-8).to(ts.dtype).float()).all()
    assert not tq[0, 0].any()


# ---------------------------------------------------------------------------
# kernels 5 and 6 (prefill) and the int8 decode: plain versions vs JAX
# ---------------------------------------------------------------------------

# (H, Hk, hd, Sq, q_offset per row, window): query groups 8, 3 and 1
PREFILL_CASES = {
    "causal-g8": (16, 2, 32, 20, [0, 0], 0),
    "offset-g3": (6, 2, 32, 12, [37, 5], 0),
    "offset-g1": (2, 2, 32, 9, [0, 50], 0),
    "window-g4": (8, 2, 32, 24, [40, 3], 16),
}


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_prefill_quant_plain_matches_jax_kernel(case):
    H, Hk, hd, Sq, qoff, window = PREFILL_CASES[case]
    rng = np.random.default_rng(len(case) + Sq)
    S = 96
    kq, ks = _quant_np(rng, 3, S, Hk, hd)
    vq, vs = _quant_np(rng, 3, S, Hk, hd)
    q = rng.standard_normal((2, Sq, H, hd)).astype(np.float32)
    qoff = np.asarray(qoff, np.int32)
    lens = (qoff + Sq).astype(np.int32)
    # the port reads cache rows 2 and 0 through slot_idx; JAX, which has
    # no slot_idx, reads the same rows gathered
    rows = np.asarray([2, 0], np.int32)
    want = jops.flash_prefill_quant(
        jnp.asarray(q), jnp.asarray(kq[rows]), jnp.asarray(ks[rows]),
        jnp.asarray(vq[rows]), jnp.asarray(vs[rows]), jnp.asarray(qoff),
        jnp.asarray(lens), window=window, interpret=True)
    got = ops.flash_prefill_quant(_t(q), _t(kq), _t(ks), _t(vq), _t(vs),
                                  _t(qoff), _t(lens), window=window,
                                  slot_idx=_t(rows))
    assert np.abs(got.numpy() - np.asarray(want)).max() < KERNEL_TOL
    # and without slot_idx on the gathered rows: the same answer
    flat = ops.flash_prefill_quant(_t(q), _t(kq[rows]), _t(ks[rows]),
                                   _t(vq[rows]), _t(vs[rows]), _t(qoff),
                                   _t(lens), window=window)
    np.testing.assert_array_equal(flat.numpy(), got.numpy())


@pytest.mark.parametrize("ps,Sq,window", [(8, 5, 0), (16, 20, 0),
                                          (16, 20, 24)])
def test_prefill_paged_quant_plain_matches_jax_kernel(ps, Sq, window):
    H, Hk, hd, pmax = 8, 2, 32, 128 // ps
    rng = np.random.default_rng(ps + Sq + window)
    qoff = np.asarray([2 * ps - 3, 0, 61], np.int32)
    lens = (qoff + Sq).astype(np.int32)
    P = 3 * pmax
    kq, ks = _quant_np(rng, P + 1, ps, Hk, hd)
    vq, vs = _quant_np(rng, P + 1, ps, Hk, hd)
    bt = shared_tables(rng, np.maximum(lens, 2 * ps), pmax, ps, P)
    q = rng.standard_normal((3, Sq, H, hd)).astype(np.float32)
    want = jops.flash_prefill_paged_quant(
        *map(jnp.asarray, (q, kq, ks, vq, vs, qoff, lens, bt)),
        window=window, interpret=True)
    args = [_t(a) for a in (kq, ks, vq, vs)]
    got = ops.flash_prefill_paged_quant(_t(q), *args, _t(qoff), _t(lens),
                                        _t(bt), window=window)
    assert np.abs(got.numpy() - np.asarray(want)).max() < KERNEL_TOL
    slab = ops.flash_prefill_quant(_t(q), *[paged_gather(a, _t(bt))
                                            for a in args],
                                   _t(qoff), _t(lens), window=window)
    np.testing.assert_allclose(got.numpy(), slab.numpy(), **F32)


@pytest.mark.parametrize("H,Hk", [(16, 2), (6, 2), (4, 4)])
def test_decode_quant_plain_matches_jax(H, Hk):
    hd, S = 32, 128
    rng = np.random.default_rng(H + Hk)
    lens = np.asarray([1, 37, 128, 64, 100], np.int32)
    kq, ks = _quant_np(rng, len(lens), S, Hk, hd)
    vq, vs = _quant_np(rng, len(lens), S, Hk, hd)
    q = rng.standard_normal((len(lens), 1, H, hd)).astype(np.float32)
    want = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(lens),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = tattn.decode_attention(_t(q), _t(kq), _t(vq), _t(lens),
                                 k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the sliding window runs the blocked plain path on CPU tensors
    want = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(lens),
        window=24, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = tattn.decode_attention(_t(q), _t(kq), _t(vq), _t(lens), window=24,
                                 k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("ps,window", [(8, 0), (16, 0), (16, 24)])
def test_decode_paged_quant_plain_matches_jax(ps, window):
    H, Hk, hd, pmax = 8, 2, 32, 128 // ps
    rng = np.random.default_rng(ps + window)
    lens = np.asarray([2 * ps + 5, 2 * ps + 3, 1, 37, 128], np.int32)
    P = len(lens) * pmax
    kq, ks = _quant_np(rng, P + 1, ps, Hk, hd)
    vq, vs = _quant_np(rng, P + 1, ps, Hk, hd)
    bt = shared_tables(rng, lens, pmax, ps, P)
    q = rng.standard_normal((len(lens), 1, H, hd)).astype(np.float32)
    want = jattn.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt),
        jnp.asarray(lens), window=window, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    got = tattn.decode_attention_paged(_t(q), _t(kq), _t(vq), _t(bt),
                                       _t(lens), window=window,
                                       k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_blocked_attention_quant_matches_jax():
    rng = np.random.default_rng(11)
    kq, ks = _quant_np(rng, 2, 70, 2, 16)
    vq, vs = _quant_np(rng, 2, 70, 2, 16)
    q = rng.standard_normal((2, 9, 6, 16)).astype(np.float32)
    qoff, lens = np.asarray([30, 61], np.int32), np.asarray([39, 70], np.int32)
    want = jattn.blocked_attention_quant(
        *map(jnp.asarray, (q, kq, ks, vq, vs)), q_offset=jnp.asarray(qoff),
        lengths=jnp.asarray(lens), window=20, block_size=32)
    got = tattn.blocked_attention_quant(
        *map(_t, (q, kq, ks, vq, vs)), q_offset=_t(qoff), lengths=_t(lens),
        window=20, block_size=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_quant_wrappers_check_their_arguments():
    assert {"flash_prefill_quant", "flash_prefill_paged_quant",
            "flash_decode_quant", "flash_decode_paged_quant"} <= set(
                ops.LAUNCHES)
    q = torch.zeros(2, 1, 4, 16)
    kq = torch.zeros(2, 8, 2, 16, dtype=torch.int8)
    ks = torch.ones(2, 8, 2, 1)
    L = torch.tensor([3, 5], dtype=torch.int32)
    with pytest.raises(TypeError, match="int8"):
        ops.flash_decode_quant(q, kq.float(), ks, kq.float(), ks, L)
    with pytest.raises(TypeError, match="scales"):
        ops.flash_decode_quant(q, kq, ks.double(), kq, ks.double(), L)
    with pytest.raises(TypeError, match="scales"):
        ops.flash_decode_quant(q, kq, ks[:, :4], kq, ks[:, :4], L)
    with pytest.raises(ValueError, match="rows"):
        ops.flash_prefill_quant(torch.zeros(2, 3, 4, 16), kq, ks, kq, ks,
                                L, L, slot_idx=L[:1])
    bt = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceed"):
        ops.flash_decode_paged_quant(q, kq, ks, kq, ks,
                                     torch.tensor([3, 33], dtype=torch.int32),
                                     bt)
    # the bf16 entry does not take an int8 cache
    with pytest.raises(TypeError):
        ops.flash_decode(q, kq, kq, L)


# ---------------------------------------------------------------------------
# writers and the cache
# ---------------------------------------------------------------------------

def _quant_cache(rng, lead):
    shape = lead + (2, 16)
    return {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8),
            "ks": np.zeros(lead + (2, 1), np.float32),
            "vs": np.zeros(lead + (2, 1), np.float32)}


def _assert_leaves_equal(tc, jc, exclude=None):
    for name in ("k", "v", "ks", "vs"):
        got, want = tc[name].numpy(), np.asarray(jc[name])
        if exclude is not None:
            got, want = exclude(got), exclude(want)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_slab_quant_writers_match_jax():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    # _write_kv_quant: chunks at per-row offsets (one clamped to fit)
    base = _quant_cache(rng, (3, 16))
    offs = np.asarray([0, 5, 14], np.int32)
    jc = jblocks._write_kv_quant({n: jnp.asarray(a) for n, a in base.items()},
                                 jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(offs))
    tc = {n: _t(a) for n, a in base.items()}
    tblocks._write_kv_quant(tc, _t(k), _t(v), _t(offs))
    _assert_leaves_equal(tc, jc)
    # with slot_idx the rows land in the named slots (JAX: gathered rows)
    tc = {n: _t(a) for n, a in base.items()}
    tblocks._write_kv_quant(tc, _t(k[:2]), _t(v[:2]), _t(offs[:2]),
                            slot_idx=_t(np.asarray([2, 0], np.int32)))
    jc2 = jblocks._write_kv_quant(
        {n: jnp.asarray(a[[2, 0]]) for n, a in base.items()},
        jnp.asarray(k[:2]), jnp.asarray(v[:2]), jnp.asarray(offs[:2]))
    _assert_leaves_equal({n: t[[2, 0]] for n, t in tc.items()}, jc2)
    assert not tc["k"][1].any()
    # _slab_write_scatter_quant: out-of-range positions go to the scratch
    # row S - 1, which is left out of the comparison (colliding rows race)
    pos = np.asarray([[0, 1, 2, 3], [-1, 5, 16, 7], [13, 14, -7, 15]],
                     np.int32)
    jc = jblocks._slab_write_scatter_quant(
        {n: jnp.asarray(a) for n, a in base.items()}, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(pos))
    tc = {n: _t(a) for n, a in base.items()}
    tblocks._slab_write_scatter_quant(tc, _t(k), _t(v), _t(pos))
    _assert_leaves_equal(tc, jc, exclude=lambda a: a[:, :15])


def test_paged_quant_writer_matches_jax():
    rng = np.random.default_rng(4)
    k = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    base = _quant_cache(rng, (9, 4))
    bt = np.asarray([[5, 2], [0, 7]], np.int32)
    pos = np.asarray([[0, 5, 7], [-1, 3, 8]], np.int32)
    jc = jblocks._paged_write_quant(
        {n: jnp.asarray(a) for n, a in base.items()}, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(bt), jnp.asarray(pos))
    tc = {n: _t(a) for n, a in base.items()}
    idx = tblocks.paged_write_index(_t(bt), _t(pos), 9, 4)
    tblocks._paged_write_quant(tc, _t(k), _t(v), idx)
    _assert_leaves_equal(tc, jc, exclude=lambda a: a[:8])


def port_cfg(jcfg, **kw):
    """The port's ModelConfig with the JAX config's field values."""
    vals = {f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(tbase.ModelConfig)}
    for name, cls in (("ssm", tbase.SSMConfig), ("moe", tbase.MoEConfig)):
        if vals[name] is not None:
            vals[name] = cls(**dataclasses.asdict(vals[name]))
    vals.update(kw)
    return tbase.ModelConfig(**vals)


HYBRID = JModelConfig(
    name="tiny-hybrid", family="hybrid", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
    tie_embeddings=True, source="test",
    ssm=JSSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                   chunk_size=32),
    hybrid_period=2, hybrid_attn_index=0)


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_init_cache_int8_matches_jax(paged):
    kw = dict(kv_layout="paged", kv_page_size=PS) if paged else {}
    for jcfg in (dataclasses.replace(TINY, **kw),
                 dataclasses.replace(HYBRID, **kw)):
        jc = jm.init_cache(jcfg, B, S_MAX, kv_quant=True)
        tc = tm.init_cache(port_cfg(jcfg), B, S_MAX, device="cpu",
                           kv_quant=True)
        assert set(tc) == set(jc)
        for name, layer in jc.items():
            assert set(tc[name]) == set(layer)
            for k, leaf in layer.items():
                got = tc[name][k]
                assert tuple(got.shape) == leaf.shape, (name, k)
                assert str(got.dtype)[6:] == str(leaf.dtype), (name, k)
            ptrs = {t.data_ptr() for t in tc[name].values()}
            assert len(ptrs) == len(tc[name])      # distinct buffers
    plain = tm.init_cache(port_cfg(TINY), B, S_MAX, device="cpu")
    assert set(plain["l0"]) == {"k", "v"}


# ---------------------------------------------------------------------------
# the serving forwards over an int8 cache
# ---------------------------------------------------------------------------

_JAX_CALLS = []
_JAX_QUANTIZE = jblocks.quantize_kv
_PORT_QUANTIZE = tblocks.quantize_kv


def _jax_sink(r, q, s):
    _JAX_CALLS.append((np.asarray(q), np.asarray(s), np.asarray(r)))


def _jax_recording_quantize(x):
    q, s = _JAX_QUANTIZE(x)
    jax.debug.callback(_jax_sink, x.astype(jnp.float32)
                       / s.astype(jnp.float32), q, s, ordered=True)
    return q, s


class Ledger:
    """Holds each port quantiser call to JAX's call of the same index
    and hands the port JAX's values (module docstring)."""

    def __init__(self):
        self.next = 0
        self.values = self.flips = 0

    def quantize(self, x):
        q, s = _PORT_QUANTIZE(x)
        q_j, s_j, r_j = _JAX_CALLS[self.next]
        self.next += 1
        assert tuple(q.shape) == q_j.shape
        np.testing.assert_allclose(s.float().numpy(), s_j, rtol=3e-5, atol=0)
        diff = q.numpy().astype(np.int32) - q_j.astype(np.int32)
        flip = diff != 0
        assert np.abs(diff).max(initial=0) <= 1
        near_half = np.abs(r_j - (np.floor(r_j) + 0.5)) < 1e-4
        assert near_half[flip].all(), "a flip away from a half-integer"
        self.values += q.numel()
        self.flips += int(flip.sum())
        return torch.from_numpy(q_j.copy()), torch.from_numpy(
            s_j.copy()).to(s.dtype)

    def caught_up(self):
        assert self.next == len(_JAX_CALLS), (self.next, len(_JAX_CALLS))


def _heads(name, H, Hk):
    return dataclasses.replace(j_smoke(name), num_heads=H, num_kv_heads=Hk,
                               head_dim=16)


# config -> (constructor, MoE mode, logits tolerance): the hybrid's scan
# order and the MoE combine keep the other port tests' 2e-4
CONFIGS = {
    "tiny": (lambda: TINY, "gmm", F32),
    "qwen2.5-3b-g8": (lambda: _heads("qwen2.5-3b", 16, 2), "gmm", F32),
    "tiny-hybrid": (lambda: HYBRID, "gmm", dict(rtol=2e-4, atol=2e-4)),
    "olmoe-dense": (lambda: j_smoke("olmoe-1b-7b"), "dense",
                    dict(rtol=2e-4, atol=2e-4)),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def weights(request):
    build, mode, tol = CONFIGS[request.param]
    jcfg = build()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(7))
    tp = tm.from_jax_params(port_cfg(jcfg), jax.tree.map(np.asarray, jp),
                            device="cpu")
    return jcfg, jp, tp, mode, tol


class Case:
    """Paired int8 caches of B slots; ``paged`` maps each row's first
    ``pmax - 2`` pages from a shuffled arena (the rest to the scratch
    page).  Every forward runs on JAX first, then on the port through
    the ledger."""

    def __init__(self, weights, paged, seed, monkeypatch):
        jcfg, self.jp, self.tp, self.mode, self.tol = weights
        kw = dict(kv_layout="paged", kv_page_size=PS) if paged else {}
        self.jcfg = dataclasses.replace(jcfg, **kw)
        self.tcfg = port_cfg(self.jcfg)
        self.paged = paged
        self.rng = np.random.default_rng(seed)
        self.jc = jm.init_cache(self.jcfg, B, S_MAX, kv_quant=True)
        self.tc = tm.init_cache(self.tcfg, B, S_MAX, device="cpu",
                                kv_quant=True)
        self.bt = None
        if paged:
            pmax = S_MAX // PS
            num_pages = tm.num_kv_pages(self.tcfg, B, S_MAX)
            perm = self.rng.permutation(num_pages)[:B * (pmax - 2)]
            self.bt = np.full((B, pmax), num_pages, np.int32)
            self.bt[:, :pmax - 2] = perm.reshape(B, pmax - 2)
        _JAX_CALLS.clear()
        self.ledger = Ledger()
        monkeypatch.setattr(jblocks, "quantize_kv", _jax_recording_quantize)
        monkeypatch.setattr(tblocks, "quantize_kv", self.ledger.quantize)

    def both(self, name, *args, **kw):
        """Run forward ``name`` on JAX, then on the port; returns both
        results."""
        extra = {"moe_mode": self.mode}
        if self.bt is not None:
            extra["block_tables"] = self.bt
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in {**kw, **extra}.items()}
        jout = getattr(jm, name)(self.jp, self.jcfg, *jargs[:1], self.jc,
                                 *jargs[1:], **jkw)
        jax.effects_barrier()
        self.jc = next(o for o in jout if isinstance(o, dict))
        targs = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
        tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
               for k, v in {**kw, **extra}.items()}
        tout = getattr(tm, name)(self.tp, self.tcfg, *targs[:1], self.tc,
                                 *targs[1:], **tkw)
        self.ledger.caught_up()
        return jout, tout

    def assert_cache(self):
        for name, layer in self.jc.items():
            for k, v in layer.items():
                got, want = self.tc[name][k].numpy(), np.asarray(v)
                assert got.shape == want.shape, (name, k)
                if k in tm.POSITIONAL_CACHE_KEYS:
                    if self.paged:
                        pages = sorted(set(self.bt[:, :-2].ravel().tolist()))
                        got, want = got[:, pages], want[:, pages]
                    else:
                        got, want = got[:, :, :S_MAX - 1], want[:, :, :S_MAX - 1]
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{name}/{k}")
                else:
                    np.testing.assert_allclose(got, want, **self.tol,
                                               err_msg=f"{name}/{k}")

    def tokens(self, *shape):
        return self.rng.integers(0, self.jcfg.vocab_size,
                                 shape).astype(np.int32)


LAYOUTS = pytest.mark.parametrize("paged", [False, True],
                                  ids=["slab", "paged"])


@LAYOUTS
def test_int8_prefill_and_resume_batch(weights, paged, monkeypatch):
    c = Case(weights, paged, 1, monkeypatch)
    (jl, _, _), (tl, _, _) = c.both("forward_prefill", c.tokens(B, 20),
                                    np.zeros(B, np.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **c.tol)
    c.assert_cache()
    # a padded resume chunk at per-row offsets
    (jl, _, _), (tl, _, _) = c.both(
        "forward_prefill", c.tokens(B, 8), np.asarray([20, 3, 31], np.int32),
        logit_idx=np.asarray([7, 4, 0], np.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **c.tol)
    c.assert_cache()
    # a batched resume into permuted slots
    (jl, _), (tl, _) = c.both(
        "forward_resume_batch", c.tokens(2, 8), np.asarray([2, 0], np.int32),
        np.asarray([39, 28], np.int32), np.asarray([7, 3], np.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **c.tol)
    c.assert_cache()
    print(f"quantiser: {c.ledger.values} values, {c.ledger.flips} flips")


@LAYOUTS
def test_int8_decode_fused_and_megastep(weights, paged, monkeypatch):
    c = Case(weights, paged, 2, monkeypatch)
    c.both("forward_prefill", c.tokens(B, 20), np.zeros(B, np.int32))
    toks, lens = c.tokens(B), np.asarray([20, 20, 20], np.int32)
    (jl, _, _), (tl, _, _) = c.both("forward_decode", toks, lens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **c.tol)
    c.assert_cache()
    lens = lens + 1
    active = np.asarray([True, False, True])
    before = {k: v.clone() for k, v in c.tc["l0"].items()}
    (jt, _, jlen), (tt, _, tlen) = c.both("forward_decode_fused", toks, lens,
                                          active)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    c.assert_cache()
    for k in ("k", "v", "ks", "vs"):      # the inactive lane: scratch only
        leaf, old = c.tc["l0"][k], before[k]
        if paged:
            own = c.bt[1, :-2]
            assert torch.equal(leaf[:, own], old[:, own])
        else:
            assert torch.equal(leaf[:, 1, :S_MAX - 1], old[:, 1, :S_MAX - 1])
            assert not torch.equal(leaf[:, 1, S_MAX - 1], old[:, 1, S_MAX - 1])
    (jseq, jt, _, jlen), (tseq, tt, _, tlen) = c.both(
        "forward_decode_megastep", np.asarray(jt), np.asarray(jlen), active,
        num_steps=3)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    c.assert_cache()
    print(f"quantiser: {c.ledger.values} values, {c.ledger.flips} flips")
