"""The port's paged KV layout against the JAX package: the paged kernels'
plain versions and every paged serving forward, on the CPU.

The plain versions of kernels 3 and 4 (``flash_decode_paged``,
``flash_prefill_paged``) are held against the JAX Pallas kernels in
interpret mode on shuffled block tables in which two rows share pages
and unmapped entries point at the scratch page.  Each paged forward is
held against its JAX twin on the same weights (f32, 3e-5): logits, and
the arena at every mapped page.  The scratch page is filled with large
values on the port side only, so agreement with JAX also shows that no
forward reads it.  The paged forwards also equal the port's slab
forwards on the same logical rows.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.blocks import _paged_write as j_paged_write  # noqa: E402
from conftest import TINY  # noqa: E402

import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import paged_gather  # noqa: E402
from repro_torch.models.blocks import _paged_write  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
B, S_MAX = 3, 64


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port_out, jax_out):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), **F32)


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


def _arena(rng, ps, pmax, rows, Hk, hd):
    num_pages = rows * pmax
    return (_randn(rng, num_pages + 1, ps, Hk, hd),
            _randn(rng, num_pages + 1, ps, Hk, hd), num_pages)


# ---------------------------------------------------------------------------
# kernels 3 and 4: plain versions vs the JAX Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("H,Hk", [(4, 2), (6, 2)])
def test_decode_paged_plain_matches_jax_kernel(ps, H, Hk):
    hd, pmax = 32, 128 // ps
    rng = np.random.default_rng(ps + H)
    lens = np.asarray([2 * ps + 5, 2 * ps + 3, 1, 37, 128], np.int32)
    ka, va, P = _arena(rng, ps, pmax, len(lens), Hk, hd)
    bt = shared_tables(rng, lens, pmax, ps, P)
    q = _randn(rng, len(lens), 1, H, hd)
    want = jops.flash_decode_paged(jnp.asarray(q), jnp.asarray(ka),
                                   jnp.asarray(va), jnp.asarray(lens),
                                   jnp.asarray(bt), interpret=True)
    got = ops.flash_decode_paged(_t(q), _t(ka), _t(va), _t(lens), _t(bt))
    _close(got, want)
    # the slab plain version on the gathered rows gives the same answer
    slab = ops.flash_decode(_t(q), paged_gather(_t(ka), _t(bt)),
                            paged_gather(_t(va), _t(bt)), _t(lens))
    np.testing.assert_allclose(got.numpy(), slab.numpy(), **F32)


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("Sq,window", [(5, 0), (20, 0), (20, 24)])
def test_prefill_paged_plain_matches_jax_kernel(ps, Sq, window):
    H, Hk, hd, pmax = 4, 2, 32, 128 // ps
    rng = np.random.default_rng(ps + Sq + window)
    qoff = np.asarray([2 * ps - 3, 0, 61], np.int32)
    lens = (qoff + Sq).astype(np.int32)
    ka, va, P = _arena(rng, ps, pmax, len(lens), Hk, hd)
    bt = shared_tables(rng, np.maximum(lens, 2 * ps), pmax, ps, P)
    q = _randn(rng, len(lens), Sq, H, hd)
    want = jops.flash_prefill_paged(jnp.asarray(q), jnp.asarray(ka),
                                    jnp.asarray(va), jnp.asarray(qoff),
                                    jnp.asarray(lens), jnp.asarray(bt),
                                    window=window, interpret=True)
    got = ops.flash_prefill_paged(_t(q), _t(ka), _t(va), _t(qoff), _t(lens),
                                  _t(bt), window=window)
    _close(got, want)
    slab = ops.flash_prefill(_t(q), paged_gather(_t(ka), _t(bt)),
                             paged_gather(_t(va), _t(bt)), _t(qoff),
                             _t(lens), window=window)
    np.testing.assert_allclose(got.numpy(), slab.numpy(), **F32)


def test_paged_wrappers_reject_bad_arguments():
    q = torch.zeros(2, 1, 4, 16)
    ka = torch.zeros(9, 8, 2, 16)
    L = torch.tensor([3, 5], dtype=torch.int32)
    bt = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.flash_decode_paged(q, ka, ka, L, bt.long())
    with pytest.raises(TypeError):
        ops.flash_decode_paged(q, ka, ka, L, bt[0])          # 1-D table
    with pytest.raises(ValueError, match="rows"):
        ops.flash_decode_paged(q, ka, ka, L, bt[:1])
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_decode_paged(q, ka, ka, L,
                               torch.zeros(4, 2, dtype=torch.int32).t())
    with pytest.raises(ValueError, match="exceed"):
        ops.flash_decode_paged(q, ka, ka, torch.tensor([3, 33],
                                                       dtype=torch.int32), bt)
    qq = torch.zeros(2, 4, 4, 16)
    with pytest.raises(ValueError):
        ops.flash_prefill_paged(qq, ka, ka[:, :4], L, L, bt)  # arena shapes
    with pytest.raises(ValueError, match="rows"):
        ops.flash_prefill_paged(qq, ka, ka, L, L, bt[:1])


def test_paged_write_matches_jax_and_redirects_to_scratch():
    """In-range positions land where the table says; negative and
    beyond-table positions land on the scratch (last) page only."""
    rng = np.random.default_rng(6)
    arena = _randn(rng, 9, 4, 2, 3)
    rows = _randn(rng, 2, 3, 2, 3)
    bt = np.asarray([[5, 2], [0, 7]], np.int32)
    pos = np.asarray([[0, 5, 7], [-1, 3, 8]], np.int32)
    want = np.asarray(j_paged_write(jnp.asarray(arena), jnp.asarray(rows),
                                    jnp.asarray(bt), jnp.asarray(pos)))
    got = _t(arena)
    _paged_write(got, _t(rows), _t(bt), _t(pos))
    np.testing.assert_array_equal(got.numpy()[:8], want[:8])
    np.testing.assert_array_equal(got.numpy()[0, 3], rows[1, 1])
    np.testing.assert_array_equal(got.numpy()[2, 3], rows[0, 2])
    # two redirected rows race for scratch row 0: either may win
    assert any(np.array_equal(got.numpy()[8, 0], rows[1, i]) for i in (0, 2))


# ---------------------------------------------------------------------------
# paged forwards vs JAX
# ---------------------------------------------------------------------------

def _paged(jcfg, ps):
    return dataclasses.replace(jcfg, kv_layout="paged", kv_page_size=ps)


CONFIGS = {"tiny": lambda: _paged(TINY, 8),
           "qwen2.5-3b-smoke": lambda: _paged(j_smoke("qwen2.5-3b"), 16),
           "smollm-360m-smoke": lambda: _paged(j_smoke("smollm-360m"), 16)}


def _port_cfg(jcfg):
    return tbase.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(tbase.ModelConfig)})


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(jax cfg, port cfg, jax params, port params) on shared weights."""
    jcfg = CONFIGS[request.param]()
    tcfg = _port_cfg(jcfg)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(7))
    tp = tm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


class Case:
    """Paired caches and a block table: each row maps ``pmax - 2`` pages
    drawn from a shuffled arena, the rest of its table points at the
    scratch page, and the port's scratch page holds large values."""

    def __init__(self, pair, seed):
        self.jcfg, self.tcfg, self.jp, self.tp = pair
        self.rng = np.random.default_rng(seed)
        ps = self.jcfg.kv_page_size
        pmax = S_MAX // ps
        self.num_pages = tm.num_kv_pages(self.tcfg, B, S_MAX)
        need = pmax - 2
        perm = self.rng.permutation(self.num_pages)[:B * need]
        self.bt = np.full((B, pmax), self.num_pages, np.int32)
        self.bt[:, :need] = perm.reshape(B, need)
        self.jc = jm.init_cache(self.jcfg, B, S_MAX)
        self.tc = tm.init_cache(self.tcfg, B, S_MAX, device="cpu")
        for leaf in self.tc["l0"].values():
            leaf[:, -1] = 1e3 * torch.randn(leaf[:, -1].shape)

    @property
    def mapped(self):
        return sorted(set(self.bt[:, :-2].ravel().tolist()))

    def assert_arena(self):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(
                self.tc["l0"][leaf].numpy()[:, self.mapped],
                np.asarray(self.jc["l0"][leaf])[:, self.mapped], **F32)

    def tokens(self, *shape):
        return self.rng.integers(0, self.jcfg.vocab_size,
                                 shape).astype(np.int32)

    def prefill(self, toks, lens, **kw):
        jl, self.jc, _ = jm.forward_prefill(
            self.jp, self.jcfg, jnp.asarray(toks), self.jc, jnp.asarray(lens),
            block_tables=jnp.asarray(self.bt),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        tl, self.tc, _ = tm.forward_prefill(
            self.tp, self.tcfg, _t(toks), self.tc, _t(lens),
            block_tables=_t(self.bt), **{k: _t(v) for k, v in kw.items()})
        _close(tl, jl)
        return tl

    def fill(self, n=20):
        """A cold prefill of ``n`` tokens per row."""
        return self.prefill(self.tokens(B, n), np.zeros(B, np.int32))


def test_paged_prefill_cold_and_resume(pair):
    c = Case(pair, 1)
    c.fill()
    c.assert_arena()
    toks = c.tokens(B, 12)
    c.prefill(toks, np.asarray([20, 3, 31], np.int32),
              logit_idx=np.asarray([11, 4, 0], np.int32))
    c.assert_arena()


def test_paged_decode(pair):
    c = Case(pair, 2)
    c.fill()
    toks, lens = c.tokens(B), np.asarray([20, 20, 20], np.int32)
    jl, c.jc, _ = jm.forward_decode(c.jp, c.jcfg, jnp.asarray(toks), c.jc,
                                    jnp.asarray(lens),
                                    block_tables=jnp.asarray(c.bt))
    tl, c.tc, _ = tm.forward_decode(c.tp, c.tcfg, _t(toks), c.tc, _t(lens),
                                    block_tables=_t(c.bt))
    _close(tl, jl)
    c.assert_arena()


def test_paged_decode_fused_inactive_lane(pair):
    c = Case(pair, 3)
    c.fill()
    before = {k: c.tc["l0"][k].clone() for k in ("k", "v")}
    toks, lens = c.tokens(B), np.asarray([20, 20, 20], np.int32)
    active = np.asarray([True, False, True])
    jt, c.jc, jlen = jm.forward_decode_fused(
        c.jp, c.jcfg, jnp.asarray(toks), c.jc, jnp.asarray(lens),
        jnp.asarray(active), block_tables=jnp.asarray(c.bt))
    tt, c.tc, tlen = tm.forward_decode_fused(
        c.tp, c.tcfg, _t(toks), c.tc, _t(lens), _t(active),
        block_tables=_t(c.bt))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    c.assert_arena()
    own = c.bt[1, :-2]            # the inactive lane's pages: untouched
    for k in ("k", "v"):
        assert torch.equal(c.tc["l0"][k][:, own], before[k][:, own])


def test_paged_decode_megastep(pair):
    c = Case(pair, 4)
    c.fill()
    toks, lens = c.tokens(B), np.asarray([20, 20, 20], np.int32)
    active = np.asarray([True, True, False])
    jseq, jt, c.jc, jlen = jm.forward_decode_megastep(
        c.jp, c.jcfg, jnp.asarray(toks), c.jc, jnp.asarray(lens),
        jnp.asarray(active), num_steps=4, block_tables=jnp.asarray(c.bt))
    tseq, tt, c.tc, tlen = tm.forward_decode_megastep(
        c.tp, c.tcfg, _t(toks), c.tc, _t(lens), _t(active), num_steps=4,
        block_tables=_t(c.bt))
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    c.assert_arena()


def test_paged_resume_batch_permuted_slots(pair):
    c = Case(pair, 5)
    c.fill()
    slots = np.asarray([2, 0], np.int32)
    toks = c.tokens(2, 16)
    lens = np.asarray([20, 20], np.int32)
    logit_idx = np.asarray([15, 6], np.int32)
    jl, c.jc = jm.forward_resume_batch(
        c.jp, c.jcfg, jnp.asarray(toks), c.jc, jnp.asarray(slots),
        jnp.asarray(lens), jnp.asarray(logit_idx),
        block_tables=jnp.asarray(c.bt))
    tl, c.tc = tm.forward_resume_batch(
        c.tp, c.tcfg, _t(toks), c.tc, _t(slots), _t(lens), _t(logit_idx),
        block_tables=_t(c.bt))
    _close(tl, jl)
    c.assert_arena()


def test_paged_forwards_equal_slab_forwards(pair):
    """The same tokens through the port's slab and paged layouts: equal
    logits and equal rows at every logical position written."""
    _, tcfg, _, tp = pair
    c = Case(pair, 6)
    scfg = dataclasses.replace(tcfg, kv_layout="slab")
    slab = tm.init_cache(scfg, B, S_MAX, device="cpu")
    bt = _t(c.bt)
    toks = _t(c.tokens(B, 20))
    zeros = torch.zeros(B, dtype=torch.int32)
    lp, c.tc, _ = tm.forward_prefill(tp, tcfg, toks, c.tc, zeros,
                                     block_tables=bt)
    ls, slab, _ = tm.forward_prefill(tp, scfg, toks, slab, zeros)
    np.testing.assert_allclose(lp.numpy(), ls.numpy(), **F32)
    nxt = _t(c.tokens(B))
    lens = torch.full((B,), 20, dtype=torch.int32)
    active = torch.tensor([True, False, True])
    sp, _, c.tc, _ = tm.forward_decode_megastep(
        tp, tcfg, nxt, c.tc, lens, active, num_steps=3, block_tables=bt)
    ss, _, slab, _ = tm.forward_decode_megastep(
        tp, scfg, nxt, slab, lens, active, num_steps=3)
    np.testing.assert_array_equal(sp.numpy(), ss.numpy())
    for k in ("k", "v"):
        lin = torch.stack([paged_gather(c.tc["l0"][k][g], bt)
                           for g in range(tcfg.num_layers)])
        for b, n in enumerate((23, 20, 23)):
            np.testing.assert_allclose(lin[:, b, :n].numpy(),
                                       slab["l0"][k][:, b, :n].numpy(),
                                       **F32)


def test_init_cache_paged_layout():
    cfg = _port_cfg(CONFIGS["tiny"]())
    c = tm.init_cache(cfg, 3, 64, device="cpu")
    assert tuple(c["l0"]["k"].shape) == (2, 3 * 8 + 1, 8, 2, 16)
    c = tm.init_cache(cfg, 3, 64, device="cpu", num_pages=5)
    assert c["l0"]["v"].shape[1] == 6
    with pytest.raises(ValueError, match="multiple"):
        tm.init_cache(cfg, 3, 60, device="cpu")
