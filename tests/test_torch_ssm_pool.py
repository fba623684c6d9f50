"""The port's KV pools on models with recurrent state, against the JAX
pools op for op, on the CPU.

A tiny hybrid (attention + Mamba-2, ``hybrid_period=2``) and a tiny pure
Mamba-2 stack run one seeded random sequence of alloc, prepare_append,
register (radix and exact), lookup_longest + restore, park/unpark,
truncate, free and release on the port's and the JAX package's paged
pools; each freshly written slot gets the same random state on both
sides.  After every op the block tables, refcounts, lengths, stats
(``state_copies`` included), radix node count, index page references,
free list and every allocated slot's state leaves must be equal, and a
restored or unparked slot must hold the JAX slot's state.  The slab pools
are held against each other the same way.  Then the JAX package's own
state-leaf cases: reset on alloc, park of a paged hybrid snapshots state
only, partial radix hits only at state boundaries, no state copy on an
exact re-registration, and a pure Mamba-2 paged pool without an arena.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.serving.kvcache import KVCachePool as JSlab  # noqa: E402
from repro.serving.kvcache import KVExhausted as JKVExhausted  # noqa: E402
from repro.serving.kvcache import PagedKVCachePool as JPool  # noqa: E402

from repro_torch.configs.base import ModelConfig, SSMConfig  # noqa: E402
from repro_torch.models import POSITIONAL_CACHE_KEYS  # noqa: E402
from repro_torch.serving.kvcache import (KVCachePool,  # noqa: E402
                                         KVExhausted, PagedKVCachePool,
                                         make_pool)

PS = 8
SSM_FIELDS = dict(d_state=16, d_conv=4, expand=2, head_dim=32, chunk_size=32)
HYBRID = dict(name="tiny-pool-hybrid", family="hybrid", num_layers=2,
              d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
              vocab_size=128, tie_embeddings=True, source="test",
              kv_layout="paged", kv_page_size=PS, hybrid_period=2,
              hybrid_attn_index=0)
PURE = dict(name="tiny-pool-ssm", family="ssm", num_layers=2, d_model=64,
            num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=128,
            tie_embeddings=True, source="test", kv_layout="paged",
            kv_page_size=PS)
CONFIGS = {"hybrid": HYBRID, "ssm": PURE}


def cfgs(fields, **kw):
    f = dict(fields, **kw)
    return (JModelConfig(**f, ssm=JSSMConfig(**SSM_FIELDS)),
            ModelConfig(**f, ssm=SSMConfig(**SSM_FIELDS)))


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _state_items(cache):
    for name, layer in cache.items():
        if not set(layer) <= POSITIONAL_CACHE_KEYS:
            for k, v in layer.items():
                yield name, k, v


def _set_state(jp, tp, slot, rng):
    """Write the same random state into ``slot`` of both pools (a stand-in
    for a prefill's state update)."""
    for name, k, v in list(_state_items(tp.cache)):
        val = rng.standard_normal(tuple(v[:, slot].shape)).astype(np.float32)
        v[:, slot] = torch.tensor(val)
        jp.cache[name][k] = jp.cache[name][k].at[:, slot].set(
            jnp.asarray(val))


def _assert_states(jp, tp, slots):
    for name, k, v in _state_items(tp.cache):
        want = np.asarray(jp.cache[name][k])
        for s in slots:
            np.testing.assert_array_equal(v[:, s].numpy(), want[:, s],
                                          err_msg=f"{name}/{k} slot {s}")


def _assert_entry_state(je, te):
    if je.state is None:
        assert te.state is None
        return
    assert set(te.state) == set(je.state)
    for name, layer in je.state.items():
        for k, v in layer.items():
            np.testing.assert_array_equal(te.state[name][k].numpy(),
                                          np.asarray(v))


def _both(fn_j, fn_t):
    out = []
    for fn, exc in ((fn_j, JKVExhausted), (fn_t, KVExhausted)):
        try:
            out.append(fn())
        except exc:
            out.append(exc)
    assert (out[0] is JKVExhausted) == (out[1] is KVExhausted), out
    return out


def _assert_same(jp, tp, slots, parked):
    np.testing.assert_array_equal(tp.block_table, jp.block_table)
    np.testing.assert_array_equal(tp.refcount, jp.refcount)
    np.testing.assert_array_equal(tp.lengths, jp.lengths)
    assert tp._free_pages == jp._free_pages
    assert tp.stats == jp.stats
    assert tp.radix_nodes == jp.radix_nodes
    assert tp.prefix_page_refs == jp.prefix_page_refs
    assert tp.prefix_version == jp.prefix_version
    slot_refs = int((tp.block_table >= 0).sum())
    parked_refs = sum(len(t.pages) for _, t, _ in parked)
    assert int(tp.refcount.sum()) == (slot_refs + parked_refs
                                      + tp.prefix_page_refs)
    _assert_states(jp, tp, slots)


def _run_state_twins(seed: int, mode: str, fields):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = cfgs(fields)
    kw = dict(num_pages=20, max_prefix_entries=5, prefix_cache=mode)
    jp = JPool(jcfg, 4, 64, **kw)
    tp = PagedKVCachePool(tcfg, 4, 64, device="cpu", **kw)
    slots, parked, registered = {}, [], []

    def tokens():
        stem = np.zeros((0,), np.int32)
        if registered and rng.random() < 0.6:
            src = registered[int(rng.integers(len(registered)))]
            stem = src[:int(rng.integers(0, min(len(src), 40) + 1))]
        tail = rng.integers(0, 4, size=int(rng.integers(
            1, 48 - len(stem) + 1))).astype(np.int32)
        return np.concatenate([stem, tail]).astype(np.int32)

    def claim(slot, toks):
        start = int(tp.lengths[slot])
        res = _both(lambda: jp.prepare_append(slot, start, len(toks)),
                    lambda: tp.prepare_append(slot, start, len(toks)))
        if res[1] is KVExhausted:
            return False
        jp.lengths[slot] += len(toks)
        tp.lengths[slot] += len(toks)
        _set_state(jp, tp, slot, rng)
        return True

    for _ in range(70):
        op = rng.random()
        if op < 0.24 and tp.free_slots:                 # alloc + claim
            s = jp.alloc()
            assert tp.alloc() == s
            _assert_states(jp, tp, [s])                 # reset to zero
            toks = tokens()
            if claim(s, toks):
                slots[s] = toks
            else:
                jp.free(s)
                tp.free(s)
        elif op < 0.34 and slots:                       # append
            s = int(rng.choice(sorted(slots)))
            more = rng.integers(0, 4, size=int(rng.integers(1, 9)))
            if len(slots[s]) + len(more) <= 64 and claim(s, more):
                slots[s] = np.concatenate([slots[s], more]).astype(np.int32)
        elif op < 0.50 and slots:                       # register
            s = int(rng.choice(sorted(slots)))
            _both(lambda: jp.register_prefix(s, slots[s]),
                  lambda: tp.register_prefix(s, slots[s]))
            if len(slots[s]):
                registered.append(slots[s])
        elif op < 0.64 and registered and tp.free_slots:  # lookup + restore
            src = registered[int(rng.integers(len(registered)))]
            q = np.concatenate([src[:int(rng.integers(1, len(src) + 1))],
                                rng.integers(100, 104, size=3)])
            q = q.astype(np.int32)
            cap = len(q) - 1
            assert tp.peek_longest(q, max_len=cap) == \
                jp.peek_longest(q, max_len=cap)
            je = jp.lookup_longest(q, max_len=cap)
            te = tp.lookup_longest(q, max_len=cap)
            assert (je is None) == (te is None)
            if te is not None:
                assert te.length == je.length
                np.testing.assert_array_equal(te.pages, je.pages)
                _assert_entry_state(je, te)
                s = jp.alloc()
                assert tp.alloc() == s
                jp.restore_prefix(s, je)
                tp.restore_prefix(s, te)
                slots[s] = q[:te.length]
        elif op < 0.72 and slots:                       # park
            s = int(rng.choice(sorted(slots)))
            je, te = jp.park(s), tp.park(s)
            _assert_entry_state(je, te)
            parked.append((je, te, slots.pop(s)))
        elif op < 0.80 and parked and tp.free_slots:    # unpark
            je, te, toks = parked.pop(int(rng.integers(len(parked))))
            s = jp.alloc()
            assert tp.alloc() == s
            jp.unpark(s, je)
            tp.unpark(s, te)
            slots[s] = toks
        elif op < 0.86 and slots:                       # truncate
            s = int(rng.choice(sorted(slots)))
            n = int(rng.integers(0, len(slots[s]) + 1))
            jp.truncate(s, n)
            tp.truncate(s, n)
            slots[s] = slots[s][:n]
        elif op < 0.94 and slots:                       # free
            s = int(rng.choice(sorted(slots)))
            jp.free(s)
            tp.free(s)
            del slots[s]
        elif parked:                                    # release parked
            je, te, _ = parked.pop(int(rng.integers(len(parked))))
            jp.release_entry(je)
            tp.release_entry(te)
        _assert_same(jp, tp, list(slots), parked)

    for je, te, _ in parked:
        jp.release_entry(je)
        tp.release_entry(te)
    for s in list(slots):
        jp.free(s)
        tp.free(s)
    _assert_same(jp, tp, [], [])
    assert tp.stats["state_copies"] > 0
    return tp


@pytest.mark.parametrize("mode", ["radix", "exact"])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("model", list(CONFIGS))
def test_paged_pool_state_leaves_match_jax(model, seed, mode):
    _run_state_twins(seed, mode, CONFIGS[model])


@pytest.mark.parametrize("model", list(CONFIGS))
def test_slab_pool_state_leaves_match_jax(model):
    """Slab: alloc zeroes the state, and a prefix snapshot, its restore
    and a park/unpark carry the whole slot (attention rows and states)."""
    jcfg, tcfg = cfgs(CONFIGS[model], kv_layout="slab")
    rng = np.random.default_rng(7)
    jp, tp = JSlab(jcfg, 3, 32), KVCachePool(tcfg, 3, 32, device="cpu")
    a = jp.alloc()
    assert tp.alloc() == a
    _set_state(jp, tp, a, rng)
    toks = np.arange(10, dtype=np.int32)
    jp.lengths[a] = tp.lengths[a] = 10
    jp.register_prefix(a, toks)
    tp.register_prefix(a, toks)
    b = jp.alloc()
    assert tp.alloc() == b
    _assert_states(jp, tp, [a, b])
    je, te = jp.lookup_longest(toks), tp.lookup_longest(toks)
    jp.restore_prefix(b, je)
    tp.restore_prefix(b, te)
    _assert_states(jp, tp, [a, b])
    for name, k, v in _state_items(tp.cache):
        assert torch.equal(v[:, b], v[:, a])
    _set_state(jp, tp, a, rng)
    je, te = jp.park(a), tp.park(a)
    c = jp.alloc()
    assert tp.alloc() == c
    _set_state(jp, tp, c, rng)                  # the slot is reused
    jp.free(c)
    tp.free(c)
    c = jp.alloc()
    assert tp.alloc() == c
    jp.unpark(c, je)
    tp.unpark(c, te)
    _assert_states(jp, tp, [b, c])
    assert {k: tp.stats[k] for k in jp.stats} == jp.stats
    assert tp.stats["state_copies"] == 4     # register, restore, park, unpark


def _pool(fields=HYBRID, **kw):
    _, tcfg = cfgs(fields)
    return PagedKVCachePool(tcfg, 4, 64, device="cpu", **kw)


def _register(pool, toks):
    s = pool.alloc()
    pool.prepare_append(s, 0, len(toks))
    pool.lengths[s] = len(toks)
    pool.register_prefix(s, toks)
    pool.free(s)


def test_alloc_resets_state():
    pool = _pool()
    s = pool.alloc()
    for _, _, v in _state_items(pool.cache):
        v[:, s] = 1.0
    pool.free(s)
    assert pool.alloc() == s
    for _, _, v in _state_items(pool.cache):
        assert not v[:, s].any()


def test_park_on_paged_hybrid_snapshots_state_only():
    pool = _pool()
    s = pool.alloc()
    pool.prepare_append(s, 0, PS)
    pool.lengths[s] = PS
    for _, _, v in _state_items(pool.cache):
        v[:, s] = 1.0
    copies = pool.stats["page_copies"]
    entry = pool.park(s)
    assert entry.state is not None and "l0" not in entry.state
    assert set(entry.state["l1"]) == {"conv_x", "conv_B", "conv_C", "ssd"}
    assert pool.stats["state_copies"] == 1
    d = pool.alloc()
    pool.unpark(d, entry)
    assert pool.stats["state_copies"] == 2
    assert pool.stats["page_copies"] == copies          # pages by reference
    for _, _, v in _state_items(pool.cache):
        assert bool((v[:, d] == 1.0).all())


def test_partial_hits_only_at_state_boundaries():
    pool = _pool()
    toks = np.arange(32, dtype=np.int32)
    _register(pool, toks)
    longer = np.concatenate([toks, np.array([99, 98], np.int32)])
    assert pool.peek_longest(longer) == 32
    assert pool.peek_longest(toks[:20]) == 0     # mid-run: no state there
    entry = pool.lookup_longest(longer, max_len=len(longer) - 1)
    assert entry is not None and entry.length == 32
    assert entry.state is not None


def test_reregistration_skips_state_copy():
    pool = _pool()
    toks = np.arange(32, dtype=np.int32)
    _register(pool, toks)
    assert pool.stats["state_copies"] == 1
    _register(pool, toks)
    assert pool.stats["state_copies"] == 1
    assert pool.stats["prefix_refreshes"] == 1
    ver = pool.prefix_version
    _register(pool, toks)
    assert pool.prefix_version == ver
    # a registration ending inside the run splits it and snapshots there
    _register(pool, toks[:16])
    assert pool.stats["state_copies"] == 2
    assert pool.peek_longest(np.concatenate([toks[:16], [99]])) == 16


def test_pure_ssm_paged_pool_has_no_arena():
    pool = _pool(PURE)
    assert pool.arena_bytes() == 0
    assert set(pool.cache["l0"]) == {"conv_x", "conv_B", "conv_C", "ssd"}
    assert pool.cache["l0"]["ssd"].shape[1] == 4      # per slot
    toks = np.arange(20, dtype=np.int32)
    _register(pool, toks)
    b = pool.alloc()
    entry = pool.lookup_longest(np.concatenate([toks, [7]]), max_len=20)
    pool.restore_prefix(b, entry)
    pool.prepare_append(b, 20, 5)          # COW of the shared tail page
    assert pool.stats["page_copies"] == 1 and pool.stats["state_copies"] == 2
    hybrid = _pool()
    assert hybrid.arena_bytes() == 2 * 1 * 33 * PS * 2 * 16 * 4   # k, v
    slab = make_pool(cfgs(PURE, kv_layout="slab")[1], 2, 64, device="cpu")
    assert isinstance(slab, KVCachePool) and slab.has_state_leaves
    dense = dataclasses.replace(cfgs(HYBRID)[1], family="dense",
                                hybrid_period=0, ssm=None)
    assert not make_pool(dense, 2, 64, device="cpu").has_state_leaves
