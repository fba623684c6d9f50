"""The port's paged KV pool and radix prefix cache, and the engine and
launcher on the paged layout, on the CPU.

``PagedKVCachePool`` is held against the JAX package's pool op for op:
one seeded random sequence of alloc, prepare_append, register (radix
and exact), lookup_longest + restore, park/unpark, truncate, free,
release and page-pressure eviction runs on both pools, and after every
op the block tables, refcounts, lengths, stats, radix node count, page
references of the index and free list must be equal, with the central
invariant of tests/test_radix.py holding:

    refcount.sum() == live block-table refs + parked-entry refs
                      + tree refs (``prefix_page_refs``)

The engine on the paged layout is held against the port's own greedy
oracle (the JAX engine's streams depend on timing-driven chunk shapes).
"""
import dataclasses

import numpy as np
import pytest
from _hyp import given, settings, st

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.serving.kvcache import KVExhausted as JKVExhausted  # noqa: E402
from repro.serving.kvcache import PagedKVCachePool as JPool  # noqa: E402

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.kvcache import (KVExhausted, PagedKVCachePool,  # noqa: E402
                                         make_pool)
from repro_torch.serving.oracle import oracle_streams  # noqa: E402
from repro_torch.serving.request import (AgentTurn, Session,  # noqa: E402
                                         SessionState)
from repro_torch.serving.workload import shared_prefix_workload  # noqa: E402

PS = 8
FIELDS = dict(name="tiny-radix", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
              tie_embeddings=True, source="test", kv_layout="paged",
              kv_page_size=PS)
CFG = ModelConfig(**FIELDS)
JCFG = JModelConfig(**FIELDS)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the pool against the JAX pool, op for op
# ---------------------------------------------------------------------------

def _ref_invariant(pool, parked):
    slot_refs = int((pool.block_table >= 0).sum())
    parked_refs = sum(len(e.pages) for e in parked)
    assert int(pool.refcount.sum()) == (slot_refs + parked_refs
                                        + pool.prefix_page_refs)


def _assert_same(jp, tp, parked):
    np.testing.assert_array_equal(tp.block_table, jp.block_table)
    np.testing.assert_array_equal(tp.refcount, jp.refcount)
    np.testing.assert_array_equal(tp.lengths, jp.lengths)
    assert tp._free_pages == jp._free_pages
    assert tp.stats == {k: jp.stats[k] for k in tp.stats}
    assert jp.stats["state_copies"] == 0
    assert tp.radix_nodes == jp.radix_nodes
    assert tp.prefix_page_refs == jp.prefix_page_refs
    assert tp.prefix_version == jp.prefix_version
    _ref_invariant(tp, [t for _, t, _ in parked])


def _both(fn_j, fn_t):
    """Run one op on both pools; both must raise KVExhausted or neither."""
    out = []
    for fn, exc in ((fn_j, JKVExhausted), (fn_t, KVExhausted)):
        try:
            out.append(fn())
        except exc:
            out.append(exc)
    assert (out[0] is JKVExhausted) == (out[1] is KVExhausted), out
    return out


def _run_pool_twins(seed: int, mode: str):
    rng = np.random.default_rng(seed)
    kw = dict(num_pages=20, max_prefix_entries=5, prefix_cache=mode)
    jp = JPool(JCFG, 4, 64, **kw)
    tp = PagedKVCachePool(CFG, 4, 64, device="cpu", **kw)
    slots = {}                      # slot -> tokens held
    parked = []                     # (jax entry, port entry, tokens)
    registered = []

    def tokens(stem_from_registered=True):
        stem = np.zeros((0,), np.int32)
        if registered and stem_from_registered and rng.random() < 0.6:
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
        return True

    for _ in range(90):
        op = rng.random()
        if op < 0.22 and tp.free_slots:                 # alloc + claim
            s = jp.alloc()
            assert tp.alloc() == s
            toks = tokens()
            if claim(s, toks):
                slots[s] = toks
            else:
                jp.free(s)
                tp.free(s)
        elif op < 0.32 and slots:                       # append (COW)
            s = int(rng.choice(sorted(slots)))
            more = rng.integers(0, 4, size=int(rng.integers(1, 9)))
            if len(slots[s]) + len(more) <= 64 and claim(s, more):
                slots[s] = np.concatenate([slots[s], more]).astype(np.int32)
        elif op < 0.45 and slots:                       # register
            s = int(rng.choice(sorted(slots)))
            _both(lambda: jp.register_prefix(s, slots[s]),
                  lambda: tp.register_prefix(s, slots[s]))
            if len(slots[s]):
                registered.append(slots[s])
        elif op < 0.58 and registered and tp.free_slots:  # lookup + restore
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
                s = jp.alloc()
                assert tp.alloc() == s
                jp.restore_prefix(s, je)
                tp.restore_prefix(s, te)
                slots[s] = q[:te.length]
        elif op < 0.66 and slots:                       # park
            s = int(rng.choice(sorted(slots)))
            parked.append((jp.park(s), tp.park(s), slots.pop(s)))
        elif op < 0.74 and parked and tp.free_slots:    # unpark
            je, te, toks = parked.pop(int(rng.integers(len(parked))))
            s = jp.alloc()
            assert tp.alloc() == s
            jp.unpark(s, je)
            tp.unpark(s, te)
            slots[s] = toks
        elif op < 0.82 and slots:                       # truncate (twice)
            s = int(rng.choice(sorted(slots)))
            n = int(rng.integers(0, len(slots[s]) + 1))
            for _ in range(2):
                jp.truncate(s, n)
                tp.truncate(s, n)
            slots[s] = slots[s][:n]
        elif op < 0.90 and slots:                       # free (abort)
            s = int(rng.choice(sorted(slots)))
            jp.free(s)
            tp.free(s)
            del slots[s]
        elif op < 0.95 and parked:                      # release parked
            je, te, _ = parked.pop(int(rng.integers(len(parked))))
            jp.release_entry(je)
            tp.release_entry(te)
        elif mode == "radix":                           # direct eviction
            assert tp._radix_evict_one() == jp._radix_evict_one()
        _assert_same(jp, tp, parked)

    for je, te, _ in parked:
        jp.release_entry(je)
        tp.release_entry(te)
    for s in list(slots):
        jp.free(s)
        tp.free(s)
    _assert_same(jp, tp, [])
    assert int(tp.refcount.sum()) == tp.prefix_page_refs
    assert tp.stats["page_allocs"] > 0


@pytest.mark.parametrize("mode", ["radix", "exact"])
@pytest.mark.parametrize("seed", range(4))
def test_pool_matches_jax_pool_seeded(seed, mode):
    _run_pool_twins(seed, mode)


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=10_000),
       st.sampled_from(["radix", "exact"]))
def test_pool_matches_jax_pool_hypothesis(seed, mode):
    _run_pool_twins(seed, mode)


def test_cow_copies_the_page_and_leaves_the_original():
    """A restore that ends mid-page shares the boundary page; the first
    write past the restored length copies it (all layers, K and V) and
    the donor's page keeps its rows."""
    pool = PagedKVCachePool(CFG, 2, 64, device="cpu")
    a = pool.alloc()
    pool.prepare_append(a, 0, 12)
    pool.lengths[a] = 12
    for leaf in pool.cache["l0"].values():
        leaf[:, pool.block_table[a, :2]] = torch.randn(
            leaf[:, :2].shape)
    toks = np.arange(12, dtype=np.int32)
    pool.register_prefix(a, toks)
    b = pool.alloc()
    entry = pool.lookup_longest(np.concatenate([toks[:10], [99, 98]]),
                                max_len=11)
    assert entry.length == 10 and pool.stats["prefix_partial_hits"] == 1
    pool.restore_prefix(b, entry)
    shared = int(pool.block_table[b, 1])
    assert shared == pool.block_table[a, 1] and pool.refcount[shared] == 3
    before = {k: v[:, shared].clone() for k, v in pool.cache["l0"].items()}
    bt0 = pool.block_tables_device()
    assert pool.block_tables_device() is bt0        # unchanged: cached
    pool.prepare_append(b, 10, 1)
    fresh = int(pool.block_table[b, 1])
    assert fresh != shared and pool.stats["page_copies"] == 1
    assert pool.block_tables_device() is not bt0    # a new tensor
    assert int(bt0[b, 1]) == shared                 # the old one untouched
    for k, v in pool.cache["l0"].items():
        assert torch.equal(v[:, fresh], before[k])
        assert torch.equal(v[:, shared], before[k])
    assert int(pool.block_tables_device()[b, 2]) == pool.scratch_page


def test_make_pool_dispatches_on_layout():
    pool = make_pool(CFG, 2, 64, device="cpu", prefix_cache="exact")
    assert isinstance(pool, PagedKVCachePool) and pool.prefix_mode == "exact"
    assert pool.arena_bytes() == 2 * 2 * 17 * PS * 2 * 16 * 4
    new = {"l0": {k: v + 1 for k, v in pool.cache["l0"].items()}}
    pool.commit(new, np.asarray([True, False]))     # the arena is shared
    assert pool.cache is new
    slab = dataclasses.replace(CFG, kv_layout="slab")
    assert not isinstance(make_pool(slab, 2, 64, device="cpu"),
                          PagedKVCachePool)
    with pytest.raises(ValueError, match="multiple"):
        make_pool(CFG, 2, 60, device="cpu")
    with pytest.raises(NotImplementedError):      # MoE: not ported yet
        make_pool(dataclasses.replace(CFG, family="moe"), 2, 64,
                  device="cpu")


# ---------------------------------------------------------------------------
# the engine on the paged layout
# ---------------------------------------------------------------------------

SLOTS, MAX_SEQ = 3, 384


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0))


def _shared_sessions():
    """Two templates, four agents; the stem (84 tokens) ends mid-page.
    Agents 1 and 3 register and probe their whole cold prompt but one
    token, so agent 3 matches only its template's stem: a partial hit."""
    sessions = shared_prefix_workload(
        4, num_templates=2, divergence=0.3, vocab_size=CFG.vocab_size,
        token_scale=0.04, seed=2, stagger_s=0.15, turns_range=(2, 4))
    for s in sessions[1::2]:
        s.shared_prefix_len = len(s.turns[0].prefill_tokens) - 1
    return sessions


def _streams(eng):
    streams = {}
    for ev in eng.event_log:
        assert not ev.error, ev
        streams.setdefault(ev.session_id, []).append(ev.token)
    return streams


def _assert_pages_reclaimed(pool):
    """Every page is free or held by the prefix index."""
    assert (pool.block_table < 0).all() and pool.free_slots == pool.num_slots
    assert int(pool.refcount.sum()) == pool.prefix_page_refs
    assert pool.free_pages + int((pool.refcount > 0).sum()) == pool.num_pages


@pytest.mark.parametrize("policy,cache", [("agentserve", "radix"),
                                          ("fcfs", "radix"),
                                          ("agentserve", "exact")])
def test_engine_paged_streams_match_port_oracle(params, policy, cache):
    assert _shared_sessions()[0].shared_prefix_len % PS != 0
    ecfg = EngineConfig(num_slots=SLOTS, max_seq=MAX_SEQ, cycle_budget=64,
                        granularity=16, b_max=128, control_interval_s=0.05,
                        autotune_chunks=False, record_events=True,
                        prefix_cache=cache)
    eng = ServingEngine(CFG, params, policy, ecfg, device="cpu")
    sessions = _shared_sessions()
    eng.run(sessions)
    for s in sessions:
        assert s.state == SessionState.FINISHED
        assert s.output_tokens() == sum(t.decode_len for t in s.turns)
    assert _streams(eng) == oracle_streams(
        CFG, params, _shared_sessions(), num_slots=SLOTS, max_seq=MAX_SEQ,
        device="cpu")
    st = eng.pool.stats
    assert st["prefix_hits"] > 0
    if cache == "radix":
        assert st["prefix_partial_hits"] > 0 and st["page_copies"] > 0
        assert eng.stats()["radix_nodes"] > 0
    _assert_pages_reclaimed(eng.pool)


def _turn(toks, decode_len, tool_s=0.0):
    return AgentTurn(prefill_tokens=np.asarray(toks, np.int32),
                     decode_len=decode_len, tool_latency_s=tool_s)


def _pressure_sessions():
    """Session 0 fills a 9-page arena (8 pages mapped, its registered
    20-token stem ending mid-page keeps the 9th: session 0's own next
    write copied that page) and then waits on a tool.  Session 1
    restores the stem (a partial hit) and needs pages that do not exist
    until session 0 ends: its prefill must evict the stem's tree node
    and then defer on KVExhausted.  Both sessions stay inside the last
    page they map, so neither needs a page while the other waits."""
    rng = np.random.default_rng(4)
    stem = rng.integers(0, CFG.vocab_size, 20)
    s0 = Session(session_id=0, workload="pressure", shared_prefix_len=20,
                 turns=[_turn(np.concatenate([stem, rng.integers(0, 128, 37)]),
                              6, tool_s=2.0),
                        _turn(rng.integers(0, 128, 1), 1)])
    s1 = Session(session_id=1, workload="pressure", shared_prefix_len=40,
                 turns=[_turn(np.concatenate([stem, rng.integers(0, 128, 40)]),
                              4)])
    s0.ready_s, s1.ready_s = 0.0, 0.5
    return [s0, s1]


def test_engine_paged_eviction_and_kv_deferral_finish(params):
    ecfg = EngineConfig(num_slots=2, max_seq=128, cycle_budget=64,
                        granularity=16, b_max=128, control_interval_s=0.05,
                        autotune_chunks=False, record_events=True,
                        kv_pages=9, kv_defer_limit=10 ** 9)
    eng = ServingEngine(CFG, params, "agentserve", ecfg, device="cpu")
    sessions = _pressure_sessions()
    eng.run(sessions)
    for s in sessions:
        assert s.state == SessionState.FINISHED, s.state
        assert s.output_tokens() == sum(t.decode_len for t in s.turns)
    assert _streams(eng) == oracle_streams(
        CFG, params, _pressure_sessions(), num_slots=2, max_seq=128,
        device="cpu")
    st = eng.pool.stats
    assert st["prefix_partial_hits"] == 1 and st["evictions"] >= 1
    assert eng.hotpath_stats["kv_deferred"] > 0
    _assert_pages_reclaimed(eng.pool)


def test_serve_entry_point_paged_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--agents", "2",
                       "--token-scale", "0.04", "--kv-layout", "paged",
                       "--kv-page-size", "16"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("policy,") and lines[1].startswith("agentserve,2,")
