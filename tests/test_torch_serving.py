"""Port serving stack: the slab KV pool, the isolated greedy oracle, the
engine and the closed-loop entry point, on the CPU.

The port oracle is held against the JAX package's ``oracle_streams`` on
the same numpy weights and sessions (forward-level equality, no
scheduler).  The port engine is held against the port oracle only: the
JAX engine's streams depend on timing-driven chunk shapes, so they are
not a fixed reference.  An AST scan keeps JAX and the JAX package out of
the port and of ``chip_smoke.py``.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _serving_util import oracle_streams as jax_oracle_streams  # noqa: E402
from conftest import TINY  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import from_jax_params, init_params  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.kvcache import (KVCachePool,  # noqa: E402
                                         PagedKVCachePool, make_pool)
from repro_torch.serving.oracle import oracle_streams  # noqa: E402
from repro_torch.serving.workload import make_workload  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = ModelConfig(**{k: getattr(TINY, k) for k in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "tie_embeddings", "source")})
# a (slots, max_seq) pair no JAX test uses: the JAX oracle below warms the
# JAX engine's process-wide executable cache under this key
SLOTS, MAX_SEQ = 3, 384


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0))


def _sessions(n=3, seed=1):
    return make_workload(n, vocab_size=CFG.vocab_size, token_scale=0.04,
                         seed=seed)


# ---------------------------------------------------------------------------
# pool
# ---------------------------------------------------------------------------

def _write_rows(pool, slot, n, value):
    for leaf in pool.cache["l0"].values():
        leaf[:, slot, :n] = value
    pool.lengths[slot] = n


def test_pool_alloc_free_double_free():
    pool = KVCachePool(CFG, 3, 32, device="cpu")
    slots = [pool.alloc() for _ in range(3)]
    assert slots == [0, 1, 2] and pool.free_slots == 0
    with pytest.raises(RuntimeError):
        pool.alloc()
    pool.free(1)
    with pytest.raises(ValueError):
        pool.free(1)
    with pytest.raises(ValueError):
        pool.free(7)
    assert pool.alloc() == 1 and pool.lengths[1] == 0


def test_pool_prefix_register_lookup_restore():
    pool = KVCachePool(CFG, 3, 32, device="cpu")
    a, b = pool.alloc(), pool.alloc()
    toks = np.arange(5, dtype=np.int32)
    _write_rows(pool, a, 5, 3.0)
    pool.register_prefix(a, toks)
    assert pool.peek_prefix(toks) == 5 and pool.peek_longest(toks) == 5
    assert pool.peek_longest(toks, max_len=4) == 0
    assert pool.lookup(toks[:4]) is None
    entry = pool.lookup_longest(toks)
    assert entry is not None and pool.stats["prefix_hits"] == 1
    _write_rows(pool, a, 5, -1.0)            # the donor moves on
    pool.restore_prefix(b, entry)
    assert pool.lengths[b] == 5
    assert torch.all(pool.cache["l0"]["k"][:, b, :5] == 3.0)
    pool.register_prefix(a, np.full(5, 9, np.int32))
    assert pool.prefix_version == 2


def test_pool_park_unpark_truncate():
    pool = make_pool(CFG, 2, 32, device="cpu")
    s = pool.alloc()
    _write_rows(pool, s, 7, 2.5)
    entry = pool.park(s)
    assert pool.free_slots == 2 and entry.length == 7
    t = pool.alloc()
    _write_rows(pool, t, 3, 0.0)             # the slot was reused meanwhile
    pool.free(t)
    u = pool.alloc()
    pool.unpark(u, entry)
    assert pool.lengths[u] == 7
    assert torch.all(pool.cache["l0"]["v"][:, u, :7] == 2.5)
    pool.truncate(u, 4)
    pool.truncate(u, 4)                      # idempotent
    assert pool.lengths[u] == 4
    assert list(pool.lengths_device().tolist()) == [4, 0]
    # commit keeps the old rows of slots outside the mask
    new = {"l0": {k: torch.full_like(v, 7.0) for k, v in pool.cache["l0"].items()}}
    pool.commit(new, np.asarray([False, True]))
    assert torch.all(pool.cache["l0"]["k"][:, 1] == 7.0)
    assert torch.all(pool.cache["l0"]["k"][:, 0, :7] == 2.5)
    # the paged layout has its own pool (tests/test_torch_radix.py)
    paged = make_pool(ModelConfig(**{**CFG.__dict__, "kv_layout": "paged"}),
                      2, 64, device="cpu")
    assert isinstance(paged, PagedKVCachePool)


# ---------------------------------------------------------------------------
# oracle and engine
# ---------------------------------------------------------------------------

def test_port_oracle_matches_jax_oracle():
    jp = jax_init_params(TINY, jax.random.PRNGKey(0))
    tp = from_jax_params(CFG, jax.tree.map(np.asarray, jp), device="cpu")
    sessions = _sessions(2, seed=5)
    want = jax_oracle_streams(TINY, jp, sessions, num_slots=SLOTS,
                              max_seq=MAX_SEQ)
    got = oracle_streams(CFG, tp, sessions, num_slots=SLOTS, max_seq=MAX_SEQ,
                         device="cpu")
    assert got == want


@pytest.mark.parametrize("policy", ["agentserve", "fcfs"])
def test_engine_streams_match_port_oracle(params, policy):
    ecfg = EngineConfig(num_slots=SLOTS, max_seq=MAX_SEQ, cycle_budget=64,
                        granularity=16, b_max=128, control_interval_s=0.05,
                        autotune_chunks=False, record_events=True)
    eng = ServingEngine(CFG, params, policy, ecfg, device="cpu")
    sessions = _sessions()
    rep = eng.run(sessions)
    assert rep.num_sessions == 3
    streams = {}
    for ev in eng.event_log:
        assert not ev.error
        streams.setdefault(ev.session_id, []).append(ev.token)
    for s in sessions:
        assert s.output_tokens() == sum(t.decode_len for t in s.turns)
    assert streams == oracle_streams(CFG, params, _sessions(),
                                     num_slots=SLOTS, max_seq=MAX_SEQ,
                                     device="cpu")
    assert eng.pool.free_slots == SLOTS
    if policy == "agentserve":
        assert eng.hotpath_stats["resume_batches"] > 0


def test_engine_rejects_unported_options(params):
    ecfg = dict(num_slots=SLOTS, max_seq=MAX_SEQ, cycle_budget=64,
                granularity=16, b_max=128, autotune_chunks=False)
    # speculative decode is ported: spec_k builds its draft-and-verify grid
    eng = ServingEngine(CFG, params, "agentserve",
                        EngineConfig(spec_k=4, **ecfg), device="cpu")
    assert eng.specsteps.levels == [2, 4]
    # M-RoPE (the VLM family) is not
    with pytest.raises(NotImplementedError):
        ServingEngine(dataclasses.replace(CFG, mrope=True), params,
                      "agentserve", EngineConfig(**ecfg), device="cpu")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def test_serve_entry_point_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--agents", "2",
                       "--token-scale", "0.04"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("policy,") and lines[1].startswith("agentserve,2,")


def test_serve_entry_point_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--agents", "2", "--token-scale", "0.04"])


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
