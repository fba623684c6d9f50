"""The port's speculative decode against the JAX package, on the CPU.

* ``_ngram_draft`` equals the JAX proposer on seeded histories for draft
  widths 1 to 5, and on the edge cases: a history shorter than the
  n-gram, a match right at the frontier (whose continuation would run
  into unwritten history), and no match.
* ``forward_spec_step`` equals JAX on TINY, the qwen2.5-3b smoke config
  and a tiny hybrid (attention + Mamba-2), slab and paged, over a mix of
  lanes: one whose history proposes the model's own greedy continuation
  (accepts everything), one whose drafts leave it after one token, an
  inactive lane and one with no match.  Tokens, accepts, next tokens,
  lengths and history (but its scratch column, which both sides use as a
  sink) are exact; the verify's logits within 3e-5; the cache rows
  below the new lengths within 3e-5 (the hybrid's within 2e-4, the
  port's Mamba-2 tolerance against JAX), the Mamba-2 states within 2e-4,
  an inactive lane's state bit for bit unchanged.
* Engine streams with ``spec_k=4`` equal the port's isolated greedy
  oracle on the dense slab and paged layouts, with drafts accepted; on
  the hybrid under the fixed-chunk ``chunked`` policy, spec-on streams
  equal spec-off streams; rollback across copy-on-write pages of a
  shared prompt (page 16) keeps the streams and the page accounting; an
  engine that served react traffic then serves constant-prompt agents
  with drafts accepted, streams equal to the oracle.
* A verify with ``write_states=False`` leaves the Mamba-2 states as they
  were and scores what a state-writing verify scores.
* ``repro_torch.launch.serve --spec-k 4 --device cpu`` finishes.
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
from repro.models import model as jmodel  # noqa: E402
from conftest import TINY  # noqa: E402

import repro_torch.models as tm  # noqa: E402
from repro_torch.models.model import _ngram_draft  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels.decode_attention import paged_gather  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.oracle import oracle_streams  # noqa: E402
from repro_torch.serving.request import (AgentTurn, Session,  # noqa: E402
                                         SessionState)
from repro_torch.serving.workload import make_workload  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
SSM_TOL = dict(rtol=2e-4, atol=2e-4)
B, S_MAX, PROMPT = 4, 64, 24
HYBRID = JModelConfig(
    name="tiny-spec-step-hybrid", family="hybrid", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
    tie_embeddings=True, source="test",
    ssm=JSSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                   chunk_size=32),
    hybrid_period=2, hybrid_attn_index=0)
CONFIGS = {"tiny": lambda: TINY,
           "qwen2.5-3b-smoke": lambda: j_smoke("qwen2.5-3b"),
           "tiny-hybrid": lambda: HYBRID}
# (slots, max_seq) of the engine runs: a pair no JAX test uses
SLOTS, MAX_SEQ = 5, 1024


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def port_cfg(jcfg, **kw):
    vals = {f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(tbase.ModelConfig)}
    if jcfg.ssm is not None:
        vals["ssm"] = tbase.SSMConfig(**dataclasses.asdict(jcfg.ssm))
    vals.update(kw)
    return tbase.ModelConfig(**vals)


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# the proposer
# ---------------------------------------------------------------------------

def _drafts(history, tokens, lengths, k, ngram=3):
    want = jmodel._ngram_draft(jnp.asarray(history), jnp.asarray(tokens),
                               jnp.asarray(lengths), num_draft=k,
                               ngram=ngram)
    got = _ngram_draft(_t(history), _t(tokens), _t(lengths), num_draft=k,
                          ngram=ngram)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_ngram_draft_matches_jax(k):
    """Seeded histories over a 4-token alphabet (many matches, most
    recent wins), every frontier from 0 to S - 1."""
    rng = np.random.default_rng(k)
    S = 40
    for _ in range(8):
        hist = rng.integers(0, 4, (S, S)).astype(np.int32)
        lengths = np.arange(S, dtype=np.int32)
        tokens = rng.integers(0, 4, S).astype(np.int32)
        _drafts(hist, tokens, lengths, k)


def test_ngram_draft_edge_cases():
    S, k = 16, 4
    hist = np.zeros((4, S), np.int32)
    # lane 0: history shorter than the n-gram's context: no proposal
    hist[0, :1] = [7]
    # lane 1: the only match of the pattern [1, 2, 1] ends at position 6,
    # so 3 tokens after it would run past the frontier at 8: no proposal
    hist[1, :8] = [9, 9, 9, 9, 1, 2, 1, 2]
    # lane 2: no earlier occurrence of the pattern
    hist[2, :8] = [1, 2, 3, 4, 5, 6, 7, 8]
    # lane 3: a match with a full continuation: it is proposed
    hist[3, :10] = [5, 6, 9, 10, 11, 12, 13, 14, 5, 6]
    lengths = np.asarray([1, 8, 8, 10], np.int32)
    tokens = np.asarray([7, 1, 9, 9], np.int32)
    x = _drafts(hist, tokens, lengths, k)
    np.testing.assert_array_equal(x[:3], np.repeat(tokens[:3, None], k, 1))
    np.testing.assert_array_equal(x[3], [9, 10, 11, 12])
    # one draft token after the frontier match stays within known history
    x = _drafts(hist, tokens, lengths, 2)
    np.testing.assert_array_equal(x[1], [1, 2])


# ---------------------------------------------------------------------------
# the step: draft, verify, accept
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    jcfg = CONFIGS[request.param]()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = port_cfg(jcfg)
    tp = tm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tables(rng, jcfg, tcfg):
    ps = jcfg.kv_page_size
    pmax = S_MAX // ps
    num_pages = tm.num_kv_pages(tcfg, B, S_MAX)
    return rng.permutation(num_pages)[:B * pmax].reshape(
        B, pmax).astype(np.int32)


def _layout(jcfg, tcfg, layout):
    if layout == "slab":
        return jcfg, tcfg
    return (dataclasses.replace(jcfg, kv_layout="paged", kv_page_size=8),
            dataclasses.replace(tcfg, kv_layout="paged", kv_page_size=8))


def _rows(cache, name, leaf, bt):
    """[G, B, S, ...] logical rows of one cache leaf (paged: gathered
    through the tables)."""
    a = _t(cache[name][leaf])
    if bt is None:
        return a
    return torch.stack([paged_gather(a[g], _t(bt)) for g in range(a.shape[0])])


class StepCase:
    """Both packages' caches after the same cold prefill, the lanes'
    lengths, pending tokens and histories, and the model's own greedy
    continuation of each lane (from JAX's decode megastep)."""

    def __init__(self, model, layout, k, seed):
        jcfg, tcfg, self.jp, self.tp = model
        self.jcfg, self.tcfg = _layout(jcfg, tcfg, layout)
        self.k = k
        rng = np.random.default_rng(seed)
        V = jcfg.vocab_size
        self.bt = None if layout == "slab" else _tables(rng, self.jcfg,
                                                        self.tcfg)
        bt_kw = {} if self.bt is None else {"block_tables": self.bt}
        prompt = rng.integers(0, V, (B, PROMPT)).astype(np.int32)
        jc = jm.init_cache(self.jcfg, B, S_MAX)
        jl, self.jc, _ = jm.forward_prefill(
            self.jp, self.jcfg, jnp.asarray(prompt), jc,
            jnp.zeros(B, jnp.int32),
            **{n: jnp.asarray(v) for n, v in bt_kw.items()})
        self.tc = tm.init_cache(self.tcfg, B, S_MAX, device="cpu")
        tl, self.tc, _ = tm.forward_prefill(
            self.tp, self.tcfg, _t(prompt), self.tc,
            torch.zeros(B, dtype=torch.int32),
            **{n: _t(v) for n, v in bt_kw.items()})
        self.bt_kw = bt_kw
        self.tokens = np.asarray(jnp.argmax(jl, -1), np.int32)
        self.lengths = np.full(B, PROMPT, np.int32)
        self.active = np.asarray([True, True, False, True])
        # the greedy continuation after each lane's pending token
        cont, *_ = jm.forward_decode_megastep(
            self.jp, self.jcfg, jnp.asarray(self.tokens), self.jc,
            jnp.asarray(self.lengths), jnp.ones(B, bool), num_steps=k,
            **{n: jnp.asarray(v) for n, v in bt_kw.items()})
        cont = np.asarray(cont).T                                   # [B, k]
        hist = np.zeros((B, S_MAX), np.int32)
        hist[:, :PROMPT] = prompt
        # lanes 0 and 1: an earlier occurrence of the frontier's 3-gram
        # followed by the continuation (lane 1's wrong after one token);
        # lane 3 keeps the bare prompt (no match expected)
        for b, good in ((0, k - 1), (1, 1), (2, k - 1)):
            j = 4
            hist[b, j - 2: j] = prompt[b, PROMPT - 2:]
            hist[b, j] = self.tokens[b]
            follow = cont[b, :k - 1].copy()
            follow[good:] = (follow[good:] + 1) % V
            hist[b, j + 1: j + k] = follow
        self.history = hist

    def jax_step(self):
        return jm.forward_spec_step(
            self.jp, self.jcfg, jnp.asarray(self.history),
            jnp.asarray(self.tokens), self.jc, jnp.asarray(self.lengths),
            jnp.asarray(self.active), num_draft=self.k,
            **{n: jnp.asarray(v) for n, v in self.bt_kw.items()})

    def port_step(self):
        return tm.forward_spec_step(
            self.tp, self.tcfg, _t(self.history), _t(self.tokens), self.tc,
            _t(self.lengths), _t(self.active), num_draft=self.k,
            **{n: _t(v) for n, v in self.bt_kw.items()})


def _tol(tcfg):
    return SSM_TOL if tcfg.ssm is not None else F32


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_forward_spec_step_matches_jax(model, layout, k):
    c = StepCase(model, layout, k, seed=k)
    # the verify's logits first, on copies of the caches
    x = _ngram_draft(_t(c.history), _t(c.tokens), _t(c.lengths),
                        num_draft=k, ngram=3)
    kfull = np.where(c.active, k, 0).astype(np.int32)
    jlog, _ = jm.forward_spec_verify(
        c.jp, c.jcfg, jnp.asarray(x.numpy()), c.jc, jnp.asarray(c.lengths),
        jnp.asarray(c.active), jnp.asarray(kfull),
        **{n: jnp.asarray(v) for n, v in c.bt_kw.items()})
    scratch = {n: {kk: v.clone() for kk, v in layer.items()}
               for n, layer in c.tc.items()}
    tlog, _ = tm.forward_spec_verify(
        c.tp, c.tcfg, x, scratch, _t(c.lengths), _t(c.active), _t(kfull),
        **{n: _t(v) for n, v in c.bt_kw.items()})
    act = np.flatnonzero(c.active)
    np.testing.assert_allclose(tlog.numpy()[act], np.asarray(jlog)[act],
                               **F32)

    before = {n: {kk: v.clone() for kk, v in layer.items()}
              for n, layer in c.tc.items()}
    jt, jacc, jnt, jh, jc, jlen = c.jax_step()
    tt, tacc, tnt, th, tc, tlen = c.port_step()
    acc = np.asarray(jacc)
    # the lanes cover what they were built for
    assert acc[0] == k and acc[2] == 0
    if k > 2:
        assert acc[1] == 2
    for got, want in ((tt, jt), (tacc, jacc), (tnt, jnt), (tlen, jlen)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(th.numpy()[:, :-1], np.asarray(jh)[:, :-1])
    new_len = np.asarray(jlen)
    for name, layer in jc.items():
        for leaf in layer:
            if leaf in tm.POSITIONAL_CACHE_KEYS:
                got = _rows(tc, name, leaf, c.bt).numpy()
                want = _rows(jc, name, leaf, c.bt).numpy()
                for b in range(B):
                    np.testing.assert_allclose(got[:, b, :new_len[b]],
                                               want[:, b, :new_len[b]],
                                               **_tol(c.tcfg))
            else:
                np.testing.assert_allclose(tc[name][leaf].numpy(),
                                           np.asarray(layer[leaf]), **SSM_TOL)
                # the inactive lane's state is untouched
                assert torch.equal(tc[name][leaf][:, 2],
                                   before[name][leaf][:, 2])


def test_forward_spec_verify_without_state_writes():
    """``write_states=False`` (the hybrid step's first verify) leaves
    every Mamba-2 state bit for bit as it was and scores the same logits
    and K/V rows as a verify that writes the states."""
    jcfg = HYBRID
    tcfg = port_cfg(jcfg)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(3))
    tp = tm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    c = StepCase((jcfg, tcfg, jp, tp), "slab", 4, seed=4)
    x = _ngram_draft(_t(c.history), _t(c.tokens), _t(c.lengths),
                     num_draft=4, ngram=3)
    kfull = _t(np.where(c.active, 4, 0).astype(np.int32))
    copy = lambda: {n: {kk: v.clone() for kk, v in layer.items()}
                    for n, layer in c.tc.items()}
    kept, written = copy(), copy()
    got, kept = tm.forward_spec_verify(tp, tcfg, x, kept, _t(c.lengths),
                                       _t(c.active), kfull,
                                       write_states=False)
    want, written = tm.forward_spec_verify(tp, tcfg, x, written,
                                           _t(c.lengths), _t(c.active),
                                           kfull)
    assert torch.equal(got, want)
    n_state = 0
    for name, layer in kept.items():
        for leaf, v in layer.items():
            if leaf in tm.POSITIONAL_CACHE_KEYS:
                assert torch.equal(v, written[name][leaf])
            else:
                n_state += 1
                assert torch.equal(v, c.tc[name][leaf])
                assert not torch.equal(written[name][leaf], c.tc[name][leaf])
    assert n_state > 0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

DENSE = tbase.ModelConfig(
    name="tiny-spec-engine", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
    tie_embeddings=True, source="test")
ECFG = dict(num_slots=SLOTS, max_seq=MAX_SEQ, cycle_budget=80, granularity=8,
            b_min=8, b_max=128, b_init=32, delta_b=8,
            control_interval_s=0.05, max_wall_s=120.0, record_events=True,
            autotune_chunks=False)


@pytest.fixture(scope="module")
def dense_params():
    return tm.init_params(DENSE, torch.Generator().manual_seed(0))


def _run(cfg, params, *, spec_k, policy="agentserve", seed=1,
         token_scale=0.125, stagger_s=0.0, align_prefix=0, **kw):
    sessions = make_workload(3, workload="react", vocab_size=cfg.vocab_size,
                             token_scale=token_scale, num_system_prompts=1,
                             seed=seed, stagger_s=stagger_s)
    if align_prefix:
        for s in sessions:
            s.shared_prefix_len = (s.shared_prefix_len
                                   // align_prefix) * align_prefix
    eng = ServingEngine(cfg, params, policy,
                        EngineConfig(**{**ECFG, **kw}, spec_k=spec_k),
                        device="cpu")
    eng.run(sessions)
    assert all(s.state == SessionState.FINISHED for s in sessions)
    streams = {}
    for ev in eng.event_log:
        assert not ev.error
        streams.setdefault(ev.session_id, []).append(ev.token)
    for s in sessions:
        assert len(streams[s.session_id]) == s.output_tokens() == sum(
            t.decode_len for t in s.turns)
    if spec_k:
        assert eng.hotpath_stats["spec_steps"] > 0
        assert eng.hotpath_stats["spec_proposed"] > 0
    return eng, streams, sessions


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_engine_spec_streams_match_port_oracle(dense_params, layout):
    cfg = dataclasses.replace(DENSE, kv_layout=layout, kv_page_size=64)
    eng, on, sessions = _run(cfg, dense_params, spec_k=4)
    want = oracle_streams(DENSE, dense_params, sessions, num_slots=SLOTS,
                          max_seq=MAX_SEQ, device="cpu")
    assert on == want
    hs = eng.hotpath_stats
    assert hs["spec_accepted"] > 0          # drafts were taken, and rolled
    assert hs["spec_accepted"] < hs["spec_proposed"]     # back when not
    assert eng.tokens_per_model_call() > 1.0
    assert eng.stats()["spec_acceptance_rate"] == pytest.approx(
        hs["spec_accepted"] / hs["spec_proposed"])
    assert eng.pool.free_slots == SLOTS


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_engine_spec_second_run_accepts_repetition(dense_params, layout):
    """An engine that has served react traffic serves a second cohort
    whose constant prompts drive the greedy stream into an attractor
    (ids after the first cohort's, so no acceptance EMA carries over):
    streams equal the oracle, drafts are accepted and rolled back."""
    cfg = dataclasses.replace(DENSE, kv_layout=layout, kv_page_size=64)
    eng, _, _ = _run(cfg, dense_params, spec_k=4)
    before = dict(eng.hotpath_stats)

    def cohort():
        return [Session(session_id=1000 + i, turns=[
            AgentTurn(np.full(64, t, np.int32), 40, 0.05),
            AgentTurn(np.full(16, t, np.int32), 40, 0.0)])
            for i, t in enumerate((3, 50, 97))]
    sessions = cohort()
    eng.run(sessions)
    streams = {}
    for ev in eng.event_log:
        assert not ev.error
        streams.setdefault(ev.session_id, []).append(ev.token)
    assert all(s.output_tokens() == 80 for s in sessions)
    assert streams == oracle_streams(DENSE, dense_params, cohort(),
                                     num_slots=SLOTS, max_seq=MAX_SEQ,
                                     device="cpu")
    d = {k: eng.hotpath_stats[k] - before[k]
         for k in ("spec_steps", "spec_proposed", "spec_accepted")}
    assert d["spec_steps"] > 0
    assert 0 < d["spec_accepted"] < d["spec_proposed"]
    assert eng.pool.free_slots == SLOTS


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_engine_spec_hybrid_equals_spec_off(layout):
    """Hybrid streams are schedule-independent only up to the SSD chunk
    boundaries, so the reference is the spec-off engine on the same fixed
    chunks; every rejected draft goes through the fenced re-run."""
    cfg = port_cfg(HYBRID, kv_layout=layout, kv_page_size=64)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    kw = dict(policy="chunked", megastep_max=4)
    _, off, _ = _run(cfg, params, spec_k=0, **kw)
    eng, on, _ = _run(cfg, params, spec_k=4, **kw)
    assert on == off
    hs = eng.hotpath_stats
    assert hs["spec_accepted"] < hs["spec_proposed"]


def test_engine_spec_rollback_over_cow_page_boundary(dense_params):
    """Page 16 and a shared system prompt: rejected drafts roll back
    across pages copied from the shared prefix.  Streams equal the
    oracle, and the page accounting balances (no page leaked or freed
    twice)."""
    page = 16
    cfg = dataclasses.replace(DENSE, kv_layout="paged", kv_page_size=page)
    eng, on, sessions = _run(cfg, dense_params, spec_k=4, seed=3,
                             stagger_s=0.02, align_prefix=page)
    want = oracle_streams(DENSE, dense_params, sessions, num_slots=SLOTS,
                          max_seq=MAX_SEQ, device="cpu")
    assert on == want
    pool = eng.pool
    assert pool.stats["prefix_hits"] >= 1            # sharing happened
    mapped = pool.block_table[pool.block_table >= 0]
    assert all(pool.refcount[p] >= 1 for p in mapped)
    assert not (set(pool._free_pages) & set(int(p) for p in mapped))
    assert (pool.stats["page_allocs"] - pool.stats["page_frees"]
            == pool.pages_in_use)


def test_engine_spec_levels_and_planner_view(dense_params):
    ecfg = EngineConfig(**{**ECFG, "spec_k": 5})
    eng = ServingEngine(DENSE, dense_params, "agentserve", ecfg,
                        device="cpu")
    assert eng.specsteps.levels == [2, 4]
    assert eng.snapshot().spec_levels == (2, 4)
    off = ServingEngine(DENSE, dense_params, "agentserve",
                        EngineConfig(**ECFG), device="cpu")
    assert off.specsteps is None and off.snapshot().spec_levels == ()


def test_serve_spec_k_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--agents", "2",
                       "--token-scale", "0.04", "--spec-k", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("policy,")
    assert lines[1].startswith("agentserve,2,")
