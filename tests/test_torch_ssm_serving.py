"""The port's serving stack on Mamba-2 and hybrid stacks, on the CPU.

* For the mamba2-780m smoke config and a tiny hybrid (attention +
  Mamba-2, ``hybrid_period=2``), the port oracle's streams equal the JAX
  package's ``oracle_streams`` on the same weights.
* Slab and paged engine streams are token-identical under the
  ``chunked`` policy with ``autotune_chunks=False`` and
  ``prefix_cache="exact"`` on both legs (fixed chunk boundaries: a
  recurrent stream is schedule-independent only up to the SSD chunk
  boundaries, as in the JAX package's test of the same), the staggered
  agents restore the shared system prompt's state snapshot, and every
  session finishes with all its tokens.  The adaptive engine's streams
  equal the port oracle's.
* ``repro_torch.launch.serve --arch mamba2-780m --device cpu`` finishes
  on both layouts, and raises without ``--device cpu`` when no card is
  present.
* The AST scan of ``test_torch_serving.py`` covers the new modules.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.models as jm  # noqa: E402
from _serving_util import oracle_streams as jax_oracle_streams  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.oracle import oracle_streams  # noqa: E402
from repro_torch.serving.policies import POLICIES  # noqa: E402
from repro_torch.serving.request import SessionState  # noqa: E402
from repro_torch.serving.workload import shared_prefix_workload  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HYBRID = JModelConfig(
    name="tiny-serve-hybrid", family="hybrid", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
    tie_embeddings=True, source="test",
    ssm=JSSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                   chunk_size=32),
    hybrid_period=2, hybrid_attn_index=0)
CONFIGS = {"mamba2-780m-smoke": lambda: j_smoke("mamba2-780m"),
           "tiny-hybrid": lambda: HYBRID}
# a (slots, max_seq) pair no JAX test uses: the JAX oracle warms the JAX
# engine's process-wide executable cache under this key
SLOTS, MAX_SEQ, PAGE = 4, 320, 32


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def port_cfg(jcfg, **kw):
    vals = {f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(tbase.ModelConfig)}
    vals["ssm"] = tbase.SSMConfig(**dataclasses.asdict(jcfg.ssm))
    vals.update(kw)
    return tbase.ModelConfig(**vals)


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    jcfg = CONFIGS[request.param]()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = port_cfg(jcfg)
    return jcfg, jp, tcfg, from_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                                           device="cpu")


def _sessions(vocab, n=3, seed=5):
    """Agents of one system-prompt template, 1 s apart: the first has
    registered the shared stem before the next arrives."""
    return shared_prefix_workload(n, num_templates=1, vocab_size=vocab,
                                  token_scale=0.04, seed=seed, stagger_s=1.0)


def _ecfg(**kw):
    return EngineConfig(num_slots=SLOTS, max_seq=MAX_SEQ, cycle_budget=48,
                        granularity=16, b_min=16, b_max=64, b_init=32,
                        delta_b=16, control_interval_s=0.05,
                        max_wall_s=120.0, megastep_max=4,
                        resume_batch_max=2, autotune_chunks=False,
                        record_events=True, **kw)


def _serve(cfg, params, policy, **kw):
    sessions = _sessions(cfg.vocab_size)
    eng = ServingEngine(cfg, params, POLICIES[policy], _ecfg(**kw),
                        device="cpu")
    eng.run(sessions)
    streams = {}
    for ev in eng.event_log:
        assert not ev.error
        streams.setdefault(ev.session_id, []).append(ev.token)
    for s in sessions:
        assert s.state == SessionState.FINISHED
        assert s.output_tokens() == sum(t.decode_len for t in s.turns)
        assert len(streams[s.session_id]) == s.output_tokens()
    assert eng.pool.free_slots == SLOTS
    return streams, eng


def test_port_oracle_matches_jax_oracle(model):
    jcfg, jp, tcfg, tp = model
    sessions = _sessions(jcfg.vocab_size, n=2, seed=8)
    want = jax_oracle_streams(jcfg, jp, sessions, num_slots=SLOTS,
                              max_seq=MAX_SEQ)
    got = oracle_streams(tcfg, tp, sessions, num_slots=SLOTS,
                         max_seq=MAX_SEQ, device="cpu")
    assert got == want


def test_slab_and_paged_engines_are_token_identical(model):
    _, _, tcfg, tp = model
    slab, eng_s = _serve(tcfg, tp, "chunked", prefix_cache="exact")
    paged, eng_p = _serve(
        dataclasses.replace(tcfg, kv_layout="paged", kv_page_size=PAGE), tp,
        "chunked", prefix_cache="exact")
    assert paged == slab
    for eng in (eng_s, eng_p):
        assert eng.pool.stats["prefix_hits"] > 0
        assert eng.pool.stats["state_copies"] > 0
    assert eng_p.pool.stats["page_allocs"] > 0
    has_attn = any("k" in layer for layer in eng_p.pool.cache.values())
    assert (eng_p.pool.arena_bytes() > 0) == has_attn


def test_engine_streams_match_port_oracle(model):
    _, _, tcfg, tp = model
    paged = dataclasses.replace(tcfg, kv_layout="paged", kv_page_size=PAGE)
    streams, eng = _serve(paged, tp, "agentserve")
    want = oracle_streams(tcfg, tp, _sessions(tcfg.vocab_size),
                          num_slots=SLOTS, max_seq=MAX_SEQ, device="cpu")
    assert streams == want
    assert eng.hotpath_stats["resume_batches"] > 0


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_serve_entry_point_mamba2_on_cpu(layout, capsys):
    assert serve.main(["--arch", "mamba2-780m", "--device", "cpu",
                       "--agents", "2", "--token-scale", "0.04",
                       "--kv-layout", layout]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("policy,")
    assert lines[1].startswith("agentserve,2,")


def test_serve_entry_point_mamba2_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2-780m", "--agents", "2",
                    "--token-scale", "0.04"])


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_import_scan_covers_the_ssm_modules():
    """The AST scan in test_torch_serving.py walks every module of the
    port; the modules of this slice are among them and import neither
    JAX nor the JAX package."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    names = {f.relative_to(ROOT / "src").as_posix() for f in files}
    for new in ("repro_torch/models/mamba2.py",
                "repro_torch/kernels/ssd_scan.py",
                "repro_torch/configs/mamba2_780m.py"):
        assert new in names
        for mod in _imports(ROOT / "src" / new):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod
    assert (ROOT / "src/repro_torch/kernels/csrc/ssd_scan.cu").exists()
