"""The port's serving stack on an MoE decoder, on the CPU.

* For the olmoe-1b-7b smoke config, the port oracle's streams equal the
  JAX package's ``oracle_streams`` on the same weights, under
  ``moe_mode`` "dense" (the engine's default) and "gmm".
* Slab and paged (radix) engine streams equal the port oracle's, with
  ``autotune_chunks=False`` as in the other port engine tests, and every
  session finishes with all its tokens.  Under "dense" a lane's tokens do
  not depend on the other lanes, so the adaptive schedule cannot change
  them.
* An engine built with ``moe_mode="gmm"`` runs every MoE slot of every
  executable it calls in "gmm" mode and finishes every session on both
  layouts.  Its streams are not held to the oracle: under "gmm" the rows
  of one call compete for expert capacity, so a stream depends on the
  schedule.
* ``repro_torch.launch.serve --arch olmoe-1b-7b --device cpu`` finishes
  on both layouts.
* The AST scan covers the new modules: they import neither JAX nor the
  JAX package.
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
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import blocks, from_jax_params  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.oracle import oracle_streams  # noqa: E402
from repro_torch.serving.policies import POLICIES  # noqa: E402
from repro_torch.serving.request import SessionState  # noqa: E402
from repro_torch.serving.workload import make_workload  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# a (slots, max_seq) pair no JAX test uses: the JAX oracle warms the JAX
# engine's process-wide executable cache under this key
SLOTS, MAX_SEQ, PAGE = 4, 352, 32


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    jcfg = j_smoke("olmoe-1b-7b")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tbase.get_smoke_config("olmoe-1b-7b")
    return jcfg, jp, tcfg, from_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                                           device="cpu")


def _sessions(vocab, n=3, seed=5):
    return make_workload(n, workload="react", vocab_size=vocab,
                         token_scale=0.04, seed=seed)


def _ecfg(**kw):
    return EngineConfig(num_slots=SLOTS, max_seq=MAX_SEQ, cycle_budget=48,
                        granularity=16, b_min=16, b_max=64, b_init=32,
                        delta_b=16, control_interval_s=0.05,
                        max_wall_s=120.0, megastep_max=4,
                        resume_batch_max=2, autotune_chunks=False,
                        record_events=True, **kw)


@pytest.mark.parametrize("moe_mode", ["dense", "gmm"])
def test_port_oracle_matches_jax_oracle(model, moe_mode):
    jcfg, jp, tcfg, tp = model
    sessions = _sessions(jcfg.vocab_size, n=2, seed=8)
    want = jax_oracle_streams(jcfg, jp, sessions, num_slots=SLOTS,
                              max_seq=MAX_SEQ, moe_mode=moe_mode)
    got = oracle_streams(tcfg, tp, sessions, num_slots=SLOTS,
                         max_seq=MAX_SEQ, device="cpu", moe_mode=moe_mode)
    assert got == want


def _spy_moe_modes(monkeypatch):
    """Record the mode of every MoE FFN call the layers make."""
    modes = []
    real = blocks.moe_output

    def spy(*args, mode, **kw):
        modes.append(mode)
        return real(*args, mode=mode, **kw)

    monkeypatch.setattr(blocks, "moe_output", spy)
    return modes


def _serve(cfg, params, sessions, ecfg):
    """Run the engine; check that every session finished with all its
    tokens and no error.  Returns (engine, {session_id: tokens})."""
    eng = ServingEngine(cfg, params, POLICIES["agentserve"], ecfg,
                        device="cpu")
    eng.run(sessions)
    streams = {}
    for ev in eng.event_log:
        assert not ev.error
        streams.setdefault(ev.session_id, []).append(ev.token)
    for s in sessions:
        assert s.state == SessionState.FINISHED
        assert s.output_tokens() == sum(t.decode_len for t in s.turns)
    assert eng.pool.free_slots == SLOTS
    return eng, streams


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_engine_streams_match_port_oracle(model, layout, monkeypatch):
    _, _, tcfg, tp = model
    cfg = dataclasses.replace(tcfg, kv_layout=layout, kv_page_size=PAGE)
    sessions = _sessions(cfg.vocab_size)
    modes = _spy_moe_modes(monkeypatch)
    ops.reset_launches()
    eng, streams = _serve(cfg, tp, sessions, _ecfg())
    assert eng.ecfg.moe_mode == "dense"
    assert modes and set(modes) == {"dense"}
    want = oracle_streams(tcfg, tp, _sessions(tcfg.vocab_size),
                          num_slots=SLOTS, max_seq=MAX_SEQ, device="cpu")
    assert streams == want
    assert eng.hotpath_stats["resume_batches"] > 0
    # CPU tensors run the plain versions: no kernel launch is counted
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_engine_serves_in_gmm_mode(model, layout, monkeypatch):
    _, _, tcfg, tp = model
    cfg = dataclasses.replace(tcfg, kv_layout=layout, kv_page_size=PAGE)
    modes = _spy_moe_modes(monkeypatch)
    eng, _ = _serve(cfg, tp, _sessions(cfg.vocab_size),
                    _ecfg(moe_mode="gmm"))
    assert modes and set(modes) == {"gmm"}
    # the resume-batch executable ran, and decode went through the fused
    # step or the megastep (which of the two is the schedule's choice)
    assert eng.hotpath_stats["resume_batches"] > 0
    assert (eng.hotpath_stats["fused_steps"]
            + eng.hotpath_stats["megasteps"]) > 0


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_serve_entry_point_olmoe_on_cpu(layout, capsys):
    assert serve.main(["--arch", "olmoe-1b-7b", "--device", "cpu",
                       "--agents", "2", "--token-scale", "0.04",
                       "--kv-layout", layout]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("policy,")
    assert lines[1].startswith("agentserve,2,")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_import_scan_covers_the_moe_modules():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    names = {f.relative_to(ROOT / "src").as_posix() for f in files}
    for new in ("repro_torch/models/moe.py",
                "repro_torch/kernels/moe_gmm.py",
                "repro_torch/configs/olmoe_1b_7b.py",
                "repro_torch/configs/mixtral_8x22b.py",
                "repro_torch/configs/jamba_1_5_large.py"):
        assert new in names
        for mod in _imports(ROOT / "src" / new):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod
    assert (ROOT / "src/repro_torch/kernels/csrc/moe_gmm.cu").exists()
