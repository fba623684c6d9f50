"""The paper's dense testbed and the other dense configs on the port.

Qwen2.5-7B and Llama3-8B (the paper's evaluation models), Llama3.2-3B
(tied embeddings), Phi-4-mini-3.8B and StarCoder2-15B (a gelu MLP): the
port's configs equal the JAX package's, full and smoke, and the cold
prefill, resume chunk and decode step of each smoke variant, and of the
same with the published head counts at narrow heads (query groups 7, 4,
3, 3 and 12), equal their JAX twins on the same numpy weights in f32
(3e-5): logits and every written cache row below the scratch row.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs.base import get_config as j_config  # noqa: E402
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402

import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
B, S_MAX = 3, 64
NAMES = ["qwen2.5-7b", "llama3-8b", "llama3.2-3b", "phi4-mini-3.8b",
         "starcoder2-15b"]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _port_cfg(jcfg):
    return tbase.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(tbase.ModelConfig)})


@pytest.mark.parametrize("name", NAMES)
def test_testbed_configs_match_jax(name):
    assert _port_cfg(j_config(name)) == tbase.get_config(name)
    assert _port_cfg(j_smoke(name)) == tbase.get_smoke_config(name)
    assert tbase.get_config(name).family == "dense"


def _assert_cache(tc, jc):
    for name in jc:
        for leaf in ("k", "v"):
            np.testing.assert_allclose(
                tc[name][leaf].numpy()[:, :, :S_MAX - 1],
                np.asarray(jc[name][leaf])[:, :, :S_MAX - 1], **F32)


@pytest.mark.parametrize("heads", ["smoke", "published"])
@pytest.mark.parametrize("name", NAMES)
def test_testbed_smoke_forwards_match_jax(name, heads):
    jcfg = j_smoke(name)
    if heads == "published":
        full = j_config(name)
        jcfg = dataclasses.replace(jcfg, num_heads=full.num_heads,
                                   num_kv_heads=full.num_kv_heads,
                                   head_dim=16)
    tcfg = _port_cfg(jcfg)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(11))
    tp = tm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert ("lm_head" in tp) != tcfg.tie_embeddings
    rng = np.random.default_rng(len(name))
    jc = jm.init_cache(jcfg, B, S_MAX)
    tc = tm.init_cache(tcfg, B, S_MAX, device="cpu")

    def prefill(jc, tc, toks, lens, **kw):
        jl, jc, _ = jm.forward_prefill(jp, jcfg, jnp.asarray(toks), jc,
                                       jnp.asarray(lens),
                                       **{k: jnp.asarray(v)
                                          for k, v in kw.items()})
        tl, tc, _ = tm.forward_prefill(tp, tcfg, torch.tensor(toks), tc,
                                       torch.tensor(lens),
                                       **{k: torch.tensor(v)
                                          for k, v in kw.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        _assert_cache(tc, jc)
        return jc, tc

    V = jcfg.vocab_size
    jc, tc = prefill(jc, tc, rng.integers(0, V, (B, 20)).astype(np.int32),
                     np.zeros(B, np.int32))
    jc, tc = prefill(jc, tc, rng.integers(0, V, (B, 12)).astype(np.int32),
                     np.asarray([20, 3, 31], np.int32),
                     logit_idx=np.asarray([11, 4, 0], np.int32))
    toks = rng.integers(0, V, B).astype(np.int32)
    lens = np.asarray([32, 15, 43], np.int32)
    jl, jc, _ = jm.forward_decode(jp, jcfg, jnp.asarray(toks), jc,
                                  jnp.asarray(lens))
    tl, tc, _ = tm.forward_decode(tp, tcfg, torch.tensor(toks), tc,
                                  torch.tensor(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _assert_cache(tc, jc)
