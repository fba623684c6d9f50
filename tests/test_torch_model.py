"""Port model forwards against the JAX package on the same numpy weights.

For the conftest ``TINY`` config, the qwen2.5-3b and smollm-360m smoke
configs, and the same two with their published GQA groups (8 and 3) at
narrow heads, every serving forward of the port
equals its JAX twin in f32 (3e-5): logits, every written cache row
(excluding the scratch row) and, for the fused steps, the sampled
tokens and lengths.  Inactive decode lanes must write nothing but
their scratch row.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from conftest import TINY  # noqa: E402

import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
B, S_MAX = 3, 64


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _port_cfg(jcfg):
    """The port's ModelConfig with the JAX config's field values."""
    return tbase.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(tbase.ModelConfig)})


def _heads(name, H, Hk):
    """A smoke config keeping the published head counts (narrow heads)."""
    return dataclasses.replace(j_smoke(name), num_heads=H, num_kv_heads=Hk,
                               head_dim=16)


# the reduced smoke configs have 4 query heads over 1 KV head; the
# "-heads" variants keep the published GQA groups (8 and 3)
CONFIGS = {"tiny": lambda: TINY,
           "qwen2.5-3b-smoke": lambda: j_smoke("qwen2.5-3b"),
           "smollm-360m-smoke": lambda: j_smoke("smollm-360m"),
           "qwen2.5-3b-heads": lambda: _heads("qwen2.5-3b", 16, 2),
           "smollm-360m-heads": lambda: _heads("smollm-360m", 15, 5)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(jax cfg, port cfg, jax params, port params) on shared weights."""
    jcfg = CONFIGS[request.param]()
    tcfg = _port_cfg(jcfg)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(7))
    tp = tm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _caches(jcfg, tcfg):
    return (jm.init_cache(jcfg, B, S_MAX),
            tm.init_cache(tcfg, B, S_MAX, device="cpu"))


def _assert_cache(tc, jc, rows=None):
    """Every row below the scratch row (or only ``rows`` [(b, lo, hi)])."""
    for name in jc:
        for leaf in ("k", "v"):
            a = tc[name][leaf].numpy()
            b = np.asarray(jc[name][leaf])
            if rows is None:
                np.testing.assert_allclose(a[:, :, :S_MAX - 1],
                                           b[:, :, :S_MAX - 1], **F32)
            else:
                for r, lo, hi in rows:
                    np.testing.assert_allclose(a[:, r, lo:hi], b[:, r, lo:hi],
                                               **F32)


def _prefill_both(jcfg, tcfg, jp, tp, jc, tc, toks, lens, **kw):
    jl, jc, _ = jm.forward_prefill(jp, jcfg, jnp.asarray(toks), jc,
                                   jnp.asarray(lens), **kw)
    tkw = {k: torch.tensor(np.asarray(v)) for k, v in kw.items()}
    tl, tc, _ = tm.forward_prefill(tp, tcfg, torch.tensor(toks), tc,
                                   torch.tensor(lens), **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    return jc, tc


def _filled(pair, rng):
    """Caches holding a cold prefill of 20 tokens per row, both sides."""
    jcfg, tcfg, jp, tp = pair
    jc, tc = _caches(jcfg, tcfg)
    toks = rng.integers(0, jcfg.vocab_size, (B, 20)).astype(np.int32)
    return _prefill_both(jcfg, tcfg, jp, tp, jc, tc, toks,
                         np.zeros(B, np.int32))


def test_slab_write_scatter_redirects_to_scratch_row():
    """Negative or out-of-range write positions land in row S_max - 1,
    as in the JAX package; in-range rows land where they say."""
    from repro.models.blocks import _slab_write_scatter as j_scatter
    from repro_torch.models.blocks import _slab_write_scatter
    rng = np.random.default_rng(6)
    cache = rng.standard_normal((3, 16, 2, 4)).astype(np.float32)
    rows = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    pos = np.asarray([[0, 1, 2], [-1, 5, 16], [13, 14, -7]], np.int32)
    want = np.asarray(j_scatter(jnp.asarray(cache), jnp.asarray(rows),
                                jnp.asarray(pos)))
    got = torch.tensor(cache)
    _slab_write_scatter(got, torch.tensor(rows), torch.tensor(pos))
    # several rows redirected to the scratch row race for it: compare the
    # rest exactly and check the scratch row holds one of the candidates
    np.testing.assert_array_equal(got.numpy()[:, :15], want[:, :15])
    assert any(np.array_equal(got.numpy()[1, 15], rows[1, i]) for i in (0, 2))


def test_config_registry_matches_jax():
    for name in ("qwen2.5-3b", "smollm-360m"):
        assert _port_cfg(j_smoke(name)) == tbase.get_smoke_config(name)
    with pytest.raises(NotImplementedError):
        tbase.get_config("hubert-xlarge")
    with pytest.raises(KeyError):
        tbase.get_config("no-such-arch")


def test_weight_bridge_round_trips(pair):
    jcfg, tcfg, jp, tp = pair
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda x: x, tp, is_leaf=torch.is_tensor)))
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    bad = jax.tree.map(np.asarray, jp)
    del bad["final_norm"]
    with pytest.raises(ValueError):
        tm.from_jax_params(tcfg, bad, device="cpu")
    # the port's own init has the same tree, shapes and distributions
    own = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    for path, leaf in flat_j:
        node = own
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == tuple(leaf.shape)
    wq = own["groups"]["l0"]["attn"]["wq"]
    assert abs(wq.std().item() * tcfg.d_model ** 0.5 - 1.0) < 0.05


def test_forward_prefill_cold_and_resume(pair):
    jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(1)
    jc, tc = _filled(pair, rng)
    _assert_cache(tc, jc)
    # resume chunks at per-row offsets, logits at the last unpadded token
    toks = rng.integers(0, jcfg.vocab_size, (B, 12)).astype(np.int32)
    lens = np.asarray([20, 3, 31], np.int32)
    jc, tc = _prefill_both(jcfg, tcfg, jp, tp, jc, tc, toks, lens,
                           logit_idx=np.asarray([11, 4, 0], np.int32))
    _assert_cache(tc, jc)


def test_forward_decode(pair):
    jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(2)
    jc, tc = _filled(pair, rng)
    toks = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
    lens = np.asarray([20, 20, 20], np.int32)
    jl, jc, _ = jm.forward_decode(jp, jcfg, jnp.asarray(toks), jc,
                                  jnp.asarray(lens))
    tl, tc, _ = tm.forward_decode(tp, tcfg, torch.tensor(toks), tc,
                                  torch.tensor(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _assert_cache(tc, jc)


def test_forward_decode_fused_inactive_lane(pair):
    jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(3)
    jc, tc = _filled(pair, rng)
    before = {k: tc["l0"][k].clone() for k in ("k", "v")}
    toks = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
    lens = np.asarray([20, 20, 20], np.int32)
    active = np.asarray([True, False, True])
    jt, jc, jlen = jm.forward_decode_fused(jp, jcfg, jnp.asarray(toks), jc,
                                           jnp.asarray(lens),
                                           jnp.asarray(active))
    tt, tc, tlen = tm.forward_decode_fused(tp, tcfg, torch.tensor(toks), tc,
                                           torch.tensor(lens),
                                           torch.tensor(active))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    _assert_cache(tc, jc)
    for k in ("k", "v"):     # the inactive lane wrote only its scratch row
        assert torch.equal(tc["l0"][k][:, 1, :S_MAX - 1],
                           before[k][:, 1, :S_MAX - 1])
        assert not torch.equal(tc["l0"][k][:, 1, S_MAX - 1],
                               before[k][:, 1, S_MAX - 1])


def test_forward_decode_megastep(pair):
    jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(4)
    jc, tc = _filled(pair, rng)
    toks = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
    lens = np.asarray([20, 20, 20], np.int32)
    active = np.asarray([True, True, False])
    jseq, jt, jc, jlen = jm.forward_decode_megastep(
        jp, jcfg, jnp.asarray(toks), jc, jnp.asarray(lens),
        jnp.asarray(active), num_steps=4)
    tseq, tt, tc, tlen = tm.forward_decode_megastep(
        tp, tcfg, torch.tensor(toks), tc, torch.tensor(lens),
        torch.tensor(active), num_steps=4)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    _assert_cache(tc, jc)


def test_forward_resume_batch_permuted_slots(pair):
    jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(5)
    jc, tc = _filled(pair, rng)
    slots = np.asarray([2, 0], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.asarray([20, 20], np.int32)
    logit_idx = np.asarray([15, 6], np.int32)
    jl, jc = jm.forward_resume_batch(jp, jcfg, jnp.asarray(toks), jc,
                                     jnp.asarray(slots), jnp.asarray(lens),
                                     jnp.asarray(logit_idx))
    tl, tc = tm.forward_resume_batch(tp, tcfg, torch.tensor(toks), tc,
                                     torch.tensor(slots), torch.tensor(lens),
                                     torch.tensor(logit_idx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _assert_cache(tc, jc)
