"""The port's MoE path against the JAX package, on the CPU.

* ``ops.moe_gmm`` (its plain version here) against the JAX
  ``ops.moe_gmm`` (Pallas, interpret mode), and ``gmm_plain`` against the
  JAX ``naive_gmm``, at the JAX kernel test's shapes (f32 3e-5, bf16 2e-2:
  the JAX kernel test's tolerances).
* ``_router`` against JAX, with two experts tied on every token (both
  pick the lower index), and ``apply_moe`` in ``dense`` and ``gmm``
  modes, with a capacity factor that drops tokens and with
  ``data_shards=2``, and its aux loss, on the same ``init_moe`` weights
  (f32, 3e-5).
* Every serving forward of the olmoe-1b-7b, mixtral-8x22b and
  jamba-1.5-large-398b smoke configs on both layouts and in both MoE
  modes against JAX: logits within 2e-4 (mixtral's sliding window and
  jamba's SSD scan order as in the other port tests), greedy tokens
  equal, every cache leaf equal by key and shape and within 2e-4.
* ``from_jax_params`` carries the MoE leaves; the port's own
  ``init_params`` has the JAX tree, shapes and scales.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm_plain  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

GMM_TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TOL = dict(rtol=2e-4, atol=2e-4)
MOE_TOL = dict(rtol=3e-5, atol=3e-5)
B, S_MAX, PS = 3, 64, 8
ARCHS = ("olmoe-1b-7b", "mixtral-8x22b", "jamba-1.5-large-398b")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def port_cfg(jcfg, **kw):
    """The port's ModelConfig with the JAX config's field values."""
    vals = {f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(tbase.ModelConfig)}
    for name, cls in (("ssm", tbase.SSMConfig), ("moe", tbase.MoEConfig)):
        if vals[name] is not None:
            vals[name] = cls(**dataclasses.asdict(vals[name]))
    vals.update(kw)
    return tbase.ModelConfig(**vals)


# ---------------------------------------------------------------------------
# the grouped matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,C,d,f", [
    (4, 32, 64, 96),
    (2, 50, 48, 40),
    (8, 16, 128, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_plain_matches_jax_kernel(E, C, d, f, dtype):
    rng = np.random.default_rng(E + C)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = rng.standard_normal((E, d, f)).astype(np.float32)
    jx, jw = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w))
    tx, tw = (_t(a).to(getattr(torch, dtype)) for a in (x, w))
    got = ops.moe_gmm(tx, tw)
    assert got.dtype == tx.dtype and tuple(got.shape) == (E, C, f)
    want = jops.moe_gmm(jx, jw, block_c=16, block_f=32, block_d=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **GMM_TOL[dtype])
    np.testing.assert_allclose(gmm_plain(tx, tw).float().numpy(),
                               np.asarray(jref.naive_gmm(jx, jw), np.float32),
                               **GMM_TOL[dtype])


def test_moe_gmm_takes_an_expert_stride_zero_view():
    rng = np.random.default_rng(3)
    x2d = _t(rng.standard_normal((5, 16)).astype(np.float32))
    w = _t(rng.standard_normal((3, 16, 8)).astype(np.float32))
    got = ops.moe_gmm(x2d.expand(3, 5, 16), w)
    np.testing.assert_allclose(got.numpy(),
                               ops.moe_gmm(x2d.expand(3, 5, 16).contiguous(),
                                           w).numpy(), rtol=0, atol=0)


def test_moe_gmm_rejects_bad_arguments():
    x = torch.zeros(2, 4, 16)
    with pytest.raises(ValueError):
        ops.moe_gmm(x, torch.zeros(3, 16, 8))
    with pytest.raises(ValueError):
        ops.moe_gmm(x, torch.zeros(2, 12, 8))
    with pytest.raises(TypeError):
        ops.moe_gmm(x, torch.zeros(2, 16, 8, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        ops.moe_gmm(x.double(), torch.zeros(2, 16, 8).double())


# ---------------------------------------------------------------------------
# the router and the MoE layer
# ---------------------------------------------------------------------------

D, F_FF = 32, 48


@pytest.fixture(scope="module", params=[(4, 2), (8, 3)], ids=["e4k2", "e8k3"])
def layer(request):
    E, k = request.param
    jcfg = JMoEConfig(num_experts=E, top_k=k)
    jp = jmoe.init_moe(jax.random.PRNGKey(E), D, F_FF, jcfg, "swiglu",
                       jnp.float32)
    tp = {n: _t(v) for n, v in jax.tree.map(np.asarray, jp).items()}
    return jcfg, tbase.MoEConfig(num_experts=E, top_k=k), jp, tp


def test_router_matches_jax_with_ties(layer):
    jcfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(1)
    x = rng.standard_normal((20, D)).astype(np.float32)
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 1]          # experts 1 and 2 tie on every token
    router[:, 0] = 0.0                   # ... and expert 0 ties across rows
    jprobs, jw, jidx = jmoe._router({"router": jnp.asarray(router)},
                                    jnp.asarray(x), jcfg)
    probs, w, idx = tmoe._router({"router": _t(router)}, _t(x), tcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **MOE_TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **MOE_TOL)
    assert probs.dtype == torch.float32 and idx.dtype == torch.int64
    # wherever both tied experts are picked, the lower index comes first
    both = (idx == 1).any(1) & (idx == 2).any(1)
    assert bool(both.any())
    for row in idx[both].tolist():
        assert row.index(1) < row.index(2)


@pytest.mark.parametrize("mode,cf,shards,T", [
    ("dense", 1.25, 1, 24),
    ("gmm", 1.25, 1, 24),
    ("gmm", 0.5, 1, 24),        # tokens dropped at the capacity
    ("gmm", 0.5, 2, 24),        # per-shard sort and capacity
    ("gmm", 1.25, 4, 18),       # T not divisible by the shards: one shard
])
def test_apply_moe_matches_jax(layer, mode, cf, shards, T):
    jcfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(T + shards)
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, "swiglu",
                                mode=mode, capacity_factor=cf,
                                data_shards=shards)
    out, aux = tmoe.apply_moe(tp, _t(x), tcfg, "swiglu", mode=mode,
                              capacity_factor=cf, data_shards=shards)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOE_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **MOE_TOL)
    np.testing.assert_allclose(
        tmoe.moe_output(tp, _t(x), tcfg, "swiglu", mode=mode,
                        capacity_factor=cf, data_shards=shards).numpy(),
        out.numpy(), rtol=0, atol=0)


def test_gmm_capacity_drops_tokens(layer):
    """At capacity factor 0.5 some token-expert pairs are dropped, so the
    gmm output differs from the dense one; at a large factor they agree."""
    jcfg, tcfg, jp, tp = layer
    x = _t(np.random.default_rng(2).standard_normal((1, 24, D))
           .astype(np.float32))
    dense, _ = tmoe.apply_moe(tp, x, tcfg, "swiglu", mode="dense")
    full, _ = tmoe.apply_moe(tp, x, tcfg, "swiglu", mode="gmm",
                             capacity_factor=float(tcfg.num_experts))
    tight, _ = tmoe.apply_moe(tp, x, tcfg, "swiglu", mode="gmm",
                              capacity_factor=0.5)
    np.testing.assert_allclose(full.numpy(), dense.numpy(), **MOE_TOL)
    assert (tight - dense).abs().max().item() > 1e-3


def test_apply_moe_gelu_and_bad_mode():
    jcfg = JMoEConfig(num_experts=4, top_k=2)
    jp = jmoe.init_moe(jax.random.PRNGKey(9), D, F_FF, jcfg, "gelu",
                       jnp.float32)
    tp = {n: _t(v) for n, v in jax.tree.map(np.asarray, jp).items()}
    assert "w_gate" not in tp
    x = np.random.default_rng(4).standard_normal((1, 10, D)).astype(
        np.float32)
    tcfg = tbase.MoEConfig(num_experts=4, top_k=2)
    for mode in ("dense", "gmm"):
        jout, _ = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, "gelu", mode=mode)
        out, _ = tmoe.apply_moe(tp, _t(x), tcfg, "gelu", mode=mode)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOE_TOL)
    with pytest.raises(ValueError):
        tmoe.apply_moe(tp, _t(x), tcfg, "gelu", mode="sparse")


# ---------------------------------------------------------------------------
# serving forwards of the MoE configs, both layouts, both modes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    jcfg = j_smoke(request.param)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(7))
    tp = tm.from_jax_params(port_cfg(jcfg), jax.tree.map(np.asarray, jp),
                            device="cpu")
    return jcfg, jp, tp


class Case:
    """Paired caches of B slots; ``paged`` maps each row's first
    ``pmax - 2`` pages from a shuffled arena (the rest to the scratch
    page).  ``mode`` is the MoE mode of every forward."""

    def __init__(self, weights, paged, mode, seed):
        jcfg, self.jp, self.tp = weights
        kw = dict(kv_layout="paged", kv_page_size=PS) if paged else {}
        self.jcfg = dataclasses.replace(jcfg, **kw)
        self.tcfg = port_cfg(self.jcfg)
        self.mode = mode
        self.paged = paged
        self.rng = np.random.default_rng(seed)
        self.jc = jm.init_cache(self.jcfg, B, S_MAX)
        self.tc = tm.init_cache(self.tcfg, B, S_MAX, device="cpu")
        self.bt = None
        if paged:
            pmax = S_MAX // PS
            num_pages = tm.num_kv_pages(self.tcfg, B, S_MAX)
            perm = self.rng.permutation(num_pages)[:B * (pmax - 2)]
            self.bt = np.full((B, pmax), num_pages, np.int32)
            self.bt[:, :pmax - 2] = perm.reshape(B, pmax - 2)

    def kw(self, jax_side):
        out = {"moe_mode": self.mode}
        if self.bt is not None:
            out["block_tables"] = (jnp.asarray(self.bt) if jax_side
                                   else _t(self.bt))
        return out

    def assert_cache(self):
        assert set(self.tc) == set(self.jc)
        for name, layer in self.jc.items():
            assert set(self.tc[name]) == set(layer)
            for k, v in layer.items():
                got, want = self.tc[name][k].numpy(), np.asarray(v)
                assert got.shape == want.shape, (name, k)
                if k in tm.POSITIONAL_CACHE_KEYS:
                    if self.paged:
                        pages = sorted(set(self.bt[:, :-2].ravel().tolist()))
                        got, want = got[:, pages], want[:, pages]
                    else:
                        got, want = got[:, :, :S_MAX - 1], want[:, :, :S_MAX - 1]
                np.testing.assert_allclose(got, want, **TOL,
                                           err_msg=f"{name}/{k}")

    def tokens(self, *shape):
        return self.rng.integers(0, self.jcfg.vocab_size,
                                 shape).astype(np.int32)

    def fill(self, n=20):
        toks, lens = self.tokens(B, n), np.zeros(B, np.int32)
        jl, self.jc, _ = jm.forward_prefill(
            self.jp, self.jcfg, jnp.asarray(toks), self.jc,
            jnp.asarray(lens), **self.kw(True))
        tl, self.tc, _ = tm.forward_prefill(
            self.tp, self.tcfg, _t(toks), self.tc, _t(lens), **self.kw(False))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


CASES = pytest.mark.parametrize("paged,mode", [
    (False, "dense"), (False, "gmm"), (True, "dense"), (True, "gmm")],
    ids=["slab-dense", "slab-gmm", "paged-dense", "paged-gmm"])


@CASES
def test_prefill_and_resume_batch(weights, paged, mode):
    c = Case(weights, paged, mode, 1)
    c.fill()
    c.assert_cache()
    # a padded resume batch: rows end at different real lengths
    slots = np.asarray([2, 0], np.int32)
    lens = np.asarray([20, 20], np.int32)
    toks, li = c.tokens(2, 8), np.asarray([7, 3], np.int32)
    jl, c.jc = jm.forward_resume_batch(
        c.jp, c.jcfg, jnp.asarray(toks), c.jc, jnp.asarray(slots),
        jnp.asarray(lens), jnp.asarray(li), **c.kw(True))
    tl, c.tc = tm.forward_resume_batch(
        c.tp, c.tcfg, _t(toks), c.tc, _t(slots), _t(lens), _t(li),
        **c.kw(False))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    c.assert_cache()


@CASES
def test_decode_fused_and_megastep(weights, paged, mode):
    c = Case(weights, paged, mode, 2)
    c.fill()
    toks, lens = c.tokens(B), np.asarray([20, 20, 20], np.int32)
    jl, c.jc, _ = jm.forward_decode(c.jp, c.jcfg, jnp.asarray(toks), c.jc,
                                    jnp.asarray(lens), **c.kw(True))
    tl, c.tc, _ = tm.forward_decode(c.tp, c.tcfg, _t(toks), c.tc, _t(lens),
                                    **c.kw(False))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    c.assert_cache()
    lens = lens + 1
    active = np.asarray([True, False, True])
    jt, c.jc, jlen = jm.forward_decode_fused(
        c.jp, c.jcfg, jnp.asarray(toks), c.jc, jnp.asarray(lens),
        jnp.asarray(active), **c.kw(True))
    tt, c.tc, tlen = tm.forward_decode_fused(
        c.tp, c.tcfg, _t(toks), c.tc, _t(lens), _t(active), **c.kw(False))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    c.assert_cache()
    jseq, jt, c.jc, jlen = jm.forward_decode_megastep(
        c.jp, c.jcfg, jt, c.jc, jlen, jnp.asarray(active), num_steps=2,
        **c.kw(True))
    tseq, tt, c.tc, tlen = tm.forward_decode_megastep(
        c.tp, c.tcfg, tt, c.tc, tlen, _t(active), num_steps=2,
        **c.kw(False))
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    c.assert_cache()


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

def test_config_registry_has_the_moe_archs():
    for name in ARCHS:
        assert port_cfg(j_smoke(name)) == tbase.get_smoke_config(name)
    full = tbase.get_config("olmoe-1b-7b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.d_ff, full.vocab_size) == (16, 2048, 16, 16, 1024, 50304)
    assert (full.moe.num_experts, full.moe.top_k) == (64, 8)
    G, gs, specs = tm.group_layout(full)
    assert (G, gs) == (16, 1) and (specs[0].kind, specs[0].ffn) == (
        "attn", "moe")
    G, gs, specs = tm.group_layout(tbase.get_config("jamba-1.5-large-398b"))
    assert (G, gs) == (9, 8)
    assert [(s.kind, s.ffn) for s in specs] == [
        ("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe"),
        ("attn", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe")]
    jamba = j_smoke("jamba-1.5-large-398b")
    from repro.models.model import group_layout as j_group_layout
    jG, jgs, jspecs = j_group_layout(jamba)
    G, gs, specs = tm.group_layout(port_cfg(jamba))
    assert (G, gs) == (jG, jgs)
    assert [(s.kind, s.ffn) for s in specs] == [(s.kind, s.ffn)
                                                for s in jspecs]


def test_weight_bridge_carries_moe_leaves(weights):
    jcfg, jp, tp = weights
    tcfg = port_cfg(jcfg)
    moe_slots = [v["ffn"] for v in tp["groups"].values()
                 if "ffn" in v and "router" in v["ffn"]]
    assert moe_slots
    E, d, f = jcfg.moe.num_experts, jcfg.d_model, jcfg.d_ff
    for p in moe_slots:
        G = p["router"].shape[0]
        assert tuple(p["router"].shape) == (G, d, E)
        assert tuple(p["w_up"].shape) == (G, E, d, f)
        assert tuple(p["w_gate"].shape) == (G, E, d, f)
        assert tuple(p["w_down"].shape) == (G, E, f, d)
    flat = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat:
        node = tp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    bf = tm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                            dtype=torch.bfloat16, device="cpu")
    assert all(p["w_up"].dtype == torch.bfloat16
               for p in (v["ffn"] for v in bf["groups"].values()
                         if "ffn" in v and "router" in v["ffn"]))
    # the port's own init: the JAX tree, shapes and scales
    own = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    for path, leaf in flat:
        node = own
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
    for p in (v["ffn"] for v in own["groups"].values()
              if "ffn" in v and "router" in v["ffn"]):
        for k, fan_in in (("router", d), ("w_up", d), ("w_down", f)):
            assert abs(p[k].std().item() * fan_in ** 0.5 - 1.0) < 0.1, k
