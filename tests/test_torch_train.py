"""The port's training path against the JAX package, on the CPU.

* ``flash_attention_plain`` (kernel 9's plain version) equals the JAX
  Pallas kernel in interpret mode, and its row statistics m, l equal the
  JAX blocked forward's (3e-5, the JAX kernel test's f32 limit): causal
  with windows 0 and 16, non-causal, ragged Sq and Sk, query groups 1, 3
  and 8, hd 64 and 128.
* The ``FlashAttention`` Function's gradients equal ``jax.grad`` through
  JAX ``blocked_attention`` (its custom VJP) within 1e-4: the same
  blocked sums, taken in another order.
* ``forward_train`` and ``forward_cold`` logits equal JAX on TINY and the
  smollm-360m and qwen2.5-3b smoke configs (3e-5), with a window too.
* ``lm_loss`` and every gradient leaf equal ``jax.value_and_grad``
  (loss 3e-5; gradients 1e-4 relative, 1e-6 absolute) with ``ce_chunk``
  0 and 8 and remat on and off; the port's remat on equals its remat off.
* ``apply_updates`` on the same numpy gradients equals JAX (1e-6) over
  two steps; ``schedule`` equals JAX's.  A ``microbatches=2`` train step
  equals JAX's: stats within 1e-5, and every parameter within 1e-6
  except where the gradient is below 1e-5, where Adam's first step,
  about ``lr * sign(g)``, may take the other sign on a rounding
  difference (those within ``2 lr``).
* ``SyntheticCorpus`` batches equal JAX's exactly, and checkpoints load
  across the two packages.
* The decode plain versions with ``window`` equal JAX ``decode_attention``
  (its XLA window branch), slab and paged, f32 and int8 (the same int8
  values and scales handed to both).
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
from repro.models import attention as jattn  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from conftest import TINY  # noqa: E402

import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_paged_plain, decode_attention_paged_quant_plain,
    decode_attention_plain, decode_attention_quant_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain)
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.common import (count_params,  # noqa: E402
                                       tree_leaves, tree_size_bytes)
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def _port_cfg(jcfg):
    """The port's ModelConfig with the JAX config's field values."""
    return tbase.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(tbase.ModelConfig)})


def _leaves_np(tree):
    """Leaves of a JAX tree or a port tree, in the pytree (sorted key)
    order, as numpy."""
    return [x.detach().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# kernel 9's plain version and the autograd Function
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, Hk, hd, causal, window)
FLASH_CASES = {
    "causal-g1-hd64": (2, 70, 70, 4, 4, 64, True, 0),
    "causal-g3-w16": (1, 90, 90, 6, 2, 64, True, 16),
    "causal-g8-hd128": (1, 40, 40, 8, 1, 128, True, 0),
    "noncausal-g3-ragged": (2, 50, 70, 3, 1, 64, False, 0),
    "causal-ragged-w16-hd128": (1, 37, 50, 2, 2, 128, True, 16),
}


def _qkv(rng, B, Sq, Sk, H, Hk, hd):
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hk, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hk, hd)).astype(np.float32))


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_plain_matches_jax_kernel(case):
    B, Sq, Sk, H, Hk, hd, causal, window = FLASH_CASES[case]
    q, k, v = _qkv(np.random.default_rng(len(case)), B, Sq, Sk, H, Hk, hd)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                block_q=32, block_k=32, interpret=True)
    o, m, l = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                    window=window, block_size=32)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **F32)
    # the wrapper runs the plain version on CPU tensors
    o2, _, _ = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                   window=window)
    np.testing.assert_allclose(o2.numpy(), np.asarray(want), **F32)
    # keys at or past sk_valid are masked, as the TPU kernel's padding
    pad = lambda x: _t(np.concatenate([x, x[:, :5] + 3.0], axis=1))
    o3, _, _ = flash_attention_plain(_t(q), pad(k), pad(v), causal=causal,
                                     window=window, sk_valid=Sk)
    np.testing.assert_allclose(o3.numpy(), np.asarray(want), **F32)
    # m and l: the JAX blocked forward's statistics, [B, Hk, G, Sq]
    _, jm_, jl = jattn._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.zeros((B,), jnp.int32), jnp.full((B,), Sk, jnp.int32), causal,
        window, Sk)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm_).reshape(B, H, Sq),
                               **F32)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl).reshape(B, H, Sq),
                               **F32)


@pytest.mark.parametrize("H,Hk,window", [(4, 4, 0), (6, 2, 12), (8, 1, 0)])
def test_flash_attention_grads_match_jax(H, Hk, window):
    B, S, hd = 2, 45, 32
    rng = np.random.default_rng(H + window)
    q, k, v = _qkv(rng, B, S, S, H, Hk, hd)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jattn.blocked_attention(q_, k_, v_, causal=True, window=window,
                                      block_size=16)
        return jnp.sum(out * jnp.asarray(do))
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tattn.train_attention(tq, tk, tv, causal=True, window=window)
    out.backward(_t(do))
    # gradients of O(1): 1e-4 relative and absolute (ds = p (dp - D)
    # cancels to rounding noise at rows with one live key)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_flash_attention_checks_its_arguments():
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[..., :32], k[..., :32])       # hd differs
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 64),
                            torch.zeros(1, 8, 3, 64))          # 4 % 3 heads
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.double(), k.double())
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, window=-1)


# ---------------------------------------------------------------------------
# the training forwards and the loss
# ---------------------------------------------------------------------------

CONFIGS = {"tiny": lambda: TINY,
           "smollm-360m-smoke": lambda: j_smoke("smollm-360m"),
           "qwen2.5-3b-smoke": lambda: j_smoke("qwen2.5-3b")}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(jax cfg, port cfg, jax params, port params) on shared weights."""
    jcfg = CONFIGS[request.param]()
    tcfg = _port_cfg(jcfg)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(3))
    tp = tm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("window", [None, 16])
def test_forward_train_and_cold_match_jax(pair, window):
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg)
    want, _ = jm.forward_train(jp, jcfg, jnp.asarray(toks),
                               window_override=window)
    with torch.no_grad():
        got, aux = tm.forward_train(tp, tcfg, _t(toks),
                                    window_override=window)
        cold = tm.forward_cold(tp, tcfg, _t(toks), window_override=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert float(aux) == 0.0
    want_cold = jm.forward_cold(jp, jcfg, jnp.asarray(toks),
                                window_override=window)
    np.testing.assert_allclose(cold.numpy(), np.asarray(want_cold), **F32)
    # return_hidden and embeds: the same hidden states from the embedding
    with torch.no_grad():
        h, _ = tm.forward_train(tp, tcfg, _t(toks), return_hidden=True)
        h2, _ = tm.forward_train(tp, tcfg, embeds=tp["embed"][_t(toks).long()],
                                 return_hidden=True)
    jh, _ = jm.forward_train(jp, jcfg, jnp.asarray(toks), return_hidden=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)
    assert torch.equal(h, h2)


def _port_loss_and_grads(tp, tcfg, toks, **kw):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, parts = tts.lm_loss(tp, tcfg, _t(toks), **kw)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), [g.numpy() for g in grads]


@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_lm_loss_and_grads_match_jax(pair, ce_chunk):
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg)
    (want, parts), jg = jax.value_and_grad(
        lambda p: jts.lm_loss(p, jcfg, jnp.asarray(toks), remat=False,
                              ce_chunk=ce_chunk), has_aux=True)(jp)
    got = {}
    for remat in (False, True):
        got[remat] = _port_loss_and_grads(tp, tcfg, toks, remat=remat,
                                          ce_chunk=ce_chunk)
        np.testing.assert_allclose(float(got[remat][0]), float(want), **F32)
        for a, b in zip(got[remat][1], _leaves_np(jg)):
            np.testing.assert_allclose(a, b, **GRAD)
    # remat recomputes the same layers: equal gradients
    assert float(got[True][0]) == float(got[False][0])
    for a, b in zip(got[True][1], got[False][1]):
        np.testing.assert_array_equal(a, b)


def test_forward_train_refuses_unported_families():
    with pytest.raises(NotImplementedError, match="12b"):
        tm.forward_train({}, tbase.get_smoke_config("olmoe-1b-7b"),
                         torch.zeros((1, 4), dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="12b"):
        tm.forward_cold({}, tbase.get_smoke_config("mamba2-780m"),
                        torch.zeros((1, 4), dtype=torch.int64))


def test_tree_sizes_match_jax(pair):
    from repro.models.common import count_params as jcount
    from repro.models.common import tree_size_bytes as jsize
    _, _, jp, tp = pair
    assert count_params(tp) == jcount(jp)
    assert tree_size_bytes(tp) == jsize(jp)


# ---------------------------------------------------------------------------
# the optimizer and the train step
# ---------------------------------------------------------------------------

def test_schedule_matches_jax():
    cfg_j = jopt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=100)
    cfg_t = topt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        assert float(topt.schedule(cfg_t, step)) == pytest.approx(
            float(jopt.schedule(cfg_j, jnp.int32(step))), rel=1e-6, abs=1e-12)


def test_apply_updates_matches_jax():
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": {"c": (3,), "d": (2, 4, 6)}}

    def make(scale):
        return jax.tree.map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = make(1.0)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5)
    cfg_j, cfg_t = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(_t, params)
    js, ts = jopt.init_opt_state(cfg_j, jp), topt.init_opt_state(cfg_t, tp)
    for _ in range(2):
        grads = make(3.0)
        jp, js, jst = jopt.apply_updates(cfg_j, jp, jax.tree.map(
            jnp.asarray, grads), js)
        tp, ts, tst = topt.apply_updates(cfg_t, tp, jax.tree.map(_t, grads),
                                         ts)
        for a, b in [(tp, jp), (ts.m, js.m), (ts.v, js.v)]:
            for x, y in zip(_leaves_np(a), _leaves_np(b)):
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)
        assert int(ts.step) == int(js.step)
        for key in ("grad_norm", "lr"):
            assert float(tst[key]) == pytest.approx(float(jst[key]),
                                                    rel=1e-6)


def test_train_step_microbatches_matches_jax():
    jcfg = TINY
    tcfg = _port_cfg(jcfg)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    cfg_j, cfg_t = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens(jcfg, B=4, S=16, seed=2)
    g_full = jax.grad(lambda p: jts.lm_loss(p, jcfg, jnp.asarray(toks),
                                            remat=False)[0])(jp)
    step_j = jts.make_train_step(jcfg, cfg_j, microbatches=2)
    step_t = tts.make_train_step(tcfg, cfg_t, microbatches=2)
    jp2, _, jst = step_j(jp, jopt.init_opt_state(cfg_j, jp),
                         {"tokens": jnp.asarray(toks)})
    tp2, ts2, tst = step_t(tp, topt.init_opt_state(cfg_t, tp),
                           {"tokens": _t(toks)})
    assert set(tst) == set(jst) == {"loss", "ce", "aux", "grad_norm", "lr"}
    for key in jst:
        assert float(tst[key]) == pytest.approx(float(jst[key]), rel=1e-5,
                                                abs=1e-7)
    assert int(ts2.step) == 1
    assert not any(p.requires_grad for p in tree_leaves(tp2))
    for a, b, g in zip(_leaves_np(tp2), _leaves_np(jp2), _leaves_np(g_full)):
        firm = np.abs(g) > 1e-5
        np.testing.assert_allclose(a[firm], b[firm], rtol=0, atol=1e-6)
        np.testing.assert_allclose(a[~firm], b[~firm], rtol=0,
                                   atol=2 * kw["lr"] + 1e-6)


def test_loss_decreases():
    tcfg = _port_cfg(TINY)
    opt_cfg = topt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=100,
                               weight_decay=0.0)
    step = tts.make_train_step(tcfg, opt_cfg)
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    opt = topt.init_opt_state(opt_cfg, params)
    toks = _t(_tokens(tcfg, B=4, S=32))
    losses = []
    for _ in range(8):
        params, opt, stats = step(params, opt, {"tokens": toks})
        losses.append(float(stats["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


# ---------------------------------------------------------------------------
# data, checkpoints and the launcher
# ---------------------------------------------------------------------------

def test_synthetic_corpus_equals_jax():
    kw = dict(vocab_size=300, seq_len=24, batch_size=3, seed=4)
    a = jdata.SyntheticCorpus(jdata.DataConfig(**kw)).batches()
    b = tdata.SyntheticCorpus(tdata.DataConfig(**kw)).batches()
    for _ in range(3):
        np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])


def test_checkpoints_load_across_packages(tmp_path):
    tcfg = _port_cfg(TINY)
    jp = jm.init_params(TINY, jax.random.PRNGKey(2))
    cfg_j, cfg_t = jopt.AdamWConfig(), topt.AdamWConfig()
    js = jopt.init_opt_state(cfg_j, jp)
    js = js._replace(step=jnp.int32(3), m=jax.tree.map(lambda x: x + 1, js.m))
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), jp, js, step=5)
    tmpl = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    tp, ts, step = tckpt.load_checkpoint(str(tmp_path / "j.npz"), tmpl,
                                         topt.init_opt_state(cfg_t, tmpl))
    assert step == 5 and int(ts.step) == 3
    for a, b in [(tp, jp), (ts.m, js.m), (ts.v, js.v)]:
        for x, y in zip(_leaves_np(a), _leaves_np(b)):
            np.testing.assert_array_equal(x, y)
    # and back: the port's checkpoint into the JAX package
    tp["embed"].mul_(2.0)
    tckpt.save_checkpoint(str(tmp_path / "t.npz"), tp, ts, step=7)
    jp2, js2, step2 = jckpt.load_checkpoint(str(tmp_path / "t.npz"), jp, js)
    assert step2 == 7 and int(js2.step) == 3
    for a, b in [(jp2, tp), (js2.m, ts.m)]:
        for x, y in zip(_leaves_np(a), _leaves_np(b)):
            np.testing.assert_array_equal(x, y)
    # bfloat16 leaves: numpy keeps JAX's as raw 2-byte values
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    jckpt.save_checkpoint(str(tmp_path / "b.npz"), jb)
    tb, _, _ = tckpt.load_checkpoint(
        str(tmp_path / "b.npz"), jax.tree.map(lambda x: x.bfloat16(), tmpl))
    for x, y in zip(tree_leaves(tb), tree_leaves(jb)):
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(x.float().numpy(),
                                      np.asarray(y, np.float32))


def test_train_launcher_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    assert tlaunch.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "32", "--log-every", "1",
                         "--checkpoint", ck]) == 0
    out = capsys.readouterr().out
    assert out.count("\nstep ") == 3 and "step_ms_p50=" in out
    assert "flash_attention_launches=0" in out    # the CPU runs no kernel
    rec = tlaunch.run(tlaunch.parse_args(
        ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "32",
         "--resume", ck]))
    assert len(rec["losses"]) == 1 and rec["peak_gb"] is None


# ---------------------------------------------------------------------------
# windowed decode: the plain versions against the XLA window branch
# ---------------------------------------------------------------------------

def _quant_np(rng, *shape):
    q, s = jattn.quantize_kv(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32)))
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [1, 24, 64])
def test_decode_plain_window_matches_jax(quant, window):
    H, Hk, hd, S = 6, 2, 32, 96
    rng = np.random.default_rng(window + quant)
    lens = np.asarray([1, 23, 24, 25, 96], np.int32)
    B = len(lens)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    if quant:
        (kq, ks), (vq, vs) = (_quant_np(rng, B, S, Hk, hd) for _ in range(2))
        want = jattn.decode_attention(
            *map(jnp.asarray, (q, kq, vq, lens)), window=window,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        got = decode_attention_quant_plain(*map(_t, (q, kq, ks, vq, vs,
                                                     lens)), window=window)
        via_ops = ops.flash_decode_quant(*map(_t, (q, kq, ks, vq, vs, lens)),
                                         window=window)
    else:
        k, v = (rng.standard_normal((B, S, Hk, hd)).astype(np.float32)
                for _ in range(2))
        want = jattn.decode_attention(*map(jnp.asarray, (q, k, v, lens)),
                                      window=window)
        got = decode_attention_plain(*map(_t, (q, k, v, lens)), window=window)
        via_ops = ops.flash_decode(*map(_t, (q, k, v, lens)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(via_ops.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_paged_plain_window_matches_jax(quant):
    H, Hk, hd, ps, pmax, window = 8, 2, 32, 8, 12, 20
    rng = np.random.default_rng(7 + quant)
    lens = np.asarray([1, 19, 20, 21, 96], np.int32)
    B = len(lens)
    P = B * pmax
    bt = np.stack([rng.permutation(P)[:pmax] for _ in range(B)]).astype(
        np.int32)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    if quant:
        (kq, ks), (vq, vs) = (_quant_np(rng, P + 1, ps, Hk, hd)
                              for _ in range(2))
        want = jattn.decode_attention_paged(
            *map(jnp.asarray, (q, kq, vq, bt, lens)), window=window,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        got = decode_attention_paged_quant_plain(
            *map(_t, (q, kq, ks, vq, vs, lens, bt)), window=window)
    else:
        k, v = (rng.standard_normal((P + 1, ps, Hk, hd)).astype(np.float32)
                for _ in range(2))
        want = jattn.decode_attention_paged(
            *map(jnp.asarray, (q, k, v, bt, lens)), window=window)
        got = decode_attention_paged_plain(*map(_t, (q, k, v, lens, bt)),
                                           window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
