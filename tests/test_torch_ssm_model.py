"""The port's Mamba-2 path against the JAX package, on the CPU.

* ``ops.ssd_scan`` (its plain version here) against the JAX
  ``ops.ssd_scan`` (Pallas, interpret mode) and the step-by-step
  ``naive_ssd`` of both packages, at the JAX kernel test's shapes, with a
  nonzero carried-in state and across two calls (f32, 2e-4: the JAX
  kernel test's tolerance).
* ``apply_mamba2_scan`` / ``apply_mamba2_step`` against JAX on the same
  ``init_mamba2`` weights (f32, 2e-4), the ``valid`` fence, and the scan
  against stepwise decode.
* Every serving forward of the mamba2-780m smoke config and of a tiny
  hybrid (attention + Mamba-2, ``hybrid_period=2``) on both layouts
  against JAX: logits within 2e-4 (the SSD chunk order may differ from
  the JAX ``lax.scan``), every cache leaf equal by key and shape and
  within 2e-4 (the arena at its mapped pages, the slab below its scratch
  row), inactive lanes' states untouched.
* A bf16 load keeps the float32-by-design Mamba-2 leaves in float32.
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402

import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_plain  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
B, S_MAX, PS = 3, 64, 8

HYBRID = JModelConfig(
    name="tiny-hybrid", family="hybrid", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
    tie_embeddings=True, source="test",
    ssm=JSSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                   chunk_size=32),
    hybrid_period=2, hybrid_attn_index=0)
CONFIGS = {"mamba2-780m-smoke": lambda: j_smoke("mamba2-780m"),
           "tiny-hybrid": lambda: HYBRID}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def port_cfg(jcfg, **kw):
    """The port's ModelConfig with the JAX config's field values."""
    vals = {f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(tbase.ModelConfig)}
    if jcfg.ssm is not None:
        vals["ssm"] = tbase.SSMConfig(**dataclasses.asdict(jcfg.ssm))
    vals.update(kw)
    return tbase.ModelConfig(**vals)


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, Bn, S, nh, hd, N, h0_scale=0.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, Bm, Cm = f(Bn, S, nh, hd), f(Bn, S, N), f(Bn, S, N)
    dt = np.log1p(np.exp(f(Bn, S, nh)))           # softplus
    A = -np.exp(f(nh))
    h0 = h0_scale * f(Bn, nh, hd, N)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("Bn,S,nh,hd,N,chunk,h0_scale", [
    (2, 64, 4, 16, 8, 16, 0.0),
    (1, 50, 2, 32, 16, 16, 0.0),      # S not a multiple of the chunk
    (2, 128, 3, 64, 32, 32, 0.0),
    (1, 50, 2, 32, 16, 16, 1.0),      # nonzero carried-in state
])
def test_ssd_scan_plain_matches_jax_and_naive(Bn, S, nh, hd, N, chunk,
                                              h0_scale):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(0, Bn, S, nh, hd, N, h0_scale)
    y, h = ops.ssd_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), _t(h0),
                        chunk=chunk)
    jy, jh = jops.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm,
                                                       h0)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    zero_d = np.zeros((nh,), np.float32)
    ny, nh_ = ref.naive_ssd(_t(x), _t(dt), _t(Bm), _t(Cm), _t(A),
                            _t(zero_d), _t(h0))
    np.testing.assert_allclose(y.numpy(), ny.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), nh_.numpy(), **TOL)
    jny, jnh = jref.naive_ssd(*(jnp.asarray(a) for a in (x, dt, Bm, Cm, A)),
                              jnp.asarray(zero_d), jnp.asarray(h0))
    np.testing.assert_allclose(ny.numpy(), np.asarray(jny), **TOL)
    np.testing.assert_allclose(nh_.numpy(), np.asarray(jnh), **TOL)


def test_ssd_scan_state_carry_and_padding_fence():
    """Two calls equal one (as the JAX kernel test), and trailing rows
    with dt = 0 leave the state exactly as the shorter call does."""
    x, dt, A, Bm, Cm, h0 = (_t(a) for a in _ssd_inputs(1, 1, 64, 2, 16, 8,
                                                        0.5))
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=16)
    y1, h1 = ops.ssd_scan(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32],
                          h0, chunk=16)
    y2, h2 = ops.ssd_scan(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:],
                          h1, chunk=16)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **TOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), **TOL)
    dt_fenced = dt.clone()
    dt_fenced[:, 40:] = 0
    yf, hf = ops.ssd_scan(x, dt_fenced, A, Bm, Cm, h0, chunk=16)
    ys, hs = ops.ssd_scan(x[:, :40], dt[:, :40], A, Bm[:, :40], Cm[:, :40],
                          h0, chunk=16)
    np.testing.assert_allclose(hf.numpy(), hs.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(yf[:, :40].numpy(), ys.numpy(), rtol=0,
                               atol=1e-6)


def test_ssd_scan_checks_its_arguments():
    x, dt, A, Bm, Cm, h0 = (_t(a) for a in _ssd_inputs(2, 1, 8, 2, 16, 8))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt[:, :4], A, Bm, Cm, h0)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt.double(), A, Bm, Cm, h0)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt, A, Bm.bfloat16(), Cm, h0)
    # the CPU path is the plain version, and in bf16 y keeps x's type
    y, h = ops.ssd_scan(x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(),
                        h0, chunk=4)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    yp, hp = ssd_scan_plain(x.bfloat16(), dt, A, Bm.bfloat16(),
                            Cm.bfloat16(), h0, chunk=4)
    assert torch.equal(y, yp) and torch.equal(h, hp)


# ---------------------------------------------------------------------------
# the Mamba-2 layer
# ---------------------------------------------------------------------------

SSM = JSSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk_size=16)
D_MODEL = 64


@pytest.fixture(scope="module")
def layer():
    jp = jmamba.init_mamba2(jax.random.PRNGKey(3), D_MODEL, SSM, jnp.float32)
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    return jp, tp, tbase.SSMConfig(**dataclasses.asdict(SSM))


def _state_pair(rng, batch):
    st = jmamba.init_ssm_state(batch, D_MODEL, SSM, jnp.float32)
    vals = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in st._asdict().items()}
    return (jmamba.SSMState(**{k: jnp.asarray(v) for k, v in vals.items()}),
            tmamba.SSMState(**{k: _t(v) for k, v in vals.items()}))


def _assert_state(tst, jst):
    for k in tmamba.SSMState._fields:
        np.testing.assert_allclose(getattr(tst, k).numpy(),
                                   np.asarray(getattr(jst, k)), **TOL)


def test_mamba2_scan_and_step_match_jax(layer):
    jp, tp, tssm = layer
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 37, D_MODEL)).astype(np.float32)
    jst, tst = _state_pair(rng, 2)
    jy, jnew = jmamba.apply_mamba2_scan(jp, jnp.asarray(u), jst, SSM)
    ty, tnew = tmamba.apply_mamba2_scan(tp, _t(u), tst, tssm)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_state(tnew, jnew)
    u1 = u[:, :1]
    jy, jnew = jmamba.apply_mamba2_step(jp, jnp.asarray(u1), jst, SSM)
    ty, tnew = tmamba.apply_mamba2_step(tp, _t(u1), tst, tssm)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_state(tnew, jnew)


def test_mamba2_valid_fence(layer):
    """A padded chunk with ``valid`` gives the unpadded call's state and
    outputs, as in JAX."""
    jp, tp, tssm = layer
    rng = np.random.default_rng(5)
    u = rng.standard_normal((2, 24, D_MODEL)).astype(np.float32)
    valid = np.asarray([24, 13], np.int32)
    jst, tst = _state_pair(rng, 2)
    ty, tnew = tmamba.apply_mamba2_scan(tp, _t(u), tst, tssm,
                                        valid=_t(valid))
    jy, jnew = jmamba.apply_mamba2_scan(jp, jnp.asarray(u), jst, SSM,
                                        valid=jnp.asarray(valid))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_state(tnew, jnew)
    row = tmamba.SSMState(*(getattr(tst, k)[1:2]
                            for k in tmamba.SSMState._fields))
    uy, unew = tmamba.apply_mamba2_scan(tp, _t(u[1:2, :13]), row, tssm)
    np.testing.assert_allclose(ty[1:2, :13].numpy(), uy.numpy(), **TOL)
    for k in tmamba.SSMState._fields:
        np.testing.assert_allclose(getattr(tnew, k)[1:2].numpy(),
                                   getattr(unew, k).numpy(), **TOL)


def test_mamba2_scan_equals_stepwise_decode(layer):
    """The chunked prefill and token-by-token decode agree (as the JAX
    package's own test does)."""
    jp, tp, tssm = layer
    rng = np.random.default_rng(6)
    u = _t(rng.standard_normal((1, 20, D_MODEL)).astype(np.float32))
    st0 = tmamba.init_ssm_state(1, D_MODEL, tssm, torch.float32, "cpu")
    y_scan, st_scan = tmamba.apply_mamba2_scan(tp, u, st0, tssm)
    st, ys = st0, []
    for i in range(u.shape[1]):
        y, st = tmamba.apply_mamba2_step(tp, u[:, i:i + 1], st, tssm)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_scan.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.ssd.numpy(), st_scan.ssd.numpy(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# serving forwards, both layouts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(CONFIGS))
def weights(request):
    jcfg = CONFIGS[request.param]()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(7))
    tp = tm.from_jax_params(port_cfg(jcfg), jax.tree.map(np.asarray, jp),
                            device="cpu")
    return jcfg, jp, tp


class Case:
    """Paired caches of B slots; ``paged`` maps each row's first
    ``pmax - 2`` pages from a shuffled arena (the rest to the scratch
    page)."""

    def __init__(self, weights, paged, seed):
        jcfg, self.jp, self.tp = weights
        kw = dict(kv_layout="paged", kv_page_size=PS) if paged else {}
        self.jcfg = dataclasses.replace(jcfg, **kw)
        self.tcfg = port_cfg(self.jcfg)
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
        if self.bt is None:
            return {}
        return {"block_tables": (jnp.asarray(self.bt) if jax_side
                                 else _t(self.bt))}

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

    def prefill(self, toks, lens, **kw):
        jl, self.jc, _ = jm.forward_prefill(
            self.jp, self.jcfg, jnp.asarray(toks), self.jc, jnp.asarray(lens),
            **{k: jnp.asarray(v) for k, v in kw.items()}, **self.kw(True))
        tl, self.tc, _ = tm.forward_prefill(
            self.tp, self.tcfg, _t(toks), self.tc, _t(lens),
            **{k: _t(v) for k, v in kw.items()}, **self.kw(False))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    def fill(self, n=20):
        self.prefill(self.tokens(B, n), np.zeros(B, np.int32))

    def state_leaves(self):
        return {(n, k): v.clone() for n, layer in self.tc.items()
                for k, v in layer.items()
                if k not in tm.POSITIONAL_CACHE_KEYS}


LAYOUTS = pytest.mark.parametrize("paged", [False, True],
                                  ids=["slab", "paged"])


@LAYOUTS
def test_prefill_with_logit_idx(weights, paged):
    c = Case(weights, paged, 1)
    c.fill()
    c.assert_cache()
    # a padded resume chunk: rows end at different real lengths
    c.prefill(c.tokens(B, 12), np.asarray([20, 20, 20], np.int32),
              logit_idx=np.asarray([11, 4, 0], np.int32))
    c.assert_cache()


@LAYOUTS
def test_decode_fused_keeps_inactive_lane_state(weights, paged):
    c = Case(weights, paged, 2)
    c.fill()
    before = c.state_leaves()
    toks, lens = c.tokens(B), np.asarray([20, 20, 20], np.int32)
    active = np.asarray([True, False, True])
    jt, c.jc, jlen = jm.forward_decode_fused(
        c.jp, c.jcfg, jnp.asarray(toks), c.jc, jnp.asarray(lens),
        jnp.asarray(active), **c.kw(True))
    tt, c.tc, tlen = tm.forward_decode_fused(
        c.tp, c.tcfg, _t(toks), c.tc, _t(lens), _t(active), **c.kw(False))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    c.assert_cache()
    for (n, k), v in before.items():
        assert torch.equal(c.tc[n][k][:, 1], v[:, 1]), (n, k)
        assert not torch.equal(c.tc[n][k][:, 0], v[:, 0]), (n, k)


@LAYOUTS
def test_decode_megastep(weights, paged):
    c = Case(weights, paged, 3)
    c.fill()
    toks, lens = c.tokens(B), np.asarray([20, 20, 20], np.int32)
    active = np.asarray([True, True, False])
    jseq, jt, c.jc, jlen = jm.forward_decode_megastep(
        c.jp, c.jcfg, jnp.asarray(toks), c.jc, jnp.asarray(lens),
        jnp.asarray(active), num_steps=3, **c.kw(True))
    tseq, tt, c.tc, tlen = tm.forward_decode_megastep(
        c.tp, c.tcfg, _t(toks), c.tc, _t(lens), _t(active), num_steps=3,
        **c.kw(False))
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    c.assert_cache()


@LAYOUTS
def test_resume_batch_gathers_and_scatters_states(weights, paged):
    c = Case(weights, paged, 4)
    c.fill()
    before = c.state_leaves()
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
    for (n, k), v in before.items():       # slot 1 was not in the batch
        assert torch.equal(c.tc[n][k][:, 1], v[:, 1]), (n, k)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

def test_config_registry_has_mamba2():
    assert port_cfg(j_smoke("mamba2-780m")) == \
        tbase.get_smoke_config("mamba2-780m")
    full = tbase.get_config("mamba2-780m")
    assert (full.num_layers, full.d_model, full.vocab_size) == (48, 1536,
                                                                50280)
    assert full.ssm.num_heads(full.d_model) == 48
    G, gs, specs = tm.group_layout(full)
    assert (G, gs) == (48, 1) and specs[0].kind == "ssm" \
        and specs[0].ffn == "none"
    G, gs, specs = tm.group_layout(port_cfg(HYBRID))
    assert (G, gs) == (1, 2)
    assert [(s.kind, s.ffn) for s in specs] == [("attn", "mlp"),
                                                ("ssm", "mlp")]
    with pytest.raises(NotImplementedError):
        tbase.get_config("qwen2-vl-7b")


def test_bf16_load_keeps_f32_leaves(weights):
    jcfg, jp, _ = weights
    tcfg = port_cfg(jcfg)
    tp = tm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                            dtype=torch.bfloat16, device="cpu")
    ssm_slots = [v["ssm"] for v in tp["groups"].values() if "ssm" in v]
    assert ssm_slots
    for p in ssm_slots:
        for k in ("A_log", "D", "dt_bias"):
            assert p[k].dtype == torch.float32, k
        assert p["w_x"].dtype == torch.bfloat16
    assert tp["embed"].dtype == torch.bfloat16
    own = tm.init_params(tcfg, torch.Generator().manual_seed(0),
                         torch.bfloat16)
    for p in (v["ssm"] for v in own["groups"].values() if "ssm" in v):
        assert p["A_log"].dtype == torch.float32
        a = torch.exp(p["A_log"])
        assert bool(((a >= 1) & (a <= 16)).all())
    # the port's own init has the JAX tree and shapes
    flat = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat:
        node = own
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path


def test_state_cache_types(weights):
    jcfg, _, _ = weights
    for layout in ("slab", "paged"):
        tcfg = port_cfg(jcfg, kv_layout=layout, kv_page_size=PS)
        tc = tm.init_cache(tcfg, B, S_MAX, dtype=torch.bfloat16,
                           device="cpu")
        jc = jm.init_cache(dataclasses.replace(jcfg, kv_layout=layout,
                                               kv_page_size=PS),
                           B, S_MAX, dtype=jnp.bfloat16)
        for name, layer in jc.items():
            for k, v in layer.items():
                assert tuple(tc[name][k].shape) == v.shape
                want = torch.float32 if v.dtype == jnp.float32 \
                    else torch.bfloat16
                assert tc[name][k].dtype == want, (layout, name, k)
