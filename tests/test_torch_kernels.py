"""Port attention kernels against the JAX package.

On the CPU each port wrapper runs its kernel's plain PyTorch version;
it is held against the JAX Pallas kernels (interpret mode) and the JAX
oracles on the same numpy inputs (tolerances of tests/test_kernels.py:
3e-5 in f32).  The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_gpu.py, which imports no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models.attention import (  # noqa: E402
    blocked_attention as j_blocked, decode_attention as j_decode)
from test_hotpath_parity import PREFILL_CASES  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.attention import blocked_attention, decode_attention  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port_out, jax_out):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), **F32)


@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd,window,causal", [
    (2, 16, 48, 4, 2, 16, 0, True),
    (1, 20, 20, 6, 3, 8, 7, True),
    (3, 9, 40, 4, 4, 32, 0, False),
])
def test_naive_oracles_match_jax(B, Sq, Sk, H, Hk, hd, window, causal):
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, B, Sq, H, hd), _randn(rng, B, Sk, Hk, hd),
               _randn(rng, B, Sk, Hk, hd))
    qoff = rng.integers(0, Sk - Sq + 1, B).astype(np.int32)
    lens = np.minimum(qoff + Sq + rng.integers(0, 3, B), Sk).astype(np.int32)
    got = ref.naive_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, q_offset=_t(qoff),
                              lengths=_t(lens))
    want = jref.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                q_offset=jnp.asarray(qoff),
                                lengths=jnp.asarray(lens))
    _close(got, want)
    dl = rng.integers(1, Sk + 1, B).astype(np.int32)
    qd = _randn(rng, B, 1, H, hd)
    _close(ref.naive_decode_attention(_t(qd), _t(k), _t(v), _t(dl),
                                      window=window),
           jref.naive_decode_attention(jnp.asarray(qd), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(dl),
                                       window=window))


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_prefill_plain_matches_jax_kernel(case):
    """The prefill kernel's plain version equals the JAX Pallas kernel
    (interpret mode) and ``blocked_attention`` on every serving case, and
    reads the same rows through a permuted ``slot_idx``."""
    H, Hk, Sq, window, qoff, lens = PREFILL_CASES[case]
    S, hd, B = 256, 32, 3
    rng = np.random.default_rng(sum(map(ord, case)))
    q, kc, vc = (_randn(rng, B, Sq, H, hd), _randn(rng, B, S, Hk, hd),
                 _randn(rng, B, S, Hk, hd))
    qoff, lens = np.asarray(qoff, np.int32), np.asarray(lens, np.int32)
    want = jops.flash_prefill(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(qoff),
                              jnp.asarray(lens), window=window, block_q=32,
                              block_k=32, interpret=True)
    want_blocked = j_blocked(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(vc), q_offset=jnp.asarray(qoff),
                             lengths=jnp.asarray(lens), causal=True,
                             window=window, block_size=64)
    got = ops.flash_prefill(_t(q), _t(kc), _t(vc), _t(qoff), _t(lens),
                            window=window)
    _close(got, want)
    _close(got, want_blocked)
    _close(blocked_attention(_t(q), _t(kc), _t(vc), q_offset=_t(qoff),
                             lengths=_t(lens), window=window, block_size=64),
           want_blocked)
    # the same rows in a 5-slot cache at permuted slots
    slots = np.asarray([4, 0, 2], np.int32)
    big_k = np.zeros((5, S, Hk, hd), np.float32)
    big_v = np.zeros((5, S, Hk, hd), np.float32)
    big_k[slots], big_v[slots] = kc, vc
    got_slots = ops.flash_prefill(_t(q), _t(big_k), _t(big_v), _t(qoff),
                                  _t(lens), window=window,
                                  slot_idx=_t(slots))
    _close(got_slots, want)


@pytest.mark.parametrize("lens", [[1, 37, 256], [5, 5, 5], [33, 64, 200]])
def test_decode_plain_matches_jax_kernel(lens):
    """The decode kernel's plain version equals the JAX Pallas kernel
    (interpret mode) on ragged lengths (test_hotpath_parity.py:200)."""
    B, S, H, Hk, hd = 3, 256, 4, 2, 32
    rng = np.random.default_rng(len(lens) + lens[0])
    q, kc, vc = (_randn(rng, B, 1, H, hd), _randn(rng, B, S, Hk, hd),
                 _randn(rng, B, S, Hk, hd))
    lens = np.asarray(lens, np.int32)
    want = jops.flash_decode(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(vc), jnp.asarray(lens), block_k=32,
                             interpret=True)
    _close(ops.flash_decode(_t(q), _t(kc), _t(vc), _t(lens)), want)


@pytest.mark.parametrize("G", [1, 2, 3, 4])
@pytest.mark.parametrize("window", [0, 24])
def test_decode_matches_jax_decode_attention(G, window):
    """Slab decode attention (the kernel's plain version; the windowed
    slice path on the CPU) equals the JAX XLA ``decode_attention``."""
    B, S, Hk, hd = 3, 96, 2, 16
    rng = np.random.default_rng(10 * G + window)
    q, kc, vc = (_randn(rng, B, 1, G * Hk, hd), _randn(rng, B, S, Hk, hd),
                 _randn(rng, B, S, Hk, hd))
    lens = np.asarray([1, 50, 96], np.int32)
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(lens), window=window)
    _close(decode_attention(_t(q), _t(kc), _t(vc), _t(lens), window=window),
           want)


def test_wrappers_reject_bad_arguments():
    q = torch.zeros(2, 4, 4, 16)
    kc = torch.zeros(2, 32, 2, 16)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.flash_prefill(q.double(), kc.double(), kc.double(), i32, i32)
    with pytest.raises(TypeError):
        ops.flash_prefill(q, kc, kc, i32.long(), i32)
    with pytest.raises(ValueError):
        ops.flash_prefill(q, kc, kc[:, :16], i32, i32)
    with pytest.raises(ValueError):
        ops.flash_decode(q, kc, kc, i32)            # Sq != 1
    with pytest.raises(ValueError):
        ops.flash_decode(q[:, :1, :3], kc, kc, i32)  # H % Hk
