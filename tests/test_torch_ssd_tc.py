"""The bf16 SSD scan's tensor-core arithmetic, on the CPU.

With bf16 x, B and C, ``ops.ssd_scan`` runs the tensor-core body of
``csrc/ssd_scan.cu`` on the card: one block per 16 columns of hd of a
(batch row, head), 16-row query and key tiles, the cumsum of dt * A in
f64 rounded once (``scan_chunk``), and every product an ``mma`` of bf16
operands summed in f32:

* G = C B^T over N in k16 steps;
* M = select(i >= j, G exp(s_i - s_j) dt_j, 0) as two bf16 operands, hi
  and lo = bf16(M - hi), against the x slice, key tile by key tile;
* C H_in^T with H_in as hi + lo, then y = M x + exp(s) C H_in^T, rounded
  to bf16;
* dH = sum_j (w_j x_j) (x) B_j with w_j x_j as hi + lo (one accumulator
  each), and H = exp(s_last) H + dH in f32.

That order is written out here in PyTorch (``tc_emulation``: an mma step
is its exact products summed in f64 and rounded once to f32 as they are
added to the f32 accumulator) and held against the JAX Pallas kernel 7
(``repro.kernels.ops.ssd_scan``, interpret mode) and the port's plain
version (``ssd_scan_plain``) on the same numpy inputs, at the smoke
widths (nh 4, hd 32, N 16, chunk 16) and mamba2-780m's (nh 48, hd 64,
N 128, chunk 256; S 160 and S 300 across two chunks), with a tail of dt
= 0 rows.  Tolerances: y within 2e-2 (bf16, the kernel's y tolerance on
the card), the state within 2e-3, ten times tighter, because the state
is carried across chunks, calls and turns.  The padding fence holds bit
for bit under the emulation, and the block plan (``tc_plan``) is a
function of static shapes that fills the card at a cold chunk.  The
kernel itself runs on the card only: tests/test_torch_gpu.py holds it
against the plain version.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    MAX_CHUNK, TC_SLICE, TC_TILE, ssd_scan_plain, tc_plan)

Y_TOL = 2e-2          # bf16 y
H_TOL = Y_TOL / 10    # the carried state


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _bf(v):
    return v.to(torch.bfloat16).float()


def _split(v):
    """hi = bf16(v), lo = bf16(v - hi), both back in f32."""
    hi = _bf(v)
    return hi, _bf(v - hi)


def _mma(acc, a, b, eq):
    """One mma step: acc + einsum(eq, a, b), the products exact and summed
    in f64, rounded once to f32."""
    return (acc.double() + torch.einsum(eq, a.double(), b.double())).float()


def tc_emulation(x, dt, A, Bm, Cm, h0, *, chunk):
    """The bf16 tensor-core body's arithmetic on CPU tensors: x, Bm, Cm in
    bf16; dt, A, h0 in f32 -> (y in bf16, the final state in f32).  Each
    16-column slice of hd is a block's; the key tiles and k16 steps run
    in the kernel's order.  A query tile's products with key tiles past
    its own are exact zeros (the select), so the query rows of a slice
    are taken together."""
    Bn, S, nh, hd = x.shape
    N = Bm.shape[-1]
    y = torch.empty(Bn, S, nh, hd)
    H = h0.float().clone()
    zero = torch.zeros(())
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        R = -(-q // TC_TILE) * TC_TILE       # the chunk's tiles, from its start

        def rows(t):                         # rows past the chunk's end: 0
            out = torch.zeros((Bn, R) + tuple(t.shape[2:]))
            out[:, :q] = t[:, c0:c0 + q].float()
            return out

        xq, Bq, Cq, dtq = rows(x), rows(Bm), rows(Cm), rows(dt)
        s = torch.cumsum((dtq * A).double(), dim=1).float()      # [Bn, R, nh]
        s_last = s[:, q - 1]                                     # [Bn, nh]
        G = torch.zeros(Bn, R, R)
        for k0 in range(0, N, 16):
            G = _mma(G, Cq[..., k0:k0 + 16], Bq[..., k0:k0 + 16],
                     "bin,bjn->bij")
        ii = torch.arange(R)
        causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
        e = torch.exp(torch.where(causal, s[:, :, None] - s[:, None], zero))
        M = torch.where(causal, G[..., None] * e * dtq[:, None], zero)
        Mhi, Mlo = _split(M)                                     # [Bn,R,R,nh]
        w = torch.exp(s_last[:, None] - s) * dtq                 # [Bn, R, nh]
        for d0 in range(0, hd, TC_SLICE):
            X = xq[..., d0:d0 + TC_SLICE]                        # [Bn,R,nh,16]
            Hhi, Hlo = _split(H[:, :, d0:d0 + TC_SLICE])         # [Bn,nh,16,N]
            ys = torch.zeros(Bn, R, nh, TC_SLICE)
            for k0 in range(0, N, 16):
                for Hp in (Hhi, Hlo):
                    ys = _mma(ys, Cq[..., k0:k0 + 16], Hp[..., k0:k0 + 16],
                              "bin,bhdn->bihd")
            yi = torch.zeros(Bn, R, nh, TC_SLICE)
            for j0 in range(0, R, TC_TILE):
                for Mp in (Mhi, Mlo):
                    yi = _mma(yi, Mp[:, :, j0:j0 + TC_TILE],
                              X[:, j0:j0 + TC_TILE], "bijh,bjhd->bihd")
            y[:, c0:c0 + q, :, d0:d0 + TC_SLICE] = (
                yi + torch.exp(s)[..., None] * ys)[:, :q]
            Whi, Wlo = _split(X * w[..., None])
            dh = torch.zeros(Bn, nh, TC_SLICE, N)
            dl = torch.zeros(Bn, nh, TC_SLICE, N)
            for j0 in range(0, R, TC_TILE):
                Bt = Bq[:, j0:j0 + TC_TILE]
                dh = _mma(dh, Whi[:, j0:j0 + TC_TILE], Bt, "bjhd,bjn->bhdn")
                dl = _mma(dl, Wlo[:, j0:j0 + TC_TILE], Bt, "bjhd,bjn->bhdn")
            H[:, :, d0:d0 + TC_SLICE] = (
                H[:, :, d0:d0 + TC_SLICE]
                * torch.exp(s_last)[..., None, None] + (dh + dl))
    return y.to(x.dtype), H


def _inputs(seed, Bn, S, nh, hd, N, pad=0):
    """Scan inputs at the model path's magnitudes, made with numpy: x, B
    and C rounded to bf16 (B and C scaled by N^-1/2), post-softplus dt
    with its last ``pad`` rows 0, A in [-16, -1), a nonzero state."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = torch.tensor(f(Bn, S, nh, hd)).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.tensor(f(Bn, S, nh)))
    if pad:
        dt[:, S - pad:] = 0
    A = torch.tensor(-(1.0 + 15.0 * rng.random(nh)).astype(np.float32))
    Bm = torch.tensor(f(Bn, S, N) * N ** -0.5).to(torch.bfloat16)
    Cm = torch.tensor(f(Bn, S, N) * N ** -0.5).to(torch.bfloat16)
    h0 = torch.tensor(0.1 * f(Bn, nh, hd, N))
    return x, dt, A, Bm, Cm, h0


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _np(t):
    return t.float().numpy()


CASES = {
    "smoke": (2, 50, 4, 32, 16, 16),
    "smoke-one-short-chunk": (1, 13, 4, 32, 16, 16),
    "mamba2-cold-chunk": (1, 160, 48, 64, 128, 256),
    "mamba2-two-chunks": (1, 300, 48, 64, 128, 256),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tc_emulation_matches_jax_kernel_and_plain(case):
    Bn, S, nh, hd, N, chunk = CASES[case]
    args = _inputs(7, Bn, S, nh, hd, N, pad=S // 5)
    y, h = tc_emulation(*args, chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
    jy, jh = jops.ssd_scan(*(jnp.asarray(_np(t)) for t in args), chunk=chunk)
    yp, hp = ssd_scan_plain(*args, chunk=chunk)
    errs = {"y/jax": _err(_np(y), jy), "y/plain": _err(_np(y), _np(yp)),
            "h/jax": _err(h.numpy(), jh), "h/plain": _err(h.numpy(),
                                                         hp.numpy())}
    print(case, {k: f"{v:.3e}" for k, v in errs.items()})
    assert errs["y/jax"] <= Y_TOL and errs["y/plain"] <= Y_TOL, errs
    assert errs["h/jax"] <= H_TOL and errs["h/plain"] <= H_TOL, errs


@pytest.mark.parametrize("Bn,S,keep,nh,hd,N", [
    (2, 200, 150, 4, 32, 16),
    (4, 64, 40, 48, 64, 128),        # the resume batch's shape
])
def test_tc_emulation_padding_fence_is_bitwise(Bn, S, keep, nh, hd, N):
    """Trailing rows with dt = 0 leave the state and the real rows' y bit
    for bit as the unpadded call does: the padded key tiles add exact
    zero products, and the tiles start at the chunk's start."""
    x, dt, A, Bm, Cm, h0 = _inputs(11, Bn, S, nh, hd, N)
    fenced = dt.clone()
    fenced[:, keep:] = 0
    y, h = tc_emulation(x, fenced, A, Bm, Cm, h0, chunk=MAX_CHUNK)
    ys, hs = tc_emulation(x[:, :keep], dt[:, :keep], A, Bm[:, :keep],
                          Cm[:, :keep], h0, chunk=MAX_CHUNK)
    assert torch.equal(h, hs)
    assert torch.equal(y[:, :keep], ys)


def test_tc_emulation_two_calls_carry_the_state():
    """160 rows then 96 against one call of 256: the state crosses the
    call in f32, within the state tolerance; y within bf16's."""
    x, dt, A, Bm, Cm, h0 = _inputs(3, 1, 256, 8, 64, 128)
    y, h = tc_emulation(x, dt, A, Bm, Cm, h0, chunk=MAX_CHUNK)
    cut = lambda t, a, b: t[:, a:b].contiguous()
    y1, h1 = tc_emulation(*(cut(t, 0, 160) for t in (x, dt)), A,
                          *(cut(t, 0, 160) for t in (Bm, Cm)), h0,
                          chunk=MAX_CHUNK)
    y2, h2 = tc_emulation(*(cut(t, 160, 256) for t in (x, dt)), A,
                          *(cut(t, 160, 256) for t in (Bm, Cm)), h1,
                          chunk=MAX_CHUNK)
    assert _err(_np(torch.cat([y1, y2], 1)), _np(y)) <= Y_TOL
    assert _err(h2.numpy(), h.numpy()) <= H_TOL


def test_tc_plan_fills_the_card_from_static_shapes():
    """The bf16 body's plan: 16-column slices, grid (hd / 16, nh, B), two
    blocks resident an SM (shared memory within half an SM's), so a
    mamba2-780m cold chunk runs at least 132 blocks in one wave; it reads
    no sequence length, dt or device value."""
    assert list(inspect.signature(tc_plan).parameters) == ["B", "nh", "hd",
                                                           "N"]
    cold = tc_plan(1, 48, 64, 128)
    assert cold.slice == 16 and cold.grid == (4, 48, 1)
    assert cold.blocks == 192 >= 132 and cold.threads == 256
    assert cold.smem_bytes <= 113 * 1024 and cold.resident_per_sm == 2
    assert cold.waves(132) == 1
    batch = tc_plan(4, 48, 64, 128)
    assert batch.grid == (4, 48, 4) and batch.blocks == 768
    assert batch.waves(132) == 3
    smoke = tc_plan(2, 4, 32, 16)
    assert smoke.grid == (2, 4, 2) and smoke.resident_per_sm == 2
    assert smoke.smem_bytes < cold.smem_bytes


def test_cpu_path_is_the_plain_version():
    """On CPU tensors ``ops.ssd_scan`` is ``ssd_scan_plain``, bit for bit,
    in bf16 as in f32, and counts no launch."""
    args = _inputs(5, 2, 40, 4, 32, 16, pad=6)
    before = ops.LAUNCHES["ssd_scan"]
    for a in (args, (args[0].float(),) + args[1:3]
              + tuple(t.float() for t in args[3:5]) + args[5:]):
        y, h = ops.ssd_scan(*a, chunk=16)
        yp, hp = ssd_scan_plain(*a, chunk=16)
        assert torch.equal(y, yp) and torch.equal(h, hp)
    assert ops.LAUNCHES["ssd_scan"] == before
