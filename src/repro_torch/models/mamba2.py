"""Mamba-2 (SSD — state-space duality) layer [arXiv:2405.21060].

Recurrence (per head h, scalar decay):
    a_t = exp(dt_t * A_h)                       (A_h < 0)
    H_t = a_t * H_{t-1} + dt_t * x_t (x) B_t    (H: [hd, N])
    y_t = H_t . C_t + D_h * x_t

Prefill runs the chunked SSD algorithm through ``kernels.ops.ssd_scan``
(the CUDA kernel on a card, its plain version on the CPU), where the
JAX package runs the same chunk body as a ``lax.scan`` over chunks; the
``D`` term is added after it.  Decode is the O(1)-per-token recurrence
against the carried (conv, ssd-state) cache, in plain tensor ops.

B and C are shared across heads (ngroups=1), matching mamba2-780m.
Weights are separate projections (w_z/w_x/w_B/w_C/w_dt), as in the JAX
package, so its parameters carry across one to one.  ``dt_bias``,
``A_log`` and ``D`` are float32 whatever the model's type, and so is the
``ssd`` state.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import rms_norm

# leaves that stay float32 in a bf16 model (param_shapes marks them)
F32_PARAMS = frozenset({"dt_bias", "A_log", "D"})


class SSMState(NamedTuple):
    """Rolling conv inputs kept as three streams (as in the JAX package)
    plus the recurrent state."""
    conv_x: torch.Tensor  # [B, d_conv-1, d_in]
    conv_B: torch.Tensor  # [B, d_conv-1, N]
    conv_C: torch.Tensor  # [B, d_conv-1, N]
    ssd: torch.Tensor     # [B, nh, hd, N] recurrent state (float32)


def mamba2_shapes(d_model: int, ssm):
    """{leaf: (shape, init)} of one Mamba-2 layer; init is ("dense",
    fan_in), ("normal", scale), ("zeros",), ("ones",) or ("a_log",)
    (log of uniform [1, 16))."""
    d_in = ssm.expand * d_model
    nh, N, K = ssm.num_heads(d_model), ssm.d_state, ssm.d_conv
    return {
        "w_z": ((d_model, d_in), ("dense", d_model)),
        "w_x": ((d_model, d_in), ("dense", d_model)),
        "w_B": ((d_model, N), ("dense", d_model)),
        "w_C": ((d_model, N), ("dense", d_model)),
        "w_dt": ((d_model, nh), ("dense", d_model)),
        "dt_bias": ((nh,), ("zeros",)),
        "conv_x_w": ((K, d_in), ("normal", 0.1)),
        "conv_x_b": ((d_in,), ("zeros",)),
        "conv_B_w": ((K, N), ("normal", 0.1)),
        "conv_B_b": ((N,), ("zeros",)),
        "conv_C_w": ((K, N), ("normal", 0.1)),
        "conv_C_b": ((N,), ("zeros",)),
        "A_log": ((nh,), ("a_log",)),
        "D": ((nh,), ("ones",)),
        "norm": ((d_in,), ("ones",)),
        "w_out": ((d_in, d_model), ("dense", d_in)),
    }


def init_ssm_state(batch: int, d_model: int, ssm, dtype,
                   device="cuda") -> SSMState:
    d_in = ssm.expand * d_model
    nh = ssm.num_heads(d_model)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return SSMState(
        conv_x=z((batch, ssm.d_conv - 1, d_in), dtype),
        conv_B=z((batch, ssm.d_conv - 1, ssm.d_state), dtype),
        conv_C=z((batch, ssm.d_conv - 1, ssm.d_state), dtype),
        ssd=z((batch, nh, ssm.head_dim, ssm.d_state), torch.float32),
    )


def _causal_conv(seq, conv_state, w, b, valid=None):
    """seq: [B, S, ch]; conv_state: [B, d_conv-1, ch] (history).

    ``valid`` [B]: number of real tokens per row (the rest of ``seq`` is
    executable-shape padding).  The carried-out state is then the last
    ``d_conv-1`` inputs at the valid frontier, not the padded tail."""
    d_conv = w.shape[0]
    full = torch.cat([conv_state, seq], dim=1)
    if valid is None:
        new_state = full[:, full.shape[1] - (d_conv - 1):, :]
    else:
        # valid inputs occupy full[:, d_conv-1 : d_conv-1+valid); the last
        # d_conv-1 of them sit at [valid, valid + d_conv - 1)
        idx = valid.long()[:, None] + torch.arange(d_conv - 1,
                                                   device=seq.device)
        new_state = torch.gather(
            full, 1, idx[:, :, None].expand(-1, -1, full.shape[2]))
    S = seq.shape[1]
    out = sum(full[:, j: j + S, :] * w[j][None, None, :]
              for j in range(d_conv)) + b[None, None, :]
    return F.silu(out), new_state


def _split_proj(params, u):
    """u: [B, S, d_model] -> z, x, Bm, Cm, dt (pre-conv, pre-activation)."""
    z = u @ params["w_z"]
    x = u @ params["w_x"]
    Bm = u @ params["w_B"]
    Cm = u @ params["w_C"]
    dt = (u @ params["w_dt"]).float()
    return z, x, Bm, Cm, dt


def _out(params, y, z):
    y = rms_norm(y * F.silu(z), params["norm"])
    return y @ params["w_out"]


def apply_mamba2_scan(params, u, state: SSMState, ssm,
                      valid=None) -> Tuple[torch.Tensor, SSMState]:
    """Chunked SSD over a sequence. u: [B, S, d_model] -> (y, new_state).

    ``valid`` [B]: real tokens per row when ``u`` carries trailing
    executable-shape padding.  Padded positions are state-identity:
    their post-softplus ``dt`` is zeroed (a = 1, zero injection) and the
    conv streams carry out the frontier window, so the carried state is
    exactly the unpadded computation's and a session's tokens do not
    depend on which shape its chunks were padded to.  x, B and C enter
    the scan in the model's type (the kernel computes in f32); y comes
    back in that type and the ``D`` term is added in f32."""
    B_, S, d_model = u.shape
    d_in = ssm.expand * d_model
    nh, hd = ssm.num_heads(d_model), ssm.head_dim
    Q = min(ssm.chunk_size, max(S, 1))

    z, x, Bm, Cm, dt = _split_proj(params, u)
    x, new_cx = _causal_conv(x, state.conv_x, params["conv_x_w"],
                             params["conv_x_b"], valid=valid)
    Bm, new_cb = _causal_conv(Bm, state.conv_B, params["conv_B_w"],
                              params["conv_B_b"], valid=valid)
    Cm, new_cc = _causal_conv(Cm, state.conv_C, params["conv_C_w"],
                              params["conv_C_b"], valid=valid)

    dt = F.softplus(dt + params["dt_bias"][None, None, :])       # [B,S,nh]
    if valid is not None:
        pos = torch.arange(S, device=u.device)[None, :, None]
        dt = torch.where(pos < valid.long()[:, None, None], dt,
                         torch.zeros_like(dt))
    A = -torch.exp(params["A_log"])                               # [nh]
    xh = x.reshape(B_, S, nh, hd)
    y, H = ops.ssd_scan(xh, dt, A, Bm, Cm, state.ssd, chunk=Q)
    y = y.float() + xh.float() * params["D"][None, None, :, None]
    y = y.reshape(B_, S, d_in).to(u.dtype)
    return _out(params, y, z), SSMState(conv_x=new_cx, conv_B=new_cb,
                                        conv_C=new_cc, ssd=H)


def apply_mamba2_step(params, u, state: SSMState,
                      ssm) -> Tuple[torch.Tensor, SSMState]:
    """Single decode step. u: [B, 1, d_model] -> (y [B,1,d_model], state)."""
    B_, _, d_model = u.shape
    d_in = ssm.expand * d_model
    nh, hd = ssm.num_heads(d_model), ssm.head_dim

    z, x, Bm, Cm, dt = _split_proj(params, u)
    x, new_cx = _causal_conv(x, state.conv_x, params["conv_x_w"],
                             params["conv_x_b"])
    Bm, new_cb = _causal_conv(Bm, state.conv_B, params["conv_B_w"],
                              params["conv_B_b"])
    Cm, new_cc = _causal_conv(Cm, state.conv_C, params["conv_C_w"],
                              params["conv_C_b"])
    x, Bm, Cm = x[:, 0], Bm[:, 0], Cm[:, 0]

    dt = F.softplus(dt[:, 0] + params["dt_bias"][None, :])        # [B,nh]
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A[None, :])                                # [B,nh]
    xh = x.reshape(B_, nh, hd).float()
    H = state.ssd * a[:, :, None, None] + torch.einsum(
        "bh,bhd,bn->bhdn", dt, xh, Bm.float())
    y = torch.einsum("bhdn,bn->bhd", H, Cm.float())
    y = y + xh * params["D"][None, :, None]
    y = y.reshape(B_, 1, d_in).to(u.dtype)
    return _out(params, y, z), SSMState(conv_x=new_cx, conv_B=new_cb,
                                        conv_C=new_cc, ssd=H)
