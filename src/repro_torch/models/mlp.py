"""Feed-forward layers: SwiGLU (llama family) and GeLU."""
from __future__ import annotations

import torch.nn.functional as F


def apply_mlp(params, x, act: str):
    if act == "swiglu":
        g = F.silu(x @ params["w_gate"])
        return (g * (x @ params["w_up"])) @ params["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]
