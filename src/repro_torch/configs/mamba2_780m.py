"""Mamba2-780m — attention-free SSM with SSD (state-space duality).

Source: [arXiv:2405.21060]. d_ff=0: Mamba-2 blocks contain the mixing
and gating; there is no separate MLP.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
