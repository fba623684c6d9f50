"""Jamba-1.5-Large (398B) — hybrid Mamba+attention 1:7, MoE 16e top-2.

Source: [arXiv:2403.19887]. Within each period of 8 layers, one is
attention (index 4 in the published config — we use the middle slot) and
7 are Mamba; MoE replaces the MLP every 2 layers.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, every=2),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=128, chunk_size=256),
    hybrid_period=8,
    hybrid_attn_index=4,
    source="arXiv:2403.19887",
)
