"""Mixtral 8x22B — MoE 8 experts top-2, GQA, sliding-window attention.

Source: [arXiv:2401.04088] (Mixtral of Experts; 8x22B scale per assignment).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    moe=MoEConfig(num_experts=8, top_k=2, every=1),
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)
