"""Qwen2.5-7B — the paper's own evaluation SLM (§IV-A).

Source: [arXiv:2501.15383].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope_theta=1_000_000.0,
    source="arXiv:2501.15383",
)
