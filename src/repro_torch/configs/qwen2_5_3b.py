"""Qwen2.5-3B — the paper's own evaluation SLM (§IV-A).

Source: [arXiv:2501.15383] (Qwen2.5 technical report).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="arXiv:2501.15383",
)
