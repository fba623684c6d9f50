"""Llama-3-8B — the paper's own evaluation model (§IV-A).

Source: [arXiv:2407.21783] (Llama 3 herd).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
)
