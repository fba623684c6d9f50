"""Llama-3.2-3B — small llama3: GQA kv=8, RoPE, SwiGLU.

Source: [hf:meta-llama/Llama-3.2-1B] family card, 3B dims per assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)
