"""OLMoE-1B-7B — MoE 64 experts top-8 (1B active / 7B total).

Source: [arXiv:2409.02060]. d_ff=1024 is the per-expert FFN width.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, every=1),
    source="arXiv:2409.02060",
)
