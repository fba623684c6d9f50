"""SmolLM-360M — llama-architecture small model (GQA kv=5).

Source: [hf:HuggingFaceTB/SmolLM-135M] family card, 360M variant dims
per assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
