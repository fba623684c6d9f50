"""Config system: the architecture registry of the port.

``ModelConfig`` keeps the JAX package's fields one-to-one, so a config
built from the same keyword arguments describes the same model in both
packages.  ``reduced()`` derives the CPU-smoke variant of the same family
(≤2 layers, d_model ≤ 256).  The registry lists the architectures the
port runs (dense and MoE decoders, Mamba-2 and hybrids); asking for a
known architecture whose family is not ported yet raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # Apply an MoE MLP every `every` layers (1 = every layer). Jamba uses 2.
    every: int = 1
    # Router auxiliary load-balance loss weight (train path).
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) hyper-parameters [arXiv:2405.21060]."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def num_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int          # 0 for attention-free architectures
    num_kv_heads: int
    d_ff: int               # 0 for attention-free (pure SSM) architectures
    vocab_size: int
    head_dim: int = 0       # 0 -> d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_period: int = 0
    hybrid_attn_index: int = 0
    sliding_window: int = 0      # 0 = full attention
    encoder_only: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    frontend: str = "none"
    # Attention backend fields of the JAX package.  The port does not
    # read them: its slab prefill and decode attention always launch the
    # CUDA kernels on CUDA tensors and their plain versions on CPU tensors.
    prefill_kernel: str = "xla"
    decode_kernel: str = "xla"
    # KV-cache layout: "slab" (per-slot [num_slots, max_seq] stripes) or
    # "paged" (a page arena of kv_page_size-row pages addressed through
    # per-slot block tables, with the radix prefix cache; the CUDA kernels
    # take power-of-two page sizes, ``kernels.ops.PAGE_SIZES``).
    kv_layout: str = "slab"
    kv_page_size: int = 64
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "swiglu"          # swiglu | gelu
    source: str = ""             # citation

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab rounded up to a multiple of 128
        (the JAX package's layout).  Logits are sliced back to
        ``vocab_size``."""
        return -(-self.vocab_size // 128) * 128

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for layer i (hybrid interleave)."""
        if self.family == "ssm":
            return "ssm"
        if self.hybrid_period:
            return ("attn" if (i % self.hybrid_period) == self.hybrid_attn_index
                    else "ssm")
        return "attn"

    def layer_has_moe(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every) == (self.moe.every - 1)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family, shrunk per contract: ≤2 layers, d_model ≤ 256."""
    d_model = min(cfg.d_model, 256)
    heads = 4 if cfg.num_heads else 0
    kv = min(max(1, cfg.num_kv_heads * 4 // max(cfg.num_heads, 1) or 1), heads) if heads else 0
    kv = kv if heads == 0 or heads % kv == 0 else 2
    period = cfg.hybrid_period
    layers = 2 if not period else period
    moe = None
    if cfg.moe:
        moe = MoEConfig(num_experts=4, top_k=min(2, cfg.moe.top_k),
                        every=min(cfg.moe.every, 2),
                        aux_loss_weight=cfg.moe.aux_loss_weight)
    ssm = None
    if cfg.ssm:
        ssm = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk_size=32)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=(d_model // heads) if heads else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        moe=moe,
        ssm=ssm,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        mrope_sections=(8, 12, 12) if cfg.mrope else cfg.mrope_sections,
    )


# Architectures the port runs (dense decoders: the paper's testbed models
# Qwen2.5-3B/7B and Llama3-8B, the other dense configs and the smallest
# smoke architecture; the attention-free Mamba-2 SLM; the MoE decoders
# and the Jamba hybrid with MoE).
ARCH_MODULES = {
    "smollm-360m": "smollm_360m",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen2.5-7b": "qwen2_5_7b",
    "llama3-8b": "llama3_8b",
    "llama3.2-3b": "llama3_2_3b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "starcoder2-15b": "starcoder2_15b",
    "mamba2-780m": "mamba2_780m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
}

# Architectures of the JAX package that the port does not run yet.
NOT_PORTED = {"hubert-xlarge": "audio", "qwen2-vl-7b": "vlm"}


def get_config(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} ({NOT_PORTED[name]} family) is not ported yet; "
            f"ported: {sorted(ARCH_MODULES)}")
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))
