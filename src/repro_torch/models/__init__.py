"""Dense decoder model of the port (the JAX package's model layout)."""
from repro_torch.models.model import (  # noqa: F401
    POSITIONAL_CACHE_KEYS, forward_decode, forward_decode_fused,
    forward_decode_megastep, forward_prefill, forward_resume_batch,
    from_jax_params, init_cache, init_params, merge_decode_cache,
    param_shapes)
