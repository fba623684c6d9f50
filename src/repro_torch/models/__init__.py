"""Decoder models of the port (dense, Mamba-2 and hybrid stacks; the JAX
package's model layout), with the speculative decode step and the dense
training forwards."""
from repro_torch.models.model import (  # noqa: F401
    POSITIONAL_CACHE_KEYS, forward_cold, forward_decode,
    forward_decode_fused, forward_decode_megastep, forward_prefill,
    forward_resume_batch, forward_spec_step, forward_spec_verify,
    forward_train, from_jax_params, group_layout, init_cache, init_params,
    num_kv_pages, param_shapes)
