"""Model substrate: decoder architectures in PyTorch (attention and mamba
mixers, dense SwiGLU FFNs), with the flash-attention kernel as the
prefill's attention core and the selective-scan kernel as the mamba scan."""
from repro_torch.models.model import (
    ArchConfig,
    LayerSpec,
    active_param_count,
    cache_spec,
    decode_step,
    init_cache,
    init_params,
    param_count,
    prefill,
    tiny_variant,
)

__all__ = [
    "ArchConfig", "LayerSpec", "active_param_count", "cache_spec", "decode_step",
    "init_cache", "init_params", "param_count", "prefill", "tiny_variant",
]
