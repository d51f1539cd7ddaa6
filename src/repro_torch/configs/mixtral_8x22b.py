"""Mixtral 8x22B [arXiv:2401.04088; hf]. 8-expert top-2 MoE every layer;
sliding-window attention per the assignment listing (window 4096)."""
from repro_torch.models.model import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    groups=(((LayerSpec(window=4096, ffn="moe"),), 56),),
    rope_theta=1_000_000.0,
    moe_experts=8,
    moe_top_k=2,
    source="arXiv:2401.04088; hf",
)
