"""Granite 3.0 1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
32-expert top-8 fine-grained MoE (d_ff 512 per expert). Vocab 49155 is
padded to 49280 (multiple of 128) by the model; logits beyond 49155 are
masked in the loss."""
from repro_torch.models.model import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    groups=(((LayerSpec(ffn="moe"),), 24),),
    rope_theta=10_000.0,
    moe_experts=32,
    moe_top_k=8,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
