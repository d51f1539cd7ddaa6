"""Qwen3-4B [hf:Qwen/Qwen3-8B family card; hf]. GQA + qk-RMSNorm."""
from repro_torch.models.model import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    groups=(((LayerSpec(),), 36),),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-4B; hf",
)
