"""Jamba-1.5-Large (398B total / ~94B active) [arXiv:2403.19887 + 2408.12570; hf].

Hybrid Mamba+attention, 1:7 attention:mamba per 8-layer Jamba block with
the attention layer at in-block index 4 (paper Fig. 2); MoE (16 experts,
top-2) replaces the MLP on every *other* layer (e=2). No positional
encoding on attention layers (rope_theta=0) — Mamba carries position.
"""
from repro_torch.models.model import ArchConfig, LayerSpec

_M = LayerSpec(mixer="mamba", ffn="dense")
_M_MOE = LayerSpec(mixer="mamba", ffn="moe")
_A = LayerSpec(mixer="attn", ffn="dense")

# in-block index:    0     1      2     3      4   5      6     7
_PATTERN = (_M, _M_MOE, _M, _M_MOE, _A, _M_MOE, _M, _M_MOE)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    groups=((_PATTERN, 9),),  # 72 layers
    rope_theta=0.0,  # Jamba uses no explicit positional encoding
    moe_experts=16,
    moe_top_k=2,
    mamba_d_state=16,
    mamba_expand=2,
    mamba_conv=4,
    source="arXiv:2403.19887 (Jamba), 2408.12570 (Jamba-1.5); hf",
)
