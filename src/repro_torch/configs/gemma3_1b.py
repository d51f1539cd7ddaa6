"""Gemma 3 1B [hf:google/gemma-3-1b-pt; unverified].

5 local (sliding window 512) : 1 global attention schedule; 26 layers =
4 full (5L+1G) units + 2 trailing local layers. head_dim 256 (4 heads on
d_model 1152 — q/o project 1152->1024). qk-RMSNorm, tied embeddings,
sqrt(d) embedding scaling, 262k vocab. rope_theta 1e6 (global layers'
value; the 10k local theta is a documented simplification).
"""
from repro_torch.models.model import ArchConfig, LayerSpec

_L = LayerSpec(mixer="attn", window=512, ffn="dense")
_G = LayerSpec(mixer="attn", window=None, ffn="dense")

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    groups=(((_L, _L, _L, _L, _L, _G), 4), ((_L, _L), 1)),  # 26 layers
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    embed_scale=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
