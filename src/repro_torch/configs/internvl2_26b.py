"""InternVL2-26B [arXiv:2404.16821; hf] — InternLM2-20B language backbone.

The InternViT-6B vision frontend is a STUB per the assignment:
input_specs() supplies 256 precomputed patch embeddings (one 448px tile
after pixel-shuffle) prepended to the text tokens; patch positions are
masked out of the loss.
"""
from repro_torch.models.model import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,  # padded to 92672 internally
    groups=(((LayerSpec(),), 48),),
    rope_theta=1_000_000.0,
    frontend="vit_stub",
    n_patches=256,
    source="arXiv:2404.16821; hf",
)
