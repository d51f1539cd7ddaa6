"""MusicGen-Large decoder [arXiv:2306.05284; hf] — decoder-only transformer
over EnCodec tokens, 4 codebooks x 2048 vocab with the delay pattern.

The EnCodec frontend is a STUB per the assignment: input_specs() supplies
precomputed summed codebook frame embeddings (B, S, d); the model carries
4 parallel output heads (one per codebook). MHA (kv heads = heads = 32).
SwiGLU is used for the FFN (documented deviation from the GELU MLP).
"""
from repro_torch.models.model import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    groups=(((LayerSpec(),), 48),),
    rope_theta=10_000.0,
    n_codebooks=4,
    frontend="encodec_stub",
    source="arXiv:2306.05284; hf",
)
