"""IBM Granite 8B (code) [arXiv:2405.04324; hf]. Plain llama-style GQA."""
from repro_torch.models.model import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    groups=(((LayerSpec(),), 36),),
    rope_theta=10_000_000.0,  # granite-code long-context theta
    source="arXiv:2405.04324; hf",
)
