"""H2O-Danube3-4B [arXiv:2401.16818 (danube series); unverified].

llama+mistral mix with sliding-window attention (window 4096).
head_dim = 3840/32 = 120 (not 128-aligned; the planner therefore never
shards head_dim).
"""
from repro_torch.models.model import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    groups=(((LayerSpec(window=4096),), 24),),
    rope_theta=10_000.0,
    source="arXiv:2401.16818; unverified",
)
