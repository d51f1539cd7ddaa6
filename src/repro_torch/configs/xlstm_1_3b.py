"""xLSTM-1.3B [arXiv:2405.04517; unverified]. xLSTM[7:1]: 7 mLSTM blocks
per 1 sLSTM block (sLSTM at in-block index 7). d_ff=0: cells carry their
own projections; no separate FFN sublayer (see DESIGN.md width note)."""
from repro_torch.models.model import ArchConfig, LayerSpec

_M = LayerSpec(mixer="mlstm", ffn="none")
_S = LayerSpec(mixer="slstm", ffn="none")

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    groups=(((_M, _M, _M, _M, _M, _M, _M, _S), 6),),  # 48 layers
    rope_theta=0.0,  # recurrent cells encode position
    source="arXiv:2405.04517; unverified",
)
