"""xlstm-350m [ssm]: 24L d_model=1024 4H, no FFN (d_ff=0), vocab=50304,
sLSTM + mLSTM blocks (xLSTM[7:1]: every 8th block sLSTM).
[arXiv:2405.04517; unverified]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    attn_kind="none", slstm_every=8, ssm_expand=2,
    subquadratic=True,
)
