"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per block;
3 full-attention layers (first/mid/last), sliding window elsewhere.
[arXiv:2411.13676; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    n_full_attn=3, window=1024,
    subquadratic=True,
)
