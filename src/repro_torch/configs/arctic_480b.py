"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
128 routed experts top-2 + dense residual FFN in parallel.
[hf:Snowflake/snowflake-arctic-base; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, d_ff_expert=4864, moe_dense_residual=True,
)
