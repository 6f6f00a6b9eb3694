"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (MLA) d_ff_expert=1408
vocab=102400, 64 routed experts top-6 + 2 shared, MLA kv_lora=512.
[arXiv:2405.04434; hf]

Spec note (DESIGN.md): the pool line reads "2 shared+160 routed top-6" but
also "MoE 64e top-6"; we follow the explicit expert count (64 routed, as in
the HF DeepSeek-V2-Lite config) with 2 shared experts.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    attn_kind="mla", kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, head_dim=192,
    n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
)
