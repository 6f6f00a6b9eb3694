"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternLM2 backbone; InternViT frontend is a stub providing
256 patch embeddings per the assignment. [arXiv:2404.16821; unverified]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    frontend="vision", n_frontend_embeds=256,
)
