"""seamless-m4t-large-v2 [audio]: enc-dec, 24L enc + 24L dec, d_model=1024
16H d_ff=8192 vocab=256206 — speech-encoder frontend is a stub providing
frame embeddings. [arXiv:2308.11596; hf]

Shape interpretation (DESIGN.md): train/prefill use seq_len for BOTH the
encoder frames and decoder tokens; decode shapes use seq_len for the
decoder KV and a fixed 4096-frame encoder memory.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    frontend="audio",
)
