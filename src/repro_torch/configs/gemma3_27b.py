"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global attention, 128k context (window 1024).
[hf:google/gemma-3-1b-pt; unverified]

subquadratic=True: 52/62 layers are sliding-window; the 10 global layers
keep full KV, which at 500k x batch 1 shards comfortably (DESIGN.md).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab=262144,
    local_ratio=5, window=1024,
    subquadratic=True,
)
