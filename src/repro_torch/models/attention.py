"""GQA projections (port of ``repro/models/attention.py:33-48,94-114``).

Conventions: activations [B, S, D]; heads H, KV heads K (H % K == 0),
head_dim Dh.  The attention itself lives with its callers: the serving
engine's prefill (``serving/prefix_cache.prefix_chunk_attention``) and
decode (the paged-attention kernel).
"""

from __future__ import annotations

import torch

from . import layers as L


def init_gqa(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
             head_dim: int, *, bias: bool = False, dtype=torch.bfloat16,
             device: torch.device) -> dict:
    def lin(out):
        return L.init_linear(gen, d, out, bias=bias, dtype=dtype,
                             device=device)
    return {
        "wq": lin((n_heads, head_dim)),
        "wk": lin((n_kv, head_dim)),
        "wv": lin((n_kv, head_dim)),
        "wo": {"w": L._dense_init(gen, (n_heads, head_dim, d), dtype,
                                  device)},
    }


def _proj_out(p: dict, ctx: torch.Tensor) -> torch.Tensor:
    """ctx [B, S, H, Dh] -> [B, S, D]: contracts (H, Dh) against wo
    [H, Dh, D], accumulating in f32 and rounding once (see L.linear)."""
    w = p["wo"]["w"]
    y = torch.matmul(ctx.reshape(*ctx.shape[:-2], -1),
                     w.reshape(-1, w.shape[-1]))
    return y.to(ctx.dtype)


def gqa_kv(p: dict, x: torch.Tensor, positions: torch.Tensor,
           theta: float = 1e4) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V projection + K-rope: x [B, T, D] -> (k roped, v), each
    [B, T, K, Dh].  ``positions`` is [T] (shared) or [B, T] (per row)."""
    k = L.linear(p["wk"], x)
    v = L.linear(p["wv"], x)
    if theta > 0:
        cos, sin = L.rope_angles(positions, k.shape[-1], theta)
        if positions.dim() == 1:
            cos, sin = cos[None], sin[None]
        k = L.apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])
    return k, v
