"""GQA: projections and full-sequence attention (port of
``repro/models/attention.py:26-149``).

Conventions: activations [B, S, D]; heads H, KV heads K (H % K == 0),
head_dim Dh.  :func:`gqa_forward` is the training forward's attention:
exact f32 einsums, chunked over queries so the S x T score matrix is
never whole, with the causal and sliding-window masks (window 0 means
global).  The serving engine's attention lives with its callers: prefill
(``serving/prefix_cache.prefix_chunk_attention``) and decode (the
paged-attention kernel).
"""

from __future__ import annotations

import math

import torch

from . import layers as L

NEG_INF = -1e30


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


def _chunked_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                  window: int, chunk: int = 1024) -> torch.Tensor:
    """Exact attention, chunked over queries.

    q [B, S, K, G, Dh]; k/v [B, T, K, Dh]; returns [B, S, K, G, Dv].
    window: 0 => global; else only positions in (qp - window, qp].
    Padded query positions are -1 and see no key.
    """
    b, s, kh, g, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    n_chunks = max(1, (s + chunk - 1) // chunk)
    c = (s + n_chunks - 1) // n_chunks
    pad = n_chunks * c - s
    if pad:
        q = torch.cat([q, q.new_zeros((b, pad, kh, g, dh))], dim=1)
        q_pos = torch.cat([q_pos, q_pos.new_full((pad,), -1)])
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    outs = []
    for i in range(n_chunks):
        qi, qpi = q[:, i * c:(i + 1) * c], q_pos[i * c:(i + 1) * c]
        scores = torch.einsum("bckgd,btkd->bckgt", qi.to(torch.float32),
                              kf) * scale
        m = (qpi[:, None] >= 0) & (k_pos[None, :] >= 0)
        if causal:
            m &= qpi[:, None] >= k_pos[None, :]
        if window > 0:
            m &= k_pos[None, :] > qpi[:, None] - window
        scores = torch.where(m[None, :, None, None, :], scores,
                             scores.new_tensor(NEG_INF))
        w = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bckgt,btkd->bckgd", w, vf).to(qi.dtype))
    return torch.cat(outs, dim=1)[:, :s]


def gqa_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                window: int = 0, theta: float = 1e4) -> torch.Tensor:
    """Full-sequence causal GQA: x [B, S, D], positions [S] -> [B, S, D].
    K/V come from :func:`gqa_kv`, the one projection path.  (The JAX
    version's cross-attention and external-K/V arguments have no caller
    in the port yet.)"""
    b, s, _ = x.shape
    q = L.linear(p["wq"], x)                         # [B, S, H, Dh]
    dh = q.shape[-1]
    if theta > 0:
        cos, sin = L.rope_angles(positions, dh, theta)
        q = L.apply_rope(q, cos[None, :, None, :], sin[None, :, None, :])
    k, v = gqa_kv(p, x, positions, theta=theta)
    h, kh = q.shape[2], k.shape[2]
    ctx = _chunked_attn(q.reshape(b, s, kh, h // kh, dh), k, v, positions,
                        positions, True, window)
    return _proj_out(p, ctx.reshape(b, s, h, -1))
