"""Dense decoder-only LM parameters.

Port of ``repro/models/transformer.py:61-94``.

The parameter tree has the JAX package's layout — per-layer block
params stacked along a leading ``[L, ...]`` axis — so a JAX pytree
converts leaf for leaf (``params.from_numpy``) and the engine's loop over
layers indexes ``blocks`` the way ``lax.scan`` sliced it.  Only the dense
GQA family is ported.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

from . import attention as A
from . import layers as L


def _init_block(cfg: ArchConfig, gen: torch.Generator,
                device: torch.device) -> dict:
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, device),
        "ln2": L.init_rmsnorm(cfg.d_model, device),
        "attn": A.init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, bias=cfg.qkv_bias, device=device),
        "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device),
    }


def _stack_into(dst: dict | None, src: dict, li: int, n: int) -> dict:
    """Copy one layer's params into stacked [n, ...] buffers (made on the
    first layer), so the peak is the stack plus one layer."""
    if dst is None:
        dst = {}
    for k, v in src.items():
        if isinstance(v, dict):
            dst[k] = _stack_into(dst.get(k), v, li, n)
        else:
            if k not in dst:
                dst[k] = torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                                     device=v.device)
            dst[k][li] = v
    return dst


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device: torch.device | str) -> dict:
    """Random dense-GQA params on ``device`` from ``gen`` (a generator on
    that device); the JAX init's distributions, not its numbers."""
    if cfg.attn_kind != "gqa" or cfg.is_moe or cfg.is_encdec:
        raise ValueError(f"{cfg.name}: only dense GQA models are ported")
    device = torch.device(device)
    embed = L.init_embed(gen, cfg.vocab, cfg.d_model, device=device)
    blocks = None
    for li in range(cfg.n_layers):
        blocks = _stack_into(blocks, _init_block(cfg, gen, device), li,
                             cfg.n_layers)
    return {
        "embed": embed,
        "blocks": blocks,
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
        "lm_head": L.init_lm_head(gen, cfg.d_model, cfg.vocab,
                                  device=device),
    }
