"""Dense decoder-only LM: parameters, full-sequence forward and loss.

Port of ``repro/models/transformer.py:37-165`` for the dense GQA family
(yi-6b/9b, qwen2.5-14b, gemma3-27b's local:global windows, internvl2's
prepended frontend embeddings); MoE and MLA raise.

The parameter tree has the JAX package's layout — per-layer block
params stacked along a leading ``[L, ...]`` axis — so a JAX pytree
converts leaf for leaf (``params.from_numpy``) and the engine's loop over
layers indexes ``blocks`` the way ``lax.scan`` sliced it.  Where JAX
scans the blocks under ``jax.checkpoint(policy=nothing_saveable)``, the
forward here loops over them, each layer under
``torch.utils.checkpoint``: only each layer's input is kept for the
backward.  The stacked leaves are split with ``unbind``, whose backward
stacks a leaf's per-layer gradients once, instead of one full-size
scatter a layer.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

from . import attention as A
from . import layers as L
from . import params as P


def is_dense(cfg: ArchConfig) -> bool:
    """The family this module ports: GQA attention, dense FFN, decoder
    only."""
    return (cfg.attn_kind == "gqa" and not cfg.is_moe and not cfg.is_encdec
            and cfg.family not in ("ssm", "hybrid"))


def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """Per-layer attention window (0 = global)."""
    if cfg.local_ratio <= 0:
        return np.zeros(cfg.n_layers, np.int32)
    w = np.full(cfg.n_layers, cfg.window, np.int32)
    # every (ratio+1)-th layer is global (gemma3: 5 local then 1 global)
    w[cfg.local_ratio::cfg.local_ratio + 1] = 0
    return w


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
    if not is_dense(cfg):
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


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def _ffn_apply(cfg: ArchConfig, bp: dict, h: torch.Tensor) -> torch.Tensor:
    return L.mlp(bp["ffn"], h)


def _block_forward(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                   positions: torch.Tensor, window: int) -> torch.Tensor:
    h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    x = x + A.gqa_forward(bp["attn"], h, positions, window=window,
                          theta=cfg.rope_theta)
    h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return x + _ffn_apply(cfg, bp, h)


def _embed_inputs(cfg: ArchConfig, params: dict,
                  batch: dict) -> torch.Tensor:
    x = L.embed(params["embed"], batch["tokens"])
    if cfg.n_frontend_embeds and "embeds" in batch:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
    return x


def _hidden(cfg: ArchConfig, params: dict, batch: dict,
            remat: bool = True) -> torch.Tensor:
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for bp, w in zip(P.unstack(params["blocks"]), layer_windows(cfg)):
        if remat:
            x = checkpoint(_block_forward, cfg, bp, x, positions, int(w),
                           use_reentrant=False)
        else:
            x = _block_forward(cfg, bp, x, positions, int(w))
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(cfg: ArchConfig, params: dict, batch: dict,
            remat: bool = True) -> torch.Tensor:
    """Teacher-forcing forward -> logits [B, S, V]."""
    return L.lm_logits(params["lm_head"], _hidden(cfg, params, batch, remat))


def loss_fn(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    x = _hidden(cfg, params, batch)
    return L.chunked_cross_entropy(params["lm_head"], x, batch["targets"],
                                   batch.get("loss_mask"))
