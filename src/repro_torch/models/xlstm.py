"""xLSTM language model (sLSTM + mLSTM blocks): the xlstm-350m family
(port of ``repro/models/xlstm.py``).

Mostly mLSTM (matrix memory) blocks with an sLSTM block every
``cfg.slstm_every`` layers (xLSTM[7:1]).  No FFN (d_ff 0): the up and
down projections live inside the cells.  Every block holds the params of
both cells, as JAX's ``vmap``-ed init makes them, so a JAX tree converts
leaf for leaf; a Python ``if`` picks the cell where JAX has ``lax.cond``.
Decode carries an O(1) state a layer; prefill is JAX's repeated decode
over the prompt, one step a token.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._device import resolve_device

from . import layers as L
from . import params as P
from . import ssm as S
from . import trips


def layer_is_slstm(cfg: ArchConfig) -> np.ndarray:
    flags = np.zeros(cfg.n_layers, bool)
    if cfg.slstm_every > 0:
        flags[cfg.slstm_every - 1::cfg.slstm_every] = True
    return flags


def _init_block(cfg: ArchConfig, gen: torch.Generator,
                device: torch.device) -> dict:
    return {"ln": L.init_rmsnorm(cfg.d_model, device),
            "mlstm": S.init_mlstm(gen, cfg.d_model, cfg.n_heads,
                                  proj_factor=cfg.ssm_expand, device=device),
            "slstm": S.init_slstm(gen, cfg.d_model, cfg.n_heads,
                                  device=device)}


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device: torch.device | str) -> dict:
    """Random params on ``device`` from ``gen``; the JAX init's tree and
    distributions, not its numbers."""
    device = torch.device(device)
    embed = L.init_embed(gen, cfg.vocab, cfg.d_model, device=device)
    blocks = P.init_stacked(lambda: _init_block(cfg, gen, device),
                            cfg.n_layers)
    return {"embed": embed, "blocks": blocks,
            "final_norm": L.init_rmsnorm(cfg.d_model, device),
            "lm_head": L.init_lm_head(gen, cfg.d_model, cfg.vocab,
                                      device=device)}


def _block_forward(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                   is_s: bool) -> torch.Tensor:
    h = L.rmsnorm(bp["ln"], x, cfg.norm_eps)
    if is_s:
        return x + S.slstm_forward(bp["slstm"], h, cfg.n_heads)
    return x + S.mlstm_forward(bp["mlstm"], h, cfg.n_heads)


def _hidden(cfg: ArchConfig, params: dict, batch: dict,
            remat: bool = True) -> torch.Tensor:
    x = L.embed(params["embed"], batch["tokens"])
    for bp, is_s in zip(P.unstack(params["blocks"]), layer_is_slstm(cfg)):
        if remat:
            x = checkpoint(_block_forward, cfg, bp, x, bool(is_s),
                           use_reentrant=False)
        else:
            x = _block_forward(cfg, bp, x, bool(is_s))
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(cfg: ArchConfig, params: dict, batch: dict,
            remat: bool = True) -> torch.Tensor:
    return L.lm_logits(params["lm_head"], _hidden(cfg, params, batch, remat))


def loss_fn(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    x = _hidden(cfg, params, batch)
    return L.chunked_cross_entropy(params["lm_head"], x, batch["targets"],
                                   batch.get("loss_mask"))


class XLSTMCache(NamedTuple):
    mC: torch.Tensor      # [L, B, H, dh, dh]
    mn: torch.Tensor      # [L, B, H, dh]
    mm: torch.Tensor      # [L, B, H]
    sh: torch.Tensor      # [L, B, d]
    sc: torch.Tensor
    sn: torch.Tensor
    sm: torch.Tensor


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16,
               device: torch.device | str | None = None) -> XLSTMCache:
    """The O(1) decode state of every layer (both cells' leaves, as JAX's
    cache has them); ``max_len`` and ``dtype`` are unused."""
    device = resolve_device(device)
    del max_len, dtype
    lyr, b, h, d = cfg.n_layers, batch, cfg.n_heads, cfg.d_model
    dh = cfg.ssm_expand * d // h

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)
    return XLSTMCache(
        mC=full((lyr, b, h, dh, dh), 0.0), mn=full((lyr, b, h, dh), 0.0),
        mm=full((lyr, b, h), -np.inf), sh=full((lyr, b, d), 0.0),
        sc=full((lyr, b, d), 0.0), sn=full((lyr, b, d), 1.0),
        sm=full((lyr, b, d), 0.0))


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: dict, cache: XLSTMCache,
                token: torch.Tensor, t: int
                ) -> tuple[torch.Tensor, XLSTMCache]:
    """token [B] -> (logits [B, V], the cache, updated in place).  The
    recurrent state carries the position, so ``t`` is unused."""
    del t
    x = L.embed(params["embed"], token[:, None])
    for i, (bp, is_s) in enumerate(zip(P.unstack(params["blocks"]),
                                       layer_is_slstm(cfg))):
        h = L.rmsnorm(bp["ln"], x, cfg.norm_eps)
        if is_s:
            st = {"h": cache.sh[i], "c": cache.sc[i], "n": cache.sn[i],
                  "m": cache.sm[i]}
            y, st = S.slstm_decode(bp["slstm"], h, st, cfg.n_heads)
            for key, leaf in (("h", cache.sh), ("c", cache.sc),
                              ("n", cache.sn), ("m", cache.sm)):
                leaf[i] = st[key]
        else:
            st = {"C": cache.mC[i], "n": cache.mn[i], "m": cache.mm[i]}
            y, st = S.mlstm_decode(bp["mlstm"], h, st, cfg.n_heads)
            for key, leaf in (("C", cache.mC), ("n", cache.mn),
                              ("m", cache.mm)):
                leaf[i] = st[key]
        x = x + y
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(params["lm_head"], x)[:, 0], cache


@torch.no_grad()
def prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int
            ) -> tuple[torch.Tensor, XLSTMCache]:
    """The state built by JAX's repeated decode over the prompt, one step a
    token -> (last logits [B, V] in f32, cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    logits = torch.zeros((b, cfg.vocab), dtype=torch.float32,
                         device=tokens.device)
    for j in trips.steps(s):
        step, cache = decode_step(cfg, params, cache, tokens[:, j], 0)
        logits = step.float()
    return logits, cache
