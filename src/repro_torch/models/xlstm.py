"""xLSTM language model (sLSTM + mLSTM blocks): the xlstm-350m family
(port of ``repro/models/xlstm.py``).

Mostly mLSTM (matrix memory) blocks with an sLSTM block every
``cfg.slstm_every`` layers (xLSTM[7:1]).  No FFN (d_ff 0): the up and
down projections live inside the cells.  Every block holds the params of
both cells, as JAX's ``vmap``-ed init makes them, so a JAX tree converts
leaf for leaf; a Python ``if`` picks the cell where JAX has ``lax.cond``.
Decode carries an O(1) state a layer; prefill is JAX's repeated decode
over the prompt, one step a token.

Under a ``(d, m)`` mesh (``distributed/tp.py``) a rank holds its blocks
under JAX's rule table (``distributed/sharding.local_params``) and its
rows of the batch, and the cells run as ``models/ssm.py`` lays them out
(mLSTM on the rank's heads, or its share of a head's value dims where a
head spans several ranks; sLSTM's recurrence whole on every rank).  The
decode state is kept as ``cache_specs`` cuts it: mLSTM's C and n over
their key dim, its m over the heads where they divide the axis (whole
otherwise), sLSTM's four states over d, gathered over ``model`` for the
step and cut back after it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tp
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
                   is_s: bool, s: int) -> torch.Tensor:
    """One layer over a sequence of ``s`` positions.  Under sequence
    parallelism x and the result are this rank's S block: the cell reads
    the gathered norm of it, its output comes back as the block."""
    with tp.seq_parallel(x, s) as x:
        h = tp.gather_seq(L.rmsnorm(bp["ln"], x, cfg.norm_eps))
        if is_s:
            y = S.slstm_forward(bp["slstm"], h, cfg.n_heads)
        else:
            y = S.mlstm_forward(bp["mlstm"], h, cfg.n_heads)
        return x + tp.seq_block(y)


@functools.lru_cache(maxsize=8)
def whole_shapes(cfg: ArchConfig) -> dict:
    """The whole model's params as ``meta`` tensors."""
    return init_params(cfg, torch.Generator(), "meta")


def placed(cfg: ArchConfig, params: dict) -> tuple[dict, list[dict]]:
    """``(params outside the blocks, the views of each layer)``: under a
    mesh each leaf split over ``data`` a ``tp.Fsdp`` block and each leaf
    kept whole over ``model`` a ``tp.Whole`` (``tp.placed``)."""
    top, layers = tp.placed(lambda: whole_shapes(cfg), params, ("blocks",))
    return top, layers["blocks"]


def _hidden(cfg: ArchConfig, params: dict, batch: dict,
            remat: bool = True) -> torch.Tensor:
    params, layers = placed(cfg, params)
    x = L.embed(params["embed"], batch["tokens"])
    s = x.shape[1]
    for bp, is_s in zip(layers, layer_is_slstm(cfg)):
        if remat:
            x = checkpoint(tp.under_mesh(_block_forward), cfg, bp, x,
                           bool(is_s), s, use_reentrant=False)
        else:
            x = _block_forward(cfg, bp, x, bool(is_s), s)
    with tp.seq_parallel(x, s) as x:
        return tp.gather_seq(L.rmsnorm(params["final_norm"], x,
                                       cfg.norm_eps))


def forward(cfg: ArchConfig, params: dict, batch: dict,
            remat: bool = True) -> torch.Tensor:
    tp.check_layout(cfg)
    return L.lm_logits(placed(cfg, params)[0]["lm_head"],
                       _hidden(cfg, params, batch, remat))


def loss_fn(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    tp.check_layout(cfg)
    x = _hidden(cfg, params, batch)
    return L.chunked_cross_entropy(placed(cfg, params)[0]["lm_head"], x,
                                   batch["targets"], batch.get("loss_mask"))


class XLSTMCache(NamedTuple):
    mC: torch.Tensor      # [L, B, H, dh, dh]
    mn: torch.Tensor      # [L, B, H, dh]
    mm: torch.Tensor      # [L, B, H]
    sh: torch.Tensor      # [L, B, d]
    sc: torch.Tensor
    sn: torch.Tensor
    sm: torch.Tensor


# the dims cache_specs may split over the model axis, by leaf
_SPLITS = {"mC": (3,), "mn": (3,), "mm": (2,), "sh": (2,), "sc": (2,),
           "sn": (2,), "sm": (2,)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16,
               device: torch.device | str | None = None) -> XLSTMCache:
    """The O(1) decode state of every layer (both cells' leaves, as JAX's
    cache has them); ``max_len`` and ``dtype`` are unused.  Under a model
    axis this rank's block of each leaf as ``cache_specs`` cuts it."""
    device = resolve_device(device)
    tp.check_layout(cfg)
    del max_len, dtype
    lyr, b, h, d = cfg.n_layers, batch, cfg.n_heads, cfg.d_model
    dh = cfg.ssm_expand * d // h

    def z(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    whole = XLSTMCache(mC=z(lyr, b, h, dh, dh), mn=z(lyr, b, h, dh),
                       mm=z(lyr, b, h), sh=z(lyr, b, d), sc=z(lyr, b, d),
                       sn=z(lyr, b, d), sm=z(lyr, b, d))
    fill = {"mm": -np.inf, "sn": 1.0}
    return XLSTMCache(*(
        torch.full(s, fill.get(f, 0.0), dtype=torch.float32, device=device)
        for f, s in zip(whole._fields,
                        tp.cache_blocks(cfg.name, whole, _SPLITS))))


_SLSTM = (("h", "sh"), ("c", "sc"), ("n", "sn"), ("m", "sm"))


def _step(cfg: ArchConfig, params: dict, layers: list[dict],
          cache: XLSTMCache, token: torch.Tensor) -> torch.Tensor:
    """One token through every layer on placed params; the cache updated
    in place -> logits [B, V]."""
    x = L.embed(params["embed"], token[:, None])
    split = cache.sh.shape[-1] != cfg.d_model
    for i, (bp, is_s) in enumerate(zip(layers, layer_is_slstm(cfg))):
        h = L.rmsnorm(bp["ln"], x, cfg.norm_eps)
        if is_s:
            st = torch.stack([getattr(cache, f)[i] for _, f in _SLSTM])
            if split:                  # the whole state, for the step
                st = tp.all_gather(st, -1, "model")
            y, st = S.slstm_decode(bp["slstm"], h, dict(zip(
                (k for k, _ in _SLSTM), st.unbind(0))), cfg.n_heads)
            for key, f in _SLSTM:
                getattr(cache, f)[i] = tp.model_block(st[key]) if split \
                    else st[key]
        else:
            st = {"C": cache.mC[i], "n": cache.mn[i], "m": cache.mm[i]}
            y, st = S.mlstm_decode(bp["mlstm"], h, st, cfg.n_heads)
            for key, leaf in (("C", cache.mC), ("n", cache.mn),
                              ("m", cache.mm)):
                leaf[i] = st[key]
        x = x + y
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(params["lm_head"], x)[:, 0]


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: dict, cache: XLSTMCache,
                token: torch.Tensor, t: int
                ) -> tuple[torch.Tensor, XLSTMCache]:
    """token [B] -> (logits [B, V], the cache, updated in place).  The
    recurrent state carries the position, so ``t`` is unused."""
    tp.check_layout(cfg)
    del t
    return _step(cfg, *placed(cfg, params), cache, token), cache


@torch.no_grad()
def prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int
            ) -> tuple[torch.Tensor, XLSTMCache]:
    """The state built by JAX's repeated decode over the prompt, one step a
    token -> (last logits [B, V] in f32, cache)."""
    tp.check_layout(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    top, layers = placed(cfg, params)
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    logits = torch.zeros((b, cfg.vocab), dtype=torch.float32,
                         device=tokens.device)
    for j in trips.steps(s):
        logits = _step(cfg, top, layers, cache, tokens[:, j]).float()
    return logits, cache
