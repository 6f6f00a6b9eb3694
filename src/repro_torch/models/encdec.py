"""Encoder-decoder transformer: the seamless-m4t backbone (port of
``repro/models/encdec.py``).

Encoder: bidirectional self-attention over precomputed frame embeddings
(the speech frontend is a stub: the batch carries ``enc_embeds`` [B,
S_enc, D]).  Decoder: causal self-attention, then cross-attention to the
encoder memory (unroped, ``theta`` 0).  Decode caches: self-attention
K/V a decoder layer, plus the cross K/V projected once from the memory
at prefill.  Layers loop in Python (under ``torch.utils.checkpoint`` in
the training forward) where JAX scans them.

Under a ``(d, m)`` mesh (``distributed/tp.py``) a rank holds its blocks
under JAX's rule table (``distributed/sharding.local_params``) and its
rows of the batch (the encoder's frames too): the encoder blocks and the
decoder's self-attention run the GQA path on the rank's heads, and
cross-attention follows the ``['cross']`` rules (wq, wk, wv split over
the heads, wo row-parallel; wk and wv whole where the KV heads do not
divide m, K and V then computed whole), its cache split as
``cache_specs`` splits it: over the KV heads, else the encoder's frames
(the softmax's blocks combined across the ranks, ``attention.
attend_rows``), else the head dim (``attend_dh``), else whole; the self
cache likewise over its KV heads, T, the head dim or whole.  A d_ff that
does not divide m keeps the FFN whole, a vocab that does not the
embedding and the head.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tp
from repro_torch.kernels._device import resolve_device

from . import attention as A
from . import layers as L
from . import params as P
from .frontends import ENC_LEN_DECODE


def _init_enc_block(cfg: ArchConfig, gen: torch.Generator,
                    device: torch.device) -> dict:
    d = cfg.d_model
    return {"ln1": L.init_rmsnorm(d, device), "ln2": L.init_rmsnorm(d, device),
            "attn": A.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, device=device),
            "ffn": L.init_mlp(gen, d, cfg.d_ff, device=device)}


def _init_dec_block(cfg: ArchConfig, gen: torch.Generator,
                    device: torch.device) -> dict:
    d = cfg.d_model
    return {"ln1": L.init_rmsnorm(d, device), "lnx": L.init_rmsnorm(d, device),
            "ln2": L.init_rmsnorm(d, device),
            "attn": A.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, device=device),
            "cross": A.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, device=device),
            "ffn": L.init_mlp(gen, d, cfg.d_ff, device=device)}


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device: torch.device | str) -> dict:
    """Random params on ``device`` from ``gen``; the JAX init's tree and
    distributions, not its numbers."""
    device = torch.device(device)
    embed = L.init_embed(gen, cfg.vocab, cfg.d_model, device=device)
    enc = P.init_stacked(lambda: _init_enc_block(cfg, gen, device),
                         cfg.enc_layers)
    dec = P.init_stacked(lambda: _init_dec_block(cfg, gen, device),
                         cfg.n_layers)
    return {"embed": embed, "enc_blocks": enc, "dec_blocks": dec,
            "enc_norm": L.init_rmsnorm(cfg.d_model, device),
            "final_norm": L.init_rmsnorm(cfg.d_model, device),
            "lm_head": L.init_lm_head(gen, cfg.d_model, cfg.vocab,
                                      device=device)}


def _enc_block(cfg: ArchConfig, bp: dict, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    x = x + A.gqa_forward(bp["attn"], h, positions, causal=False,
                          theta=cfg.rope_theta)
    h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return x + L.mlp(bp["ffn"], h)


@functools.lru_cache(maxsize=8)
def whole_shapes(cfg: ArchConfig) -> dict:
    """The whole model's params as ``meta`` tensors."""
    return init_params(cfg, torch.Generator(), "meta")


_STACKS = ("enc_blocks", "dec_blocks")


def placed(cfg: ArchConfig, params: dict) -> tuple[dict, dict]:
    """``(params outside the stacks, {stack: the views of each layer})``:
    under a mesh each leaf split over ``data`` a ``tp.Fsdp`` block and
    each leaf kept whole over ``model`` a ``tp.Whole`` (``tp.placed``)."""
    return tp.placed(lambda: whole_shapes(cfg), params, _STACKS)


def _encode(cfg: ArchConfig, top: dict, layers: list[dict],
            enc_embeds: torch.Tensor, remat: bool) -> torch.Tensor:
    x = enc_embeds.to(torch.bfloat16)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for bp in layers:
        if remat:
            x = checkpoint(tp.under_mesh(_enc_block), cfg, bp, x, positions,
                           use_reentrant=False)
        else:
            x = _enc_block(cfg, bp, x, positions)
    return L.rmsnorm(top["enc_norm"], x, cfg.norm_eps)


def encode(cfg: ArchConfig, params: dict, enc_embeds: torch.Tensor,
           remat: bool = True) -> torch.Tensor:
    """Frames [B, S_enc, D] (cast to bf16) -> memory [B, S_enc, D]."""
    top, layers = placed(cfg, params)
    return _encode(cfg, top, layers["enc_blocks"], enc_embeds, remat)


def _dec_block(cfg: ArchConfig, bp: dict, x: torch.Tensor,
               positions: torch.Tensor, memory: torch.Tensor,
               mem_pos: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    x = x + A.gqa_forward(bp["attn"], h, positions, theta=cfg.rope_theta)
    h = L.rmsnorm(bp["lnx"], x, cfg.norm_eps)
    x = x + A.gqa_forward(bp["cross"], h, positions, causal=False, theta=0.0,
                          kv_x=memory, kv_positions=mem_pos)
    h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return x + L.mlp(bp["ffn"], h)


def _hidden(cfg: ArchConfig, params: dict, batch: dict,
            remat: bool = True) -> torch.Tensor:
    """Teacher-forcing decoder hidden states (before the LM head)."""
    top, layers = placed(cfg, params)
    memory = _encode(cfg, top, layers["enc_blocks"], batch["enc_embeds"],
                     remat)
    x = L.embed(top["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    mem_pos = torch.arange(memory.shape[1], dtype=torch.int32,
                           device=x.device)
    for bp in layers["dec_blocks"]:
        if remat:
            x = checkpoint(tp.under_mesh(_dec_block), cfg, bp, x, positions,
                           memory, mem_pos, use_reentrant=False)
        else:
            x = _dec_block(cfg, bp, x, positions, memory, mem_pos)
    return L.rmsnorm(top["final_norm"], x, cfg.norm_eps)


def forward(cfg: ArchConfig, params: dict, batch: dict,
            remat: bool = True) -> torch.Tensor:
    """Teacher forcing: the encoder over frames, the decoder over tokens."""
    tp.check_layout(cfg)
    return L.lm_logits(placed(cfg, params)[0]["lm_head"],
                       _hidden(cfg, params, batch, remat))


def loss_fn(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    tp.check_layout(cfg)
    x = _hidden(cfg, params, batch)
    return L.chunked_cross_entropy(placed(cfg, params)[0]["lm_head"], x,
                                   batch["targets"], batch.get("loss_mask"))


class EncDecCache(NamedTuple):
    self_k: torch.Tensor    # [L, B, T, K, Dh]
    self_v: torch.Tensor
    cross_k: torch.Tensor   # [L, B, S_enc, K, Dh]
    cross_v: torch.Tensor


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               enc_len: int = ENC_LEN_DECODE, dtype=torch.bfloat16,
               device: torch.device | str | None = None) -> EncDecCache:
    device = resolve_device(device)
    tp.check_layout(cfg)
    lyr, k, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def z(n):
        return torch.empty((lyr, batch, n, k, dh), dtype=dtype,
                           device="meta")
    whole = EncDecCache(self_k=z(max_len), self_v=z(max_len),
                        cross_k=z(enc_len), cross_v=z(enc_len))
    return tp.new_cache(whole, device)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: dict, cache: EncDecCache,
                token: torch.Tensor, t: int
                ) -> tuple[torch.Tensor, EncDecCache]:
    """One decode step: token [B] at position ``t`` -> (logits [B, V],
    the cache, its self-attention K/V written in place).  Cross-attention
    reads the whole static memory, without a mask or rope, scaled by
    ``1 / sqrt(dh)`` in f32."""
    tp.check_layout(cfg)
    t = int(t)
    f32 = torch.float32
    params, layers = placed(cfg, params)
    x = L.embed(params["embed"], token[:, None])
    # the cross cache over the encoder's frames, its head dim, or whole
    attend = {"rows": A.attend_rows, "dh": A.attend_dh}.get(
        A.cache_layout(cache.cross_k), A.attend_whole)
    for i, bp in enumerate(layers["dec_blocks"]):
        h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
        y, _, _ = A.gqa_decode(bp["attn"], h, cache.self_k[i],
                               cache.self_v[i], t, ring=False,
                               theta=cfg.rope_theta,
                               split=A.cache_layout(cache.self_k))
        x = x + y
        h = L.rmsnorm(bp["lnx"], x, cfg.norm_eps)
        q = L.column_linear(bp["cross"]["wq"], h)        # [B, 1, H, Dh]
        ctx = attend(bp["cross"], q, cache.cross_k[i].to(f32),
                     cache.cross_v[i].to(f32))
        x = x + A._proj_out(bp["cross"], ctx)
        h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(bp["ffn"], h)
    return L.last_logits(params, x, cfg.norm_eps), cache


@torch.no_grad()
def prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int
            ) -> tuple[torch.Tensor, EncDecCache]:
    """Encode the frames, run the prompt, build the cache -> (last logits
    [B, V], cache).  A layer projects its self K/V once (roped, for the
    cache and attention) and its cross K/V once from the memory (theta 0,
    kept in the cache for decode)."""
    tp.check_layout(cfg)
    params, layers = placed(cfg, params)
    memory = _encode(cfg, params, layers["enc_blocks"], batch["enc_embeds"],
                     remat=False)
    b, s_enc, _ = memory.shape
    x = L.embed(params["embed"], batch["tokens"])
    s = x.shape[1]
    if s > max_len:
        raise ValueError(f"prompt of {s} positions exceeds max_len "
                         f"{max_len}")
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    mem_pos = torch.arange(s_enc, dtype=torch.int32, device=x.device)
    cache = init_cache(cfg, b, max_len, enc_len=s_enc, device=x.device)
    split, tb = A.cache_layout(cache.self_k), cache.self_k.shape[2]
    start = tp.model_rank() * tb if split == "rows" else 0
    cross = A.cache_layout(cache.cross_k)
    for i, bp in enumerate(layers["dec_blocks"]):
        h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
        kv = A.gqa_kv(bp["attn"], h, positions, theta=cfg.rope_theta)
        cache.self_k[i], cache.self_v[i] = A.gqa_prefill_cache(
            bp["attn"], h, positions, tb, ring=False, kv=kv, start=start,
            split=split)
        x = x + A.gqa_forward(bp["attn"], h, positions, theta=cfg.rope_theta,
                              kv=kv)
        h = L.rmsnorm(bp["lnx"], x, cfg.norm_eps)
        ck, cv = A.gqa_kv(bp["cross"], memory, mem_pos, theta=0.0)
        cache.cross_k[i], cache.cross_v[i] = (A.cache_block(c, cross)
                                              for c in (ck, cv))
        x = x + A.gqa_forward(bp["cross"], h, positions, causal=False,
                              theta=0.0, kv=(ck, cv), kv_positions=mem_pos)
        h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(bp["ffn"], h)
    return L.last_logits(params, x, cfg.norm_eps), cache
