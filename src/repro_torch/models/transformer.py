"""Decoder-only LM for the dense / MoE / MLA families: parameters,
full-sequence forward and loss, prefill and greedy decode over a dense
KV cache, and decode over the BDI-quantised cache.

Port of ``repro/models/transformer.py``: yi-6b/9b, qwen2.5-14b (QKV
bias), gemma3-27b (5:1 local:global windows), internvl2-76b (prepended
frontend embeddings), deepseek-v2-lite (MLA + MoE with shared experts)
and arctic-480b (MoE + a dense residual FFN).

The parameter tree has the JAX package's layout — per-layer block
params stacked along a leading ``[L, ...]`` axis (experts ``[L, E, D,
F]``) — so a JAX pytree converts leaf for leaf (``params.from_numpy``)
and a loop over layers indexes ``blocks`` the way ``lax.scan`` sliced
it.  Where JAX scans the blocks under
``jax.checkpoint(policy=nothing_saveable)``, the forward here loops over
them, each layer under ``torch.utils.checkpoint``: only each layer's
input is kept for the backward.  The stacked leaves are split with
``unbind``, whose backward stacks a leaf's per-layer gradients once,
instead of one full-size scatter a layer.

Decode keeps two GQA cache pools — rings of ``window`` slots for local
layers and full-length caches for global ones — and picks a layer's
pool with a Python ``if`` where JAX has ``lax.cond``; MLA caches the
latent.  The caches are written in place, as the JAX package's donated
``jit`` updates them.

Tensor parallelism (a ``(1, m)`` mesh active, ``distributed/tp.py``):
the dense GQA configs serve and train with each rank holding its shards
of the params (``distributed/sharding.local_params``) and of the caches
(``cache_specs``: the K/m KV heads, or, where the KV heads do not divide
m and the rule table keeps K/V whole, its T/m rows of every KV head,
which ``prefill`` keeps of the K/V it computed and decode attends over
with the ranks' softmax statistics combined; where the rows do not
divide m either, its block of the head dim, else the whole cache;
``tp.new_cache`` records each leaf's split); a dense MLP whose d_ff does
not divide m is whole on every rank (``layers.mlp``); ``prefill``,
``decode_step``, ``decode_step_quant`` and ``forward`` return the whole
logits on every rank, and ``loss_fn`` the same loss on every rank, its
gradients being this rank's shards (a replicated leaf's, the norms',
equal on every rank).  Each layer's recompute in the backward issues its
attention's sum again (the MLP's is past the recompute's last saved
tensor), in the same order on every rank, as JAX's remat does; it runs
under the caller's mesh (``tp.under_mesh``).  Every entry point refuses
what JAX refuses (``tp.check_layout``).

DP x TP (a ``(d, m)`` mesh, d > 1): the entry points take this rank's
rows of the batch (``distributed/sharding.local_batch``; the prompt's
tokens, a decode step's tokens, the cache's rows) and its blocks of the
params under either layout of the rule table (``local_params``, with
``fsdp=True`` the training layout of JAX's dry run); the logits they
return are the whole batch's, ``loss_fn`` the global mean.  Each leaf
split over ``data`` (:func:`placed` finds them by shape against the
whole model's, :func:`whole_shapes`) is gathered at its one use in a
layer (``tp.weight``): q/k/v, wo, gate/up/down, the embedding and the
LM head, inside the layer loop and again in a layer's recompute.  At d
= 1 nothing changes and no data collective is issued.

Sequence parallelism (``axes.set_sp(True)``, a model axis that divides
S): ``forward`` and ``loss_fn`` hold the residual stream between layers
as this rank's block of S/m positions (``tp.seq_parallel``, the layout
of ``axes.shard_seq``, at the top of each layer, inside its checkpoint,
so that the checkpoint keeps the block and the recompute gathers again);
the final norm runs on the block, which is gathered before the head.
``prefill`` and the decode steps never split it, as in JAX.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.store import leaf_paths
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tp
from repro_torch.kernels._device import resolve_device

from repro_torch.core.bdi_value import _pow2_scale

from . import attention as A
from . import layers as L
from . import moe as M
from . import params as P


def check_family(cfg: ArchConfig) -> None:
    """The family this module models: decoder-only transformers (dense,
    moe, vlm) with GQA or MLA attention; any other config raises (the
    ssm, hybrid and encoder-decoder families have modules of their own,
    ``models/api.get_model``)."""
    if (cfg.attn_kind not in ("gqa", "mla") or cfg.is_encdec
            or cfg.family in ("ssm", "hybrid")):
        raise ValueError(f"{cfg.name}: only the decoder-only transformer "
                         "family (dense, moe, vlm; GQA or MLA) is ported")


def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """Per-layer attention window (0 = global)."""
    if cfg.local_ratio <= 0:
        return np.zeros(cfg.n_layers, np.int32)
    w = np.full(cfg.n_layers, cfg.window, np.int32)
    # every (ratio+1)-th layer is global (gemma3: 5 local then 1 global)
    w[cfg.local_ratio::cfg.local_ratio + 1] = 0
    return w


def cache_slots(cfg: ArchConfig) -> tuple[np.ndarray, np.ndarray,
                                          tuple[int, int]]:
    """(is_global [L], slot_id [L], counts (n_global, n_local))."""
    is_global = layer_windows(cfg) == 0
    slot = np.zeros(cfg.n_layers, np.int32)
    slot[is_global] = np.arange(is_global.sum())
    slot[~is_global] = np.arange((~is_global).sum())
    return is_global, slot, (int(is_global.sum()), int((~is_global).sum()))


_EXPERTS = "['blocks']['ffn']['experts']['{}']['w']"


def _init_block(cfg: ArchConfig, gen: torch.Generator,
                device: torch.device, block=None) -> dict:
    p = {"ln1": L.init_rmsnorm(cfg.d_model, device),
         "ln2": L.init_rmsnorm(cfg.d_model, device)}
    if cfg.attn_kind == "mla":
        p["attn"] = A.init_mla(gen, cfg.d_model, cfg.n_heads,
                               cfg.kv_lora_rank, cfg.qk_nope_dim,
                               cfg.qk_rope_dim, cfg.v_head_dim, device=device)
    else:
        p["attn"] = A.init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, bias=cfg.qkv_bias, device=device)
    if cfg.is_moe:
        p["ffn"] = M.init_moe(
            gen, cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
            cfg.n_shared_experts, device=device,
            block=block and (lambda k, sh: block(_EXPERTS.format(k), sh)))
        if cfg.moe_dense_residual:
            p["dense_ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                        device=device)
    else:
        p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device: torch.device | str,
                local: SH.Local | None = None) -> dict:
    """Random params on ``device`` from ``gen`` (a generator on that
    device); the JAX init's tree and distributions, not its numbers.

    ``local``: a ``distributed/sharding.Local`` (this rank's blocks on a
    mesh), applied to the embedding, to each layer's block (keyed
    ``{"blocks": block}``, one layer) and to the head as each is drawn,
    so that a rank keeps its blocks and never holds more of the whole
    model than one layer; it cuts the MoE expert stacks as each expert is
    drawn, so that a rank never holds a whole layer's stack either
    (arctic-480b's is 26.8 GB).  The draws are the same either way."""
    check_family(cfg)
    device = torch.device(device)
    keep = local or (lambda t, layer=None: t)
    layers = itertools.count()

    def one_layer() -> dict:
        li = next(layers)

        def block(path: str, shape: tuple) -> list[slice] | None:
            # the slices this rank keeps of layer li; None: none of it
            rows, cuts = local.block(path, shape)
            return cuts if rows is None or rows.start <= li < rows.stop \
                else None
        bp = _init_block(cfg, gen, device, block if local else None)
        if local is None or not cfg.is_moe:
            return keep({"blocks": bp}, li)["blocks"]
        experts = bp["ffn"].pop("experts")            # cut already
        bp = keep({"blocks": bp}, li)["blocks"]
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        whole = {"gate": (e, d, f), "up": (e, d, f), "down": (e, f, d)}
        for k, v in experts.items():
            # as the layer's stacking takes it: itself, or where the rule
            # table splits the layers over the data axes its row of this
            # rank's block (None where the rank keeps none of the layer)
            rows, _ = local.block(_EXPERTS.format(k), whole[k])
            if rows is not None and v["w"] is not None:
                v["w"] = P.Rows(v["w"], li - rows.start,
                                rows.stop - rows.start)
        bp["ffn"]["experts"] = experts
        return bp

    embed = keep({"embed": L.init_embed(gen, cfg.vocab, cfg.d_model,
                                        device=device)})["embed"]
    blocks = P.init_stacked(one_layer, cfg.n_layers)
    return {
        "embed": embed,
        "blocks": blocks,
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
        "lm_head": keep({"lm_head": L.init_lm_head(
            gen, cfg.d_model, cfg.vocab, device=device)})["lm_head"],
    }


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def _ffn_apply(cfg: ArchConfig, bp: dict, h: torch.Tensor) -> torch.Tensor:
    if cfg.is_moe:
        y = M.moe_ffn(bp["ffn"], h, top_k=cfg.top_k, n_experts=cfg.n_experts,
                      capacity_factor=cfg.capacity_factor)
        if cfg.moe_dense_residual:
            y = y + L.mlp(bp["dense_ffn"], h)
        return y
    return L.mlp(bp["ffn"], h)


def _attn_forward(cfg: ArchConfig, bp: dict, h: torch.Tensor,
                  positions: torch.Tensor, window: int,
                  kv=None) -> torch.Tensor:
    if cfg.attn_kind == "mla":
        return A.mla_forward(bp["attn"], h, positions, cfg.qk_nope_dim,
                             cfg.qk_rope_dim, cfg.rope_theta)
    return A.gqa_forward(bp["attn"], h, positions, window=window,
                         theta=cfg.rope_theta, kv=kv)


def _block_forward(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                   positions: torch.Tensor, window: int) -> torch.Tensor:
    """One layer of the full-sequence path.  Under sequence parallelism
    (``tp.seq_parallel``, ``axes.shard_seq``'s layout) x and the result
    are this rank's S block: the norms run on it, their outputs are
    gathered for attention and the FFN, whose outputs come back as
    blocks."""
    with tp.seq_parallel(x, positions.shape[0]) as x:
        h = tp.gather_seq(L.rmsnorm(bp["ln1"], x, cfg.norm_eps))
        x = x + tp.seq_block(_attn_forward(cfg, bp, h, positions, window))
        h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
        if cfg.is_moe or not L.whole_mlp(bp["ffn"]):
            h = tp.gather_seq(h)           # a whole MLP runs on the block
        return x + tp.seq_block(_ffn_apply(cfg, bp, h))


def _embed_inputs(cfg: ArchConfig, params: dict,
                  batch: dict) -> torch.Tensor:
    x = L.embed(params["embed"], batch["tokens"])
    if cfg.n_frontend_embeds and "embeds" in batch:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
    return x


@functools.lru_cache(maxsize=8)
def whole_shapes(cfg: ArchConfig) -> dict:
    """The whole model's params as ``meta`` tensors (shapes and dtypes,
    nothing allocated)."""
    return init_params(cfg, torch.Generator(), "meta")


def placed(cfg: ArchConfig, params: dict) -> tuple[dict, list[dict]]:
    """``(params, layers)``: this rank's params and their per-layer views
    (``params.unstack``), where under a data axis each leaf split over
    ``data`` is a ``tp.Fsdp`` block, which the layers read through
    ``tp.weight``, and under a model axis each leaf kept whole over it
    (heads or KV heads that do not divide it, shared experts whose width
    does not, a vocab that does not) a ``tp.Whole`` (``tp.placed``)."""
    top, layers = tp.placed(lambda: whole_shapes(cfg), params, ("blocks",))
    return top, layers["blocks"]


def _hidden(cfg: ArchConfig, params: dict, batch: dict,
            remat: bool = True) -> torch.Tensor:
    params, layers = placed(cfg, params)
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for bp, w in zip(layers, layer_windows(cfg)):
        if remat:
            x = checkpoint(tp.under_mesh(_block_forward), cfg, bp, x,
                           positions, int(w), use_reentrant=False)
        else:
            x = _block_forward(cfg, bp, x, positions, int(w))
    with tp.seq_parallel(x, positions.shape[0]) as x:
        return tp.gather_seq(L.rmsnorm(params["final_norm"], x,
                                       cfg.norm_eps))


def forward(cfg: ArchConfig, params: dict, batch: dict,
            remat: bool = True) -> torch.Tensor:
    """Teacher-forcing forward -> logits [B, S, V]."""
    tp.check_layout(cfg)
    x = _hidden(cfg, params, batch, remat)
    return L.lm_logits(placed(cfg, params)[0]["lm_head"], x)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    tp.check_layout(cfg)
    x = _hidden(cfg, params, batch)
    return L.chunked_cross_entropy(placed(cfg, params)[0]["lm_head"], x,
                                   batch["targets"], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    full_k: torch.Tensor    # [n_global, B, T, K, Dh]
    full_v: torch.Tensor
    ring_k: torch.Tensor    # [n_local, B, W, K, Dh]
    ring_v: torch.Tensor
    mla_c: torch.Tensor     # [L, B, T, r]          (MLA archs; else size 0)
    mla_kr: torch.Tensor    # [L, B, T, dr]


class QuantDecodeCache(NamedTuple):
    """BDI-quantised decode cache (all-global GQA archs): int8 deltas
    plus an f32 base and scale for each (token, head) — the LCP
    bandwidth path at the step level: it reads about half the bytes of
    the bf16 cache."""
    kd: torch.Tensor    # int8 [L, B, T, K, Dh]
    kb: torch.Tensor    # f32  [L, B, T, K]
    ks: torch.Tensor    # f32  [L, B, T, K]
    vd: torch.Tensor    # int8 [L, B, T, K, Dh]
    vb: torch.Tensor    # f32  [L, B, T, K]
    vs: torch.Tensor    # f32  [L, B, T, K]


def cache_bytes(cache: NamedTuple) -> int:
    """Bytes of a decode cache of any family (a NamedTuple of tensors):
    this rank's under tensor parallelism."""
    return sum(t.numel() * t.element_size() for t in cache)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16,
               device: torch.device | str | None = None) -> DecodeCache:
    device = resolve_device(device)
    check_family(cfg)
    tp.check_layout(cfg)
    _, _, (n_g, n_l) = cache_slots(cfg)
    k, dh = cfg.n_kv_heads, cfg.head_dim

    def z(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")
    if cfg.attn_kind == "mla":
        whole = DecodeCache(
            full_k=z(0), full_v=z(0), ring_k=z(0), ring_v=z(0),
            mla_c=z(cfg.n_layers, batch, max_len, cfg.kv_lora_rank),
            mla_kr=z(cfg.n_layers, batch, max_len, cfg.qk_rope_dim))
    else:
        w = min(max(cfg.window, 1), max_len)
        whole = DecodeCache(
            full_k=z(n_g, batch, max_len, k, dh),
            full_v=z(n_g, batch, max_len, k, dh),
            ring_k=z(n_l, batch, w, k, dh), ring_v=z(n_l, batch, w, k, dh),
            mla_c=z(0), mla_kr=z(0))
    return tp.new_cache(whole, device)


def init_quant_cache(cfg: ArchConfig, batch: int, max_len: int,
                     device: torch.device | str | None = None
                     ) -> QuantDecodeCache:
    device = resolve_device(device)
    _, _, (_, n_l) = cache_slots(cfg)
    if n_l or cfg.attn_kind != "gqa":
        raise ValueError(f"{cfg.name}: the quantised cache takes all-global "
                         "GQA archs only")
    tp.check_layout(cfg)
    rows = (cfg.n_layers, batch, max_len, cfg.n_kv_heads)
    deltas = torch.empty((*rows, cfg.head_dim), dtype=torch.int8,
                         device="meta")
    stat = torch.empty(rows, device="meta")
    whole = QuantDecodeCache(deltas, stat, stat, deltas, stat, stat)
    return tp.new_cache(whole, device, fill={"ks": 1.0, "vs": 1.0})


def _quant_vec(x: torch.Tensor):
    """Single-base BDI over the last dim: x [..., Dh] -> (int8 deltas,
    f32 base, f32 power-of-two scale)."""
    base = x[..., 0].to(torch.float32)
    r = x.to(torch.float32) - base[..., None]
    scale = _pow2_scale(r.abs().amax(dim=-1), 127.0)
    d = torch.clamp(torch.round(r / scale[..., None]), -127, 127)
    return d.to(torch.int8), base, scale


@torch.no_grad()
def decode_step_quant(cfg: ArchConfig, params: dict, cache: QuantDecodeCache,
                      token: torch.Tensor, t: int
                      ) -> tuple[torch.Tensor, QuantDecodeCache]:
    """:func:`decode_step` over the quantised cache: the new token's K/V
    are quantised on the write path (in place at ``t``) and the cache is
    dequantised inside attention (its first t + 1 rows)."""
    tp.check_layout(cfg)
    t = int(t)
    params, layers = placed(cfg, params)
    x = L.embed(params["embed"], token[:, None])
    f32 = torch.float32
    lay = A.cache_layout(cache.kd)
    for i, bp in enumerate(layers):
        h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
        a = bp["attn"]
        q = A._rope_at(L.column_linear(a["wq"], h), t, cfg.rope_theta)
        k_new = A._rope_at(L.column_linear(a["wk"], h), t, cfg.rope_theta)
        v_new = L.column_linear(a["wv"], h)
        rows = lay == "rows"
        for (dd, bb, ss), new in (((cache.kd, cache.kb, cache.ks), k_new),
                                  ((cache.vd, cache.vb, cache.vs), v_new)):
            qd, qb, qs = _quant_vec(new[:, 0])            # [B, K, *]
            if rows:
                for c, row in zip((dd[i], bb[i], ss[i]), (qd, qb, qs)):
                    tp.write_row(c, t, row)
            else:                  # the deltas' Dh block, whole stats
                dd[i, :, t] = tp.model_block(qd) if lay == "dh" else qd
                bb[i, :, t], ss[i, :, t] = qb, qs
        n = A.rows_upto(cache.kd.shape[2], t) if rows else t + 1
        kk = (cache.kd[i, :, :n].to(f32) * cache.ks[i, :, :n, :, None]
              + cache.kb[i, :, :n, :, None])               # [B, n, K, Dh]
        vv = (cache.vd[i, :, :n].to(f32) * cache.vs[i, :, :n, :, None]
              + cache.vb[i, :, :n, :, None])
        attend = {"rows": A.attend_rows, "dh": A.attend_dh}.get(
            lay, A.attend_whole)
        x = x + A._proj_out(a, attend(a, q, kk, vv))
        h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
        x = x + _ffn_apply(cfg, bp, h)
    return L.last_logits(params, x, cfg.norm_eps), cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: dict, cache: DecodeCache,
                token: torch.Tensor, t: int
                ) -> tuple[torch.Tensor, DecodeCache]:
    """One decode step: token [B] at position ``t`` -> (logits [B, V],
    the cache, updated in place)."""
    tp.check_layout(cfg)
    t = int(t)
    params, layers = placed(cfg, params)
    x = L.embed(params["embed"], token[:, None])
    is_g, slots, _ = cache_slots(cfg)
    for i, bp in enumerate(layers):
        h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
        s = int(slots[i])
        if cfg.attn_kind == "mla":
            y, _, _ = A.mla_decode(bp["attn"], h, cache.mla_c[i],
                                   cache.mla_kr[i], t, cfg.qk_nope_dim,
                                   cfg.qk_rope_dim, cfg.rope_theta,
                                   (A.latent_layout(cache.mla_c),
                                    A.latent_layout(cache.mla_kr)))
        elif is_g[i]:
            y, _, _ = A.gqa_decode(bp["attn"], h, cache.full_k[s],
                                   cache.full_v[s], t, ring=False,
                                   theta=cfg.rope_theta,
                                   split=A.cache_layout(cache.full_k))
        else:
            y, _, _ = A.gqa_decode(bp["attn"], h, cache.ring_k[s],
                                   cache.ring_v[s], t, ring=True,
                                   theta=cfg.rope_theta,
                                   split=A.cache_layout(cache.ring_k))
        x = x + y
        h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
        x = x + _ffn_apply(cfg, bp, h)
    return L.last_logits(params, x, cfg.norm_eps), cache


@torch.no_grad()
def prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int
            ) -> tuple[torch.Tensor, DecodeCache]:
    """Run the prompt (plus frontend embeddings), building the decode
    cache -> (last logits [B, V], cache).  A GQA layer projects K/V once,
    for its cache and its attention; a local layer's ring takes the last
    min(window, S) positions at slot ``position % window``."""
    tp.check_layout(cfg)
    params, layers = placed(cfg, params)
    x = _embed_inputs(cfg, params, batch)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} positions exceeds max_len "
                         f"{max_len}")
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    is_g, slots, _ = cache_slots(cfg)
    for i, (bp, w) in enumerate(zip(layers, layer_windows(cfg))):
        h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
        sl = int(slots[i])
        kv = None
        if cfg.attn_kind == "mla":
            cache.mla_c[i], cache.mla_kr[i] = A.mla_prefill_cache(
                bp["attn"], h, positions, max_len,
                cfg.rope_theta, (A.latent_layout(cache.mla_c),
                                 A.latent_layout(cache.mla_kr)))
        else:
            kv = A.gqa_kv(bp["attn"], h, positions, theta=cfg.rope_theta)
            k_pool, v_pool = ((cache.full_k, cache.full_v) if is_g[i]
                              else (cache.ring_k, cache.ring_v))
            tb, split = k_pool.shape[2], A.cache_layout(k_pool)
            start = tp.model_rank() * tb if split == "rows" else 0
            k_pool[sl], v_pool[sl] = A.gqa_prefill_cache(
                bp["attn"], h, positions, tb, ring=not is_g[i], kv=kv,
                start=start, split=split)
        x = x + _attn_forward(cfg, bp, h, positions, int(w), kv=kv)
        h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
        x = x + _ffn_apply(cfg, bp, h)
    return L.last_logits(params, x, cfg.norm_eps), cache
