"""Hymba-style hybrid LM: parallel attention and Mamba heads in every
block (port of ``repro/models/hybrid.py``).

Each block: x -> norm -> {GQA attention, Mamba SSM} on the same input,
each output normalised and the two averaged (the Hymba fusion), then a
SwiGLU FFN.  ``cfg.n_full_attn`` layers (first, middle, last) attend
globally; the rest through a sliding window, decoded over ring caches of
``min(window, max_len)`` slots at ``position % ring_len``.  Learnable
meta tokens are not implemented, as in the JAX package.

The forward loops over layers under ``torch.utils.checkpoint``; decode
picks a layer's pool with a Python ``if`` where JAX has ``lax.cond`` and
writes the caches in place, as the JAX package's donated ``jit`` does.

Under a ``(d, m)`` mesh (``distributed/tp.py``) a rank holds its blocks
under JAX's rule table (``distributed/sharding.local_params``) and its
rows of the batch; the entry points find the layout by shape
(:func:`placed`).  hymba's 25 heads and 5 KV heads divide neither 4 nor
16, so Q, K, V and wo are whole on every rank (``tp.Whole``) and the
attention caches are sharded over T (the full-attention layers) and over
the window (the rings), as ``cache_specs`` shards them; Mamba runs on the
rank's d_inner channels (``models/ssm.py``), its decode state kept as
``cache_specs`` cuts it, over the state dim n, and re-cut to the rank's
channels and back at each step (two all-gathers a layer); both branches
are whole before the fusion's norms; the FFN is column- and
row-parallel; a vocab that does not divide m keeps the embedding and the
head whole.
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

from . import attention as A
from . import layers as L
from . import params as P
from . import ssm as S


def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """Full attention on n_full_attn layers (first/mid/last), the sliding
    window elsewhere (0 = global)."""
    w = np.full(cfg.n_layers, cfg.window or 1024, np.int32)
    if cfg.n_full_attn > 0:
        w[np.linspace(0, cfg.n_layers - 1, cfg.n_full_attn).astype(int)] = 0
    return w


def cache_slots(cfg: ArchConfig) -> tuple[np.ndarray, np.ndarray,
                                          tuple[int, int]]:
    """(is_global [L], slot_id [L], counts (n_global, n_local))."""
    is_global = layer_windows(cfg) == 0
    slot = np.zeros(cfg.n_layers, np.int32)
    slot[is_global] = np.arange(is_global.sum())
    slot[~is_global] = np.arange((~is_global).sum())
    return is_global, slot, (int(is_global.sum()), int((~is_global).sum()))


def _init_block(cfg: ArchConfig, gen: torch.Generator,
                device: torch.device) -> dict:
    d = cfg.d_model
    return {
        "ln1": L.init_rmsnorm(d, device), "ln2": L.init_rmsnorm(d, device),
        "ln_attn": L.init_rmsnorm(d, device),
        "ln_ssm": L.init_rmsnorm(d, device),
        "attn": A.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           device=device),
        "mamba": S.init_mamba(gen, d, cfg.ssm_expand * d, cfg.ssm_state,
                              cfg.ssm_conv, device=device),
        "ffn": L.init_mlp(gen, d, cfg.d_ff, device=device),
    }


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


def _fuse(bp: dict, attn_y: torch.Tensor, ssm_y: torch.Tensor,
          eps: float) -> torch.Tensor:
    """Hymba head fusion: the mean of the per-branch normalised outputs."""
    return 0.5 * (L.rmsnorm(bp["ln_attn"], attn_y, eps)
                  + L.rmsnorm(bp["ln_ssm"], ssm_y, eps))


def _block_forward(cfg: ArchConfig, bp: dict, x: torch.Tensor,
                   positions: torch.Tensor, window: int) -> torch.Tensor:
    h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    attn_y = A.gqa_forward(bp["attn"], h, positions, window=window,
                           theta=cfg.rope_theta)
    ssm_y = S.mamba_forward(bp["mamba"], h, cfg.ssm_state)
    x = x + _fuse(bp, attn_y, ssm_y, cfg.norm_eps)
    h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return x + L.mlp(bp["ffn"], h)


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
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for bp, w in zip(layers, layer_windows(cfg)):
        if remat:
            x = checkpoint(tp.under_mesh(_block_forward), cfg, bp, x,
                           positions, int(w), use_reentrant=False)
        else:
            x = _block_forward(cfg, bp, x, positions, int(w))
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


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


class HybridCache(NamedTuple):
    full_k: torch.Tensor   # [n_full, B, T, K, Dh]
    full_v: torch.Tensor
    ring_k: torch.Tensor   # [n_swa, B, W, K, Dh]
    ring_v: torch.Tensor
    ssm_h: torch.Tensor    # [L, B, di, n] f32
    conv: torch.Tensor     # [L, B, cw-1, di]


# the dims cache_specs may split over the model axis, by leaf: the KV
# heads, else T or the window; the state dim n, else the channels
_SPLITS = {"full_k": (3, 2), "full_v": (3, 2), "ring_k": (3, 2),
           "ring_v": (3, 2), "ssm_h": (3, 2), "conv": (3,)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16,
               device: torch.device | str | None = None) -> HybridCache:
    """The decode cache of ``batch`` rows (this rank's under a data axis);
    under a model axis this rank's block of each leaf as ``cache_specs``
    cuts it: a leaf that it would cut elsewhere than ``_SPLITS`` says (the
    rows or the window not dividing the axis either) raises, naming the
    ROADMAP item."""
    device = resolve_device(device)
    tp.check_layout(cfg)
    _, _, (n_g, n_l) = cache_slots(cfg)
    k, dh = cfg.n_kv_heads, cfg.head_dim
    di = cfg.ssm_expand * cfg.d_model
    w = min(max(cfg.window or 1024, 1), max_len)

    def z(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")
    whole = HybridCache(
        full_k=z(n_g, batch, max_len, k, dh),
        full_v=z(n_g, batch, max_len, k, dh),
        ring_k=z(n_l, batch, w, k, dh), ring_v=z(n_l, batch, w, k, dh),
        ssm_h=z(cfg.n_layers, batch, di, cfg.ssm_state, dt=torch.float32),
        conv=z(cfg.n_layers, batch, cfg.ssm_conv - 1, di))
    return HybridCache(*(
        torch.zeros(s, dtype=t.dtype, device=device)
        for s, t in zip(tp.cache_blocks(cfg.name, whole, _SPLITS), whole)))


def _state_to_channels(cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """A layer's Mamba state as the cache keeps it (this rank's block of
    the state dim n, ``[B, di, n/m]``) -> the rank's channels ``[B, di/m,
    n]``: gathered over ``model``, then cut.  As it is where the cache
    holds the channels already (m = 1, or n not dividing m)."""
    if h.shape[-1] == cfg.ssm_state:
        return h
    return tp.model_block(tp.all_gather(h, -1, "model"), 1)


def _state_to_cache(cfg: ArchConfig, h: torch.Tensor,
                    like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_state_to_channels` for the cache's block
    ``like``."""
    if like.shape[-1] == cfg.ssm_state:
        return h
    return tp.model_block(tp.all_gather(h, 1, "model"), -1)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: dict, cache: HybridCache,
                token: torch.Tensor, t: int
                ) -> tuple[torch.Tensor, HybridCache]:
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
        if is_g[i]:
            attn_y, _, _ = A.gqa_decode(bp["attn"], h, cache.full_k[s],
                                        cache.full_v[s], t, ring=False,
                                        theta=cfg.rope_theta)
        else:
            attn_y, _, _ = A.gqa_decode(bp["attn"], h, cache.ring_k[s],
                                        cache.ring_v[s], t, ring=True,
                                        theta=cfg.rope_theta)
        ssm_y, hs, cache.conv[i] = S.mamba_decode(
            bp["mamba"], h, _state_to_channels(cfg, cache.ssm_h[i]),
            cache.conv[i], cfg.ssm_state)
        cache.ssm_h[i] = _state_to_cache(cfg, hs, cache.ssm_h[i])
        x = x + _fuse(bp, attn_y, ssm_y, cfg.norm_eps)
        h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(bp["ffn"], h)
    return L.last_logits(params, x, cfg.norm_eps), cache


@torch.no_grad()
def prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int
            ) -> tuple[torch.Tensor, HybridCache]:
    """Run the prompt, building the decode cache -> (last logits [B, V],
    cache).  A layer projects K/V once, for its cache and its attention;
    a ring takes the last min(ring_len, S) positions at slot ``position %
    ring_len``; the Mamba branch hands over its last state and conv
    tail."""
    tp.check_layout(cfg)
    params, layers = placed(cfg, params)
    x = L.embed(params["embed"], batch["tokens"])
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} positions exceeds max_len "
                         f"{max_len}")
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    is_g, slots, _ = cache_slots(cfg)
    for i, (bp, w) in enumerate(zip(layers, layer_windows(cfg))):
        h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
        kv = A.gqa_kv(bp["attn"], h, positions, theta=cfg.rope_theta)
        k_pool, v_pool = ((cache.full_k, cache.full_v) if is_g[i]
                          else (cache.ring_k, cache.ring_v))
        sl, tb = int(slots[i]), k_pool.shape[2]
        start = tp.model_rank() * tb if A.rows_split(bp["attn"]) else 0
        k_pool[sl], v_pool[sl] = A.gqa_prefill_cache(
            bp["attn"], h, positions, tb, ring=not is_g[i], kv=kv,
            start=start)
        attn_y = A.gqa_forward(bp["attn"], h, positions, window=int(w),
                               theta=cfg.rope_theta, kv=kv)
        ssm_y, hs, cache.conv[i] = S.mamba_forward(
            bp["mamba"], h, cfg.ssm_state, return_state=True)
        cache.ssm_h[i] = _state_to_cache(cfg, hs, cache.ssm_h[i])
        x = x + _fuse(bp, attn_y, ssm_y, cfg.norm_eps)
        h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(bp["ffn"], h)
    return L.last_logits(params, x, cfg.norm_eps), cache
