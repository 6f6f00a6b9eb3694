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
head whole.  Where the axis splits them otherwise (hymba at 5 ranks: its
heads, KV heads and channels split, d_ff 5504 not) each leaf follows its
own dims: the FFN whole on every rank where d_ff does not divide m;
Mamba whole where d_inner does not (``ssm.channels_whole``, its state
gathered from ``cache_specs``' blocks a step, :func:`_state_in`); the
attention caches over T, the head dim or whole.
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
    """One layer.  Under sequence parallelism x and the result are this
    rank's S block: attention and Mamba read the gathered norm of it and
    return blocks, on which ``_fuse`` and the FFN's norm run."""
    with tp.seq_parallel(x, positions.shape[0]) as x:
        h = tp.gather_seq(L.rmsnorm(bp["ln1"], x, cfg.norm_eps))
        attn_y = tp.seq_block(A.gqa_forward(bp["attn"], h, positions,
                                            window=window,
                                            theta=cfg.rope_theta))
        ssm_y = tp.seq_block(S.mamba_forward(bp["mamba"], h, cfg.ssm_state))
        x = x + _fuse(bp, attn_y, ssm_y, cfg.norm_eps)
        h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
        if not L.whole_mlp(bp["ffn"]):
            h = tp.gather_seq(h)           # a whole MLP runs on the block
        return x + tp.seq_block(L.mlp(bp["ffn"], h))


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
    with tp.seq_parallel(x, positions.shape[0]) as x:
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


class HybridCache(NamedTuple):
    full_k: torch.Tensor   # [n_full, B, T, K, Dh]
    full_v: torch.Tensor
    ring_k: torch.Tensor   # [n_swa, B, W, K, Dh]
    ring_v: torch.Tensor
    ssm_h: torch.Tensor    # [L, B, di, n] f32
    conv: torch.Tensor     # [L, B, cw-1, di]


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16,
               device: torch.device | str | None = None) -> HybridCache:
    """The decode cache of ``batch`` rows (this rank's under a data axis);
    under a model axis this rank's block of each leaf as ``cache_specs``
    cuts it (``tp.new_cache``: the attention caches over their KV heads,
    T or the window, the head dim, or whole; the Mamba state over n, its
    channels, or whole; the conv tail over its channels, its rows, or
    whole)."""
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
    return tp.new_cache(whole, device)


def _state_in(cache: HybridCache, i: int, whole: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i``'s Mamba state and conv tail as the cache keeps them
    (``cache_specs``' blocks: the state over n, else over the channels,
    else whole; the tail over the channels, else its cw - 1 rows, else
    whole) -> as the mixer reads them: this rank's channels, or every
    channel where they are whole over the axis (``whole``,
    ``ssm.channels_whole``).  A block of n is gathered over ``model`` (and
    cut to the rank's channels unless ``whole``), a block of the tail's
    rows gathered."""
    h, conv = cache.ssm_h[i], cache.conv[i]
    if tp.split_dim(cache.ssm_h) == 3:
        h = tp.all_gather(h, -1, "model")
        if not whole:
            h = tp.model_block(h, 1)
    if tp.split_dim(cache.conv) == 2:
        conv = tp.all_gather(conv, 1, "model")
    return h, conv


def _state_out(cache: HybridCache, i: int, h: torch.Tensor,
               conv: torch.Tensor, whole: bool) -> None:
    """The inverse of :func:`_state_in`: layer ``i``'s new state and tail
    written into the cache's blocks."""
    if tp.split_dim(cache.ssm_h) == 3:
        if not whole:
            h = tp.all_gather(h, 1, "model")
        h = tp.model_block(h, -1)
    if tp.split_dim(cache.conv) == 2:
        conv = tp.model_block(conv, 1)
    cache.ssm_h[i], cache.conv[i] = h, conv


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
                                        theta=cfg.rope_theta,
                                        split=A.cache_layout(cache.full_k))
        else:
            attn_y, _, _ = A.gqa_decode(bp["attn"], h, cache.ring_k[s],
                                        cache.ring_v[s], t, ring=True,
                                        theta=cfg.rope_theta,
                                        split=A.cache_layout(cache.ring_k))
        whole = S.channels_whole(bp["mamba"])
        ssm_y, hs, conv = S.mamba_decode(bp["mamba"], h,
                                         *_state_in(cache, i, whole),
                                         cfg.ssm_state)
        _state_out(cache, i, hs, conv, whole)
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
        sl, tb, split = int(slots[i]), k_pool.shape[2], \
            A.cache_layout(k_pool)
        start = tp.model_rank() * tb if split == "rows" else 0
        k_pool[sl], v_pool[sl] = A.gqa_prefill_cache(
            bp["attn"], h, positions, tb, ring=not is_g[i], kv=kv,
            start=start, split=split)
        attn_y = A.gqa_forward(bp["attn"], h, positions, window=int(w),
                               theta=cfg.rope_theta, kv=kv)
        ssm_y, hs, conv = S.mamba_forward(bp["mamba"], h, cfg.ssm_state,
                                          return_state=True)
        _state_out(cache, i, hs, conv, S.channels_whole(bp["mamba"]))
        x = x + _fuse(bp, attn_y, ssm_y, cfg.norm_eps)
        h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(bp["ffn"], h)
    return L.last_logits(params, x, cfg.norm_eps), cache
