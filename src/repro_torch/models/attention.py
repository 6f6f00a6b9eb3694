"""Attention: GQA (full sequence, sliding window, cross-attention, decode
over a full or a ring cache) and MLA (DeepSeek multi-head latent
attention, absorbed decode).  Port of ``repro/models/attention.py``.

Conventions: activations [B, S, D]; heads H, KV heads K (H % K == 0),
head_dim Dh.  The full-sequence paths are exact f32 einsums, chunked
over queries so the S x T score matrix is never whole, with the causal
and sliding-window masks (window 0 means global).  The decode paths take
caches owned by the caller and a position ``t`` (a Python int: the host
drives the loop) and write the new token's K/V into them in place, as
the JAX package's donated ``jit`` does; they attend over the cache's
first ``t + 1`` rows only (a full cache) or over every slot (a ring),
which gives the masked softmax of the JAX version, whose masked scores
weigh exactly 0.  The paged serving engine's attention lives with its
callers: prefill (``serving/prefix_cache.prefix_chunk_attention``) and
decode (the paged-attention kernel).

Under tensor parallelism (a ``model`` axis larger than one,
``distributed/tp.py``) the GQA functions run as they are on this rank's
H/m query heads and K/m KV heads (its shards of wq, wk, wv, their biases
and wo, and of the caches): query head h reads KV head h // (H/K) within
the rank's block, as in the whole model.  Where the KV heads do not
divide m, wk and wv are whole (``tp.Whole``): the rank computes every KV
head and its query heads read theirs (:func:`heads_kv`), and the decode
cache is laid out as ``cache_specs`` lays it out (:func:`cache_layout`):
the rank's rows of T, or of a ring's window, slot ``t % W`` written on
the rank that holds it (:func:`attend_rows`); else its block of the
head dim, the rank writing its block of each new row (:func:`attend_dh`,
the collectives of JAX's decode HLO); else whole on every rank
(:func:`attend_whole`).  Where the heads do not divide m either,
attention runs whole on every rank.  In the
forward only the output projection communicates: :func:`_proj_out` is
row-parallel (plain where wo is whole).  The
full-sequence q/k/v projections are column-parallel
(``layers.column_linear``), whose backward sums each input gradient's
partial over the ranks; a bias's gradient is local.  Under a data axis
they run on this rank's rows, each weight read through ``tp.weight``
(an FSDP block gathered over ``data`` at its use).

MLA under the model axis splits its heads: wq, wuk and wuv are
column-parallel, wo row-parallel; wdkv, wkr and kv_norm are replicated
(``tp.replicated``), so every rank computes the whole latent and rope
key; the rope key's gradient, shared by every head, is summed over the
rank's heads and then over the axis (``tp.heads_broadcast``); where the
heads do not divide m, wq, wuk, wuv and wo are whole and MLA runs whole
on every rank, no sum.  The decode cache holds, by leaf, this rank's
block of the latent's or the rope key's last dim (written at ``t``,
gathered over ``model`` in f32 at its use), else its rows of T (every
head scores them, the ranks' softmax statistics combined), else all of
it (``sharding.cache_specs``, :func:`latent_layout`).
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import tp

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
    [H, Dh, D], accumulating in f32 and rounding once (see L.linear); the
    heads split over the model axis (``tp.row_parallel``)."""
    return tp.row_parallel(ctx.reshape(*ctx.shape[:-2], -1), p["wo"]["w"])


def gqa_kv(p: dict, x: torch.Tensor, positions: torch.Tensor,
           theta: float = 1e4) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V projection + K-rope: x [B, T, D] -> (k roped, v), each
    [B, T, K, Dh].  ``positions`` is [T] (shared) or [B, T] (per row)."""
    k = L.column_linear(p["wk"], x)
    v = L.column_linear(p["wv"], x)
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
                window: int = 0, theta: float = 1e4, causal: bool = True,
                kv_x: torch.Tensor | None = None,
                kv_positions: torch.Tensor | None = None,
                kv: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """Full-sequence GQA: x [B, S, D], positions [S] -> [B, S, D].

    ``kv_x`` [B, T, D] (with ``kv_positions`` [T]) makes it
    cross-attention: K/V are projected from it (unroped when ``theta`` is
    0).  ``kv``: (k roped, v), each [B, T, K, Dh], computed by the caller
    with :func:`gqa_kv` (prefill projects K/V once for the cache and for
    attention); else they are projected here.  ``kv`` and ``kv_x``
    exclude each other.
    """
    b, s, _ = x.shape
    kvp = positions if kv_positions is None else kv_positions
    q = L.column_linear(p["wq"], x)                  # [B, S, H, Dh]
    dh = q.shape[-1]
    if theta > 0:
        cos, sin = L.rope_angles(positions, dh, theta)
        q = L.apply_rope(q, cos[None, :, None, :], sin[None, :, None, :])
    if kv is not None:
        if kv_x is not None:
            raise ValueError("kv and kv_x are mutually exclusive")
        k, v = kv
    else:
        k, v = gqa_kv(p, x if kv_x is None else kv_x, kvp, theta=theta)
    k, v = heads_kv(p, q, k, v)
    h, kh = q.shape[2], k.shape[2]
    ctx = _chunked_attn(q.reshape(b, s, kh, h // kh, dh), k, v, positions,
                        kvp, causal, window)
    return _proj_out(p, ctx.reshape(b, s, h, -1))


def _rope_at(x: torch.Tensor, t: int, theta: float) -> torch.Tensor:
    """Rope of x [B, 1, H, d] at position ``t``."""
    pos = torch.tensor([t], dtype=torch.int32, device=x.device)
    cos, sin = L.rope_angles(pos, x.shape[-1], theta)
    return L.apply_rope(x, cos[None, :, None, :], sin[None, :, None, :])


def _ring_slot(pos, tc: int):
    """The ring slot of position(s) ``pos`` (an int or an integer tensor):
    floor modulo, so a position below 0 maps into [0, tc) too."""
    return pos % tc


def heads_kv(p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V [..., K', Dh] for the query heads ``q`` [..., h, Dh] of this
    rank, query head i reading KV head i // (h / K'): ``k``/``v`` as they
    are, but where K/V are whole over the model axis and Q split
    (``tp.Whole`` wk read by this rank's heads only) the KV heads that
    rank r's query heads [r h, (r + 1) h) read, h // (H/K) each: one KV
    head where its group holds all of them, else one a query head."""
    w = p["wk"]["w"]
    if not (isinstance(w, tp.Whole) and w.partial):
        return k, v
    h, kh = q.shape[-2], k.shape[-2]
    g = h * tp.model_size() // kh              # query heads a KV head
    lo = tp.model_rank() * h
    if g % h == 0:
        return k.narrow(-2, lo // g, 1), v.narrow(-2, lo // g, 1)
    idx = torch.arange(lo, lo + h, device=k.device) // g
    return k.index_select(-2, idx), v.index_select(-2, idx)


def cache_layout(leaf: torch.Tensor) -> str | None:
    """How a GQA decode cache leaf ``[L, B, T, K, Dh]`` (or a quantised
    one's deltas) made by ``tp.new_cache`` is split over the model axis,
    as ``sharding.cache_specs`` splits it: ``"rows"`` (its rows of T, or
    of a ring's window), ``"dh"`` (the head dim), or None (its KV heads,
    as the K/V shards are; or whole on every rank)."""
    return {2: "rows", 4: "dh"}.get(tp.split_dim(leaf))


def cache_block(x: torch.Tensor, split: str | None) -> torch.Tensor:
    """This rank's block of K or V ``[B, T, K', Dh]`` computed whole
    (every KV head, or this rank's where they are split) for a cache laid
    out as ``split`` (:func:`cache_layout`): its rows of T, its block of
    Dh, or all of it."""
    if split is None:
        return x
    return tp.model_block(x, 1 if split == "rows" else -1)


def rows_upto(tb: int, t: int) -> int:
    """How many of this rank's ``tb`` rows of a cache sharded over T lie
    at or before position ``t``."""
    return min(max(t + 1 - tp.model_rank() * tb, 0), tb)


def _scores(q: torch.Tensor, kk: torch.Tensor,
            valid: torch.Tensor | None) -> torch.Tensor:
    """f32 scores [B, K, G, n] of q [B, 1, K G, Dh] (query head i reads KV
    head i // G) against kk f32 [B, n, K, Dh], ``valid`` [n] masking."""
    b, _, h, dh = q.shape
    kh = kk.shape[2]
    qg = q.reshape(b, kh, h // kh, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32),
                          kk) / math.sqrt(dh)
    if valid is not None:
        scores = torch.where(valid, scores, scores.new_tensor(NEG_INF))
    return scores


def attend_whole(p: dict, q: torch.Tensor, kk: torch.Tensor,
                 vv: torch.Tensor, valid: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Decode attention over whole cache rows: ``q`` [B, 1, h, Dh] this
    rank's query heads, ``kk``/``vv`` f32 [B, n, K, Dh] every KV head
    (their heads: :func:`heads_kv`) -> the context [B, 1, h, Dh] in q's
    dtype, no collective."""
    kk, vv = heads_kv(p, q, kk, vv)
    w = torch.softmax(_scores(q, kk, valid), dim=-1)
    ctx = torch.einsum("bkgt,btkd->bkgd", w, vv).to(q.dtype)
    return ctx.reshape(q.shape)


def attend_rows(p: dict, q: torch.Tensor, kk: torch.Tensor,
                vv: torch.Tensor, valid: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Decode attention over a cache sharded over T: ``q`` [B, 1, h, Dh]
    this rank's query heads (every head where Q is whole), ``kk``/``vv``
    f32 [B, n, K, Dh] this rank's n rows up to the step's position
    (``valid`` [n] masks more) -> the context [B, 1, h, Dh] in q's dtype.
    The query heads are gathered over the model axis where Q is split,
    every head scores this rank's rows, ``tp.softmax_over_rows`` combines
    the ranks, and each rank keeps its own heads for wo."""
    split = p["wk"]["w"].partial
    qa = tp.all_gather(q, 2, "model") if split else q
    b, _, h, dh = qa.shape
    ctx = tp.softmax_over_rows(_scores(qa, kk, valid), vv).to(q.dtype)
    ctx = ctx.reshape(b, 1, h, dh)
    if split:
        ctx = ctx.narrow(2, tp.model_rank() * q.shape[2], q.shape[2])
    return ctx


def attend_dh(p: dict, q: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """Decode attention over a cache sharded over the head dim (its rows
    and KV heads do not divide the model axis, its Dh does): ``q`` [B, 1,
    h, Dh] this rank's query heads (every head where Q is whole),
    ``kk``/``vv`` f32 [B, n, K, Dh/m] this rank's block of every row ->
    the context [B, 1, h, Dh] in q's dtype.  As JAX's decode HLO runs it:
    the K blocks all-gathered (f32) for the whole ``q . k``; this rank's
    heads' softmax weights all-gathered over ``model`` where Q is split;
    every head's weighted values over this rank's Dh block; then an
    all-to-all to this rank's heads over the whole Dh (an all-gather of
    the Dh blocks where Q is whole)."""
    kk = tp.all_gather(kk, -1, "model")
    kq, _ = heads_kv(p, q, kk, kk)
    b, _, h, dh = q.shape
    w = torch.softmax(_scores(q, kq, valid), dim=-1).reshape(b, h, -1)
    wk = p["wk"]["w"]
    split = isinstance(wk, tp.Whole) and wk.partial
    if split:
        w = tp.all_gather(w, 1, "model")             # [B, H, n]
    kh = vv.shape[2]
    ctx = torch.einsum("bkgt,btkd->bkgd",
                       w.reshape(b, kh, w.shape[1] // kh, -1), vv)
    ctx = ctx.reshape(b, w.shape[1], -1)             # [B, H, Dh/m]
    ctx = tp.all_to_all(ctx, 1, 2, "model") if split else \
        tp.all_gather(ctx, -1, "model")
    return ctx.to(q.dtype).reshape(b, 1, h, dh)


def gqa_decode(p: dict, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, t: int, *, ring: bool,
               theta: float = 1e4, window: int = 0,
               split: str | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step.  x [B, 1, D]; caches [B, Tc, K, Dh], written in
    place at the new token's slot; ``t`` its position.

    ``ring``: the cache is a ring of Tc == window slots (slot t % Tc);
    slot s holds the largest position p <= t with p % Tc == s, and
    positions below 0 (slots not yet written) are masked.  A full cache
    attends over its first t + 1 rows, within ``window`` if it is > 0.
    ``split``: the cache's layout over the model axis
    (:func:`cache_layout`): its KV heads or whole (None), this rank's
    rows of T or of a ring's window of W = Tc m slots (``"rows"``), or
    its block of Dh (``"dh"``, each rank writing its block of the new
    row).  Returns (y [B, 1, D], k_cache, v_cache).
    """
    tc = k_cache.shape[1]
    q = L.column_linear(p["wq"], x)                  # [B, 1, H, Dh]
    k_new = L.column_linear(p["wk"], x)              # [B, 1, K, Dh]
    v_new = L.column_linear(p["wv"], x)
    if theta > 0:
        q = _rope_at(q, t, theta)
        k_new = _rope_at(k_new, t, theta)
    f32 = torch.float32
    if split == "rows" and ring:
        # this rank's slots [r Tc, (r + 1) Tc) of a ring of W = Tc m slots
        # (cache_specs splits it over its window): the new row lands on
        # the rank that holds slot t % W; every slot is scored, masked by
        # the ring's validity
        w = tc * tp.model_size()
        tp.write_row(k_cache, _ring_slot(t, w), k_new[:, 0])
        tp.write_row(v_cache, _ring_slot(t, w), v_new[:, 0])
        sidx = tp.model_rank() * tc + torch.arange(tc, dtype=torch.int64,
                                                   device=x.device)
        slot_pos = t - torch.remainder(t - sidx, w)
        ctx = attend_rows(p, q, k_cache.to(f32), v_cache.to(f32),
                          (slot_pos >= 0) & (slot_pos <= t))
        return _proj_out(p, ctx), k_cache, v_cache
    if split == "rows":
        tp.write_row(k_cache, t, k_new[:, 0])
        tp.write_row(v_cache, t, v_new[:, 0])
        n = rows_upto(tc, t)
        valid = None
        if window > 0:
            pos = tp.model_rank() * tc + torch.arange(n, device=x.device)
            valid = pos > t - window
        ctx = attend_rows(p, q, k_cache[:, :n].to(f32),
                          v_cache[:, :n].to(f32), valid)
        return _proj_out(p, ctx), k_cache, v_cache
    slot = _ring_slot(t, tc) if ring else t
    if split == "dh":
        k_new, v_new = tp.model_block(k_new), tp.model_block(v_new)
    k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)

    if ring:
        kk, vv = k_cache, v_cache
        sidx = torch.arange(tc, dtype=torch.int64, device=x.device)
        slot_pos = t - torch.remainder(t - sidx, tc)  # floor modulo
        valid = (slot_pos >= 0) & (slot_pos <= t)
    else:
        kk, vv = k_cache[:, :t + 1], v_cache[:, :t + 1]
        valid = None
        if window > 0:
            valid = torch.arange(t + 1, device=x.device) > t - window
    attend = attend_dh if split == "dh" else attend_whole
    ctx = attend(p, q, kk.to(f32), vv.to(f32), valid)
    return _proj_out(p, ctx), k_cache, v_cache


def gqa_prefill_cache(p: dict, x: torch.Tensor, positions: torch.Tensor,
                      cache_len: int, *, ring: bool, theta: float = 1e4,
                      kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                      start: int = 0, split: str | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """A prompt's K/V laid out as a decode cache [B, cache_len, K, Dh].

    ``kv``: (k roped, v) from :func:`gqa_kv`, so that a caller that also
    runs attention projects once.  ``split``: the cache's layout over the
    model axis (:func:`cache_layout`).  A ring takes the last min(W, S)
    positions at slot ``position % W``, W = cache_len, or cache_len m
    where it is sharded over its window (``"rows"``: this rank's slots [r
    cache_len, (r + 1) cache_len)); a full cache the cache_len rows from
    position ``start`` (a rank's block of a cache sharded over T), those
    past the prompt zero.  Under ``"dh"`` the rank keeps its block of the
    head dim of the whole K/V it computed.
    """
    k, v = kv if kv is not None else gqa_kv(p, x, positions, theta=theta)
    if split == "dh":
        k, v = tp.model_block(k), tp.model_block(v)
    b, s, kh, dh = k.shape
    kc = k.new_zeros((b, cache_len, kh, dh))
    vc = torch.zeros_like(kc)
    if ring:
        rows = split == "rows"
        w = cache_len * (tp.model_size() if rows else 1)
        lo = tp.model_rank() * cache_len if rows else 0
        take = min(w, s)
        idx = _ring_slot(positions[s - take:].long(), w) - lo
        if rows:
            # other ranks' slots go to a spare row, dropped after: a
            # count that depends on no data (the dry run traces this on
            # meta, where a boolean index has no size)
            idx = torch.where((idx >= 0) & (idx < cache_len), idx,
                              cache_len)
            kc = k.new_zeros((b, cache_len + 1, kh, dh))
            vc = torch.zeros_like(kc)
        kc[:, idx] = k[:, s - take:]
        vc[:, idx] = v[:, s - take:]
        if rows:
            kc = kc[:, :cache_len].contiguous()
            vc = vc[:, :cache_len].contiguous()
    else:
        n = max(0, min(cache_len, s - start))
        kc[:, :n] = k[:, start:start + n]
        vc[:, :n] = v[:, start:start + n]
    return kc, vc


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2), absorbed decode
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, d: int, n_heads: int, r: int, dn: int,
             dr: int, dv: int, *, dtype=torch.bfloat16,
             device: torch.device) -> dict:
    def dense(shape):
        return {"w": L._dense_init(gen, shape, dtype, device)}
    return {
        "wq": L.init_linear(gen, d, (n_heads, dn + dr), dtype=dtype,
                            device=device),
        "wdkv": L.init_linear(gen, d, r, dtype=dtype, device=device),
        "wkr": L.init_linear(gen, d, dr, dtype=dtype, device=device),
        "kv_norm": L.init_rmsnorm(r, device),
        "wuk": dense((r, n_heads, dn)),
        "wuv": dense((r, n_heads, dv)),
        "wo": dense((n_heads, dv, d)),
    }


def _mla_qkr(p: dict, x: torch.Tensor, positions: torch.Tensor, dn: int,
             dr: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(q_nope [B, S, H, dn], q_rope [B, S, H, dr] roped): this rank's
    heads under a model axis."""
    q = L.column_linear(p["wq"], x)                  # [B, S, H, dn+dr]
    qn, qr = q[..., :dn], q[..., dn:]
    cos, sin = L.rope_angles(positions, dr, theta)
    qr = L.apply_rope(qr, cos[None, :, None, :], sin[None, :, None, :])
    return qn, qr


def _mla_latent(p: dict, x: torch.Tensor, positions: torch.Tensor,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(c [B, S, r] normed latent, k_rope [B, S, dr] roped), whole on
    every rank."""
    c = L.rmsnorm(p["kv_norm"], tp.replicated(x, p["wdkv"]["w"]))
    kr = tp.replicated(x, p["wkr"]["w"])[:, :, None, :]
    cos, sin = L.rope_angles(positions, kr.shape[-1], theta)
    kr = L.apply_rope(kr, cos[None, :, None, :], sin[None, :, None, :])
    return c, kr[:, :, 0]


def mla_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                dn: int, dr: int, theta: float = 1e4) -> torch.Tensor:
    """Materialised MLA for training and prefill; causal.  The value
    width (dv) differs from the q/k width (dn + dr)."""
    b, s, _ = x.shape
    qn, qr = _mla_qkr(p, x, positions, dn, dr, theta)
    c, kr = _mla_latent(p, x, positions, theta)
    kn = L.column_linear(p["wuk"], c)                # [B, S, H, dn]
    v = L.column_linear(p["wuv"], c)                 # [B, S, H, dv]
    h = qn.shape[2]
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kn, tp.heads_broadcast(
        kr, h, not isinstance(p["wq"]["w"], tp.Whole))], dim=-1)
    ctx = _chunked_attn(q.reshape(b, s, h, 1, dn + dr), k, v, positions,
                        positions, True, 0)
    return _proj_out(p, ctx.reshape(b, s, h, v.shape[-1]))


def latent_layout(leaf: torch.Tensor) -> str | None:
    """How an MLA cache leaf ``[L, B, T, w]`` (the latent, or the rope
    key) made by ``tp.new_cache`` is split over the model axis, as
    ``sharding.cache_specs`` splits it: ``"last"`` (its width), ``"rows"``
    (its rows of T), or None (whole)."""
    return {2: "rows", 3: "last"}.get(tp.split_dim(leaf))


def _latent_write(cache: torch.Tensor, t: int, new: torch.Tensor,
                  lay: str | None) -> None:
    """Write the new token's row ``new`` [B, w] (whole on every rank) at
    ``t`` into this rank's block of a latent cache [B, T', w']."""
    if lay == "rows":
        tp.write_row(cache, t, new)
    else:
        cache[:, t] = (tp.model_block(new) if lay == "last"
                       else new).to(cache.dtype)


def _latent_rows(cache: torch.Tensor, lay: str | None, t: int,
                 lo: int = 0, n: int | None = None) -> torch.Tensor:
    """A latent cache's rows up to position ``t`` over its whole width,
    in f32 (this rank's block gathered over ``model`` where the width is
    split; the same rows on every rank, so the same size), then rows [lo,
    lo + n) of them where ``n`` is given (this rank's rows of T, ``lo``
    0 for a leaf split over T)."""
    if lay == "rows":
        return cache[:, :n].to(torch.float32)
    rows = cache[:, :t + 1].to(torch.float32)
    if lay == "last":
        rows = tp.all_gather(rows, -1, "model")
    return rows if n is None else rows[:, lo:lo + n]


def mla_decode(p: dict, x: torch.Tensor, c_cache: torch.Tensor,
               kr_cache: torch.Tensor, t: int, dn: int, dr: int,
               theta: float = 1e4, lays: tuple = (None, None)
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed-matrix decode: attention runs in the r-wide latent space.

    The cache is the latent itself (c [B, T, r], k_rope [B, T, dr]),
    written in place at ``t`` and read in f32; under a model axis each
    leaf is this rank's block as ``cache_specs`` cuts it (``lays``, by
    leaf, :func:`latent_layout`): its width's block, gathered over the
    axis at its use; its rows of T, which every head scores (the rank's
    query heads gathered where they are split), the ranks' softmax
    statistics then combined (``tp.softmax_over_rows``) as the GQA decode
    over T blocks combines them; or whole.  W_uk is absorbed into q and
    W_uv applied to the latent context, both in f32 (bf16 operands are
    exact there; TF32 is off on the card, ``kernels/_device.
    resolve_device``), for this rank's heads (every head where they do
    not divide the axis).
    """
    pos = torch.tensor([t], dtype=torch.int32, device=x.device)
    qn, qr = _mla_qkr(p, x, pos, dn, dr, theta)
    c_new, kr_new = _mla_latent(p, x, pos, theta)
    _latent_write(c_cache, t, c_new[:, 0], lays[0])
    _latent_write(kr_cache, t, kr_new[:, 0], lays[1])

    f32 = torch.float32
    q_eff = torch.einsum("bhd,rhd->bhr", qn[:, 0].to(f32),
                         tp.weight(p["wuk"]["w"]).to(f32))
    qr = qr[:, 0].to(f32)
    scale = math.sqrt(dn + dr)
    if "rows" in lays:
        # this rank's rows of T: every head scores them
        tb = (c_cache if lays[0] == "rows" else kr_cache).shape[1]
        n = rows_upto(tb, t)
        lo = tp.model_rank() * tb
        cc, krc = (_latent_rows(c, lay, t, lo, n)
                   for c, lay in ((c_cache, lays[0]), (kr_cache, lays[1])))
        split = not isinstance(p["wq"]["w"], tp.Whole) \
            and tp.model_size() > 1
        qa, qra = (tp.all_gather(a, 1, "model") if split else a
                   for a in (q_eff, qr))
        scores = (torch.einsum("bhr,btr->bht", qa, cc)
                  + torch.einsum("bhd,btd->bht", qra, krc)) / scale
        b, hh = scores.shape[:2]
        ctx_lat = tp.softmax_over_rows(scores[:, None], cc[:, :, None])[:, 0]
        if split:
            h = q_eff.shape[1]
            ctx_lat = ctx_lat.narrow(1, tp.model_rank() * h, h)
    else:
        cc = _latent_rows(c_cache, lays[0], t)              # [B, t+1, r]
        krc = _latent_rows(kr_cache, lays[1], t)
        scores = torch.einsum("bhr,btr->bht", q_eff, cc)
        scores = scores + torch.einsum("bhd,btd->bht", qr, krc)
        w = torch.softmax(scores / scale, dim=-1)
        ctx_lat = torch.einsum("bht,btr->bhr", w, cc)
    ctx = torch.einsum("bhr,rhd->bhd", ctx_lat,
                       tp.weight(p["wuv"]["w"]).to(f32)).to(x.dtype)
    return _proj_out(p, ctx[:, None]), c_cache, kr_cache


def mla_prefill_cache(p: dict, x: torch.Tensor, positions: torch.Tensor,
                      cache_len: int, theta: float = 1e4,
                      lays: tuple = (None, None)
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """A prompt's latent cache: c [B, cache_len, r] and k_rope [B,
    cache_len, dr], the first cache_len positions, each as its cache
    leaf's block (``lays``, :func:`latent_layout`): its width's block,
    or this rank's cache_len / m rows of T, or whole."""
    out = []
    for t, lay in zip(_mla_latent(p, x, positions, theta), lays):
        if lay == "last":
            t = tp.model_block(t)
        rows = cache_len // tp.model_size() if lay == "rows" else cache_len
        start = tp.model_rank() * rows if lay == "rows" else 0
        b, s, w = t.shape
        block = t.new_zeros((b, rows, w))
        n = max(0, min(rows, s - start))
        block[:, :n] = t[:, start:start + n]
        out.append(block)
    return out[0], out[1]
