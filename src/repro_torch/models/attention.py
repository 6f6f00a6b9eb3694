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
cache holds the rank's rows of T, or of a ring's window, slot ``t % W``
written on the rank that holds it (:func:`attend_rows`); where the heads
do not divide m either, attention runs whole on every rank.  In the
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
rank's heads and then over the axis (``tp.heads_broadcast``).  The
decode cache holds this rank's block of the latent's and the rope key's
last dim (``sharding.cache_specs``), which the step writes at ``t`` and
gathers over ``model`` in f32 at its use.
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


def rows_split(p: dict) -> bool:
    """Whether a GQA layer's decode cache holds this rank's rows of T (K/V
    whole over the model axis: ``cache_specs`` shards the cache over T)."""
    return isinstance(p["wk"]["w"], tp.Whole)


def rows_upto(tb: int, t: int) -> int:
    """How many of this rank's ``tb`` rows of a cache sharded over T lie
    at or before position ``t``."""
    return min(max(t + 1 - tp.model_rank() * tb, 0), tb)


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
    kh = kk.shape[2]
    qg = qa.reshape(b, kh, h // kh, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32),
                          kk) / math.sqrt(dh)
    if valid is not None:
        scores = torch.where(valid, scores, scores.new_tensor(NEG_INF))
    ctx = tp.softmax_over_rows(scores, vv).to(q.dtype).reshape(b, 1, h, dh)
    if split:
        ctx = ctx.narrow(2, tp.model_rank() * q.shape[2], q.shape[2])
    return ctx


def gqa_decode(p: dict, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, t: int, *, ring: bool,
               theta: float = 1e4, window: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step.  x [B, 1, D]; caches [B, Tc, K, Dh], written in
    place at the new token's slot; ``t`` its position.

    ``ring``: the cache is a ring of Tc == window slots (slot t % Tc);
    slot s holds the largest position p <= t with p % Tc == s, and
    positions below 0 (slots not yet written) are masked.  A full cache
    attends over its first t + 1 rows, within ``window`` if it is > 0.
    Returns (y [B, 1, D], k_cache, v_cache).
    """
    b = x.shape[0]
    tc = k_cache.shape[1]
    q = L.column_linear(p["wq"], x)                  # [B, 1, H, Dh]
    k_new = L.column_linear(p["wk"], x)              # [B, 1, K, Dh]
    v_new = L.column_linear(p["wv"], x)
    dh = q.shape[-1]
    if theta > 0:
        q = _rope_at(q, t, theta)
        k_new = _rope_at(k_new, t, theta)
    if rows_split(p) and ring:
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
        ctx = attend_rows(p, q, k_cache.to(torch.float32),
                          v_cache.to(torch.float32),
                          (slot_pos >= 0) & (slot_pos <= t))
        return _proj_out(p, ctx), k_cache, v_cache
    if rows_split(p):
        tp.write_row(k_cache, t, k_new[:, 0])
        tp.write_row(v_cache, t, v_new[:, 0])
        n = rows_upto(tc, t)
        valid = None
        if window > 0:
            pos = tp.model_rank() * tc + torch.arange(n, device=x.device)
            valid = pos > t - window
        ctx = attend_rows(p, q, k_cache[:, :n].to(torch.float32),
                          v_cache[:, :n].to(torch.float32), valid)
        return _proj_out(p, ctx), k_cache, v_cache
    slot = _ring_slot(t, tc) if ring else t
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
    h, kh = q.shape[2], k_cache.shape[2]
    qg = q.reshape(b, kh, h // kh, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32),
                          kk.to(torch.float32)) / math.sqrt(dh)
    if valid is not None:
        scores = torch.where(valid, scores, scores.new_tensor(NEG_INF))
    wts = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgt,btkd->bkgd", wts,
                       vv.to(torch.float32)).to(x.dtype)
    return _proj_out(p, ctx.reshape(b, 1, h, dh)), k_cache, v_cache


def gqa_prefill_cache(p: dict, x: torch.Tensor, positions: torch.Tensor,
                      cache_len: int, *, ring: bool, theta: float = 1e4,
                      kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                      start: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """A prompt's K/V laid out as a decode cache [B, cache_len, K, Dh].

    ``kv``: (k roped, v) from :func:`gqa_kv`, so that a caller that also
    runs attention projects once.  A ring takes the last min(W, S)
    positions at slot ``position % W``, W = cache_len, or cache_len m
    where K/V are whole over the model axis (:func:`rows_split`: the ring
    is sharded over its window, this rank's slots [r cache_len, (r + 1)
    cache_len)); a full cache the cache_len rows from position ``start``
    (a rank's block of a cache sharded over T), those past the prompt
    zero.
    """
    k, v = kv if kv is not None else gqa_kv(p, x, positions, theta=theta)
    b, s, kh, dh = k.shape
    kc = k.new_zeros((b, cache_len, kh, dh))
    vc = torch.zeros_like(kc)
    if ring:
        split = rows_split(p)
        w = cache_len * (tp.model_size() if split else 1)
        lo = tp.model_rank() * cache_len if split else 0
        take = min(w, s)
        idx = _ring_slot(positions[s - take:].long(), w) - lo
        if split:
            # other ranks' slots go to a spare row, dropped after: a
            # count that depends on no data (the dry run traces this on
            # meta, where a boolean index has no size)
            idx = torch.where((idx >= 0) & (idx < cache_len), idx,
                              cache_len)
            kc = k.new_zeros((b, cache_len + 1, kh, dh))
            vc = torch.zeros_like(kc)
        kc[:, idx] = k[:, s - take:]
        vc[:, idx] = v[:, s - take:]
        if split:
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
    k = torch.cat([kn, tp.heads_broadcast(kr, h)], dim=-1)
    ctx = _chunked_attn(q.reshape(b, s, h, 1, dn + dr), k, v, positions,
                        positions, True, 0)
    return _proj_out(p, ctx.reshape(b, s, h, v.shape[-1]))


def mla_decode(p: dict, x: torch.Tensor, c_cache: torch.Tensor,
               kr_cache: torch.Tensor, t: int, dn: int, dr: int,
               theta: float = 1e4
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed-matrix decode: attention runs in the r-wide latent space.

    The cache is the latent itself (c [B, T, r], k_rope [B, T, dr]; this
    rank's block of the last dim under a model axis), written in place at
    ``t`` and read (gathered over the axis) in f32.  W_uk is absorbed
    into q and W_uv applied to the latent context, both in f32 (bf16
    operands are exact there; TF32 is off on the card, ``kernels/
    _device.resolve_device``), for this rank's heads.
    """
    pos = torch.tensor([t], dtype=torch.int32, device=x.device)
    qn, qr = _mla_qkr(p, x, pos, dn, dr, theta)
    c_new, kr_new = _mla_latent(p, x, pos, theta)
    c_cache[:, t] = tp.model_block(c_new[:, 0]).to(c_cache.dtype)
    kr_cache[:, t] = tp.model_block(kr_new[:, 0]).to(kr_cache.dtype)

    f32 = torch.float32
    cc, krc = c_cache[:, :t + 1].to(f32), kr_cache[:, :t + 1].to(f32)
    if tp.model_size() > 1:
        cc = tp.all_gather(cc, -1, "model")           # [B, t+1, r]
        krc = tp.all_gather(krc, -1, "model")
    q_eff = torch.einsum("bhd,rhd->bhr", qn[:, 0].to(f32),
                         tp.weight(p["wuk"]["w"]).to(f32))
    scores = torch.einsum("bhr,btr->bht", q_eff, cc)
    scores = scores + torch.einsum("bhd,btd->bht", qr[:, 0].to(f32), krc)
    w = torch.softmax(scores / math.sqrt(dn + dr), dim=-1)
    ctx_lat = torch.einsum("bht,btr->bhr", w, cc)
    ctx = torch.einsum("bhr,rhd->bhd", ctx_lat,
                       tp.weight(p["wuv"]["w"]).to(f32)).to(x.dtype)
    return _proj_out(p, ctx[:, None]), c_cache, kr_cache


def mla_prefill_cache(p: dict, x: torch.Tensor, positions: torch.Tensor,
                      cache_len: int, theta: float = 1e4
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """A prompt's latent cache: c [B, cache_len, r] and k_rope [B,
    cache_len, dr], the first cache_len positions (this rank's block of
    the last dim under a model axis)."""
    c, kr = _mla_latent(p, x, positions, theta)
    c, kr = tp.model_block(c), tp.model_block(kr)
    b, s, r = c.shape
    cc = c.new_zeros((b, cache_len, r))
    krc = kr.new_zeros((b, cache_len, kr.shape[-1]))
    n = min(cache_len, s)
    cc[:, :n] = c[:, :n]
    krc[:, :n] = kr[:, :n]
    return cc, krc
