"""Paged compressed-KV serving engine (port of ``repro/serving/engine.py``).

Greedy decoding of a dense-GQA model over a KV cache stored in
compressed pages:

  * KV pages are stored compressed through a :class:`PageCodec` (any
    registered one: ``bdi``, ``zero``, ``raw``, ``gbdi``, ``fpc``,
    ``adaptive``), in device pools whose leaves lead with ``[L, P]`` —
    the JAX package's layouts; a per-page codec tag (``page_codec_id``)
    records the member an ``adaptive`` page chose;
  * page tables map each sequence's page slots to pool ids (LCP
    addressing), padded to a power-of-two ``PMAX``;
  * when the pool is full, CAMP preempts the least valuable sequence
    (value = reuse proxy / compressed bytes).

Prefill is chunked and batched: every admitted prompt advances
``prefill_chunk`` tokens per step through all layers, writing exact f32
K/V into a scratch and attending under the canonical-prefix contract
(``serving/prefix_cache.py``).  Every page a chunk completes is
compressed and scattered into the pools (the codec's kernels on the
card); the final partial page goes to the decode tail buffers.  A
lossless codec skips the canonical roundtrip: its prefill attends the
exact scratch.  Decode advances every active sequence one token per
step; a codec with a fused attention kernel (``has_fused_kernels``:
bdi) reads the pools in compressed form, every other codec goes through
:func:`_attend_ref`, which gathers the pages, decompresses them and
attends densely.

With a :class:`~repro_torch.serving.prefix_cache.PrefixCache` attached,
admission looks up each prompt's longest cached page-boundary prefix,
pins the entry chain, maps its pool pages into the new sequence's page
table and decompresses them into the prefill scratch
(:func:`_fill_warm_scratch`); the member then starts chunked prefill at
the first uncached boundary — each cohort row at its own offset through
one shared relative chunk grid — and a full hit skips prefill.  Prompt
pages register in the cache as they publish; two same-prefix members of
one cohort dedup onto one entry.  Under pool pressure, pages come back
from the free list, then from refcount-0 cache entries in SIP order,
then from CAMP preemption of a live sequence (whose value counts only
the bytes its preemption would free).

Where the JAX engine donates buffers to a jit, this engine updates the
same tensors in place (slice assignment / ``index_put_``), and says so
at each site.  ``lax.scan`` over layers is a Python loop over the
stacked ``[L, ...]`` parameters.  Host decisions are the JAX engine's,
step for step: the free list, CAMP victims, SIP evictions, ``PMAX``
doubling, cohort row and scratch rounding, and the publish order.
Counters live in a :class:`~repro_torch.serving.telemetry.Telemetry`
registry (``stats`` reads the eight of them back as a dict), with the
JAX engine's gauges and per-codec publish series.

Integrity (``serving/faults.py``): every published page carries a
checksum computed with its compression; with ``integrity=True`` (the
default) a warm prefix hit is verified before its chain is mapped, and
with a fault injector attached each CAMP victim is verified before its
pages drop.  A :class:`~repro_torch.serving.tier.TieredPageStore`
(``tier=``) catches the prefix cache's eviction victims: their
compressed pages are gathered out of the pools and copied to the host
(one copy a demotion, off the decode path); admission walks the tier
past the device hit, verifies each record host-side and scatters the
verified run back into the pools with one indexed write per pool leaf.
``cache_decode_pages`` also demotes a retiring sequence's private pages
(the multi-turn chat path).  ``serving/snapshot.py`` saves and restores
the whole engine.

An :class:`~repro_torch.serving.observatory.Observatory`
(``observatory=``) rides the page lifecycle: publishes (with every
adaptive member's would-be size, from the same compressed pages and the
same host sync), warm-hit and dedup reuse, releases and CAMP victims.
Without one (``obs`` None) each hook is a single ``is not None`` check.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import codecs
from repro_torch.configs.base import ArchConfig
from repro_torch.core.camp import _pow2_bucket
from repro_torch.kernels._device import resolve_device
from repro_torch.kernels.ref import softmax_attend
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.params import layer, to_device
from repro_torch.serving import faults as F
from repro_torch.serving import tier as T
from repro_torch.serving._tree import tree_leaves, tree_map
from repro_torch.serving.prefix_cache import (PrefixCache, canonical_update,
                                              prefix_chunk_attention)
from repro_torch.serving.telemetry import Telemetry


@dataclass
class Sequence:
    sid: int
    slot: int                            # batch slot in the device state
    tokens: list[int]
    pages: list[list[int]]               # [L][n_pages] pool ids
    tail_len: int = 0
    done: bool = False
    preempted: bool = False
    corrupted: bool = False              # failed a page-integrity check
    prefilling: bool = False             # in-flight admission cohort member
    # prefix-cache chain: entry ids whose pages this sequence maps, in
    # block order.  pages[li][:len(chain)] are shared (cache-owned); the
    # rest are private and freed on release/preemption.
    chain: list[int] = field(default_factory=list)


@dataclass
class _Cohort:
    """In-flight chunked-prefill admission cohort.

    All members advance one shared *relative* chunk grid: each step moves
    the grid offset ``roff`` by up to ``prefill_chunk`` tokens.  Member
    ``i`` starts at its own absolute offset ``starts[i]`` (its prefix-cache
    hit boundary, 0 when cold), so its chunk covers absolute positions
    ``starts[i] + roff ..``.  ``toks`` is the host-side zero-padded prompt
    buffer (absolute positions); ``kscr/vscr`` the exact f32 K/V scratch
    and ``kcan/vcan`` its canonical view, all [L, nrows, tmax, K, D] on
    the device (the canonical view zero-length, T = 0, for a lossless
    codec; warm rows carry the decompressed cached prefix below
    ``starts[i]``); ``pub[i]`` counts pages already published or mapped
    for ``seqs[i]``; ``done_sids`` the members whose prefill completed.
    """
    seqs: list[Sequence]
    row: dict[int, int]                  # sid -> scratch row
    toks: np.ndarray                     # [nrows, tmax] i32, host
    kscr: torch.Tensor
    vscr: torch.Tensor
    kcan: torch.Tensor
    vcan: torch.Tensor
    starts: list[int]                    # absolute start offset per member
    maxrel: int                          # grid length: max stored - start
    pub: list[int]
    done_sids: set[int]
    roff: int = 0                        # grid offset


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------

def _attend_ref(codec: codecs.PageCodec, q, pools_l, pt, page_len, tk, tv,
                tail_len):
    """Gather-then-decompress decode attention over pages + tail.

    q f32 [S, K, G, D]; pools_l the codec's one-layer pool tree (leaves
    leading [P]); pt i32 [S, PMAX]; tk/tv f32 [S, K, page, D].  Gathers
    the compressed pages first, so only [S, PMAX] pages decompress (on
    the card through the codec's kernels), then attends densely.
    """
    s, kvh, _, d = q.shape
    pmax, page = pt.shape[1], tk.shape[2]
    ptl = pt.long()
    kg, vg = codec.decompress_pages(tree_map(lambda a: a[ptl], pools_l))
    kg = torch.cat([kg.movedim(2, 1).reshape(s, kvh, pmax * page, d), tk], 2)
    vg = torch.cat([vg.movedim(2, 1).reshape(s, kvh, pmax * page, d), tv], 2)
    dev = q.device
    valid = torch.cat(
        [torch.arange(pmax * page, device=dev)[None, :] < page_len[:, None],
         torch.arange(page, device=dev)[None, :] < tail_len[:, None]], dim=1)
    return softmax_attend(q, kg, vg, valid)


def _decode_core(layers: list[dict], params: dict, pools, tk, tv,
                 page_table, page_cnt, last_tok, pos, tail_len, active, *,
                 cfg: ArchConfig, codec: codecs.PageCodec):
    """One greedy decode step for every slot, all layers.

    pools: the codec's pool NamedTuple, leaves [L, P, ...]; tk/tv f32
    [L, S, K, page, D] tail buffers, written in place (the JAX step
    donates them); page_table i32 [L, S, PMAX]; page_cnt/last_tok/pos/
    tail_len i32 [S]; active bool [S].  Returns (next_tok [S], logits
    [S, V]); inactive slots keep their last token and their tails.
    """
    s = last_tok.shape[0]
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    page = tk.shape[3]
    dev = last_tok.device
    x = L.embed(params["embed"], last_tok[:, None])          # [S, 1, D]
    cos, sin = L.rope_angles(pos, dh, cfg.rope_theta)        # [S, dh/2]
    cos_b, sin_b = cos[:, None, None, :], sin[:, None, None, :]
    page_len = page_cnt * page                               # tokens in pages
    # tail write slot, masked so inactive sequences' buffers stay untouched
    slot_hot = ((torch.arange(page, device=dev)[None, :] == tail_len[:, None])
                & active[:, None])
    sel = slot_hot[:, None, :, None]                         # [S, 1, page, 1]
    lens_tail = tail_len + 1
    # the codec's fused kernel reads compressed pages; others decompress
    attend = (codec.paged_attention_tail if codec.has_fused_kernels
              else lambda *a: _attend_ref(codec, *a))
    for li, bp in enumerate(layers):
        h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
        q = L.apply_rope(L.linear(bp["attn"]["wq"], h), cos_b, sin_b)
        k_new = L.apply_rope(L.linear(bp["attn"]["wk"], h), cos_b, sin_b)
        v_new = L.linear(bp["attn"]["wv"], h)
        # append the new token into the tail write buffer, in place
        tk[li] = torch.where(sel, k_new[:, 0].float()[:, :, None, :], tk[li])
        tv[li] = torch.where(sel, v_new[:, 0].float()[:, :, None, :], tv[li])
        hq = q.shape[2]
        qg = q[:, 0].reshape(s, kvh, hq // kvh, dh).float()
        pools_l = tree_map(lambda a: a[li], pools)
        ctx = attend(qg, pools_l, page_table[li], page_len, tk[li], tv[li],
                     lens_tail)
        x = x + A._proj_out(bp["attn"], ctx.reshape(s, 1, hq, dh).to(x.dtype))
        x = x + L.mlp(bp["ffn"], L.rmsnorm(bp["ln2"], x, cfg.norm_eps))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.lm_logits(params["lm_head"], x)[:, 0]         # [S, V]
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)       # first max
    return torch.where(active, nxt, last_tok), logits


def _prefill_core(layers: list[dict], params: dict, tokens, kscr, vscr,
                  kcan, vcan, offs, *, cfg: ArchConfig, page: int,
                  codec: codecs.PageCodec) -> None:
    """One chunked-batch prefill step: C prompt tokens per row, all layers.

    tokens i32 [R, C] (zero-padded rows); offs i64 [R] each row's chunk
    start.  kscr/vscr f32 [L, R, Tmax, K, D] exact scratch and kcan/vcan
    its canonical view are updated in place (the JAX step donates them).
    Attention follows the canonical-prefix contract; a lossless codec
    skips the roundtrip and attends the exact scratch (``identity``),
    leaving kcan/vcan (zero-length) alone.  The last layer's
    attention output and MLP feed nothing — only its K/V is kept — so
    they are skipped, with its canonical view, which only a later
    layer-L attention would read.
    """
    r, c = tokens.shape
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    dev = tokens.device
    x = L.embed(params["embed"], tokens)                     # [R, C, D]
    qpos = offs[:, None] + torch.arange(c, device=dev)[None, :]
    cos, sin = L.rope_angles(qpos, dh, cfg.rope_theta)       # [R, C, dh/2]
    cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]
    rows = torch.arange(r, device=dev)[:, None]
    last = len(layers) - 1
    for li, bp in enumerate(layers):
        h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
        k, v = A.gqa_kv(bp["attn"], h, qpos, theta=cfg.rope_theta)
        # per-row scratch write at each row's offset, in place
        kscr[li][rows, qpos] = k.float()
        vscr[li][rows, qpos] = v.float()
        if li == last:
            break
        if not codec.lossless:
            canonical_update(kscr[li], vscr[li], kcan[li], vcan[li], offs,
                             page, c + page, codec)
        q = L.apply_rope(L.linear(bp["attn"]["wq"], h), cos_b, sin_b)
        hq = q.shape[2]
        qg = q.reshape(r, c, kvh, hq // kvh, dh).float()
        ctx = prefix_chunk_attention(qg, qpos, kscr[li], vscr[li], kcan[li],
                                     vcan[li], page, identity=codec.lossless)
        x = x + A._proj_out(bp["attn"],
                            ctx.reshape(r, c, hq, dh).to(x.dtype))
        x = x + L.mlp(bp["ffn"], L.rmsnorm(bp["ln2"], x, cfg.norm_eps))


def _scratch_blocks(kscr, vscr, rows, blks, page: int):
    """Page blocks [L, m, K, page, D] from the [L, R, Tmax, K, D] scratch:
    entry j is row ``rows[j]``'s page ``blks[j]``."""
    lyr, r, tmax, kvh, dh = kscr.shape
    kp = kscr.view(lyr, r, tmax // page, page, kvh, dh)
    vp = vscr.view(lyr, r, tmax // page, page, kvh, dh)
    return (kp[:, rows, blks].transpose(2, 3),
            vp[:, rows, blks].transpose(2, 3))


def _publish_blocks(pools, k_blocks, v_blocks, layer_idx, pids, *,
                    codec: codecs.PageCodec, member_sizes: bool = False):
    """Compress [n, K, page, D] KV blocks and scatter them into the pools
    in place (``index_put_``; the JAX step donates the pools).  Returns
    the per-page compressed byte counts [n], checksums [n], codec tags
    [n] and, with ``member_sizes`` (a composite codec under an
    observatory), every member's would-be byte counts [n_members, n]
    read off the member pages the compress already made (else None)."""
    pg = codec.compress_kv_pages(k_blocks, v_blocks)
    for pool, new in zip(tree_leaves(pools), tree_leaves(pg)):
        pool.index_put_((layer_idx, pids), new)
    msizes = None
    if member_sizes:
        msizes = torch.stack([m.page_nbytes(c).to(torch.int64)
                              for m, c in zip(codec.members, pg[1:])])
    return (codec.page_nbytes(pg), F.page_checksums(pg), codec.page_tags(pg),
            msizes)


def _fill_warm_scratch(kscr, vscr, kcan, vcan, pools, wpt, wlen, *,
                       codec: codecs.PageCodec) -> None:
    """Decompress cached prefix pages into the scratch warm regions.

    kscr/vscr/kcan/vcan [L, R, T, K, D], written in place (the JAX step
    donates them); wpt i64 [L, R, WP] per-layer pool ids of each row's
    cached chain (0-padded); wlen [R] cached token count (page-aligned).
    The values are what decode-side attention reads for those pages —
    canonical by construction — so both the exact scratch and the
    canonical view receive them, and ``canonical_update`` never
    re-compresses the warm region (its windows start at or after the hit
    boundary).  A lossless codec's canonical view is zero-length: only
    the exact scratch is filled.
    """
    lyr, r, _, kvh, dh = kscr.shape
    wp = wpt.shape[2]
    for li in range(lyr):
        pools_l = tree_map(lambda a: a[li], pools)
        kw, vw = codec.decompress_pages(
            tree_map(lambda a: a[wpt[li]], pools_l))   # [R, WP, K, pg, D]
        n = wp * kw.shape[3]
        m = (torch.arange(n, device=kscr.device)[None, :]
             < wlen[:, None])[:, :, None, None]        # [R, WP*pg, 1, 1]
        bufs = [(kscr, kw), (vscr, vw)]
        if not codec.lossless:
            bufs += [(kcan, kw), (vcan, vw)]
        for buf, warm in bufs:
            warm = warm.movedim(2, 3).reshape(r, n, kvh, dh)
            buf[li, :, :n] = torch.where(m, warm, buf[li, :, :n])


def _to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Copy tensors to host numpy arrays through one byte buffer: a single
    device-to-host copy however many there are."""
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(flat[off:off + n].view(dt).reshape(tuple(t.shape)))
        off += n
    return out


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class PagedKVEngine:
    """Greedy-decoding engine over a dense-GQA transformer.

    ``add_requests`` admits prompts and prefills them; ``decode_batch``
    decodes one token for every active sequence; ``mixed_step`` does both
    in one iteration (what ``serving/scheduler.py`` drives).  Runs on the
    card unless ``device="cpu"``.
    """

    # the JAX engine's counters
    _STAT_KEYS = ("pages_compressed", "pages_evicted", "bytes_raw",
                  "bytes_compressed", "preemptions",
                  "prefix_pages_evicted", "shed_inserts",
                  "integrity_failures")

    def __init__(self, cfg: ArchConfig, params: dict, *, page_size: int = 16,
                 n_pool_pages: int = 256, max_batch: int = 32,
                 prefill_chunk: int | None = None,
                 prefix_cache: PrefixCache | None = None,
                 codec: str | codecs.PageCodec | None = None,
                 faults: F.FaultInjector | None = None,
                 integrity: bool = True,
                 telemetry: Telemetry | None = None,
                 tier: T.TieredPageStore | None = None,
                 cache_decode_pages: bool = False,
                 observatory=None,
                 device: str | torch.device | None = None):
        if (cfg.attn_kind != "gqa" or cfg.is_moe or cfg.is_encdec
                or cfg.family in ("ssm", "hybrid")):
            # its layers run the dense MLP over GQA pages (as the JAX
            # engine's): serve MoE and MLA through launch/serve's dense path
            raise ValueError(f"{cfg.name}: the paged engine serves dense "
                             "GQA only (no MoE, MLA or recurrent layers)")
        if prefix_cache is not None and (
                prefix_cache.page != page_size
                or prefix_cache.n_layers != cfg.n_layers):
            raise ValueError("prefix cache shape disagrees with the engine")
        self.device = resolve_device(device)
        self.codec = codecs.resolve(codec)
        self.cfg = cfg
        self.params = to_device(params, self.device)
        self._layers = [layer(self.params["blocks"], li)
                        for li in range(cfg.n_layers)]
        self.page = page_size
        self.max_batch = max_batch
        self.n_pool_pages = n_pool_pages
        self.prefix_cache = prefix_cache
        # chunked-prefill step width; page-aligned so every chunk
        # completes whole pages
        self.prefill_chunk = (2 * page_size if prefill_chunk is None
                              else prefill_chunk)
        if self.prefill_chunk % page_size:
            raise ValueError(f"prefill_chunk {self.prefill_chunk} is not a "
                             f"multiple of page_size {page_size}")
        lyr, k, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        self.pools = self.codec.init_pools(lyr, n_pool_pages, k, page_size,
                                           dh, self.device)
        self.tail_k = torch.zeros((lyr, max_batch, k, page_size, dh),
                                  dtype=torch.float32, device=self.device)
        self.tail_v = torch.zeros_like(self.tail_k)
        # pool id 0 is the padding target of padded page tables
        self.free: list[int] = list(range(n_pool_pages - 1, 0, -1))
        self.page_bytes = np.zeros(n_pool_pages, np.int64)
        # publish-time page checksums (faults.page_checksums)
        self.page_checksum = np.zeros(n_pool_pages, np.uint32)
        # per-page codec tags: 0 for a single codec, the winning member
        # id under ``adaptive``
        self.page_codec_id = np.zeros(n_pool_pages, np.int32)
        self.integrity = integrity
        self.faults = faults
        # degradation-ladder level 1 (set by the scheduler): drop
        # speculative prefix-cache insertions while the pool is under
        # pressure
        self.shed_cache_inserts = False
        self.seqs: dict[int, Sequence] = {}
        # cumulative published [raw, compressed] bytes per request
        # (survives release)
        self.request_bytes: dict[int, list[int]] = {}
        self._free_slots = list(range(max_batch - 1, -1, -1))
        self._pmax = 8
        self._pt_dev: torch.Tensor | None = None
        self._pt_dirty = True
        self._cohort: _Cohort | None = None
        # registry-backed counters behind ``stats``, shareable with the
        # scheduler through one Telemetry
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._init_metrics()
        if faults is not None:
            faults.telemetry = self.telemetry
        if prefix_cache is not None:
            prefix_cache.telemetry = self.telemetry
        # logits [S, V] of the last decode step (greedy-parity tie reports)
        self.last_logits: torch.Tensor | None = None
        # opt-in hierarchy observatory (serving/observatory.py); None keeps
        # every hook a single attribute check
        self.obs = observatory
        if observatory is not None:
            observatory.bind_engine(self)
        # optional host/disk tier.  Decode-page caching is opt-in: decode
        # and prefill may differ at ULP level on the same prefix, so the
        # warm == cold equalities keep it off by default
        self.tier: T.TieredPageStore | None = None
        self.cache_decode_pages = cache_decode_pages
        self._h_promote = None
        if tier is not None:
            self.attach_tier(tier)

    def _init_metrics(self) -> None:
        reg = self.telemetry.registry
        cn = self.codec.name
        self._m = {k: reg.counter(f"engine_{k}_total", codec=cn)
                   for k in self._STAT_KEYS}
        self._g_pool_used = reg.gauge(
            "engine_pool_used_pages", "mapped pool pages (id 0 excluded)")
        self._g_free = reg.gauge(
            "engine_free_list_depth", "pages on the free list")
        self._g_pressure = reg.gauge(
            "engine_pool_pressure", "non-reclaimable pool fraction [0,1]")
        # per-codec publish series: under the adaptive composite each
        # page's winning member is its tag, so the series split by member
        members = getattr(self.codec, "members", None)
        self._tag_names = ([m.name for m in members] if members else [cn])
        self._tag_metrics: dict[int, tuple] = {}

    def _publish_metrics(self, tag: int):
        tm = self._tag_metrics.get(tag)
        if tm is None:
            reg = self.telemetry.registry
            name = (self._tag_names[tag] if tag < len(self._tag_names)
                    else str(tag))
            tm = self._tag_metrics[tag] = (
                reg.counter("engine_pages_by_codec_total",
                            "published pages by winning codec",
                            codec=name),
                reg.counter("engine_compressed_bytes_by_codec_total",
                            "compressed bytes by winning codec",
                            codec=name),
                reg.histogram("engine_page_compressed_bytes",
                              "per-page compressed size", codec=name),
                reg.histogram("engine_page_compression_ratio",
                              "per-page raw/compressed ratio",
                              codec=name))
        return tm

    @property
    def stats(self) -> dict:
        """The eight counters of ``_STAT_KEYS``, read from the registry."""
        return {k: m.value for k, m in self._m.items()}

    def load_stats_dict(self, s: dict) -> None:
        """Restore counters from a stats dict."""
        for k, m in self._m.items():
            if k in s:
                m.value = s[k]

    def sample_gauges(self) -> None:
        """Refresh the pool-occupancy gauges (called before an export)."""
        self._g_pool_used.set(self.pool_used_pages())
        self._g_free.set(len(self.free))
        self._g_pressure.set(round(self.pool_pressure(), 6))
        if self.prefix_cache is not None:
            self.prefix_cache.sample_metrics()
        if self.faults is not None:
            self.faults.sample_metrics()
        if self.obs is not None:
            self.obs.sample_gauges()
        if self.tier is not None:
            self.tier.sample_metrics()

    # -- pool bookkeeping ----------------------------------------------------

    def page_raw_bytes(self) -> int:
        c = self.cfg
        return 2 * self.page * c.n_kv_heads * c.head_dim * 2   # K+V bf16

    def pool_pressure(self) -> float:
        """Non-reclaimable pool fraction in [0, 1]: pages neither free nor
        held only by the prefix cache (refcount-0 entries free without
        preempting anyone).  The degradation ladder's input."""
        reclaimable = len(self.free)
        if self.prefix_cache is not None:
            reclaimable += self.prefix_cache.retained_pages()
        return max(0.0, 1.0 - reclaimable / (self.n_pool_pages - 1))

    def _reserve_pages(self, n: int) -> list[int]:
        """Reclaim order: the free list, then retained prefix-cache
        entries (SIP victims), then CAMP preemption of the least valuable
        live sequence (which unpins its chain, possibly feeding the next
        round of cache eviction)."""
        while len(self.free) < n:
            if not self._evict_prefix_pages(n - len(self.free)):
                self._preempt_one()
        return [self.free.pop() for _ in range(n)]

    def _evict_prefix_pages(self, need: int) -> bool:
        if self.prefix_cache is None:
            return False
        pids = self.prefix_cache.evict_for(need)
        if not pids:
            return False
        self.free.extend(pids)
        if self.obs is not None:
            self.obs.on_release(pids)
        self._m["prefix_pages_evicted"].inc(len(pids))
        return True

    def _seq_reclaimable_bytes(self, seq: Sequence) -> int:
        """Compressed bytes preempting this sequence would make evictable:
        its private pages, plus the shared entries it alone pins."""
        ns = len(seq.chain)
        size = sum(int(self.page_bytes[p])
                   for lp in seq.pages for p in lp[ns:])
        for eid in seq.chain:
            e = self.prefix_cache.entries[eid]
            if e.refcount == 1:
                size += e.nbytes
        return size

    def _seq_value(self, seq: Sequence) -> float:
        """CAMP/MVE value: reuse proxy / reclaimable compressed size
        (smaller = victim); a finished sequence is worth -1."""
        if seq.done:
            return -1.0
        return ((len(seq.tokens) + 1)
                / max(self._seq_reclaimable_bytes(seq), 1))

    def _drop_seq_pages(self, seq: Sequence, *, count_evicted: bool) -> None:
        """Free the private pages and unpin the shared chain (cache-owned
        pages stay resident; refcount-0 entries become evictable)."""
        ns = len(seq.chain)
        for lp in seq.pages:
            self.free.extend(lp[ns:])
            if self.obs is not None:
                self.obs.on_release(lp[ns:])
            if count_evicted:
                self._m["pages_evicted"].inc(len(lp) - ns)
        if seq.chain:
            self.prefix_cache.release(seq.chain)
            seq.chain = []
        seq.pages = [[] for _ in range(self.cfg.n_layers)]

    def _preempt_one(self) -> None:
        cands = [s for s in self.seqs.values() if any(s.pages)]
        if not cands:
            raise F.PoolExhaustedError(
                f"pool exhausted with nothing evictable "
                f"({self.n_pool_pages - 1} pages, {len(self.free)} free)")
        victim = min(cands, key=self._seq_value)   # first minimum
        if self.obs is not None:
            rb = self._seq_reclaimable_bytes(victim)
            self.obs.audit.record(
                "camp_preempt", sid=victim.sid,
                value=self._seq_value(victim), reclaimable_bytes=rb,
                pow2_bucket=_pow2_bucket(max(rb, 1)),
                tokens=len(victim.tokens), pins=len(victim.chain),
                candidates=len(cands))
        # verify the victim before its pages drop: a requeue absorbs its
        # generated tokens into the prompt, so corruption must be flagged
        # here (a check only where faults can occur)
        if self.integrity and self.faults is not None \
                and not F.verify_seq(self, victim.sid):
            self._m["integrity_failures"].inc()
        self._drop_seq_pages(victim, count_evicted=True)
        victim.tail_len = 0
        victim.preempted = True
        self._pt_dirty = True
        self._m["preemptions"].inc()

    def _record_publish(self, seq: Sequence, pids: list[int],
                        nbytes: np.ndarray, csums: np.ndarray,
                        tags: np.ndarray,
                        msizes: np.ndarray | None = None) -> None:
        """Attach freshly published pages (one per layer) to a sequence.
        ``msizes`` [n_members, L]: each member's would-be page bytes
        (observatory-on adaptive publishes only)."""
        raw = self.page_raw_bytes()
        for li, pid in enumerate(pids):
            nb, tag = int(nbytes[li]), int(tags[li])
            self.page_bytes[pid] = nb
            self.page_checksum[pid] = csums[li]
            self.page_codec_id[pid] = tag
            seq.pages[li].append(pid)
            pages_c, bytes_c, h_bytes, h_ratio = self._publish_metrics(tag)
            pages_c.inc()
            bytes_c.inc(nb)
            h_bytes.observe(nb)
            h_ratio.observe(raw / max(nb, 1))
            if self.obs is not None:
                name = (self._tag_names[tag] if tag < len(self._tag_names)
                        else str(tag))
                wb = (None if msizes is None else
                      {self._tag_names[k]: int(msizes[k][li])
                       for k in range(msizes.shape[0])})
                self.obs.on_publish(pid, nb, name, wb)
        self._m["pages_compressed"].inc(len(pids))
        self._m["bytes_raw"].inc(raw * len(pids))
        self._m["bytes_compressed"].inc(int(nbytes.sum()))
        rb = self.request_bytes.setdefault(seq.sid, [0, 0])
        rb[0] += raw * len(pids)
        rb[1] += int(nbytes.sum())
        self._pt_dirty = True

    # -- page table ----------------------------------------------------------

    def _page_table(self) -> torch.Tensor:
        """Padded device page table i32 [L, S, PMAX] (rebuilt when dirty)."""
        need = max((len(s.pages[0]) for s in self.seqs.values()), default=0)
        while self._pmax < need:
            self._pmax *= 2
            self._pt_dirty = True
        if self._pt_dirty or self._pt_dev is None:
            pt = np.zeros((self.cfg.n_layers, self.max_batch, self._pmax),
                          np.int32)
            for s in self.seqs.values():
                if s.pages[0]:
                    pt[:, s.slot, :len(s.pages[0])] = s.pages
            self._pt_dev = torch.from_numpy(pt).to(self.device)
            self._pt_dirty = False
        return self._pt_dev

    # -- request lifecycle ---------------------------------------------------

    def release(self, sid: int) -> None:
        """Retire a request: free its private pool pages, unpin its shared
        prefix chain (those pages stay cache-retained for the next request
        that shares the prefix) and recycle its slot."""
        seq = self.seqs[sid]
        if seq.prefilling and not seq.preempted:
            raise ValueError(f"sid {sid} is mid-prefill; cannot release")
        del self.seqs[sid]
        if (self.tier is not None and self.cache_decode_pages
                and not seq.preempted and not seq.corrupted):
            # decode-produced pages become demotable too (the multi-turn
            # chat path); the tier holds copies, the pages free below
            self._demote_decode_pages(seq)
        self._drop_seq_pages(seq, count_evicted=False)
        if self.prefix_cache is not None:
            # quarantined entries free once their last pin drops
            purged = self.prefix_cache.purge_corrupt()
            self.free.extend(purged)
            if self.obs is not None:
                self.obs.on_release(purged)
        if self.obs is not None:
            self.obs.on_retire(sid)
        self._free_slots.append(seq.slot)
        self._pt_dirty = True

    def abort(self, sid: int) -> None:
        """Abandon a request mid-flight (deadline miss): drop its pages and
        mark it preempted, so ``release`` accepts it even mid-prefill —
        its cohort row keeps computing masked values that are never
        published, as for a CAMP victim, without the preemption count."""
        seq = self.seqs[sid]
        if seq.preempted:
            return
        self._drop_seq_pages(seq, count_evicted=False)
        seq.tail_len = 0
        seq.preempted = True
        self._pt_dirty = True
        self._maybe_drop_cohort()

    # -- host/disk tier (serving/tier.py) ------------------------------------

    def attach_tier(self, tier: T.TieredPageStore) -> None:
        """Attach a host/disk tier: SIP eviction victims demote into it
        (compressed bytes, codec tags and publish-time checksums intact)
        and warm lookups that miss the device pool promote out of it."""
        if self.prefix_cache is None:
            raise ValueError("a tier needs a prefix cache to demote from")
        if (tier.page != self.page or tier.n_layers != self.cfg.n_layers
                or tier.codec_name != self.codec.name):
            raise ValueError("tier layout disagrees with the engine")
        self.tier = tier
        if tier.telemetry is None:
            tier.telemetry = self.telemetry
        if tier.observatory is None:
            tier.observatory = self.obs
        self._h_promote = self.telemetry.registry.histogram(
            "tier_promotion_seconds",
            "wall time to promote a warm chain from the tier",
            codec=self.codec.name)
        self.prefix_cache.demote_cb = self._demote_entry

    def _entry_parent_digest(self, e) -> str:
        """Digest of the token prefix before entry ``e``, from its resident
        ancestors (eviction is leaf-first, so they are all resident)."""
        anc = []
        pid = e.parent
        while pid:
            pe = self.prefix_cache.entries[pid]
            anc.append(pe)
            pid = pe.parent
        digest = T.ROOT
        for pe in reversed(anc):
            digest = T.child_digest(digest, pe.toks)
        return digest

    def _demote_pages(self, parent: str, toks: tuple[int, ...],
                      pids: list[int], *, hits: int = 0,
                      source: str = "prompt") -> None:
        """Gather one page boundary's ``[L]`` pages out of every pool leaf
        and hand them to the tier with their publish metadata: one copy to
        the host a demotion, off the decode path."""
        lidx = torch.arange(len(pids), device=self.device)
        pidx = torch.tensor(pids, dtype=torch.long, device=self.device)
        leaves = _to_host([lf[lidx, pidx] for lf in tree_leaves(self.pools)])
        self.tier.demote(parent, toks, leaves,
                         [int(self.page_bytes[p]) for p in pids],
                         [int(self.page_codec_id[p]) for p in pids],
                         [int(self.page_checksum[p]) for p in pids],
                         hits=hits, source=source)

    def _demote_entry(self, e) -> None:
        """``PrefixCache.demote_cb``: capture an eviction victim's pages
        before they drop.  Bytes corrupted since publish travel with their
        original checksum, so promotion quarantines them."""
        self._demote_pages(self._entry_parent_digest(e), e.toks,
                           list(e.pages), hits=e.hits)

    def _demote_decode_pages(self, seq: Sequence) -> None:
        """Retirement hook (``cache_decode_pages``): demote the sequence's
        private full pages — decode-produced and any shed prompt pages —
        keyed by the token prefix they cover, so a follow-up turn that
        replays this exchange promotes instead of recomputing."""
        page, lyr = self.page, self.cfg.n_layers
        ns = len(seq.chain)
        digest = T.ROOT
        for blk in range(len(seq.pages[0])):
            toks = tuple(seq.tokens[blk * page:(blk + 1) * page])
            if blk >= ns:
                self._demote_pages(digest, toks,
                                   [seq.pages[li][blk] for li in range(lyr)],
                                   source="decode")
            digest = T.child_digest(digest, toks)

    def _promote_from_tier(self, prompt: list[int], start: int,
                           chain: list[int]) -> tuple[int, list[int]]:
        """Extend a warm hit past the device pool from the tier.

        Walks the tier trie from the first block the device did not hit,
        verifies each record host-side (a corrupt one is quarantined and
        ends the walk: a shorter hit, never bad bytes), scatters the
        verified run into freshly reserved pool pages with one indexed
        write per pool leaf (rows padded to a power of two and aimed at
        page 0, as in JAX), and inserts each block into the prefix cache,
        pinned, in chain order.  Returns the extended ``(start, chain)``.
        """
        tier, cache, page = self.tier, self.prefix_cache, self.page
        lyr = self.cfg.n_layers
        recs = tier.lookup(prompt)
        b = start // page
        if len(recs) <= b:
            return start, chain
        t0 = time.perf_counter()
        stored, promoted = len(prompt) - 1, 0
        picked: list = []
        while (b + len(picked) < len(recs)
               and (b + len(picked) + 1) * page <= stored):
            rec = recs[b + len(picked)]
            lo = (b + len(picked)) * page
            if rec.toks != tuple(prompt[lo:lo + page]):
                break                      # a digest collision
            leaves, ok = tier.read_record(rec)
            if not ok:
                self._m["integrity_failures"].inc()
                break
            picked.append((rec, leaves))
        if not picked:
            return start, chain
        pids = [self._reserve_pages(lyr) for _ in picked]
        pad = 1 << (len(picked) - 1).bit_length()
        rows = torch.tensor(pids + [[0] * lyr] * (pad - len(picked)),
                            dtype=torch.long, device=self.device)
        lidx = torch.arange(lyr, device=self.device)[None, :]
        for i, pool in enumerate(tree_leaves(self.pools)):
            vals = np.stack([lv[i] for _, lv in picked]
                            + [picked[0][1][i]] * (pad - len(picked)))
            pool[lidx, rows] = torch.from_numpy(vals).to(self.device)
        for idx, ((rec, _), bpids) in enumerate(zip(picked, pids)):
            for li, pid in enumerate(bpids):
                self.page_bytes[pid] = rec.nbytes[li]
                self.page_checksum[pid] = rec.checksums[li]
                self.page_codec_id[pid] = rec.codec_ids[li]
            eid, created = cache.insert(
                chain[-1] if chain else 0, rec.toks, bpids,
                sum(rec.nbytes), codec_ids=list(rec.codec_ids))
            displaced = cache.drain_displaced()   # healed-over pages
            self.free.extend(displaced)
            if self.obs is not None:
                self.obs.on_release(displaced)
            if eid is None:        # pinned corrupt twin: cannot map
                for later in pids[idx:]:   # scattered but unmapped
                    self.free.extend(later)
                break
            if not created:        # a clean twin is resident: share it
                self.free.extend(bpids)
            cache.pin([eid])
            chain.append(eid)
            tier.on_promoted(rec)
            promoted += 1
            b += 1
        if promoted:
            self._pt_dirty = True
            self._h_promote.observe(time.perf_counter() - t0)
            if self.telemetry.tracer.enabled:
                self.telemetry.tracer.event(-1, "tier_promote",
                                            blocks=promoted)
        return b * page, chain

    def recycle_device_pool(self) -> int:
        """Drop every retained prefix entry (demoting through the tier when
        one is attached) and return their pages to the free list: the
        multi-turn scenario's reset between turns.  Needs an idle engine.
        Returns the number of pages freed."""
        if self.seqs or self._cohort is not None:
            raise RuntimeError("recycle_device_pool with work in flight")
        before = len(self.free)
        while (self.prefix_cache is not None and self.prefix_cache.entries
               and self._evict_prefix_pages(self.n_pool_pages)):
            pass
        return len(self.free) - before

    # -- integrity / invariants ---------------------------------------------

    def verify_seq(self, sid: int) -> bool:
        """Recompute checksums of every pool page the sequence maps;
        quarantines corrupt shared entries (``faults.verify_seq``)."""
        return F.verify_seq(self, sid)

    def debug_validate(self) -> None:
        """Assert page/refcount/slot accounting is exact
        (``faults.debug_validate``)."""
        F.debug_validate(self)

    def add_request(self, sid: int, prompt: list[int]) -> None:
        self.add_requests({sid: prompt})

    def add_requests(self, prompts: dict[int, list[int]]) -> dict[int, int]:
        """Admit a batch of prompts and prefill them to completion (one
        cohort, full-width chunks).  Returns ``{sid: cached_tokens}``."""
        cached = self.begin_cohort(prompts)
        while self._cohort is not None:
            self.mixed_step(decode_sids=[], pf_tokens=self.prefill_chunk)
        return cached

    def begin_cohort(self, prompts: dict[int, list[int]]) -> dict[int, int]:
        """Admit prompts into a chunked-prefill cohort without running it.

        With a prefix cache, each prompt's longest cached page-boundary
        prefix is looked up, pinned and mapped into the new sequence's
        page table, and the member starts prefill at the first uncached
        boundary (a full hit skips prefill and is decodable at once).
        Returns ``{sid: cached_tokens}``.  Allocates batch slots and the
        cohort's scratch; no model compute happens until
        :meth:`mixed_step` gets a nonzero ``pf_tokens``.  The whole batch
        is validated before any state changes.
        """
        self._maybe_drop_cohort()
        if self._cohort is not None:
            raise RuntimeError("a prefill cohort is already in flight")
        if len(prompts) > len(self._free_slots):
            raise RuntimeError("engine at max_batch capacity")
        for sid, prompt in prompts.items():
            if sid in self.seqs:
                raise ValueError(f"sid {sid} is already admitted")
            if not prompt:
                raise ValueError(f"empty prompt for sid {sid}")
        cached: dict[int, int] = {}
        if not prompts:
            return cached
        cfg, chunk, page = self.cfg, self.prefill_chunk, self.page
        lyr, kvh, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        seqs, starts = [], []
        for sid, prompt in prompts.items():
            start, chain = 0, []
            if self.prefix_cache is not None:
                start, chain = self.prefix_cache.lookup(prompt)
                if self.integrity:
                    # warm-hit trust boundary: a corrupt entry truncates
                    # the hit, and the request recomputes from there
                    vstart, chain = F.verified_prefix(self, start, chain)
                    if vstart != start:
                        self._m["integrity_failures"].inc()
                        if self.telemetry.tracer.enabled:
                            self.telemetry.tracer.event(
                                sid, "hit_truncated", hit=start,
                                verified=vstart)
                        start = vstart
                self.prefix_cache.pin(chain)
                if self.tier is not None:
                    # the device chain is pinned first, so promotion's
                    # reservations cannot evict the chain it extends
                    start, chain = self._promote_from_tier(prompt, start,
                                                           chain)
            ent = [self.prefix_cache.entries[e] for e in chain]
            seq = Sequence(sid=sid, slot=self._free_slots.pop(),
                           tokens=list(prompt),
                           pages=[[e.pages[li] for e in ent]
                                  for li in range(lyr)],
                           chain=list(chain), prefilling=True)
            self.seqs[sid] = seq
            cached[sid] = start
            if self.obs is not None:
                # counterfactual access stream: one key per full prompt
                # block whatever the real lookup found; the warm chain's
                # pages score real reuse accesses
                self.obs.on_admit(sid, prompt, (len(prompt) - 1) // page,
                                  [pid for e in ent for pid in e.pages])
            if start >= len(prompt) - 1:
                # every stored token is already paged in (or there is
                # none): straight to decode, with an empty tail
                seq.prefilling = False
                continue
            seqs.append(seq)
            starts.append(start)
        self._pt_dirty = True
        if not seqs:
            return cached
        # the grid covers *stored* positions only (prompt minus the last
        # token, whose K/V the first decode step computes into the tail)
        maxstored = max(len(s.tokens) - 1 for s in seqs)
        maxrel = max(len(s.tokens) - 1 - st for s, st in zip(seqs, starts))
        # scratch length: one chunk of headroom past the longest stored
        # prefix, rounded up to a power-of-two chunk count
        n_chunks = -(-maxstored // chunk) + 1
        cap = 1
        while cap < n_chunks:
            cap *= 2
        tmax = cap * chunk
        # scratch rows: the admitted prompts, rounded up to a power of
        # two, capped at max_batch; ``row`` maps a sequence to its row
        nrows = 1
        while nrows < len(seqs):
            nrows *= 2
        nrows = min(nrows, self.max_batch)
        row = {s.sid: r for r, s in enumerate(seqs)}
        toks = np.zeros((nrows, tmax), np.int32)
        for s in seqs:
            toks[row[s.sid], :len(s.tokens)] = s.tokens

        def scratch(t):
            return torch.zeros((lyr, nrows, t, kvh, dh),
                               dtype=torch.float32, device=self.device)

        # a lossless codec's prefill never reads the canonical view
        can_t = 0 if self.codec.lossless else tmax
        co = _Cohort(seqs=seqs, row=row, toks=toks, kscr=scratch(tmax),
                     vscr=scratch(tmax), kcan=scratch(can_t),
                     vcan=scratch(can_t), starts=starts, maxrel=maxrel,
                     pub=[st // page for st in starts], done_sids=set())
        if any(starts):
            # each warm row's cached chain, decompressed into its scratch
            # prefix; WP rounds up to a power of two (the JAX engine's
            # retrace bound), capped at the scratch's page count
            wp = 1
            while wp < max(starts) // page:
                wp *= 2
            wp = min(wp, tmax // page)
            wpt = np.zeros((lyr, nrows, wp), np.int64)
            wlen = np.zeros(nrows, np.int64)
            for s, st in zip(seqs, starts):
                wlen[row[s.sid]] = st
                for li in range(lyr):
                    wpt[li, row[s.sid], :st // page] = s.pages[li][:st // page]
            _fill_warm_scratch(co.kscr, co.vscr, co.kcan, co.vcan,
                               self.pools,
                               torch.from_numpy(wpt).to(self.device),
                               torch.from_numpy(wlen).to(self.device),
                               codec=self.codec)
        self._cohort = co
        return cached

    def _maybe_drop_cohort(self) -> None:
        """Retire the cohort once no live member still needs it (a
        preempted member never completes its grid)."""
        co = self._cohort
        if co is not None and all(s.sid in co.done_sids or s.preempted
                                  for s in co.seqs):
            for s in co.seqs:
                s.prefilling = False
            self._cohort = None

    def _advance_cohort(self, n: int) -> list[int]:
        """Bookkeeping after an ``n``-token chunk: publish every page the
        chunk completed, move finished members' last partial page into
        their tail slots, retire the cohort when the grid drains.
        Returns the sids whose prefill completed."""
        co, page = self._cohort, self.page
        new_roff = min(co.roff + n, co.maxrel)
        entries = []
        for i, s in enumerate(co.seqs):
            upto = min(co.starts[i] + new_roff, len(s.tokens) - 1) // page
            entries.extend((s, blk) for blk in range(co.pub[i], upto))
            co.pub[i] = max(co.pub[i], upto)
        if entries:
            rows = torch.tensor([co.row[s.sid] for s, _ in entries],
                                device=self.device)
            blks = torch.tensor([b for _, b in entries], device=self.device)
            kb, vb = _scratch_blocks(co.kscr, co.vscr, rows, blks, page)
            shape = (-1,) + tuple(kb.shape[2:])        # layer-major blocks
            self._publish(kb.reshape(shape), vb.reshape(shape),
                          [s for s, _ in entries],
                          blocks=[b for _, b in entries])
        completed, tails = [], []
        for i, s in enumerate(co.seqs):
            stored = len(s.tokens) - 1
            if s.sid in co.done_sids or co.starts[i] + new_roff < stored:
                continue
            co.done_sids.add(s.sid)
            s.prefilling = False
            # final partial page -> decode tail (exact f32, like the pages)
            s.tail_len = 0 if s.preempted else stored % page
            if s.tail_len:
                tails.append((s, stored // page))
            completed.append(s.sid)
        if tails:
            rows = torch.tensor([co.row[s.sid] for s, _ in tails],
                                device=self.device)
            slots = torch.tensor([s.slot for s, _ in tails],
                                 device=self.device)
            blks = torch.tensor([b for _, b in tails], device=self.device)
            kb, vb = _scratch_blocks(co.kscr, co.vscr, rows, blks, page)
            # in place: the JAX step donates the tail buffers
            self.tail_k[:, slots] = kb
            self.tail_v[:, slots] = vb
        co.roff = new_roff
        if new_roff >= co.maxrel:
            self._cohort = None
        return completed

    def _publish(self, k_blocks, v_blocks, seqs: list[Sequence],
                 blocks: list[int] | None = None) -> None:
        """Publish len(seqs) filled pages per layer in one step.

        Blocks are layer-major [L * len(seqs), K, page, D], the order of
        ``seqs`` repeating inside each layer group.  ``blocks[j]`` is the
        page index of a *prompt* page (None for decode tails): those
        register in the prefix cache.  Pages of a sequence already
        preempted, or preempted by this very reservation, go straight
        back to the free list.
        """
        lyr, m_all = self.cfg.n_layers, len(seqs)
        keep = [j for j, s in enumerate(seqs) if not s.preempted]
        if not keep:
            return
        if len(keep) != m_all:
            sel = torch.tensor([li * m_all + j for li in range(lyr)
                                for j in keep], device=self.device)
            k_blocks, v_blocks = k_blocks[sel], v_blocks[sel]
            seqs = [seqs[j] for j in keep]
            if blocks is not None:
                blocks = [blocks[j] for j in keep]
        m = len(seqs)
        pids = self._reserve_pages(lyr * m)
        layer_idx = torch.from_numpy(np.repeat(np.arange(lyr), m)).to(
            self.device)
        # observatory + composite codec: every member's would-be page
        # size rides the same host copy (what-if codec sampling)
        want_members = (self.obs is not None
                        and getattr(self.codec, "members", None) is not None)
        nbytes, csums, tags, msizes = _publish_blocks(
            self.pools, k_blocks, v_blocks, layer_idx,
            torch.tensor(pids, device=self.device), codec=self.codec,
            member_sizes=want_members)
        rows = [nbytes.to(torch.int64)[None], csums[None],
                tags.to(torch.int64)[None]]
        if msizes is not None:
            rows.append(msizes)
        host = torch.cat(rows).cpu().numpy()                  # 1 sync
        nbytes, csums, tags = host[0], host[1].astype(np.uint32), host[2]
        msizes = host[3:] if msizes is not None else None
        for j, seq in enumerate(seqs):
            if seq.preempted:      # victim of our own reservation
                self.free.extend(pids[j::m])
                continue
            self._record_publish(seq, pids[j::m], nbytes[j::m], csums[j::m],
                                 tags[j::m],
                                 None if msizes is None else msizes[:, j::m])
            if blocks is not None and self.prefix_cache is not None:
                self._register_prompt_page(seq, blocks[j], pids[j::m],
                                           int(nbytes[j::m].sum()))
        if self.faults is not None:
            # corruption lands in the pool bytes after the checksums were
            # recorded, like bit rot after publish
            for j, seq in enumerate(seqs):
                if not seq.preempted:
                    for li, pid in enumerate(pids[j::m]):
                        self.faults.page_published(self, li, pid)

    def _register_prompt_page(self, seq: Sequence, blk: int,
                              pids: list[int], nbytes: int) -> None:
        """Attach a freshly published prompt page to the prefix cache."""
        page, cache = self.page, self.prefix_cache
        if self.shed_cache_inserts or blk != len(seq.chain):
            # ladder level 1 sheds speculative insertions (the page stays
            # private); once a block is shed the chain is broken, so
            # later blocks stay private even after pressure clears
            self._m["shed_inserts"].inc()
            return
        parent = seq.chain[-1] if seq.chain else 0
        toks = tuple(seq.tokens[blk * page:(blk + 1) * page])
        eid, created = cache.insert(
            parent, toks, pids, nbytes,
            codec_ids=[int(self.page_codec_id[p]) for p in pids])
        displaced = cache.drain_displaced()         # healed-over pages
        self.free.extend(displaced)
        if self.obs is not None:
            self.obs.on_release(displaced)
        if displaced and self.telemetry.tracer.enabled:
            self.telemetry.tracer.event(seq.sid, "cache_heal",
                                        pages=len(displaced))
        if eid is None:            # pinned corrupt twin: block stays private
            self._m["shed_inserts"].inc()
            return
        cache.pin([eid])
        seq.chain.append(eid)
        if created:
            if self.obs is not None:
                self.obs.on_cache_insert(seq.sid, blk, nbytes)
        else:
            # in-cohort dedup: map the first publisher's pages (the same
            # bits by the canonical-prefix contract) and free ours; undo
            # their publish accounting so each resident page counts once
            ent = cache.entries[eid]
            for li in range(self.cfg.n_layers):
                seq.pages[li][blk] = ent.pages[li]
            self.free.extend(pids)
            if self.obs is not None:
                self.obs.on_dedup(seq.sid, blk, nbytes, pids, ent.pages)
            self._pt_dirty = True
            lyr = self.cfg.n_layers
            self._m["pages_compressed"].inc(-lyr)
            self._m["bytes_raw"].inc(-self.page_raw_bytes() * lyr)
            self._m["bytes_compressed"].inc(-nbytes)

    # -- decode --------------------------------------------------------------

    def decode_batch(self, sids: list[int] | None = None) -> dict[int, int]:
        """Greedy-decode one token for every active (or given) sequence."""
        out, _ = self.mixed_step(decode_sids=sids, pf_tokens=0)
        return out

    def mixed_step(self, decode_sids: list[int] | None = None,
                   pf_tokens: int = 0) -> tuple[dict[int, int], list[int]]:
        """One iteration: a decode token for every given (default: every
        decodable) sequence AND up to ``pf_tokens`` prompt tokens (clamped
        to ``prefill_chunk``) for the in-flight cohort.

        Decode tail publishes land first, then the chunk's completed
        prompt pages, as in the JAX engine.  Returns ``(decoded {sid:
        next_token}, completed_prefill_sids)``.
        """
        if decode_sids is None:
            decode_sids = [s.sid for s in self.seqs.values()
                           if not (s.preempted or s.done or s.prefilling)]
        sids = [sid for sid in dict.fromkeys(decode_sids)  # dedup in order
                if not (self.seqs[sid].preempted or self.seqs[sid].done
                        or self.seqs[sid].prefilling)]
        co = self._cohort
        n = 0 if co is None else max(0, min(pf_tokens, self.prefill_chunk,
                                            co.maxrel - co.roff))
        out: dict[int, int] = {}
        if sids:
            nxt, self.last_logits = _decode_core(
                self._layers, self.params, self.pools, self.tail_k,
                self.tail_v, self._page_table(), *self._decode_inputs(sids),
                cfg=self.cfg, codec=self.codec)
        if n > 0:
            self._prefill_chunk(co, n)
        if sids:
            out = self._decode_post(sids, nxt.cpu().numpy())  # 1 sync/step
        completed = self._advance_cohort(n) if n > 0 else []
        # a decode-side publish may have preempted the cohort's last live
        # member this very step; don't leave a dead cohort in flight
        self._maybe_drop_cohort()
        return out, completed

    def _prefill_chunk(self, co: _Cohort, n: int) -> None:
        c = self.prefill_chunk
        nrows, tmax = co.toks.shape
        ptoks = np.zeros((nrows, c), np.int32)
        offs = np.zeros(nrows, np.int64)
        for i, s in enumerate(co.seqs):
            r = co.row[s.sid]
            # each row's absolute chunk start, clamped so the static-width
            # scratch write stays in bounds for rows already past their
            # stored length
            off = min(co.starts[i] + co.roff, tmax - c)
            offs[r] = off
            ptoks[r] = co.toks[r, off:off + c]
        # budget-split chunk: tokens past the valid width are zero padding,
        # rewritten by the next chunk before any valid query attends them
        ptoks[:, n:] = 0
        _prefill_core(self._layers, self.params,
                      torch.from_numpy(ptoks).to(self.device),
                      co.kscr, co.vscr, co.kcan, co.vcan,
                      torch.from_numpy(offs).to(self.device), cfg=self.cfg,
                      page=self.page, codec=self.codec)

    def _decode_inputs(self, sids: list[int]):
        """Pack the padded per-slot decode state for a step."""
        sb = self.max_batch
        state = np.zeros((4, sb), np.int32)  # page_cnt, last_tok, pos, tail
        active = np.zeros(sb, bool)
        for sid in sids:
            s = self.seqs[sid]
            active[s.slot] = True
            state[:, s.slot] = (len(s.pages[0]), s.tokens[-1],
                                len(s.tokens) - 1, s.tail_len)
        state = torch.from_numpy(state).to(self.device)
        return (state[0], state[1], state[2], state[3],
                torch.from_numpy(active).to(self.device))

    def _decode_post(self, sids: list[int], nxt: np.ndarray
                     ) -> dict[int, int]:
        """Append decoded tokens; publish every tail page that filled."""
        if self.faults is not None:
            nxt = self.faults.garble_tokens(
                nxt, [self.seqs[sid].slot for sid in sids])
        filled: list[Sequence] = []
        out: dict[int, int] = {}
        for sid in sids:
            s = self.seqs[sid]
            out[sid] = int(nxt[s.slot])
            s.tokens.append(out[sid])
            s.tail_len += 1
            if s.tail_len == self.page:
                filled.append(s)
                s.tail_len = 0
        if filled:
            slots = torch.tensor([s.slot for s in filled], device=self.device)
            kb, vb = self.tail_k[:, slots], self.tail_v[:, slots]
            shape = (-1,) + tuple(kb.shape[2:])        # layer-major blocks
            self._publish(kb.reshape(shape), vb.reshape(shape), filled)
        return out

    def decode_one(self, sid: int) -> int:
        """Greedy-decode one token for sequence ``sid``."""
        out = self.decode_batch([sid])
        if sid not in out:
            seq = self.seqs[sid]                   # KeyError for unknown sid
            state = ("preempted" if seq.preempted
                     else "prefilling" if seq.prefilling else "done")
            raise ValueError(f"sequence {sid} is {state}; cannot decode")
        return out[sid]

    # -- metrics -------------------------------------------------------------

    def compression_ratio(self) -> float:
        if not self._m["bytes_compressed"].value:
            return 1.0
        return self._m["bytes_raw"].value / self._m["bytes_compressed"].value

    def pool_used_pages(self) -> int:
        return (self.n_pool_pages - 1) - len(self.free)
