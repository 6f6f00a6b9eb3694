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

Where the JAX engine donates buffers to a jit, this engine updates the
same tensors in place (slice assignment / ``index_put_``), and says so
at each site.  ``lax.scan`` over layers is a Python loop over the
stacked ``[L, ...]`` parameters.  Host decisions are the JAX engine's,
step for step: the free list, CAMP victims, ``PMAX`` doubling, cohort
row and scratch rounding, and the publish order.

Not ported yet: the prefix cache, fault injection and integrity checks,
the host/disk tier, telemetry and the observatory.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import codecs
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels._device import resolve_device
from repro_torch.kernels.ref import softmax_attend
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.params import layer, to_device
from repro_torch.serving import faults as F
from repro_torch.serving._tree import tree_leaves, tree_map
from repro_torch.serving.prefix_cache import (canonical_update,
                                              prefix_chunk_attention)


@dataclass
class Sequence:
    sid: int
    slot: int                            # batch slot in the device state
    tokens: list[int]
    pages: list[list[int]]               # [L][n_pages] pool ids
    tail_len: int = 0
    done: bool = False
    preempted: bool = False
    prefilling: bool = False             # in-flight admission cohort member


@dataclass
class _Cohort:
    """In-flight chunked-prefill admission cohort.

    All members advance one shared chunk grid: each step moves the grid
    offset ``roff`` by up to ``prefill_chunk`` tokens.  ``toks`` is the
    host-side zero-padded prompt buffer; ``kscr/vscr`` the exact f32 K/V
    scratch and ``kcan/vcan`` its canonical view, all [L, nrows, tmax, K,
    D] on the device (the canonical view zero-length, T = 0, for a
    lossless codec); ``pub[i]`` counts pages already published for
    ``seqs[i]``; ``done_sids`` the members whose prefill completed.
    """
    seqs: list[Sequence]
    row: dict[int, int]                  # sid -> scratch row
    toks: np.ndarray                     # [nrows, tmax] i32, host
    kscr: torch.Tensor
    vscr: torch.Tensor
    kcan: torch.Tensor
    vcan: torch.Tensor
    maxrel: int                          # grid length: longest stored prompt
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
                    codec: codecs.PageCodec):
    """Compress [n, K, page, D] KV blocks and scatter them into the pools
    in place (``index_put_``; the JAX step donates the pools).  Returns
    the per-page compressed byte counts [n], checksums [n] and codec
    tags [n]."""
    pg = codec.compress_kv_pages(k_blocks, v_blocks)
    for pool, new in zip(tree_leaves(pools), tree_leaves(pg)):
        pool.index_put_((layer_idx, pids), new)
    return codec.page_nbytes(pg), F.page_checksums(pg), codec.page_tags(pg)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class PagedKVEngine:
    """Greedy-decoding engine over a dense-GQA transformer.

    ``add_requests`` admits prompts and prefills them; ``decode_batch``
    decodes one token for every active sequence; ``mixed_step`` does both
    in one iteration.  Runs on the card unless ``device="cpu"``.
    """

    # the JAX engine's counters; the last three stay 0 until the prefix
    # cache and the integrity checks are ported
    _STAT_KEYS = ("pages_compressed", "pages_evicted", "bytes_raw",
                  "bytes_compressed", "preemptions",
                  "prefix_pages_evicted", "shed_inserts",
                  "integrity_failures")

    def __init__(self, cfg: ArchConfig, params: dict, *, page_size: int = 16,
                 n_pool_pages: int = 256, max_batch: int = 32,
                 prefill_chunk: int | None = None,
                 codec: str | codecs.PageCodec | None = None,
                 device: str | torch.device | None = None):
        if cfg.attn_kind != "gqa" or cfg.is_encdec:
            raise ValueError(f"{cfg.name}: the engine serves dense GQA only")
        self.device = resolve_device(device)
        self.codec = codecs.resolve(codec)
        # on the card a fused codec decodes through the attention kernel:
        # refuse here a shape it does not take, not at the first step
        g = cfg.n_heads // cfg.n_kv_heads
        if (self.device.type == "cuda" and self.codec.has_fused_kernels
                and not PA.takes(g, cfg.head_dim, page_size)):
            raise ValueError(f"{cfg.name} under {self.codec.name}: " +
                             PA.refusal("paged_attention_tail", g,
                                        cfg.head_dim, page_size))
        self.cfg = cfg
        self.params = to_device(params, self.device)
        self._layers = [layer(self.params["blocks"], li)
                        for li in range(cfg.n_layers)]
        self.page = page_size
        self.max_batch = max_batch
        self.n_pool_pages = n_pool_pages
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
        self.seqs: dict[int, Sequence] = {}
        # cumulative published [raw, compressed] bytes per request
        # (survives release)
        self.request_bytes: dict[int, list[int]] = {}
        self._free_slots = list(range(max_batch - 1, -1, -1))
        self._pmax = 8
        self._pt_dev: torch.Tensor | None = None
        self._pt_dirty = True
        self._cohort: _Cohort | None = None
        self._stats = dict.fromkeys(self._STAT_KEYS, 0)
        # logits [S, V] of the last decode step (greedy-parity tie reports)
        self.last_logits: torch.Tensor | None = None

    @property
    def stats(self) -> dict:
        return dict(self._stats)

    # -- pool bookkeeping ----------------------------------------------------

    def page_raw_bytes(self) -> int:
        c = self.cfg
        return 2 * self.page * c.n_kv_heads * c.head_dim * 2   # K+V bf16

    def _reserve_pages(self, n: int) -> list[int]:
        while len(self.free) < n:
            self._preempt_one()
        return [self.free.pop() for _ in range(n)]

    def _seq_value(self, seq: Sequence) -> float:
        """CAMP/MVE value: reuse proxy / compressed size (smaller =
        victim); a finished sequence is worth -1."""
        if seq.done:
            return -1.0
        size = sum(int(self.page_bytes[p]) for lp in seq.pages for p in lp)
        return (len(seq.tokens) + 1) / max(size, 1)

    def _drop_seq_pages(self, seq: Sequence, *, count_evicted: bool) -> None:
        for lp in seq.pages:
            self.free.extend(lp)
            if count_evicted:
                self._stats["pages_evicted"] += len(lp)
        seq.pages = [[] for _ in range(self.cfg.n_layers)]

    def _preempt_one(self) -> None:
        cands = [s for s in self.seqs.values() if any(s.pages)]
        if not cands:
            raise F.PoolExhaustedError(
                f"pool exhausted with nothing evictable "
                f"({self.n_pool_pages - 1} pages, {len(self.free)} free)")
        victim = min(cands, key=self._seq_value)   # first minimum
        self._drop_seq_pages(victim, count_evicted=True)
        victim.tail_len = 0
        victim.preempted = True
        self._pt_dirty = True
        self._stats["preemptions"] += 1

    def _record_publish(self, seq: Sequence, pids: list[int],
                        nbytes: np.ndarray, csums: np.ndarray,
                        tags: np.ndarray) -> None:
        """Attach freshly published pages (one per layer) to a sequence."""
        for li, pid in enumerate(pids):
            self.page_bytes[pid] = int(nbytes[li])
            self.page_checksum[pid] = csums[li]
            self.page_codec_id[pid] = int(tags[li])
            seq.pages[li].append(pid)
        raw = self.page_raw_bytes() * len(pids)
        self._stats["pages_compressed"] += len(pids)
        self._stats["bytes_raw"] += raw
        self._stats["bytes_compressed"] += int(nbytes.sum())
        rb = self.request_bytes.setdefault(seq.sid, [0, 0])
        rb[0] += raw
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
        """Retire a request: free its pool pages and recycle its slot."""
        seq = self.seqs[sid]
        if seq.prefilling and not seq.preempted:
            raise ValueError(f"sid {sid} is mid-prefill; cannot release")
        del self.seqs[sid]
        self._drop_seq_pages(seq, count_evicted=False)
        self._free_slots.append(seq.slot)
        self._pt_dirty = True

    def add_request(self, sid: int, prompt: list[int]) -> None:
        self.add_requests({sid: prompt})

    def add_requests(self, prompts: dict[int, list[int]]) -> dict[int, int]:
        """Admit a batch of prompts and prefill them to completion (one
        cohort, full-width chunks).  Returns ``{sid: cached_tokens}``,
        all 0 until the prefix cache is ported."""
        cached = self.begin_cohort(prompts)
        while self._cohort is not None:
            self.mixed_step(decode_sids=[], pf_tokens=self.prefill_chunk)
        return cached

    def begin_cohort(self, prompts: dict[int, list[int]]) -> dict[int, int]:
        """Admit prompts into a chunked-prefill cohort without running it.

        Allocates batch slots and the cohort's scratch; no model compute
        happens until :meth:`mixed_step` gets a nonzero ``pf_tokens``.
        The whole batch is validated before any state changes.
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
        cfg, chunk = self.cfg, self.prefill_chunk
        lyr, kvh, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        seqs = []
        for sid, prompt in prompts.items():
            seq = Sequence(sid=sid, slot=self._free_slots.pop(),
                           tokens=list(prompt),
                           pages=[[] for _ in range(lyr)], prefilling=True)
            self.seqs[sid] = seq
            cached[sid] = 0
            if len(prompt) == 1:
                # nothing to store: the first decode step writes the only
                # token's K/V into the tail
                seq.prefilling = False
                continue
            seqs.append(seq)
        self._pt_dirty = True
        if not seqs:
            return cached
        # the grid covers *stored* positions only (prompt minus the last
        # token, whose K/V the first decode step computes into the tail)
        maxstored = max(len(s.tokens) - 1 for s in seqs)
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
        self._cohort = _Cohort(seqs=seqs, row=row, toks=toks,
                               kscr=scratch(tmax), vscr=scratch(tmax),
                               kcan=scratch(can_t), vcan=scratch(can_t),
                               maxrel=maxstored,
                               pub=[0] * len(seqs), done_sids=set())
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
            upto = min(new_roff, len(s.tokens) - 1) // page
            entries.extend((s, blk) for blk in range(co.pub[i], upto))
            co.pub[i] = max(co.pub[i], upto)
        if entries:
            rows = torch.tensor([co.row[s.sid] for s, _ in entries],
                                device=self.device)
            blks = torch.tensor([b for _, b in entries], device=self.device)
            kb, vb = _scratch_blocks(co.kscr, co.vscr, rows, blks, page)
            shape = (-1,) + tuple(kb.shape[2:])        # layer-major blocks
            self._publish(kb.reshape(shape), vb.reshape(shape),
                          [s for s, _ in entries])
        completed, tails = [], []
        for s in co.seqs:
            stored = len(s.tokens) - 1
            if s.sid in co.done_sids or new_roff < stored:
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

    def _publish(self, k_blocks, v_blocks, seqs: list[Sequence]) -> None:
        """Publish len(seqs) filled pages per layer in one step.

        Blocks are layer-major [L * len(seqs), K, page, D], the order of
        ``seqs`` repeating inside each layer group.  Pages of a sequence
        already preempted, or preempted by this very reservation, go
        straight back to the free list.
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
        m = len(seqs)
        pids = self._reserve_pages(lyr * m)
        layer_idx = torch.from_numpy(np.repeat(np.arange(lyr), m)).to(
            self.device)
        nbytes, csums, tags = _publish_blocks(
            self.pools, k_blocks, v_blocks, layer_idx,
            torch.tensor(pids, device=self.device), codec=self.codec)
        host = torch.stack([nbytes.to(torch.int64), csums,
                            tags.to(torch.int64)]).cpu().numpy()  # 1 sync
        nbytes, csums, tags = host[0], host[1].astype(np.uint32), host[2]
        for j, seq in enumerate(seqs):
            if seq.preempted:      # victim of our own reservation
                self.free.extend(pids[j::m])
                continue
            self._record_publish(seq, pids[j::m], nbytes[j::m], csums[j::m],
                                 tags[j::m])

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
        off = min(co.roff, tmax - c)
        for s in co.seqs:
            r = co.row[s.sid]
            # clamped so the static-width scratch write stays in bounds
            # for rows already past their stored length
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
        if not self._stats["bytes_compressed"]:
            return 1.0
        return self._stats["bytes_raw"] / self._stats["bytes_compressed"]

    def pool_used_pages(self) -> int:
        return (self.n_pool_pages - 1) - len(self.free)
