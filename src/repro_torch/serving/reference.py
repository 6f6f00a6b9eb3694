"""Reference serving engine: host-looped, one sequence / layer at a time
(port of ``repro/serving/reference.py``).

This is the behavioural oracle of the port: the batched engine
(``serving/engine.py``) must give the same greedy tokens, stats and
prefix-cache decisions as this implementation
(``tests/test_torch_reference.py``; ``chip_smoke.py`` on the card).  Do
not optimise this file — its value is being the slow, obviously correct
path.

  * KV pages are stored compressed through the same
    :class:`~repro_torch.codecs.PageCodec` the batched engine runs, in
    pools that stay on the host (CPU tensors, the JAX oracle's numpy
    pools); each page is compressed on the engine's device — on the card
    through the codec's kernels — and copied into the host pool, one
    page and one layer at a time (:meth:`_publish_page`);
  * page addressing is LCP: a page table per sequence maps page slots to
    pool ids;
  * the finite pool is managed CAMP-style: retained prefix-cache entries
    evict first (SIP ranking), then the least valuable sequence (reuse
    proxy / compressed size) is preempted;
  * prompt pages are shared across requests through the prefix cache
    (lookup/pin at admission, insert at publish, release at retirement),
    the protocol the batched engine speaks.

Prefill stores K/V for every prompt token but the last; the first decode
step computes the last prompt token's K/V into the tail.  Prefill
attention follows the canonical-prefix contract, and its numerics go
through the batched engine's chunk dispatch at one scratch row
(``engine._prefill_core``): the contract feeds quantised page values
back into prefill attention, so any float noise between two prefill
implementations would be amplified through the int8 quantiser into
token divergence.  The dispatch is bit-invariant to row count, scratch
length, chunk width and grid offsets
(``tests/test_torch_prefix_cache.py``), which is the property the oracle
exercises by replaying a different schedule shape.  Everything else —
paging, CAMP accounting, cache pin/insert/release, publishes into the
host pools, decode — is reimplemented here: decode runs one sequence
through every layer and attends densely in f32 over the decompressed
pages plus the exact tail (:meth:`_attend`).

The model math and every compress/decompress call run on ``device``
(the card unless the caller asks for the CPU; no fallback): a CUDA
tensor reaches the codec kernels, a CPU tensor their plain versions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import codecs
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.params import layer, to_device
from repro_torch.serving import engine as _E
from repro_torch.serving import faults as F
from repro_torch.serving._tree import tree_leaves, tree_map
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.telemetry import Telemetry


@dataclass
class Sequence:
    sid: int
    tokens: list[int]
    pages: list[list[int]]               # [L][n_pages] pool ids
    tail_k: torch.Tensor                 # [L, page, K, Dh] f32, on device
    tail_v: torch.Tensor
    tail_len: int = 0
    done: bool = False
    preempted: bool = False
    corrupted: bool = False              # failed a page-integrity check
    # chunked-prefill state (begin_request / prefill_advance)
    prefilling: bool = False
    pf_start: int = 0                    # prefix-cache hit boundary
    pf_pos: int = 0                      # prompt tokens processed so far
    pf_published: int = 0                # full pages published or mapped
    pf_k: torch.Tensor | None = None     # [L, 1, Tpad, K, Dh] f32 scratch
    pf_v: torch.Tensor | None = None
    pf_kc: torch.Tensor | None = None    # its canonical view (zero-length
    pf_vc: torch.Tensor | None = None    # for a lossless codec)
    # prefix-cache chain (entry ids, block order); pages[li][:len(chain)]
    # are shared, the rest private
    chain: list[int] = field(default_factory=list)


class ReferencePagedKVEngine:
    """Greedy-decoding engine over a dense-GQA transformer (oracle path).
    Runs on the card unless ``device="cpu"``; its pools stay on the host."""

    # the oracle carries neither an observatory nor a tier (read by the
    # shared ``sample_gauges`` and the scheduler)
    obs = None
    tier = None

    def __init__(self, cfg: ArchConfig, params: dict, *, page_size: int = 16,
                 n_pool_pages: int = 256,
                 prefix_cache: PrefixCache | None = None,
                 prefill_chunk: int | None = None,
                 codec: str | codecs.PageCodec | None = None,
                 faults: F.FaultInjector | None = None,
                 integrity: bool = True,
                 telemetry: Telemetry | None = None,
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
        self.cfg = cfg
        self.params = to_device(params, self.device)
        self._layers = [layer(self.params["blocks"], li)
                        for li in range(cfg.n_layers)]
        self.page = page_size
        self.n_pool_pages = n_pool_pages
        self.prefix_cache = prefix_cache
        self.codec = codecs.resolve(codec)
        # width of the shared prefill dispatch (bit-invariant to it)
        self.prefill_chunk = (2 * page_size if prefill_chunk is None
                              else prefill_chunk)
        if self.prefill_chunk % page_size:
            raise ValueError(f"prefill_chunk {self.prefill_chunk} is not a "
                             f"multiple of page_size {page_size}")
        lyr, k, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        # compressed page pools, the codec's tree with host leaves
        self.pools = self.codec.init_pools(lyr, n_pool_pages, k, page_size,
                                           dh, "cpu")
        self.free: list[int] = list(range(n_pool_pages - 1, 0, -1))
        self.page_bytes = np.zeros(n_pool_pages, np.int64)
        # publish-time checksums (faults.page_checksums), verified at the
        # batched engine's trust boundaries
        self.page_checksum = np.zeros(n_pool_pages, np.uint32)
        self.page_codec_id = np.zeros(n_pool_pages, np.int32)
        self.integrity = integrity
        self.faults = faults
        # degradation-ladder level >= 1 (set by the scheduler): stop
        # inserting new prompt pages into the prefix cache
        self.shed_cache_inserts = False
        self.seqs: dict[int, Sequence] = {}
        # cumulative published [raw, compressed] bytes per request
        self.request_bytes: dict[int, list[int]] = {}
        # logits row [V] of each sequence's last decode step
        self.last_logits: dict[int, torch.Tensor] = {}
        # the batched engine's metric series (same names and labels), so
        # engine-vs-oracle stats equality holds through ``stats``
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._init_metrics()
        if faults is not None:
            faults.telemetry = self.telemetry
        if prefix_cache is not None:
            prefix_cache.telemetry = self.telemetry

    # telemetry plumbing shared with the batched engine: the same
    # attribute contracts, the same metric series
    _STAT_KEYS = _E.PagedKVEngine._STAT_KEYS
    _init_metrics = _E.PagedKVEngine._init_metrics
    _publish_metrics = _E.PagedKVEngine._publish_metrics
    stats = _E.PagedKVEngine.stats
    load_stats_dict = _E.PagedKVEngine.load_stats_dict
    sample_gauges = _E.PagedKVEngine.sample_gauges

    # -- pool bookkeeping ----------------------------------------------------

    def page_raw_bytes(self) -> int:
        c = self.cfg
        return 2 * self.page * c.n_kv_heads * c.head_dim * 2   # K+V bf16

    def pool_pressure(self) -> float:
        """Non-reclaimable pool fraction in [0, 1] (the batched engine's):
        the degradation ladder's input."""
        reclaimable = len(self.free)
        if self.prefix_cache is not None:
            reclaimable += self.prefix_cache.retained_pages()
        return max(0.0, 1.0 - reclaimable / (self.n_pool_pages - 1))

    def _alloc_page(self) -> int:
        """The batched engine's reclaim order, one page at a time: the free
        list, then retained prefix-cache entries, then CAMP preemption."""
        while not self.free:
            if not self._evict_prefix_pages(1):
                self._preempt_one()
        return self.free.pop()

    def _evict_prefix_pages(self, need: int) -> bool:
        if self.prefix_cache is None:
            return False
        pids = self.prefix_cache.evict_for(need)
        if not pids:
            return False
        self.free.extend(pids)
        self._m["prefix_pages_evicted"].inc(len(pids))
        return True

    def _seq_value(self, seq: Sequence) -> float:
        """CAMP/MVE value: reuse proxy / reclaimable compressed size
        (smaller = victim); shared prefix pages count only when this
        sequence is their sole pinner; a finished sequence is worth -1."""
        if seq.done:
            return -1.0
        ns = len(seq.chain)
        size = sum(int(self.page_bytes[p])
                   for lp in seq.pages for p in lp[ns:])
        for eid in seq.chain:
            e = self.prefix_cache.entries[eid]
            if e.refcount == 1:
                size += e.nbytes
        return (len(seq.tokens) + 1) / max(size, 1)

    def _drop_seq_pages(self, seq: Sequence, *, count_evicted: bool) -> None:
        ns = len(seq.chain)
        for lp in seq.pages:
            self.free.extend(lp[ns:])
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
        victim = min(cands, key=self._seq_value)
        # verify the victim before its pages drop: a requeue folds its
        # decoded tokens into the prompt
        if self.integrity and self.faults is not None \
                and not F.verify_seq(self, victim.sid):
            self._m["integrity_failures"].inc()
        self._drop_seq_pages(victim, count_evicted=True)
        victim.tail_len = 0
        victim.preempted = True
        self._m["preemptions"].inc()

    def _publish_page(self, seq: Sequence, li: int, k_blk: torch.Tensor,
                      v_blk: torch.Tensor) -> None:
        """Compress one full [page, K, Dh] block on the device and copy it
        into the host pool.  A preempted sequence's publishes are dropped,
        including the one whose own allocation picked it as the victim."""
        if seq.preempted:
            return
        pid = self._alloc_page()
        if seq.preempted:          # victim of its own allocation just now
            self.free.append(pid)
            return
        pg = self.codec.compress_kv_pages(k_blk.transpose(0, 1)[None],
                                          v_blk.transpose(0, 1)[None])
        for pool, new in zip(tree_leaves(self.pools), tree_leaves(pg)):
            pool[li, pid] = new[0].cpu()
        # the batched engine's byte accounting and checksum, on the same
        # compressed bits
        nbytes = int(self.codec.page_nbytes(pg)[0])
        tag = int(self.codec.page_tags(pg)[0])
        self.page_bytes[pid] = nbytes
        self.page_checksum[pid] = int(F.page_checksums(pg)[0])
        self.page_codec_id[pid] = tag
        seq.pages[li].append(pid)
        raw = self.page_raw_bytes()
        pages_c, bytes_c, h_bytes, h_ratio = self._publish_metrics(tag)
        pages_c.inc()
        bytes_c.inc(nbytes)
        h_bytes.observe(nbytes)
        h_ratio.observe(raw / max(nbytes, 1))
        self._m["pages_compressed"].inc()
        self._m["bytes_raw"].inc(raw)
        self._m["bytes_compressed"].inc(nbytes)
        rb = self.request_bytes.setdefault(seq.sid, [0, 0])
        rb[0] += raw
        rb[1] += nbytes
        if self.faults is not None:
            self.faults.page_published(self, li, pid)

    def _publish_block(self, seq: Sequence, k_blk: torch.Tensor,
                       v_blk: torch.Tensor, blk: int | None = None) -> None:
        """Publish one [L, page, K, Dh] block, layer by layer; register a
        prompt page (``blk`` = its page index) in the prefix cache,
        deduping against an already resident identical page."""
        for li in range(self.cfg.n_layers):
            self._publish_page(seq, li, k_blk[li], v_blk[li])
        if blk is None or seq.preempted or self.prefix_cache is None:
            return
        if self.shed_cache_inserts or blk != len(seq.chain):
            # ladder shed, or the chain already broke on an earlier shed
            # block: later blocks stay private
            self._m["shed_inserts"].inc()
            return
        page, cache, lyr = self.page, self.prefix_cache, self.cfg.n_layers
        parent = seq.chain[-1] if seq.chain else 0
        toks = tuple(seq.tokens[blk * page:(blk + 1) * page])
        pids = [seq.pages[li][blk] for li in range(lyr)]
        nbytes = sum(int(self.page_bytes[p]) for p in pids)
        eid, created = cache.insert(
            parent, toks, pids, nbytes,
            codec_ids=[int(self.page_codec_id[p]) for p in pids])
        self.free.extend(cache.drain_displaced())   # healed-over pages
        if eid is None:            # pinned corrupt twin: block stays private
            self._m["shed_inserts"].inc()
            return
        cache.pin([eid])
        seq.chain.append(eid)
        if not created:            # dedup: map the shared pages instead
            ent = cache.entries[eid]
            for li in range(lyr):
                self.free.append(seq.pages[li][blk])
                seq.pages[li][blk] = ent.pages[li]
            # undo the duplicate's publish accounting: each resident page
            # counts once
            self._m["pages_compressed"].inc(-lyr)
            self._m["bytes_raw"].inc(-self.page_raw_bytes() * lyr)
            self._m["bytes_compressed"].inc(-nbytes)

    def _decompress(self, li: int, pids: list[int]):
        """Layer ``li``'s pool pages ``pids``, copied to the device and
        decompressed there: K, V f32 [n, K, page, Dh]."""
        idx = torch.tensor(pids, dtype=torch.long)
        return self.codec.decompress_pages(
            tree_map(lambda a: a[li, idx].to(self.device), self.pools))

    # -- request lifecycle ---------------------------------------------------

    def add_requests(self, prompts: dict[int, list[int]]) -> None:
        """The batched engine's API, with the oracle's semantics: one
        prompt prefilled at a time."""
        for sid, prompt in prompts.items():
            self.add_request(sid, prompt)

    def add_request(self, sid: int, prompt: list[int]) -> None:
        """Blocking admission: chunked prefill driven to completion (the
        canonical-prefix rule is chunk-layout independent)."""
        self.begin_request(sid, prompt)
        while self.seqs[sid].prefilling:
            self.prefill_advance(sid, len(prompt))

    def release(self, sid: int) -> None:
        """Retire a request: free its private pool pages and unpin its
        shared prefix chain."""
        seq = self.seqs[sid]
        if seq.prefilling and not seq.preempted:
            raise ValueError(f"sid {sid} is mid-prefill; cannot release")
        del self.seqs[sid]
        self.last_logits.pop(sid, None)
        self._drop_seq_pages(seq, count_evicted=False)
        if self.prefix_cache is not None:
            # quarantined entries free once their last pin drops
            self.free.extend(self.prefix_cache.purge_corrupt())

    def abort(self, sid: int) -> None:
        """Abandon a request mid-flight: drop its pages and mark it
        preempted, so ``release`` accepts it even mid-prefill."""
        seq = self.seqs[sid]
        if seq.preempted:
            return
        self._drop_seq_pages(seq, count_evicted=False)
        seq.tail_len = 0
        seq.preempted = True
        seq.pf_k = seq.pf_v = seq.pf_kc = seq.pf_vc = None

    # -- integrity / invariants ---------------------------------------------

    def verify_seq(self, sid: int) -> bool:
        """Recompute checksums of every pool page the sequence maps;
        quarantines corrupt shared entries (``faults.verify_seq``)."""
        return F.verify_seq(self, sid)

    def debug_validate(self) -> None:
        """Assert page/refcount accounting is exact
        (``faults.debug_validate``)."""
        F.debug_validate(self)

    # -- chunked prefill ------------------------------------------------------

    def begin_request(self, sid: int, prompt: list[int]) -> int:
        """Admit a prompt for chunked prefill without running any of it:
        the oracle twin of ``PagedKVEngine.begin_cohort``.  Consults the
        prefix cache, pins and maps the cached chain, and starts prefill
        at the hit boundary.  Returns the cached prompt token count."""
        if sid in self.seqs:
            raise ValueError(f"sid {sid} is already admitted")
        if not prompt:
            raise ValueError(f"empty prompt for sid {sid}")
        cfg, page, dev = self.cfg, self.page, self.device
        lyr, k, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        stored = len(prompt) - 1
        start, chain = 0, []
        if self.prefix_cache is not None:
            start, chain = self.prefix_cache.lookup(prompt)
            if self.integrity:
                # warm-hit trust boundary: never map a corrupt shared page
                vstart, chain = F.verified_prefix(self, start, chain)
                if vstart != start:
                    self._m["integrity_failures"].inc()
                    start = vstart
            self.prefix_cache.pin(chain)
        ent = [self.prefix_cache.entries[e] for e in chain]
        seq = Sequence(
            sid=sid, tokens=list(prompt),
            pages=[[e.pages[li] for e in ent] for li in range(lyr)],
            tail_k=torch.zeros((lyr, page, k, dh), dtype=torch.float32,
                               device=dev),
            tail_v=torch.zeros((lyr, page, k, dh), dtype=torch.float32,
                               device=dev),
            chain=list(chain), pf_start=start, pf_pos=start,
            pf_published=start // page)
        self.seqs[sid] = seq
        if start >= stored:
            return start           # full prefix hit: straight to decode
        seq.prefilling = True
        # the batched engine's scratch length (any page-aligned length
        # gives the same bits)
        chunk = self.prefill_chunk
        n_chunks = -(-stored // chunk) + 1
        cap = 1
        while cap < n_chunks:
            cap *= 2
        tpad = cap * chunk
        seq.pf_k = torch.zeros((lyr, 1, tpad, k, dh), dtype=torch.float32,
                               device=dev)
        seq.pf_v = torch.zeros_like(seq.pf_k)
        # the cached prefix, decompressed into the scratch: the canonical
        # values decode-side attention reads for those pages
        for b in range(start // page):
            sl = slice(b * page, (b + 1) * page)
            for li in range(lyr):
                kk, vv = self._decompress(li, [seq.pages[li][b]])
                seq.pf_k[li, 0, sl] = kk[0].transpose(0, 1)
                seq.pf_v[li, 0, sl] = vv[0].transpose(0, 1)
        # the warm region is canonical by construction; the rest of the
        # canonical view fills in as chunks complete.  A lossless codec
        # never reads it and carries a zero-length view
        if self.codec.lossless:
            seq.pf_kc = torch.zeros((lyr, 1, 0, k, dh), dtype=torch.float32,
                                    device=dev)
            seq.pf_vc = torch.zeros_like(seq.pf_kc)
        else:
            seq.pf_kc = seq.pf_k.clone()
            seq.pf_vc = seq.pf_v.clone()
        return start

    def prefill_advance(self, sid: int, n: int) -> bool:
        """Advance a chunked prefill by up to ``n`` prompt tokens.

        Each chunk's compute runs through the batched engine's dispatch at
        one scratch row; the pages it completes publish through this
        engine's own CAMP-accounted host-pool path and register in the
        prefix cache, and the final partial page lands in the decode tail.
        Returns True when prefill completed."""
        cfg, seq, page, dev = self.cfg, self.seqs[sid], self.page, self.device
        if not seq.prefilling:
            raise ValueError(f"sid {sid} is not prefilling")
        stored = len(seq.tokens) - 1
        chunk = self.prefill_chunk
        n = min(n, stored - seq.pf_pos)
        while n > 0:
            step = min(n, chunk)
            p = seq.pf_pos
            tpad = seq.pf_k.shape[2]
            off = min(p, tpad - chunk)
            pt = np.zeros((1, chunk), np.int32)
            w = min(chunk, len(seq.tokens) - off)
            pt[0, :w] = seq.tokens[off:off + w]
            pt[0, step:] = 0                  # budget-split masking
            _E._prefill_core(self._layers, self.params,
                             torch.from_numpy(pt).to(dev), seq.pf_k,
                             seq.pf_v, seq.pf_kc, seq.pf_vc,
                             torch.tensor([off], dtype=torch.int64,
                                          device=dev),
                             cfg=cfg, page=page, codec=self.codec)
            seq.pf_pos = p + step
            n -= step
            # publish every page the chunk completed, block by block
            for blk in range(seq.pf_published, seq.pf_pos // page):
                sl = slice(blk * page, (blk + 1) * page)
                self._publish_block(seq, seq.pf_k[:, 0, sl],
                                    seq.pf_v[:, 0, sl], blk=blk)
                seq.pf_published = blk + 1
            if seq.preempted:
                break
        if seq.pf_pos < stored and not seq.preempted:
            return False
        seq.prefilling = False
        seq.tail_len = 0 if seq.preempted else stored % page
        if seq.tail_len:
            base = (stored // page) * page
            seq.tail_k[:, :seq.tail_len] = seq.pf_k[:, 0, base:stored]
            seq.tail_v[:, :seq.tail_len] = seq.pf_v[:, 0, base:stored]
        seq.pf_k = seq.pf_v = seq.pf_kc = seq.pf_vc = None
        return True

    # -- decode ---------------------------------------------------------------

    def decode_one(self, sid: int) -> int:
        """Greedy-decode one token for sequence ``sid``."""
        cfg, seq, dev = self.cfg, self.seqs[sid], self.device
        if seq.prefilling:
            raise ValueError(f"sid {sid} is mid-prefill; cannot decode")
        tok = torch.tensor([[seq.tokens[-1]]], dtype=torch.int32, device=dev)
        pos = torch.tensor([len(seq.tokens) - 1], dtype=torch.int32,
                           device=dev)
        cos, sin = L.rope_angles(pos, cfg.head_dim, cfg.rope_theta)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        x = L.embed(self.params["embed"], tok)                # [1, 1, D]
        for li, bp in enumerate(self._layers):
            h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
            q = L.apply_rope(L.linear(bp["attn"]["wq"], h), cos, sin)
            k_new = L.apply_rope(L.linear(bp["attn"]["wk"], h), cos, sin)
            v_new = L.linear(bp["attn"]["wv"], h)
            seq.tail_k[li, seq.tail_len] = k_new[0, 0].float()
            seq.tail_v[li, seq.tail_len] = v_new[0, 0].float()
            x = x + A._proj_out(bp["attn"], self._attend(seq, li, q))
            x = x + L.mlp(bp["ffn"], L.rmsnorm(bp["ln2"], x, cfg.norm_eps))
        seq.tail_len += 1
        if seq.tail_len == self.page:
            self._publish_block(seq, seq.tail_k, seq.tail_v)
            seq.tail_len = 0
        x = L.rmsnorm(self.params["final_norm"], x, cfg.norm_eps)
        logits = L.lm_logits(self.params["lm_head"], x)[0, 0]
        self.last_logits[sid] = logits
        nxt = int(torch.argmax(logits))
        if self.faults is not None:
            nxt = self.faults.garble_one(nxt)
        seq.tokens.append(nxt)
        return nxt

    def _attend(self, seq: Sequence, li: int, q: torch.Tensor
                ) -> torch.Tensor:
        """Dense f32 attention of q [1, 1, Hq, Dh] over the sequence's
        decompressed layer-``li`` pages plus its exact tail."""
        kh, dh = self.cfg.n_kv_heads, self.cfg.head_dim
        parts_k, parts_v = [], []
        if seq.pages[li]:
            kp, vp = self._decompress(li, seq.pages[li])
            parts_k.append(kp.transpose(1, 2).reshape(-1, kh, dh))
            parts_v.append(vp.transpose(1, 2).reshape(-1, kh, dh))
        tl = seq.tail_len + 1
        parts_k.append(seq.tail_k[li, :tl])
        parts_v.append(seq.tail_v[li, :tl])
        k = torch.cat(parts_k)                                # [T, K, Dh]
        v = torch.cat(parts_v)
        hq = q.shape[2]
        qg = q[0, 0].reshape(kh, hq // kh, dh).float()
        sc = torch.einsum("kgd,tkd->kgt", qg, k) / math.sqrt(dh)
        ctx = torch.einsum("kgt,tkd->kgd", torch.softmax(sc, dim=-1), v)
        return ctx.reshape(1, 1, hq, dh).to(q.dtype)

    # -- metrics --------------------------------------------------------------

    def compression_ratio(self) -> float:
        if not self._m["bytes_compressed"].value:
            return 1.0
        return self._m["bytes_raw"].value / self._m["bytes_compressed"].value

    def pool_used_pages(self) -> int:
        return (self.n_pool_pages - 1) - len(self.free)
