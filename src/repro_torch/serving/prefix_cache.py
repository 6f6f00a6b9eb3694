"""Canonical-prefix attention and the SIP prefix cache.

Port of ``repro/serving/prefix_cache.py``.  Canonical-prefix attention
(``:84-186``), the lossless-codec ``identity`` path included.

Cross-request page sharing is only sound if a page's content is a pure
function of the token prefix it covers.  The engine guarantees this with
one attention rule in prefill: a query at position ``p`` attends
**canonical** K/V (the codec round trip of the exact values — what
decode reads from the pool) for every completed earlier page, and
**exact** f32 K/V inside its own partial page.

The SIP prefix cache (``:193-573``): a
page-granularity, content-addressed trie over completed compressed
prompt pages (:class:`PrefixCache`), one entry spanning all layers,
refcounted by the live sequences that map it, and :class:`SIPRetention`,
the victim ranking over refcount-0 entries — G-CAMP's value
``(hits + priority + 1) / pow2_bucket(compressed bytes)`` with SIP's
size-bin priority learned from lookup hits.  Host code only, equal to
the JAX classes decision for decision
(``tests/test_torch_prefix_cache.py``).
``demote_cb`` hands each clean eviction victim to the host/disk tier
(``serving/tier.py``) before its pages drop; with an observatory
attached, ``evict_for`` records each victim ranking in its decision
audit log (``serving/audit.py``).

Lifecycle:

    lookup(prompt) -> (n_cached_tokens, chain)   # longest page-boundary hit
    pin(chain)                                   # refcount++ before mapping
    insert(parent, toks, pages, nbytes)          # publish a prompt page
    release(chain)                               # retire/preempt: refcount--
    evict_for(n)                                 # pool pressure: SIP victims
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.codecs import PageCodec
from repro_torch.core.camp import N_SIZE_BINS, _pow2_bucket, size_bin


def _roundtrip_window(kw: torch.Tensor, vw: torch.Tensor, page: int,
                      codec: PageCodec) -> tuple[torch.Tensor, torch.Tensor]:
    """Codec-roundtrip [R, W, K, D] scratch windows page-wise."""
    r, w, kvh, d = kw.shape

    def to_pages(x):      # [R, W, K, D] -> [R * W/page, K, page, D]
        return x.reshape(r * (w // page), page, kvh, d).transpose(1, 2)

    kr, vr = codec.canonical_roundtrip(to_pages(kw), to_pages(vw))

    def back(x):
        return x.transpose(1, 2).reshape(r, w, kvh, d)

    return back(kr), back(vr)


def canonical_update(kscr: torch.Tensor, vscr: torch.Tensor,
                     kcan: torch.Tensor, vcan: torch.Tensor,
                     offs: torch.Tensor, page: int, width: int,
                     codec: PageCodec) -> None:
    """Refresh, in place, the canonical view of the pages a chunk touched.

    kscr/vscr f32 [R, T, K, D] exact scratch; kcan/vcan its canonical
    view; offs i64 [R] each row's chunk start; ``width`` the window span
    (chunk width + one page, so it covers a leading partial page too).
    Only the window is round-tripped: earlier pages' canonical values are
    already resident, and the codec is not assumed idempotent.  Values
    for pages the chunk left incomplete are garbage, but attention reads
    canonical values only for pages strictly before a query's own.
    The JAX version returns new arrays; here ``kcan``/``vcan`` are
    updated in place (index_put_), as the JAX engine donates them.
    """
    r, t = kscr.shape[:2]
    wstart = torch.clamp((offs // page) * page, max=t - width)
    idx = wstart[:, None] + torch.arange(width, device=kscr.device)
    rows = torch.arange(r, device=kscr.device)[:, None]
    kr, vr = _roundtrip_window(kscr[rows, idx], vscr[rows, idx], page,
                               codec)
    kcan[rows, idx] = kr
    vcan[rows, idx] = vr


def prefix_chunk_attention(q: torch.Tensor, qpos: torch.Tensor,
                           kscr: torch.Tensor, vscr: torch.Tensor,
                           kcan: torch.Tensor, vcan: torch.Tensor,
                           page: int, *, identity: bool = False
                           ) -> torch.Tensor:
    """Causal chunk attention under the canonical-prefix contract.

    q f32 [R, C, K, G, D]; qpos [R, C] absolute positions; kscr/vscr the
    exact scratch [R, T, K, D]; kcan/vcan its canonical view.  Each query
    reads canonical K/V for keys in strictly earlier pages and exact K/V
    for keys inside its own page (``kpos <= qpos``); the rest is masked
    and contributes exact zeros, so scratch padding is invisible.
    Returns f32 [R, C, K, G, D].

    ``identity=True`` is the lossless-codec path: canonical == exact, so
    one causal mask over the exact scratch replaces the two regions and
    the second einsum pair goes (kcan/vcan are not read; the engine
    passes a zero-length view).
    """
    d = q.shape[-1]
    t = kscr.shape[1]
    kpos = torch.arange(t, device=q.device)
    scale = 1.0 / math.sqrt(d)
    s_e = torch.einsum("rckgd,rtkd->rckgt", q, kscr) * scale
    if identity:
        m = (kpos[None, None, :] <= qpos[:, :, None])[:, :, None, None, :]
        w = torch.softmax(torch.where(m, s_e, -math.inf), dim=-1)
        return torch.einsum("rckgt,rtkd->rckgd", torch.where(m, w, 0.0), vscr)
    kpage = kpos // page                                # [T]
    qpage = qpos // page                                # [R, C]
    m_can = (kpage[None, None, :] < qpage[:, :, None])[:, :, None, None, :]
    m_own = ((kpage[None, None, :] == qpage[:, :, None])
             & (kpos[None, None, :] <= qpos[:, :, None]))[:, :, None, None, :]
    s_c = torch.einsum("rckgd,rtkd->rckgt", q, kcan) * scale
    sc = torch.where(m_can, s_c, torch.where(m_own, s_e, -math.inf))
    w = torch.softmax(sc, dim=-1)
    return (torch.einsum("rckgt,rtkd->rckgd", torch.where(m_can, w, 0.0), vcan)
            + torch.einsum("rckgt,rtkd->rckgd", torch.where(m_own, w, 0.0),
                           vscr))


# ---------------------------------------------------------------------------
# SIP retention policy
# ---------------------------------------------------------------------------

class SIPRetention:
    """Size-based retention priority over refcount-0 prefix entries.

    The G-CAMP value function from ``core/camp.py`` — reuse divided by
    the power-of-two size bucket of the *compressed* byte count — with
    SIP's learned size-bin priority on top: every ``train_period``
    lookups, size bins whose entries drew chain hits become high-priority
    (insertion-time boost), the rest reset.  Victim = minimum value among
    unpinned entries, FIFO insertion order as the deterministic tiebreak.
    Before any training commits, compressed size alone ranks entries, so
    highly-compressible pages are retained longest from the first evict.
    """

    PRIORITY_BOOST = 2

    def __init__(self, raw_entry_bytes: int, train_period: int = 64):
        assert raw_entry_bytes >= N_SIZE_BINS, raw_entry_bytes
        self.line = raw_entry_bytes          # uncompressed entry size
        self.train_period = train_period
        self.priority = np.zeros(N_SIZE_BINS, dtype=bool)
        self.hit_ctr = np.zeros(N_SIZE_BINS, dtype=np.int64)
        self.lookups = 0

    def bin(self, nbytes: int) -> int:
        return size_bin(nbytes, self.line)

    def on_hit(self, nbytes: int) -> None:
        self.hit_ctr[self.bin(nbytes)] += 1

    def on_lookup(self) -> None:
        self.lookups += 1
        if self.lookups % self.train_period == 0:
            self.priority = self.hit_ctr > 0
            self.hit_ctr[:] = 0

    def value(self, hits: int, nbytes: int) -> float:
        boost = self.PRIORITY_BOOST if self.priority[self.bin(nbytes)] else 0
        return (hits + boost + 1) / _pow2_bucket(max(nbytes, 1))


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@dataclass
class Entry:
    """One cached page boundary: all layers' pages for one token page."""
    eid: int
    parent: int                  # parent eid (0 = root)
    depth: int                   # page/block index (boundary = (depth+1)*page)
    toks: tuple[int, ...]        # this page's token ids (trie edge label)
    pages: list[int] = field(default_factory=list)   # [L] pool ids
    nbytes: int = 0              # device-reported compressed bytes, all layers
                                 # (post-selection under the adaptive codec,
                                 # so SIP size bins rank on real footprint)
    codec_ids: list[int] = field(default_factory=list)  # [L] per-page codec
                                 # tags (0 for single-algorithm codecs)
    refcount: int = 0            # live sequences mapping this entry
    children: int = 0            # resident child entries (evict leaf-first)
    hits: int = 0                # chain-hit reuse counter (SIP/CAMP feed)
    born: int = 0                # insertion clock (deterministic tiebreak)
    corrupt: bool = False        # failed an integrity check: quarantined
                                 # (skipped by lookups, evicted first)


class PrefixCache:
    """Content-addressed, refcounted cache of compressed prompt pages.

    Host-side metadata only — the page *data* stays in the owning
    engine's device pools; entries carry pool ids.  Each engine instance
    owns one cache; sharing happens across *requests*, not across
    engines.
    """

    def __init__(self, n_layers: int, page_size: int, raw_entry_bytes: int,
                 policy: SIPRetention | None = None):
        self.n_layers = n_layers
        self.page = page_size
        self.policy = policy or SIPRetention(raw_entry_bytes)
        self.entries: dict[int, Entry] = {}
        self._child: dict[tuple[int, tuple[int, ...]], int] = {}
        self._next_eid = 1
        self._clock = 0
        self.stats = {"lookups": 0, "lookup_tokens": 0, "hits": 0,
                      "hit_tokens": 0, "inserted": 0, "deduped": 0,
                      "evicted": 0, "quarantined": 0, "healed": 0}
        self._n_corrupt = 0
        self._displaced: list[int] = []   # pool ids freed by healing
        # set by an engine with a tier: called with each clean eviction
        # victim before its pages drop, so the tier captures them
        self.demote_cb = None
        # optional hierarchy observatory (serving/observatory.py), set by
        # the owning engine: :meth:`evict_for` audits each SIP victim
        self.observatory = None
        # set by the owning engine; :meth:`sample_metrics` pushes the
        # cache's counters into its registry at export time (zero cost
        # on the lookup/insert hot path)
        self.telemetry = None

    @classmethod
    def for_model(cls, cfg, page_size: int, **kw) -> "PrefixCache":
        """Cache sized for a model config (raw bytes = K+V bf16, all
        layers, one page)."""
        raw = 2 * page_size * cfg.n_kv_heads * cfg.head_dim * 2
        return cls(cfg.n_layers, page_size, raw * cfg.n_layers, **kw)

    # -- lookup / pin / release ---------------------------------------------

    def lookup(self, prompt: list[int]) -> tuple[int, list[int]]:
        """Longest cached page-boundary prefix of ``prompt``.

        Returns ``(n_tokens, chain)``: the number of cached prompt tokens
        (a multiple of ``page``) and the entry chain covering them.  The
        walk is capped at ``len(prompt) - 1`` tokens — the engines store
        KV for every prompt token but the last (whose K/V the first
        decode step computes), so a deeper hit could never be consumed.
        """
        stored = len(prompt) - 1
        page = self.page
        chain: list[int] = []
        parent = 0
        b = 0
        while (b + 1) * page <= stored:
            toks = tuple(prompt[b * page:(b + 1) * page])
            eid = self._child.get((parent, toks))
            if eid is None or self.entries[eid].corrupt:
                break              # quarantined entries never serve hits
            chain.append(eid)
            parent = eid
            b += 1
        self.stats["lookups"] += 1
        self.stats["lookup_tokens"] += max(stored, 0)
        if chain:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += b * page
            for eid in chain:
                e = self.entries[eid]
                e.hits += 1
                self.policy.on_hit(e.nbytes)
        self.policy.on_lookup()
        return b * page, chain

    def pin(self, chain: list[int]) -> None:
        for eid in chain:
            self.entries[eid].refcount += 1

    def release(self, chain: list[int]) -> None:
        for eid in chain:
            e = self.entries[eid]
            assert e.refcount > 0, f"release of unpinned entry {eid}"
            e.refcount -= 1

    # -- integrity quarantine -------------------------------------------------

    def quarantine(self, eid: int) -> None:
        """Mark an entry corrupt: it never serves another hit (lookups
        stop at it, orphaning its still-clean descendants, which age out
        leaf-first) and evicts ahead of every clean entry.  Its pool
        pages are reclaimed by :meth:`purge_corrupt` once unpinned."""
        e = self.entries[eid]
        if not e.corrupt:
            e.corrupt = True
            self._n_corrupt += 1
            self.stats["quarantined"] += 1

    def drain_displaced(self) -> list[int]:
        """Pool ids displaced by :meth:`insert` healing since the last
        drain — the caller (engine) returns them to its free list."""
        out, self._displaced = self._displaced, []
        return out

    def purge_corrupt(self) -> list[int]:
        """Drop every unpinned corrupt *leaf* (repeatedly, so unpinned
        corrupt subtrees collapse); returns the freed pool ids."""
        freed: list[int] = []
        while self._n_corrupt:
            drop = [e for e in self.entries.values()
                    if e.corrupt and e.refcount == 0 and e.children == 0]
            if not drop:
                break
            for e in drop:
                freed.extend(self._drop(e))
        return freed

    # -- publish -------------------------------------------------------------

    def insert(self, parent: int, toks: tuple[int, ...], pages: list[int],
               nbytes: int, codec_ids: list[int] | None = None
               ) -> tuple[int | None, bool]:
        """Register a freshly published prompt page.

        ``pages`` are the pool ids (one per layer) the publisher just
        wrote; ``nbytes`` the device-reported compressed byte total;
        ``codec_ids`` the per-layer codec tags the publisher recorded
        (``None`` -> all zeros, the single-algorithm case).
        Returns ``(eid, created)`` — ``created=False`` means an identical
        page is already resident (same parent chain, same token ids): the
        caller should free its duplicate pool pages and map the existing
        entry instead (in-cohort dedup of same-prefix prompts).

        A resident twin that is *quarantined* must never be deduped onto
        (that would re-serve the corrupt bytes the caller just recomputed
        around).  An unpinned corrupt twin is **healed** in place: the
        entry adopts the caller's freshly recomputed pages — byte-
        identical to the original publish by the canonical-prefix
        contract — and the displaced corrupt pool ids are queued for the
        caller via :meth:`drain_displaced` (returned ``created=True``:
        the caller keeps its fresh pages mapped).  A corrupt twin still
        pinned by a doomed in-flight sequence cannot have its pages
        swapped; the caller gets ``eid=None`` and keeps the block
        private.
        """
        assert len(toks) == self.page and len(pages) == self.n_layers
        if codec_ids is None:
            codec_ids = [0] * self.n_layers
        assert len(codec_ids) == self.n_layers
        eid = self._child.get((parent, toks))
        if eid is not None:
            e = self.entries[eid]
            if e.corrupt:
                if e.refcount:
                    return None, False    # pinned corrupt twin: stay private
                self._displaced.extend(e.pages)
                e.pages = list(pages)
                e.nbytes = int(nbytes)
                e.codec_ids = list(codec_ids)
                e.corrupt = False
                self._n_corrupt -= 1
                self.stats["healed"] += 1
                return eid, True
            self.stats["deduped"] += 1
            return eid, False
        self._clock += 1
        e = Entry(eid=self._next_eid, parent=parent,
                  depth=(self.entries[parent].depth + 1 if parent else 0),
                  toks=toks, pages=list(pages), nbytes=int(nbytes),
                  codec_ids=list(codec_ids), born=self._clock)
        self._next_eid += 1
        self.entries[e.eid] = e
        self._child[(parent, toks)] = e.eid
        if parent:
            self.entries[parent].children += 1
        self.stats["inserted"] += 1
        return e.eid, True

    # -- eviction ------------------------------------------------------------

    def _evictable(self) -> list[Entry]:
        """Unpinned leaves.  Pins cover whole chains (a sequence pins
        every ancestor of the deepest entry it maps), so an entry with a
        pinned descendant always has ``refcount > 0`` itself; leaf-first
        eviction keeps every resident chain reachable from the root."""
        return [e for e in self.entries.values()
                if e.refcount == 0 and e.children == 0]

    def evict_for(self, n_pages: int) -> list[int]:
        """Free >= ``n_pages`` pool pages from retained entries if
        possible; returns the freed pool ids ([] when nothing is
        evictable).  Victim order is the SIP/CAMP value ranking —
        least-valuable (big, cold, unprioritized) entries go first."""
        freed: list[int] = []
        while len(freed) < n_pages:
            cands = self._evictable()
            if not cands:
                break
            victim = min(cands, key=lambda e:
                         (not e.corrupt,     # quarantined entries go first
                          self.policy.value(e.hits, e.nbytes), e.born))
            if self.observatory is not None:
                self.observatory.audit.record(
                    "sip_evict", eid=victim.eid, hits=victim.hits,
                    nbytes=victim.nbytes,
                    value=self.policy.value(victim.hits, victim.nbytes),
                    pow2_bucket=_pow2_bucket(max(victim.nbytes, 1)),
                    size_bin=self.policy.bin(victim.nbytes),
                    born=victim.born, corrupt=victim.corrupt,
                    candidates=len(cands))
            if self.demote_cb is not None and not victim.corrupt:
                # quarantined entries are never demoted
                self.demote_cb(victim)
            freed.extend(self._drop(victim))
        return freed

    def _drop(self, e: Entry) -> list[int]:
        del self._child[(e.parent, e.toks)]
        del self.entries[e.eid]
        if e.parent:
            self.entries[e.parent].children -= 1
        if e.corrupt:
            self._n_corrupt -= 1
        self.stats["evicted"] += 1
        return e.pages

    # -- metrics -------------------------------------------------------------

    def resident_pages(self) -> int:
        return self.n_layers * len(self.entries)

    def retained_pages(self) -> int:
        """Pages held only by the cache (refcount 0): reclaimable."""
        return self.n_layers * sum(1 for e in self.entries.values()
                                   if e.refcount == 0)

    def hit_rate(self) -> float:
        """Token-weighted prefix hit rate across lookups so far."""
        if not self.stats["lookup_tokens"]:
            return 0.0
        return self.stats["hit_tokens"] / self.stats["lookup_tokens"]

    def sample_metrics(self) -> None:
        """Push cache counters into the attached telemetry registry
        (called from the owning engine's ``sample_gauges``)."""
        if self.telemetry is None:
            return
        reg = self.telemetry.registry
        for k, v in self.stats.items():
            reg.gauge(f"prefix_cache_{k}").set(v)
        reg.gauge("prefix_cache_entries",
                  "resident trie entries").set(len(self.entries))
        reg.gauge("prefix_cache_retained_pages",
                  "refcount-0 pages held only by the cache"
                  ).set(self.retained_pages())
        reg.gauge("prefix_cache_hit_rate",
                  "token-weighted hit rate").set(round(self.hit_rate(), 6))

    # -- snapshot / restore ----------------------------------------------------

    def state(self) -> dict:
        """JSON-serializable trie + policy state (what the JAX package's
        ``serving/snapshot.py`` stores; the same dict restores in either
        package)."""
        return {
            "n_layers": self.n_layers, "page": self.page,
            "next_eid": self._next_eid, "clock": self._clock,
            "stats": dict(self.stats),
            "entries": [{"eid": e.eid, "parent": e.parent,
                         "depth": e.depth, "toks": list(e.toks),
                         "pages": list(e.pages), "nbytes": e.nbytes,
                         "codec_ids": list(e.codec_ids),
                         "refcount": e.refcount, "children": e.children,
                         "hits": e.hits, "born": e.born,
                         "corrupt": e.corrupt}
                        for e in self.entries.values()],
            "policy": {"line": self.policy.line,
                       "train_period": self.policy.train_period,
                       "priority": self.policy.priority.tolist(),
                       "hit_ctr": self.policy.hit_ctr.tolist(),
                       "lookups": self.policy.lookups},
        }

    def load_state(self, st: dict) -> None:
        """Restore trie + policy state captured by :meth:`state` into a
        freshly constructed cache of the same shape."""
        assert st["n_layers"] == self.n_layers and st["page"] == self.page
        self._next_eid = st["next_eid"]
        self._clock = st["clock"]
        self.stats.update(st["stats"])
        self.entries.clear()
        self._child.clear()
        self._n_corrupt = 0
        for d in st["entries"]:
            e = Entry(eid=d["eid"], parent=d["parent"], depth=d["depth"],
                      toks=tuple(d["toks"]), pages=list(d["pages"]),
                      nbytes=d["nbytes"],
                      codec_ids=list(d.get("codec_ids",
                                           [0] * self.n_layers)),
                      refcount=d["refcount"], children=d["children"],
                      hits=d["hits"], born=d["born"], corrupt=d["corrupt"])
            self.entries[e.eid] = e
            self._child[(e.parent, e.toks)] = e.eid
            self._n_corrupt += int(e.corrupt)
        p = st["policy"]
        self.policy.line = p["line"]
        self.policy.train_period = p["train_period"]
        self.policy.priority = np.asarray(p["priority"], bool)
        self.policy.hit_ctr = np.asarray(p["hit_ctr"], np.int64)
        self.policy.lookups = p["lookups"]
