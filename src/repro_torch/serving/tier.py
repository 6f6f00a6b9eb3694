"""Host/disk tiers for compressed KV pages (port of
``repro/serving/tier.py``).

The device pool is the cache level; this module adds the DRAM and
storage levels beneath it, holding compressed pages byte for byte (no
recompression on the way down or back):

  * :class:`HostArena` — one numpy ``uint8`` buffer laid out
    LCP-linearly: a record occupies one fixed-stride slot, so the byte
    offset of record *i*'s layer-*l* page is pure arithmetic,
    ``offset(i, l) = i * slot_bytes + l * layer_stride``, with no
    per-page offset table.  The codec's per-page leaves pack back to
    back inside a layer region in ``jax.tree.leaves`` order, with the
    JAX package's sizes, so arenas and persisted tiers compare byte for
    byte across the packages.
  * :class:`DiskArena` — the same slot layout over an ``np.memmap``
    file; host victims spill there instead of dropping when configured.
  * :class:`TieredPageStore` — the digest-keyed trie over both arenas
    (SHA-256 over ``parent_digest + page token ids``), so a record's
    identity survives evictions, engine restarts and
    :meth:`~TieredPageStore.persist` / :meth:`~TieredPageStore.restore`
    round trips through ``checkpoint/store.py``.

The engine moves the data (``serving/engine.py``): demotion gathers an
evicted prefix entry's pages out of the pools and copies them to the
host; promotion verifies a record's bytes host-side against the
publish-time checksums (:func:`np_page_checksums`, equal bit for bit to
``faults.page_checksums``), quarantines a corrupt one, and scatters a
verified run back into the pools.  The tier is inclusive: promotion
copies.  All state here is host-side.  With an observatory attached,
demotions, promotions, spills and quarantines leave decision audit
records (``serving/audit.py``).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field

import numpy as np

from repro_torch.checkpoint import store
from repro_torch.core.camp import _pow2_bucket
from repro_torch.serving._tree import tree_leaves

_MIX = 2654435761                    # Knuth constant (faults.page_checksums)
_U32 = 0xFFFFFFFF
ROOT = ""                            # parent digest of depth-0 records


def np_page_checksums(leaves: list[np.ndarray]) -> np.ndarray:
    """Host-side replica of :func:`repro_torch.serving.faults.page_checksums`.

    ``leaves`` lead with the page axis ``[n, ...]`` (any dtypes); returns
    uint32 ``[n]`` equal bit-for-bit to the jnp version (the engines'
    publish-time checksums), so promotion can verify tier bytes without
    a device dispatch.  Equivalence holds because uint32 wrapping is
    arithmetic mod 2**32: products and sums reduced late (uint64 here)
    or early (uint32 lanes there) agree once reduced.
    ``tests/test_torch_tier.py`` pins the implementations against each
    other and against the JAX package's.
    """
    leaves = [lf for lf in leaves if lf.size]
    n = leaves[0].shape[0]
    acc = np.zeros(n, np.uint64)
    for lf in leaves:
        b = np.frombuffer(np.ascontiguousarray(lf).tobytes(),
                          np.uint8).reshape(n, -1).astype(np.uint64)
        w = (np.arange(b.shape[1], dtype=np.uint64) * _MIX + 1) & _U32
        acc = (acc + (b * w).sum(axis=1)) & _U32
        acc = (acc * _MIX + 1) & _U32
    return acc.astype(np.uint32)


def child_digest(parent: str, toks: tuple[int, ...]) -> str:
    """Trie edge digest: identity of the token prefix ending at this
    page boundary (chained like the PrefixCache's ``(parent, toks)``
    keys, but stable across restarts and independent of residency)."""
    h = hashlib.sha256(parent.encode())
    h.update(np.asarray(toks, np.int64).tobytes())
    return h.hexdigest()[:32]


# ---------------------------------------------------------------------------
# arenas
# ---------------------------------------------------------------------------

@dataclass
class _LeafSpec:
    """One codec leaf's per-page packed form inside a layer region."""
    offset: int                  # byte offset inside the layer region
    nbytes: int                  # packed bytes per page
    shape: tuple[int, ...]       # trailing (per-page) shape
    dtype: np.dtype


class _Arena:
    """Fixed-stride slot store over a flat uint8 buffer.

    Addressing is arithmetic by construction: slot *i* spans bytes
    ``[i * slot_bytes, (i + 1) * slot_bytes)`` of ``buf`` viewed flat.
    """

    def __init__(self, n_slots: int, slot_bytes: int, buf: np.ndarray):
        assert buf.shape == (n_slots, slot_bytes)
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes
        self.buf = buf
        self._free = list(range(n_slots - 1, -1, -1))

    def alloc(self) -> int | None:
        return self._free.pop() if self._free else None

    def free(self, slot: int) -> None:
        self._free.append(slot)

    @property
    def used(self) -> int:
        return self.n_slots - len(self._free)

    def slot_offset(self, slot: int) -> int:
        """Byte offset of a slot in the flat arena — pure arithmetic."""
        return slot * self.slot_bytes


class HostArena(_Arena):
    """DRAM level: one numpy buffer, LCP-linear slots."""

    def __init__(self, n_slots: int, slot_bytes: int):
        super().__init__(n_slots, slot_bytes,
                         np.zeros((n_slots, slot_bytes), np.uint8))


class DiskArena(_Arena):
    """Storage level: the same slot layout over an mmap-backed file."""

    def __init__(self, n_slots: int, slot_bytes: int, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        buf = np.memmap(path, np.uint8, mode="w+",
                        shape=(n_slots, slot_bytes))
        super().__init__(n_slots, slot_bytes, buf)


# ---------------------------------------------------------------------------
# records + store
# ---------------------------------------------------------------------------

@dataclass
class TierRecord:
    """One demoted page boundary: all layers' compressed pages."""
    digest: str
    parent: str                  # parent digest (ROOT at depth 0)
    depth: int
    toks: tuple[int, ...]
    slot: int
    level: str                   # "host" | "disk"
    nbytes: list[int] = field(default_factory=list)      # [L] device-reported
    codec_ids: list[int] = field(default_factory=list)   # [L] page tags
    checksums: list[int] = field(default_factory=list)   # [L] publish-time
    hits: int = 0
    born: int = 0
    corrupt: bool = False
    source: str = "prompt"       # "prompt" | "decode"


class TieredPageStore:
    """Digest-keyed host/disk store of demoted compressed KV pages.

    One store serves one engine (same codec — the packed slot layout is
    the codec's leaf layout).  All state is host-side; the engine owns
    the device interactions (gather on demote, scatter on promote).
    """

    def __init__(self, codec, *, n_layers: int, page: int, kvh: int,
                 dh: int, host_bytes: int, disk_dir: str | None = None,
                 disk_bytes: int | None = None, telemetry=None,
                 observatory=None):
        self.codec_name = codec.name
        self.n_layers = n_layers
        self.page = page
        # leaf layout from a 1-layer/1-page pool: static per-page packed
        # sizes, so every intra-slot offset is arithmetic
        proto = tree_leaves(codec.init_pools(1, 1, kvh, page, dh, "cpu"))
        self._specs: list[_LeafSpec] = []
        off = 0
        for lf in proto:
            shape = tuple(lf.shape[2:])
            dt = lf.numpy().dtype
            nb = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            self._specs.append(_LeafSpec(off, nb, shape, dt))
            off += nb
        self.layer_stride = off
        self.slot_bytes = n_layers * off
        n_host = max(1, int(host_bytes) // self.slot_bytes)
        self.host = HostArena(n_host, self.slot_bytes)
        self.disk: DiskArena | None = None
        if disk_dir is not None:
            n_disk = max(1, int(disk_bytes if disk_bytes is not None
                                else 4 * host_bytes) // self.slot_bytes)
            self.disk = DiskArena(n_disk, self.slot_bytes,
                                  os.path.join(disk_dir, "tier_arena.bin"))
        self._records: dict[str, TierRecord] = {}
        self._kids: dict[str, int] = {}      # resident children per digest
        self._clock = 0
        self.stats = {"demotions": 0, "promotions": 0, "spills": 0,
                      "drops": 0, "dedup": 0, "corrupt": 0, "evictions": 0}
        # set by the owning engine (attach_tier); counters/gauges are
        # synced into the registry at export time (sample_metrics)
        self.telemetry = telemetry
        self.observatory = observatory

    @classmethod
    def for_model(cls, cfg, page: int, codec, *, host_mb: float = 64,
                  disk_dir: str | None = None, disk_mb: float | None = None,
                  **kw) -> "TieredPageStore":
        return cls(codec, n_layers=cfg.n_layers, page=page,
                   kvh=cfg.n_kv_heads, dh=cfg.head_dim,
                   host_bytes=int(host_mb * (1 << 20)), disk_dir=disk_dir,
                   disk_bytes=(None if disk_mb is None
                               else int(disk_mb * (1 << 20))), **kw)

    # -- addressing (arithmetic, no per-page table) -------------------------

    def page_offset(self, slot: int, layer: int) -> int:
        """Flat-arena byte offset of one record's layer page: pure
        arithmetic, the LCP property this tier exists to demonstrate."""
        return slot * self.slot_bytes + layer * self.layer_stride

    def _arena(self, rec: TierRecord) -> _Arena:
        return self.host if rec.level == "host" else self.disk

    # -- pack / unpack ------------------------------------------------------

    def _pack(self, arena: _Arena, slot: int,
              leaves: list[np.ndarray]) -> None:
        """Pack [L, ...] codec leaves into one slot (layer-major)."""
        row = arena.buf[slot]
        for li in range(self.n_layers):
            base = li * self.layer_stride
            for sp, lf in zip(self._specs, leaves):
                if not sp.nbytes:
                    continue
                b = np.frombuffer(np.ascontiguousarray(lf[li]).tobytes(),
                                  np.uint8)
                row[base + sp.offset:base + sp.offset + sp.nbytes] = b

    def _unpack(self, arena: _Arena, slot: int) -> list[np.ndarray]:
        """Slot bytes -> [L, ...] codec leaves (numpy, flatten order)."""
        row = arena.buf[slot]
        out = []
        for sp in self._specs:
            per = []
            for li in range(self.n_layers):
                base = li * self.layer_stride + sp.offset
                per.append(np.frombuffer(row[base:base + sp.nbytes]
                                         .tobytes(), sp.dtype)
                           .reshape(sp.shape))
            out.append(np.stack(per))
        return out

    # -- trie ---------------------------------------------------------------

    def lookup(self, prompt: list[int]) -> list[TierRecord]:
        """Records covering ``prompt``'s page-boundary prefix, from the
        root; the walk breaks at the first missing or quarantined block
        (same cap as the device cache: the last token is never stored)."""
        stored = len(prompt) - 1
        out: list[TierRecord] = []
        dg, b = ROOT, 0
        while (b + 1) * self.page <= stored:
            child = child_digest(dg, tuple(prompt[b * self.page:
                                                  (b + 1) * self.page]))
            rec = self._records.get(child)
            if rec is None or rec.corrupt:
                break
            out.append(rec)
            dg = child
            b += 1
        return out

    def record_count(self) -> int:
        return len(self._records)

    # -- demote -------------------------------------------------------------

    def demote(self, parent: str, toks: tuple[int, ...],
               leaves: list[np.ndarray], nbytes: list[int],
               codec_ids: list[int], checksums: list[int],
               hits: int = 0, source: str = "prompt") -> TierRecord | None:
        """Capture an evicted entry's compressed pages host-ward.

        ``leaves`` are the device-gathered codec leaves ``[L, ...]`` in
        pool flatten order; ``nbytes``/``codec_ids``/``checksums`` the
        engine's per-layer publish metadata.  Returns the record, or
        ``None`` when the bytes had to be dropped (arenas full of
        higher-value records).
        """
        assert len(toks) == self.page
        dg = child_digest(parent, toks)
        rec = self._records.get(dg)
        if rec is not None:
            if not rec.corrupt:
                self.stats["dedup"] += 1
                rec.hits = max(rec.hits, hits)
                return rec
            # heal a quarantined record in place with fresh bytes
            self._pack(self._arena(rec), rec.slot, leaves)
            rec.nbytes, rec.codec_ids = list(nbytes), list(codec_ids)
            rec.checksums = [int(c) for c in checksums]
            rec.corrupt = False
        else:
            slot = self._alloc_host_slot()
            if slot is None:
                self.stats["drops"] += 1
                return None
            self._pack(self.host, slot, leaves)
            self._clock += 1
            depth = (self._records[parent].depth + 1
                     if parent in self._records else
                     0 if parent == ROOT else 1)
            rec = TierRecord(digest=dg, parent=parent, depth=depth,
                             toks=tuple(toks), slot=slot, level="host",
                             nbytes=list(nbytes),
                             codec_ids=list(codec_ids),
                             checksums=[int(c) for c in checksums],
                             hits=hits, born=self._clock, source=source)
            self._records[dg] = rec
            self._kids[parent] = self._kids.get(parent, 0) + 1
        self.stats["demotions"] += 1
        if self.observatory is not None:
            self.observatory.audit.record(
                "tier_demote", digest=dg, depth=rec.depth,
                nbytes=sum(rec.nbytes), level=rec.level, hits=rec.hits,
                source=source)
        return rec

    # -- promote (read side) ------------------------------------------------

    def read_record(self, rec: TierRecord
                    ) -> tuple[list[np.ndarray], bool]:
        """Unpack a record's leaves and verify them against the engine's
        publish-time checksums.  A mismatch quarantines the record (it
        never serves a promotion) and returns ``ok=False``."""
        leaves = self._unpack(self._arena(rec), rec.slot)
        got = np_page_checksums(leaves)
        if not np.array_equal(got, np.asarray(rec.checksums, np.uint32)):
            rec.corrupt = True
            self.stats["corrupt"] += 1
            if self.observatory is not None:
                self.observatory.audit.record(
                    "tier_corrupt", digest=rec.digest, depth=rec.depth,
                    level=rec.level)
            return leaves, False
        return leaves, True

    def on_promoted(self, rec: TierRecord) -> None:
        """Accounting for one record scattered back to the device pool
        (the tier is inclusive: the record stays resident)."""
        rec.hits += 1
        self.stats["promotions"] += 1
        if self.observatory is not None:
            self.observatory.audit.record(
                "tier_promote", digest=rec.digest, depth=rec.depth,
                nbytes=sum(rec.nbytes), level=rec.level, hits=rec.hits)

    # -- replacement --------------------------------------------------------

    def _value(self, rec: TierRecord) -> tuple:
        """CAMP-style ranking: quarantined first, then reuse over the
        power-of-two bucket of compressed size, born as tiebreak."""
        return (not rec.corrupt,
                (rec.hits + 1) / _pow2_bucket(max(sum(rec.nbytes), 1)),
                rec.born)

    def _leaves_at(self, level: str) -> list[TierRecord]:
        return [r for r in self._records.values()
                if r.level == level and not self._kids.get(r.digest, 0)]

    def _drop_record(self, rec: TierRecord) -> None:
        assert not self._kids.get(rec.digest, 0), "drop of a non-leaf"
        self._arena(rec).free(rec.slot)
        del self._records[rec.digest]
        self._kids[rec.parent] = self._kids.get(rec.parent, 1) - 1
        if not self._kids.get(rec.parent, 0):
            self._kids.pop(rec.parent, None)
        self._kids.pop(rec.digest, None)
        self.stats["evictions"] += 1

    def _alloc_host_slot(self) -> int | None:
        slot = self.host.alloc()
        if slot is not None:
            return slot
        # spill first: moving a record to disk keeps it resident, so any
        # non-corrupt host record qualifies (dropping, below, is leaf-only
        # — removing an inner trie node would orphan its descendants)
        if self.disk is not None:
            cands = [r for r in self._records.values()
                     if r.level == "host" and not r.corrupt]
            if cands:
                victim = min(cands, key=self._value)
                dslot = self.disk.alloc()
                if dslot is None:
                    dleaves = self._leaves_at("disk")
                    if dleaves:
                        self._drop_record(min(dleaves, key=self._value))
                        self.stats["drops"] += 1
                        dslot = self.disk.alloc()
                if dslot is not None:
                    self.disk.buf[dslot] = self.host.buf[victim.slot]
                    self.host.free(victim.slot)
                    victim.slot, victim.level = dslot, "disk"
                    self.stats["spills"] += 1
                    if self.observatory is not None:
                        self.observatory.audit.record(
                            "tier_spill", digest=victim.digest,
                            depth=victim.depth, nbytes=sum(victim.nbytes))
                    return self.host.alloc()
        cands = self._leaves_at("host")
        if not cands:
            return None
        self._drop_record(min(cands, key=self._value))
        self.stats["drops"] += 1
        return self.host.alloc()

    # -- telemetry ----------------------------------------------------------

    def logical_bytes(self) -> int:
        """Device-reported compressed bytes resident in the tier."""
        return sum(sum(r.nbytes) for r in self._records.values())

    def sample_metrics(self) -> None:
        """Sync counters/gauges into the attached registry (export
        time, off every hot path)."""
        if self.telemetry is None:
            return
        reg = self.telemetry.registry
        for k, v in self.stats.items():
            c = reg.counter(f"tier_{k}_total",
                            f"tier page-store {k} (cumulative)")
            if v > c.value:
                c.inc(v - c.value)
        reg.gauge("tier_records", "resident tier records"
                  ).set(len(self._records))
        reg.gauge("tier_host_slots_used", "occupied host-arena slots"
                  ).set(self.host.used)
        reg.gauge("tier_host_slots", "host-arena capacity"
                  ).set(self.host.n_slots)
        reg.gauge("tier_logical_bytes",
                  "compressed bytes resident in the tier"
                  ).set(self.logical_bytes())
        if self.disk is not None:
            reg.gauge("tier_disk_slots_used", "occupied disk-arena slots"
                      ).set(self.disk.used)
            reg.gauge("tier_disk_slots", "disk-arena capacity"
                      ).set(self.disk.n_slots)

    # -- snapshot / persist --------------------------------------------------

    def _rec_meta(self, rec: TierRecord) -> dict:
        return {"digest": rec.digest, "parent": rec.parent,
                "depth": rec.depth, "toks": list(rec.toks),
                "nbytes": list(rec.nbytes),
                "codec_ids": list(rec.codec_ids),
                "checksums": [int(c) for c in rec.checksums],
                "hits": rec.hits, "born": rec.born,
                "corrupt": rec.corrupt, "source": rec.source}

    def tier_arrays(self) -> dict[str, np.ndarray]:
        """Packed slot bytes for every resident record, insertion order
        (one [n_records, slot_bytes] array for the checkpoint store)."""
        recs = list(self._records.values())
        data = np.zeros((len(recs), self.slot_bytes), np.uint8)
        for i, rec in enumerate(recs):
            data[i] = self._arena(rec).buf[rec.slot]
        return {"tier_data": data}

    def meta_state(self) -> dict:
        """JSON-serializable record/config metadata matching
        :meth:`tier_arrays` row order."""
        return {"codec": self.codec_name, "n_layers": self.n_layers,
                "page": self.page, "slot_bytes": self.slot_bytes,
                "host_slots": self.host.n_slots,
                "clock": self._clock, "stats": dict(self.stats),
                "records": [self._rec_meta(r)
                            for r in self._records.values()]}

    def load_state(self, meta: dict, arrays: dict[str, np.ndarray]) -> None:
        """Repopulate a freshly built store from captured state; rows
        land back in the host arena (spilling per current capacity)."""
        assert meta["codec"] == self.codec_name, \
            f"tier codec mismatch: {meta['codec']} != {self.codec_name}"
        assert meta["n_layers"] == self.n_layers \
            and meta["page"] == self.page \
            and meta["slot_bytes"] == self.slot_bytes
        self._clock = meta["clock"]
        self.stats.update(meta["stats"])
        data = arrays["tier_data"]
        for i, d in enumerate(meta["records"]):
            slot = self._alloc_host_slot()
            if slot is None:
                self.stats["drops"] += 1
                continue
            self.host.buf[slot] = data[i]
            rec = TierRecord(digest=d["digest"], parent=d["parent"],
                             depth=d["depth"], toks=tuple(d["toks"]),
                             slot=slot, level="host",
                             nbytes=list(d["nbytes"]),
                             codec_ids=list(d["codec_ids"]),
                             checksums=list(d["checksums"]),
                             hits=d["hits"], born=d["born"],
                             corrupt=d["corrupt"],
                             source=d.get("source", "prompt"))
            self._records[rec.digest] = rec
            self._kids[rec.parent] = self._kids.get(rec.parent, 0) + 1

    def persist(self, ckpt_dir: str, *, step: int = 0,
                compress: bool = True) -> dict:
        """Write the whole tier (bytes + trie metadata) through the
        checkpoint store's atomic/verified/compressed path, so the warm
        cache survives an engine restart."""
        return store.persist(ckpt_dir, step, self.tier_arrays(),
                             self.meta_state(), kind="tier-cache",
                             compress=compress)

    @classmethod
    def restore(cls, ckpt_dir: str, cfg, codec, *, step: int | None = None,
                host_mb: float = 64, disk_dir: str | None = None,
                disk_mb: float | None = None) -> "TieredPageStore":
        """Rebuild a persisted tier for a fresh engine (same model +
        codec; arena sizing may differ — overflow spills or drops)."""
        arrays, meta, _ = store.restore_component(ckpt_dir,
                                                  kind="tier-cache",
                                                  step=step)
        tier = cls.for_model(cfg, meta["page"], codec, host_mb=host_mb,
                             disk_dir=disk_dir, disk_mb=disk_mb)
        tier.load_state(meta, arrays)
        return tier
