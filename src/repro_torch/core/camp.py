"""Compression-Aware Management Policies (Chapter 4): MVE + SIP = CAMP.

Trace-driven compressed-cache simulator reproducing the paper's policy
comparisons (Figures 4.8/4.9, Table 4.3):

  * local (set-associative, 2x tags, segmented data store — the BDI cache
    organization of Section 3.5): LRU, RRIP, ECM, MVE, SIP, CAMP;
  * global (V-Way-style decoupled tag/data store with Reuse Replacement):
    V-Way, G-MVE, G-SIP, G-CAMP;
  * Belady's OPT (size-oblivious) for the Figure 4.1 motivating example.

The serving-side prefix cache (serving/prefix_cache.py) applies the same
ideas to live traffic: compressed *page* size is the block size, reuse is
request-stream locality.  It reuses this module's size-bin/value helpers
but keeps its own trie-shaped bookkeeping; the ``GlobalCache``
pin/unpin/update_size hooks below are the trace-simulator twins of the
two semantics that integration made necessary — refcount pinning (shared
KV pages must never be victimized out from under a live sequence) and an
external size feed (compressed page bytes arrive from the device-side
codec, not from the trace) — so policy experiments here can model the
serving constraints.

Pure Python/NumPy; the unit is one cache "block" with a compressed size in
bytes (segmented like the hardware: ceil(size/segment) segments).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

RRPV_BITS = 3
RRPV_MAX = (1 << RRPV_BITS) - 1          # 7: distant re-reference
RRPV_LONG = RRPV_MAX - 1                 # 6: default insertion (SRRIP)

N_SIZE_BINS = 8


def size_bin(size: int, line_bytes: int = 64) -> int:
    """Bucket compressed sizes into 8 bins (paper Sec 4.3.3)."""
    return min(N_SIZE_BINS - 1, (max(size, 1) - 1) * N_SIZE_BINS // line_bytes)


def _pow2_bucket(size: int) -> int:
    """MVE size bucketing: s_i is a power of two (Sec 4.3.2)."""
    return 1 << max(1, math.ceil(math.log2(max(size, 1))) )


@dataclass
class Block:
    tag: int
    size: int                  # compressed bytes
    rrpv: int = RRPV_LONG
    last_use: int = 0
    reuse_ctr: int = 0         # V-Way Reuse Replacement counter
    region: int = 0
    pins: int = 0              # refcount: pinned blocks are never evicted

    def segments(self, seg: int) -> int:
        return max(1, math.ceil(self.size / seg))


# ---------------------------------------------------------------------------
# Local (set-associative) compressed cache
# ---------------------------------------------------------------------------

class LocalCache:
    """Set-associative compressed cache with pluggable management policy.

    Data store: ``ways * line_bytes`` bytes per set in ``segment`` units;
    tag store: ``tag_factor * ways`` tags per set (the BDI organization).
    """

    POLICIES = ("lru", "rrip", "ecm", "mve", "sip", "camp")

    def __init__(self, n_sets: int, ways: int, policy: str,
                 line_bytes: int = 64, segment: int = 8, tag_factor: int = 2,
                 sip_sample_stride: int = 4,
                 sip_train_period: int = 10_000,
                 capacity_bytes: int | None = None):
        assert policy in self.POLICIES, policy
        self.n_sets, self.ways, self.policy = n_sets, ways, policy
        self.line_bytes, self.segment = line_bytes, segment
        per_set = (capacity_bytes // n_sets if capacity_bytes
                   else ways * line_bytes)
        self.capacity_segments = max(1, per_set // segment)
        self.max_tags = tag_factor * ways
        self.sets: list[list[Block]] = [[] for _ in range(n_sets)]
        self.clock = 0
        self.hits = 0
        self.misses = 0
        # --- SIP state (dynamic set sampling, Fig 4.5) ---
        self.sip_on = policy in ("sip", "camp")
        self.sip_stride = sip_sample_stride
        self.sip_train_period = sip_train_period
        self.sip_ctr = np.zeros(N_SIZE_BINS, dtype=np.int64)
        self.sip_priority = np.zeros(N_SIZE_BINS, dtype=bool)
        self._atd: dict[int, list[Block]] = {}   # sampled-set shadow tags
        # --- ECM dynamic threshold state ---
        self._size_sum = 0
        self._size_cnt = 0

    # -- helpers ----------------------------------------------------------

    def _set_index(self, addr: int) -> int:
        return (addr // self.line_bytes) % self.n_sets

    def _atd_bin(self, set_i: int) -> int | None:
        """Which size bin this sampled set trains for (None = unsampled)."""
        if set_i % self.sip_stride == 0:
            return (set_i // self.sip_stride) % N_SIZE_BINS
        return None

    def _in_training(self) -> bool:
        return (self.clock % self.sip_train_period) < self.sip_train_period // 10

    def _used_segments(self, blocks: list[Block]) -> int:
        return sum(b.segments(self.segment) for b in blocks)

    # -- policy hooks -------------------------------------------------------

    def _insert_rrpv(self, size: int) -> int:
        if self.policy == "ecm":
            # ECM: big blocks inserted with distant re-reference prediction
            avg = self._size_sum / max(self._size_cnt, 1)
            return RRPV_MAX if size > avg else RRPV_LONG
        if self.sip_on and not self._in_training():
            if self.sip_priority[size_bin(size, self.line_bytes)]:
                return 0  # high priority (short re-reference prediction)
        return RRPV_LONG

    def _value(self, b: Block) -> float:
        """MVE value function V = p / s (Sec 4.3.2)."""
        p = RRPV_MAX + 1 - b.rrpv
        return p / _pow2_bucket(b.size)

    def _evict_from(self, blocks: list[Block], need_segments: int,
                    need_tags: int) -> None:
        while (self._used_segments(blocks) + need_segments
               > self.capacity_segments) or len(blocks) + need_tags > self.max_tags:
            if not blocks:
                return
            if self.policy == "lru":
                victim = min(blocks, key=lambda b: b.last_use)
            elif self.policy in ("rrip", "sip"):
                while not any(b.rrpv >= RRPV_MAX for b in blocks):
                    for b in blocks:
                        b.rrpv = min(RRPV_MAX, b.rrpv + 1)
                victim = next(b for b in blocks if b.rrpv >= RRPV_MAX)
            elif self.policy == "ecm":
                while not any(b.rrpv >= RRPV_MAX for b in blocks):
                    for b in blocks:
                        b.rrpv = min(RRPV_MAX, b.rrpv + 1)
                pool = [b for b in blocks if b.rrpv >= RRPV_MAX]
                victim = max(pool, key=lambda b: b.size)  # biggest in pool
            else:  # mve / camp
                victim = min(blocks, key=self._value)
            blocks.remove(victim)

    # -- main access path ---------------------------------------------------

    def access(self, addr: int, size: int) -> bool:
        """One cache access; returns hit?"""
        self.clock += 1
        self._size_sum += size
        self._size_cnt += 1
        set_i = self._set_index(addr)
        blocks = self.sets[set_i]
        sbin = size_bin(size, self.line_bytes)

        hit = False
        for b in blocks:
            if b.tag == addr:
                b.rrpv = 0
                b.last_use = self.clock
                b.reuse_ctr += 1
                hit = True
                break

        if self.sip_on and self._in_training():
            self._sip_train(set_i, addr, size, mtd_hit=hit)
        elif self.sip_on and self.clock % self.sip_train_period == 0:
            self._sip_commit()

        if hit:
            self.hits += 1
            return True

        self.misses += 1
        blk = Block(addr, size, rrpv=self._insert_rrpv(size),
                    last_use=self.clock)
        self._evict_from(blocks, blk.segments(self.segment), 1)
        blocks.append(blk)
        return False

    # -- SIP training (auxiliary tag directory) ------------------------------

    def _sip_train(self, set_i: int, addr: int, size: int,
                   mtd_hit: bool) -> None:
        tbin = self._atd_bin(set_i)
        if tbin is None:
            return
        atd = self._atd.setdefault(set_i, [])
        atd_hit = False
        for b in atd:
            if b.tag == addr:
                b.rrpv = 0
                b.last_use = self.clock
                atd_hit = True
                break
        if not mtd_hit:
            self.sip_ctr[tbin] += 1          # MTD miss
        if not atd_hit:
            self.sip_ctr[tbin] -= 1          # ATD miss
            rrpv = 0 if size_bin(size, self.line_bytes) == tbin else RRPV_LONG
            blk = Block(addr, size, rrpv=rrpv, last_use=self.clock)
            self._evict_from(atd, blk.segments(self.segment), 1)
            atd.append(blk)

    def _sip_commit(self) -> None:
        self.sip_priority = self.sip_ctr > 0
        self.sip_ctr[:] = 0
        self._atd.clear()

    # -- metrics -------------------------------------------------------------

    @property
    def miss_rate(self) -> float:
        total = self.hits + self.misses
        return self.misses / total if total else 0.0


# ---------------------------------------------------------------------------
# Global (V-Way-style) compressed cache
# ---------------------------------------------------------------------------

class GlobalCache:
    """Decoupled tag/data store with a global replacement pool (Sec 4.3.4).

    Policies: 'vway' (Reuse Replacement), 'gmve', 'gsip', 'gcamp'.
    The data store is one global segment pool partitioned into
    ``n_regions`` regions; victim search scans up to 64 candidates starting
    at a per-region clock pointer, decrementing reuse counters (V-Way).
    """

    POLICIES = ("vway", "gmve", "gsip", "gcamp")

    def __init__(self, capacity_bytes: int, policy: str, segment: int = 8,
                 max_tags: int | None = None, n_regions: int = N_SIZE_BINS,
                 train_period: int = 10_000, line_bytes: int = 64):
        assert policy in self.POLICIES, policy
        self.policy = policy
        self.segment = segment
        self.line_bytes = line_bytes
        self.capacity_segments = capacity_bytes // segment
        self.max_tags = max_tags or (2 * capacity_bytes // line_bytes)
        self.blocks: OrderedDict[int, Block] = OrderedDict()
        self.used_segments = 0
        self.clock = 0
        self.hits = 0
        self.misses = 0
        self.n_regions = n_regions
        self._insert_rr = 0
        # G-SIP region set-dueling state (Fig 4.7)
        self.train_period = train_period
        self.region_ctr = np.zeros(n_regions, dtype=np.int64)
        self.bin_priority = np.zeros(N_SIZE_BINS, dtype=bool)
        self.size_aware = policy in ("gmve", "gcamp")
        self._hand = 0                  # V-Way rotating replacement pointer
        # eviction/deletion split: an optional demotion hook consulted
        # with each victim *before* its tag/data leave the store, so a
        # lower memory tier (serving/tier.py's host/disk arenas are the
        # live-serving twin) can capture the payload instead of losing
        # it.  None keeps _evict byte-identical to the fused behavior.
        self.evict_cb = None

    def _in_training(self) -> bool:
        return (self.clock % self.train_period) < self.train_period // 10

    def _value(self, b: Block) -> float:
        if self.size_aware:
            return (b.reuse_ctr + 1) / _pow2_bucket(b.size)
        return float(b.reuse_ctr)

    # -- refcount pinning + external size feed -------------------------------
    #
    # Trace-side model of the two live-serving semantics the prefix cache
    # (serving/prefix_cache.py) layers onto SIP/CAMP scoring: blocks
    # referenced by running sequences must not be victimized (pin/unpin),
    # and a block's compressed size is only known once the device-side
    # page-fill codec reports it (update_size).

    def pin(self, addr: int) -> None:
        """Pin a block: excluded from victim selection until unpinned."""
        self.blocks[addr].pins += 1

    def unpin(self, addr: int) -> None:
        b = self.blocks[addr]
        assert b.pins > 0, f"unpin of unpinned block {addr:#x}"
        b.pins -= 1

    def update_size(self, addr: int, size: int) -> None:
        """External size feed: re-cost a resident block (e.g. when the
        device-side compressor reports the real compressed byte count)."""
        b = self.blocks[addr]
        self.used_segments -= b.segments(self.segment)
        b.size = size
        self.used_segments += b.segments(self.segment)
        # shrink back under capacity if it grew; no tag is being added,
        # so a full tag store alone must not trigger an eviction here
        self._evict(0, need_tags=0)

    def _evict(self, need_segments: int, need_tags: int = 1) -> None:
        while (self.used_segments + need_segments > self.capacity_segments
               or len(self.blocks) + need_tags > self.max_tags):
            if not self.blocks:
                return
            # scan a window of up to 64 candidates starting at the rotating
            # replacement pointer (the V-Way PTR, Sec 4.3.4), decrementing
            # reuse counters as we pass (Reuse Replacement), evict min-value.
            vals = list(self.blocks.values())
            n = len(vals)
            start = self._hand % n
            cand = [vals[(start + i) % n] for i in range(min(64, n))]
            pool = [b for b in cand if b.pins == 0]
            if not pool:
                pool = [b for b in vals if b.pins == 0]
                if not pool:
                    return      # everything pinned: caller keeps the overflow
            victim = min(pool, key=self._value)
            for b in cand:
                if b is not victim and b.reuse_ctr > 0:
                    b.reuse_ctr -= 1
            self._hand = (start + len(cand)) % n
            self._release(victim)

    def _release(self, victim: Block) -> None:
        """Drop a victim from the tag/data store, consulting the
        demotion hook first (the deletion half of the old fused evict)."""
        if self.evict_cb is not None:
            self.evict_cb(victim)
        self.used_segments -= victim.segments(self.segment)
        del self.blocks[victim.tag]

    def access(self, addr: int, size: int) -> bool:
        self.clock += 1
        if self.policy in ("gsip", "gcamp") \
                and self.clock % self.train_period == self.train_period // 10:
            self._commit_training()     # leaving the training window
        b = self.blocks.get(addr)
        if b is not None:
            b.reuse_ctr += 1
            self.hits += 1
            return True

        self.misses += 1
        region = self._insert_rr % self.n_regions
        self._insert_rr += 1
        blk = Block(addr, size, region=region)
        sbin = size_bin(size, self.line_bytes)
        if self.policy in ("gsip", "gcamp"):
            if self._in_training():
                # region r prioritizes bin r (last region = control)
                if region < N_SIZE_BINS and sbin == region:
                    blk.reuse_ctr = 2
                self.region_ctr[region] += 1
            elif self.bin_priority[sbin]:
                blk.reuse_ctr = 2               # learned high-priority size
        self._evict(blk.segments(self.segment))
        self.blocks[addr] = blk
        self.used_segments += blk.segments(self.segment)
        return False

    def _commit_training(self) -> None:
        control = self.region_ctr[self.n_regions - 1]
        scale = max(control, 1)
        for r in range(min(N_SIZE_BINS, self.n_regions - 1)):
            self.bin_priority[r] = self.region_ctr[r] < scale
        self.region_ctr[:] = 0

    @property
    def miss_rate(self) -> float:
        total = self.hits + self.misses
        return self.misses / total if total else 0.0


# ---------------------------------------------------------------------------
# graceful-degradation ladder (serving overload control)
# ---------------------------------------------------------------------------

class PressureLadder:
    """Hysteretic multi-level degradation ladder over a pressure signal.

    The serving-side twin of the hardware exception discipline: instead
    of one hard capacity cliff, the system sheds load in value order as
    a pressure signal in [0, 1] rises — level 1 first drops speculative
    state (prefix-cache insertions), level 2 cheap-but-deferrable work
    (prefill token share), level 3 new admissions.  Each level has an
    *enter* threshold and a strictly lower *exit* threshold, so a signal
    oscillating inside the band never flaps the level (classic
    Schmitt-trigger hysteresis).  What each level means is the caller's
    contract (``serving/scheduler.py`` wires the three levels above);
    this class only owns the thresholding.
    """

    def __init__(self, enter: tuple[float, ...] = (0.70, 0.85, 0.95),
                 exit: tuple[float, ...] = (0.55, 0.70, 0.85)):
        assert len(enter) == len(exit) and enter, (enter, exit)
        assert all(x < e for x, e in zip(exit, enter)), \
            f"exit thresholds must sit below enter thresholds: {exit} {enter}"
        assert list(enter) == sorted(enter), enter
        assert list(exit) == sorted(exit), exit
        self.enter = tuple(enter)
        self.exit = tuple(exit)
        self.level = 0
        self.transitions = 0

    @property
    def n_levels(self) -> int:
        return len(self.enter)

    def update(self, pressure: float) -> int:
        """Feed one pressure sample; returns the (possibly new) level."""
        while self.level < self.n_levels \
                and pressure >= self.enter[self.level]:
            self.level += 1
            self.transitions += 1
        while self.level > 0 and pressure < self.exit[self.level - 1]:
            self.level -= 1
            self.transitions += 1
        return self.level


# ---------------------------------------------------------------------------
# Belady OPT (size-oblivious) — for the Figure 4.1 motivating example
# ---------------------------------------------------------------------------

def belady_misses(trace: list[tuple[int, int]], capacity_bytes: int,
                  segment: int = 8) -> int:
    """Offline optimal *locality-only* replacement on a variable-size cache."""
    cap = capacity_bytes // segment
    future: dict[int, list[int]] = {}
    for i, (a, _) in enumerate(trace):
        future.setdefault(a, []).append(i)
    cache: dict[int, int] = {}           # addr -> segments
    used = 0
    misses = 0
    for i, (addr, size) in enumerate(trace):
        future[addr].pop(0)
        seg = max(1, math.ceil(size / segment))
        if addr in cache:
            continue
        misses += 1
        while used + seg > cap and cache:
            victim = max(cache, key=lambda a: future[a][0] if future[a]
                         else float("inf"))
            used -= cache.pop(victim)
        cache[addr] = seg
        used += seg
    return misses


def run_policy(trace: list[tuple[int, int]], policy: str,
               capacity_bytes: int = 2 << 20, **kw) -> dict:
    """Run one policy over a trace; returns metrics dict."""
    if policy == "belady":
        m = belady_misses(trace, capacity_bytes)
        return {"policy": policy, "misses": m, "hits": len(trace) - m,
                "miss_rate": m / len(trace)}
    if policy in GlobalCache.POLICIES:
        cache: LocalCache | GlobalCache = GlobalCache(
            capacity_bytes, policy, **kw)
    else:
        line = kw.pop("line_bytes", 64)
        ways = kw.pop("ways", 16)
        n_sets = max(1, capacity_bytes // (ways * line))
        cache = LocalCache(n_sets, ways, policy, line_bytes=line,
                           capacity_bytes=capacity_bytes, **kw)
    for addr, size in trace:
        cache.access(addr, size)
    return {"policy": policy, "misses": cache.misses, "hits": cache.hits,
            "miss_rate": cache.miss_rate}


# ---------------------------------------------------------------------------
# Synthetic traces with size<->reuse correlation (Sec 4.2.3, Fig 4.3/4.4)
# ---------------------------------------------------------------------------

def soplex_like_trace(n_epochs: int = 24, n_a: int = 128, n_b: int = 16,
                      n_c: int = 512, pollution_every: int = 1,
                      seed: int = 0,
                      line_bytes: int = 64) -> list[tuple[int, int]]:
    """Synthetic trace with the paper's size<->reuse signature (Fig 4.3/4.4).

      A : 20-byte blocks, short reuse (hot index array)
      B : 64-byte incompressible blocks, very short reuse (coefficients)
      C : 1-byte (zero) blocks, LONG reuse (one full epoch — sparse matrix
          sweep); tiny when compressed, so worth *retaining* — exactly what
          size-aware policies learn and size-oblivious ones cannot.
      D : 64-byte streaming pollution, never reused.
    """
    del seed
    base_a, base_b, base_c, base_d = 1 << 30, 2 << 30, 3 << 30, 4 << 30
    trace: list[tuple[int, int]] = []
    d_ctr = 0
    for _ in range(n_epochs):
        for i in range(n_c):
            trace.append((base_c + i * line_bytes, 1))
            if i % 4 == 0:
                trace.append((base_a + (i % n_a) * line_bytes, 20))
            trace.append((base_b + (i % n_b) * line_bytes, 64))
            if i % pollution_every == 0:
                trace.append((base_d + d_ctr * line_bytes, 64))
                d_ctr += 1
    return trace


def mcf_like_trace(n: int = 40_000, working_set: int = 8192,
                   seed: int = 1, line_bytes: int = 64) -> list[tuple[int, int]]:
    """Size is NOT indicative of reuse (Fig 4.4f): random sizes, uniform reuse."""
    rng = np.random.default_rng(seed)
    sizes = rng.choice([1, 20, 34, 40, 64], size=n)
    addrs = rng.integers(0, working_set, size=n) * line_bytes
    return list(zip((addrs + (4 << 30)).tolist(), sizes.tolist()))


def fig_4_1_trace() -> tuple[list[tuple[int, int]], int]:
    """The exact Figure 4.1 example: size-aware beats Belady.

    Cache capacity 160 bytes; blocks X,Y uncompressed (64B), A,B,C (32B).
    Initial state {A,B,C,Y}; then access X, A, Y, B, C, B, Y, A.
    """
    A, B, C, X, Y = (i << 12 for i in range(1, 6))
    warm = [(A, 32), (B, 32), (C, 32), (Y, 64)]
    seq = [(X, 64), (A, 32), (Y, 64), (B, 32), (C, 32), (B, 32), (Y, 64),
           (A, 32)]
    return warm + seq, 160
