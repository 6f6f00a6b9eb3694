"""Resilience layer (port of ``repro/serving/faults.py``): the failure
taxonomy, per-page checksums, the integrity checks, fault injection and
the engine invariant checker.

  * :class:`FinishReason` — terminal request outcomes (str-valued).
  * **Page integrity** — :func:`page_checksums`, a position-weighted
    byte sum per page in wrapping uint32, computed inside the engine's
    publish and recomputed at the trust boundaries: warm prefix hits at
    admission (:func:`verified_prefix`), retirement (:func:`verify_seq`)
    and preemption victims.  It must equal the JAX function bit for bit
    on the same pages, so checksums written by one package verify in the
    other; PyTorch's uint32 arithmetic is thin, so it runs in int64
    masked to 32 bits, the multiplier split in 16-bit halves so no
    product leaves int64.  :func:`pair_checksums` gathers ``(layer,
    pid)`` pages out of the pools (on the card when they live there) at
    the exact index length; JAX pads it to a power of two only to bound
    its retraces, which changes no result.
  * :class:`FaultInjector` — deterministic, seeded faults: a bit flipped
    in a published page's compressed bytes (in place in the pool),
    garbage decode tokens, free-list holds and arrival bursts.  The
    randomness is one ``np.random.default_rng(seed)`` drawn at the JAX
    injector's points, so the ``log`` equals the JAX one for the same
    spec, seed and workload.
  * :func:`debug_validate` — every pool page owned exactly once, cache
    refcounts equal live pins, batch slots partition exactly.

Every helper takes the engine duck-typed; the engine imports this module.
"""

from __future__ import annotations

import enum
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.serving._tree import tree_leaves, tree_map


class FinishReason(str, enum.Enum):
    """Terminal request outcomes (str-valued: ``== "eos"`` still works)."""
    EOS = "eos"                  # emitted the request's eos_id
    LENGTH = "length"            # reached max_new_tokens
    PREEMPTED = "preempted"      # CAMP-preempted past the requeue limit
    REJECTED = "rejected"        # bounded queue / overload admission reject
    DEADLINE = "deadline"        # TTFT or total deadline exceeded
    CORRUPTED = "corrupted-retries-exhausted"  # integrity retries exhausted

    def __str__(self) -> str:          # repr/str parity with plain strings
        return self.value


class PoolExhaustedError(RuntimeError):
    """Page reservation found nothing evictable (pool truly exhausted)."""


class SchedulerStalledError(RuntimeError):
    """The scheduler made no progress for ``stall_limit`` iterations."""


# a token id no vocabulary contains: what a NaN-logit argmax degenerates
# to in this fault model; the scheduler's range check catches it the same
# iteration it is emitted
GARBAGE_TOKEN = -(1 << 20)


_MIX = 2654435761                      # Knuth multiplicative hash constant
_MASK = 0xFFFFFFFF


def _mul_mix(x: torch.Tensor) -> torch.Tensor:
    """(x * _MIX) mod 2^32 for int64 x in [0, 2^32), without overflow."""
    lo = x * (_MIX & 0xFFFF)
    hi = ((x * (_MIX >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def page_checksums(pg) -> torch.Tensor:
    """Position-weighted byte sum per page, wrapping uint32.

    ``pg`` is a (possibly nested) NamedTuple of page leaves leading with
    the page axis ``[n, ...]``; leaves hash in ``jax.tree.leaves`` order
    (depth first, field order), bytes little-endian (as JAX's
    ``bitcast_convert_type`` lays them out).  Returns int64 ``[n]``
    holding the uint32 values.
    """
    leaves = [lf for lf in tree_leaves(pg) if lf.numel()]
    n = leaves[0].shape[0]
    dev = leaves[0].device
    acc = torch.zeros(n, dtype=torch.int64, device=dev)
    for lf in leaves:
        b = lf.contiguous().view(torch.uint8).reshape(n, -1).to(torch.int64)
        w = _mul_mix(torch.arange(b.shape[1], dtype=torch.int64,
                                  device=dev)) + 1
        w = w & _MASK
        # each product < 2^40 and a row of them sums well inside int64
        acc = (acc + (b * w).sum(dim=1)) & _MASK
        acc = (_mul_mix(acc) + 1) & _MASK   # leaf order matters too
    return acc


def pair_checksums(engine, pairs: list[tuple[int, int]]) -> np.ndarray:
    """Recompute checksums of ``(layer, pid)`` pool pages (uint32 [n]):
    one gather per pool leaf on the pools' device, one copy of the sums
    to the host."""
    dev = tree_leaves(engine.pools)[0].device
    la = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=dev)
    pa = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=dev)
    pg = tree_map(lambda a: a[la, pa], engine.pools)
    return page_checksums(pg).cpu().numpy().astype(np.uint32)


def verify_pages(engine, pairs: list[tuple[int, int]]) -> np.ndarray:
    """bool [n]: does each ``(layer, pid)`` page still match its
    publish-time checksum?"""
    if not pairs:
        return np.ones(0, bool)
    got = pair_checksums(engine, pairs)
    want = np.asarray([engine.page_checksum[p] for _, p in pairs],
                      np.uint32)
    return got == want


def verify_seq(engine, sid: int) -> bool:
    """Verify every pool page a sequence maps; quarantine corrupt shared
    prefix entries so later lookups skip them.  Sets ``seq.corrupted``
    (and returns False) on any mismatch — the scheduler turns that into
    a restart from the original prompt."""
    seq = engine.seqs[sid]
    lyr = engine.cfg.n_layers
    pairs = [(li, pid) for li in range(lyr) for pid in seq.pages[li]]
    if not pairs:
        return True
    ok = verify_pages(engine, pairs)
    if ok.all():
        return True
    ns = len(seq.chain)
    if ns and engine.prefix_cache is not None:
        nblk = len(seq.pages[0])
        for j, good in enumerate(ok):
            blk = j % nblk                 # pairs are layer-major
            if not good and blk < ns:
                engine.prefix_cache.quarantine(seq.chain[blk])
    seq.corrupted = True
    return False


def verified_prefix(engine, start: int, chain: list[int]
                    ) -> tuple[int, list[int]]:
    """Admission-time warm-hit check: truncate a looked-up chain at its
    first corrupt entry (quarantined, and purged once unpinned), so a warm
    request never maps bad pages; it recomputes from there like a shorter
    hit.  Returns the (possibly shortened) ``(start, chain)``."""
    cache = engine.prefix_cache
    if not chain:
        return start, chain
    lyr, page = engine.cfg.n_layers, engine.page
    pairs = [(li, cache.entries[eid].pages[li])
             for eid in chain for li in range(lyr)]
    ok = verify_pages(engine, pairs)
    for b, eid in enumerate(chain):
        if not ok[b * lyr:(b + 1) * lyr].all():
            cache.quarantine(eid)
            engine.free.extend(cache.purge_corrupt())
            return b * page, chain[:b]
    return start, chain


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

@dataclass
class FaultSpec:
    """Deterministic fault schedule (all counters start at 1).

    ``corrupt_page_every=N``: every Nth published page (counted per page
    across layers) gets one bit flipped in its compressed pool bytes,
    after its checksum is recorded.  ``garble_decode_every=N``: every Nth
    decode step replaces one active sequence's token with
    :data:`GARBAGE_TOKEN`.  ``holds``: ``(start_iter, n_pages,
    duration_iters)`` windows during which ``n_pages`` free-list pages are
    unallocatable.  ``bursts``: ``{iteration: extra_requests}`` for the
    code that submits the workload (:meth:`FaultInjector.burst`).
    """
    corrupt_page_every: int = 0
    corrupt_max: int | None = None
    garble_decode_every: int = 0
    garble_max: int | None = None
    holds: tuple[tuple[int, int, int], ...] = ()
    bursts: dict[int, int] = field(default_factory=dict)


class FaultInjector:
    """Seeded deterministic fault injector over one engine: hand the same
    instance to the engine (publish/decode hooks) and the scheduler
    (iteration hook).  The rng is drawn only when a fault fires, so the
    event ``log`` is a function of ``(spec, seed)`` and the workload."""

    def __init__(self, spec: FaultSpec | None = None, *, seed: int = 0):
        self.spec = spec or FaultSpec()
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.log: list[tuple] = []
        self._pub_ctr = 0
        self._dec_ctr = 0
        self._holds: list[tuple[int, list[int]]] = []   # (release_iter, pids)
        self._holds_started: set[int] = set()
        self.stats = {"corruptions": 0, "garbled": 0, "pages_held": 0}
        # set by the owning engine; :meth:`sample_metrics` mirrors the
        # counters into its registry at export time
        self.telemetry = None

    def sample_metrics(self) -> None:
        if self.telemetry is None:
            return
        reg = self.telemetry.registry
        for k, v in self.stats.items():
            reg.gauge(f"faults_{k}_injected").set(v)

    # -- compressed-page corruption (publish hook) --------------------------

    def page_published(self, engine, layer: int, pid: int) -> None:
        """Engine hook: called once per freshly published (layer, page)."""
        sp = self.spec
        if not sp.corrupt_page_every:
            return
        if sp.corrupt_max is not None \
                and self.stats["corruptions"] >= sp.corrupt_max:
            return
        self._pub_ctr += 1
        if self._pub_ctr % sp.corrupt_page_every == 0:
            self.corrupt_page(engine, layer, pid)

    def corrupt_page(self, engine, layer: int, pid: int,
                     bit: int | None = None) -> None:
        """Flip one bit of a pool page's compressed bytes (the first
        nonempty leaf in ``jax.tree.leaves`` order), in place in the pool
        on whatever device it lives."""
        leaf = next(lf for lf in tree_leaves(engine.pools)
                    if lf[layer, pid].numel())
        raw = leaf[layer, pid].reshape(-1).view(torch.uint8)   # a view
        if bit is None:
            bit = int(self.rng.integers(0, raw.numel() * 8))
        raw[(bit // 8) % raw.numel()] ^= 1 << (bit % 8)
        self.stats["corruptions"] += 1
        self.log.append(("corrupt", layer, pid, bit))

    # -- garbage decode tokens (argmax hook) --------------------------------

    def _garble_fires(self) -> bool:
        sp = self.spec
        if not sp.garble_decode_every:
            return False
        if sp.garble_max is not None \
                and self.stats["garbled"] >= sp.garble_max:
            return False
        self._dec_ctr += 1
        return self._dec_ctr % sp.garble_decode_every == 0

    def garble_tokens(self, nxt: np.ndarray, slots: list[int]) -> np.ndarray:
        """Maybe replace one active slot's token with the garbage id."""
        if not slots or not self._garble_fires():
            return nxt
        slot = slots[int(self.rng.integers(0, len(slots)))]
        nxt = nxt.copy()
        nxt[slot] = GARBAGE_TOKEN
        self.stats["garbled"] += 1
        self.log.append(("garble", slot))
        return nxt

    def garble_one(self, tok: int) -> int:
        """Reference-engine hook: maybe replace one decoded token."""
        if not self._garble_fires():
            return tok
        self.stats["garbled"] += 1
        self.log.append(("garble", -1))
        return GARBAGE_TOKEN

    # -- pool-allocation failure (scheduler iteration hook) -----------------

    def on_iteration(self, engine, iteration: int) -> None:
        """Start/expire free-list holds scheduled for this iteration."""
        for start, n, dur in self.spec.holds:
            if iteration >= start and start not in self._holds_started:
                self._holds_started.add(start)
                take = min(n, len(engine.free))
                pids = [engine.free.pop() for _ in range(take)]
                self._holds.append((start + dur, pids))
                self.stats["pages_held"] += take
                self.log.append(("hold", start, take))
        kept = []
        for release, pids in self._holds:
            if iteration >= release:
                engine.free.extend(pids)
                self.log.append(("release", release, len(pids)))
            else:
                kept.append((release, pids))
        self._holds = kept

    def release_holds(self, engine) -> None:
        """Return every held page (drain / teardown)."""
        for _, pids in self._holds:
            engine.free.extend(pids)
        self._holds = []

    @property
    def held_pages(self) -> list[int]:
        return [pid for _, pids in self._holds for pid in pids]

    # -- arrival bursts (workload hook) --------------------------------------

    def burst(self, iteration: int) -> int:
        """Extra requests to submit at this iteration."""
        return self.spec.bursts.get(iteration, 0)


# ---------------------------------------------------------------------------
# engine invariant checker
# ---------------------------------------------------------------------------

def debug_validate(engine) -> None:
    """Assert the engine's page/refcount/slot accounting is exact.

    Every pool page (ids 1..P-1; 0 is the padding page) is owned by
    exactly one of: the free list, an injector hold, a live sequence's
    private pages, or a prefix-cache entry.  Shared chain pages map the
    cache entry's pages; cache refcounts equal live pins; children
    counters match the trie; batch slots partition exactly.  Raises
    ``AssertionError`` on any violation (it is a debugging check, called
    by tests and chaos drains).
    """
    cap = engine.n_pool_pages - 1
    free = engine.free
    free_set = set(free)
    assert len(free_set) == len(free), "duplicate pages on the free list"
    assert 0 not in free_set, "padding page 0 on the free list"

    held = set(engine.faults.held_pages) if engine.faults is not None \
        else set()
    cache = engine.prefix_cache
    cache_pages = {pid for e in cache.entries.values() for pid in e.pages} \
        if cache is not None else set()

    lyr = engine.cfg.n_layers
    private: list[int] = []
    for s in engine.seqs.values():
        ns = len(s.chain)
        for li in range(lyr):
            assert len(s.pages[li]) == len(s.pages[0]), \
                f"sid {s.sid}: ragged page lists"
            private.extend(s.pages[li][ns:])
            for b, eid in enumerate(s.chain):
                assert s.pages[li][b] == cache.entries[eid].pages[li], \
                    f"sid {s.sid} layer {li} block {b}: chain mapping drift"
    private_set = set(private)
    assert len(private_set) == len(private), \
        "a private page is mapped twice"

    for a, b, what in [(free_set, private_set, "free∩private"),
                       (free_set, cache_pages, "free∩cache"),
                       (free_set, held, "free∩held"),
                       (private_set, cache_pages, "private∩cache"),
                       (held, private_set | cache_pages, "held∩mapped")]:
        assert not (a & b), f"page owned twice ({what}): {sorted(a & b)}"
    total = len(free_set) + len(held) + len(private_set) + len(cache_pages)
    assert total == cap, (f"page leak: free {len(free_set)} + held "
                          f"{len(held)} + private {len(private_set)} + "
                          f"cache {len(cache_pages)} != pool {cap}")

    if cache is not None:
        pins = Counter(eid for s in engine.seqs.values() for eid in s.chain)
        for eid, e in cache.entries.items():
            assert e.refcount == pins.get(eid, 0), \
                f"entry {eid}: refcount {e.refcount} != {pins.get(eid, 0)} pins"
        kids = Counter(e.parent for e in cache.entries.values() if e.parent)
        for eid, e in cache.entries.items():
            assert e.children == kids.get(eid, 0), \
                f"entry {eid}: children {e.children} != {kids.get(eid, 0)}"
            assert e.parent == 0 or e.parent in cache.entries, \
                f"entry {eid}: dangling parent {e.parent}"

    if hasattr(engine, "_free_slots"):   # the batched engine only
        slots = (list(engine._free_slots)
                 + [s.slot for s in engine.seqs.values()])
        assert sorted(slots) == list(range(engine.max_batch)), \
            f"slot accounting drift: {sorted(slots)}"
