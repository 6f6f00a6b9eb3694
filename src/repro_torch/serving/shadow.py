"""Ghost simulators: counterfactual retention policies and codec pools
(port of ``repro/serving/shadow.py``; block keys equal across packages).

A cachelib-style *shadow cache* answers "what would the hit rate have
been under policy X / codec Y?" from the live access stream without
touching real serving state.  The engine feeds every shadow the same
two event kinds the real prefix cache sees:

  * ``access(key)``  — a request wants the block named ``key`` (one
    deterministic key per full prompt block, emitted at admission in
    ``engine.begin_cohort`` for *every* block of *every* request — the
    counterfactual stream is policy-independent by construction);
  * ``install(key, nbytes)`` — the block became cacheable with a known
    compressed size (real publish/insert time; sizes are unknown at
    miss time, so admission is deferred exactly like the real cache's).

:class:`ShadowCache` replays one retention policy over that stream
inside a fixed compressed-byte budget:

  * ``sip``   — evict min ``(hits+1)/pow2(nbytes)`` — the untrained
    SIP/G-CAMP value function (no learned priority boost, so shadow-SIP
    is a *floor* on what the real trained policy can do);
  * ``lru``   — evict least-recently-accessed;
  * ``fifo``  — evict oldest-installed;
  * ``gcamp`` — size-oblivious G-CAMP: evict min ``hits+1`` (the
    ablation that shows how much of SIP's win is the size term).

:class:`ShadowSet` runs all four over one stream and publishes
``shadow_hits_total`` / ``shadow_misses_total`` /
``shadow_evictions_total`` / ``shadow_bytes_admitted_total`` counters
and ``shadow_occupancy_bytes`` / ``shadow_entries`` gauges per policy
on the telemetry registry (shadow-SIP against shadow-FIFO is the
comparison that separates the policies).  :class:`CodecShadow`
separately accumulates the counterfactual *byte traffic* of
single-codec pools (``shadow_codec_bytes_total``) from the per-member
would-be sizes the adaptive publish path computes.

Block keys must be stable across processes (snapshot/restore, reruns,
the two packages), so they are chained ``zlib.crc32`` digests over
token bytes — *not* Python ``hash``, which is salted per process.

Stdlib only; everything round-trips through ``state()``/``load_state()``.
"""

from __future__ import annotations

import zlib

from repro_torch.core.camp import _pow2_bucket

POLICIES = ("sip", "lru", "fifo", "gcamp")


def block_keys(tokens, page: int, n_blocks: int | None = None) -> list[str]:
    """Deterministic chained keys for each full ``page``-token block.

    Key k digests blocks 0..k, so two prompts share key k iff they share
    the whole prefix — the same identity rule the real prefix cache's
    parent-chain gives its entries.
    """
    if n_blocks is None:
        n_blocks = len(tokens) // page
    keys: list[str] = []
    crc = 0
    for b in range(n_blocks):
        blk = tokens[b * page:(b + 1) * page]
        crc = zlib.crc32(b" ".join(str(int(t)).encode() for t in blk), crc)
        keys.append(f"{b}:{crc:08x}")
    return keys


class ShadowCache:
    """One counterfactual retention policy over the shared access stream.

    Entries are ``key -> [nbytes, hits, born, last]``; ``clock`` ticks
    once per access or install, giving FIFO/LRU their order.  An entry
    larger than the whole budget is bypassed (never admitted), matching
    the real cache's behaviour of not thrashing for an unserviceable
    insert.
    """

    def __init__(self, policy: str, capacity_bytes: int):
        if policy not in POLICIES:
            raise ValueError(f"unknown shadow policy {policy!r}")
        self.policy = policy
        self.capacity_bytes = int(capacity_bytes)
        self.clock = 0
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_admitted = 0
        self.entries: dict[str, list] = {}

    # -- stream ----------------------------------------------------------------

    def access(self, key: str) -> bool:
        self.clock += 1
        e = self.entries.get(key)
        if e is None:
            self.misses += 1
            return False
        self.hits += 1
        e[1] += 1
        e[3] = self.clock
        return True

    def install(self, key: str, nbytes: int) -> None:
        nbytes = int(nbytes)
        self.clock += 1
        e = self.entries.get(key)
        if e is not None:               # in-cohort twin: refresh size only
            self.used_bytes += nbytes - e[0]
            e[0] = nbytes
            return
        if nbytes > self.capacity_bytes:
            return
        while self.used_bytes + nbytes > self.capacity_bytes:
            self._evict_one()
        self.entries[key] = [nbytes, 0, self.clock, self.clock]
        self.used_bytes += nbytes
        self.bytes_admitted += nbytes

    def _value(self, e: list) -> float:
        nbytes, hits, born, last = e
        if self.policy == "sip":
            return (hits + 1) / _pow2_bucket(max(nbytes, 1))
        if self.policy == "lru":
            return float(last)
        if self.policy == "fifo":
            return float(born)
        return float(hits + 1)          # gcamp: size-oblivious value

    def _evict_one(self) -> None:
        victim = min(self.entries,
                     key=lambda k: (self._value(self.entries[k]),
                                    self.entries[k][2]))
        self.used_bytes -= self.entries.pop(victim)[0]
        self.evictions += 1

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    # -- snapshot/restore ------------------------------------------------------

    def state(self) -> dict:
        return {"policy": self.policy, "capacity": self.capacity_bytes,
                "clock": self.clock, "used": self.used_bytes,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "bytes_admitted": self.bytes_admitted,
                "entries": {k: list(e) for k, e in self.entries.items()}}

    def load_state(self, s: dict) -> None:
        assert s["policy"] == self.policy, (s["policy"], self.policy)
        self.capacity_bytes = s["capacity"]
        self.clock = s["clock"]
        self.used_bytes = s["used"]
        self.hits = s["hits"]
        self.misses = s["misses"]
        self.evictions = s["evictions"]
        self.bytes_admitted = s["bytes_admitted"]
        self.entries = {k: list(e) for k, e in s["entries"].items()}


class ShadowSet:
    """All counterfactual policies fed from one access stream.

    The engine talks to this, not to individual :class:`ShadowCache`
    instances: ``access``/``install`` fan out to every policy, and
    per-policy counters/gauges land on ``registry`` after each event so
    exports always reflect the latest state.  ``note_request``/
    ``install_for``/``forget`` carry the per-sequence block-key lists
    between admission (where keys are computed from the prompt) and
    publish (where compressed sizes become known).
    """

    def __init__(self, registry, capacity_bytes: int = 1 << 20,
                 policies=POLICIES):
        self.registry = registry
        self.caches = {p: ShadowCache(p, capacity_bytes) for p in policies}
        self._seq_keys: dict[int, list[str]] = {}

    @property
    def capacity_bytes(self) -> int:
        return next(iter(self.caches.values())).capacity_bytes

    def set_capacity(self, capacity_bytes: int) -> None:
        for c in self.caches.values():
            c.capacity_bytes = int(capacity_bytes)

    # -- stream ----------------------------------------------------------------

    def access(self, key: str) -> None:
        for c in self.caches.values():
            c.access(key)
        self._publish()

    def install(self, key: str, nbytes: int) -> None:
        for c in self.caches.values():
            c.install(key, nbytes)
        self._publish()

    def note_request(self, sid: int, keys: list[str]) -> None:
        self._seq_keys[sid] = list(keys)
        for k in keys:
            self.access(k)

    def install_for(self, sid: int, blk: int, nbytes: int) -> None:
        keys = self._seq_keys.get(sid)
        if keys is None or blk >= len(keys):
            return
        self.install(keys[blk], nbytes)

    def forget(self, sid: int) -> None:
        self._seq_keys.pop(sid, None)

    # -- reporting -------------------------------------------------------------

    def _publish(self) -> None:
        r = self.registry
        for p, c in self.caches.items():
            r.counter("shadow_hits_total",
                      "shadow-cache hits, by retention policy",
                      policy=p).value = c.hits
            r.counter("shadow_misses_total",
                      "shadow-cache misses, by retention policy",
                      policy=p).value = c.misses
            r.counter("shadow_evictions_total",
                      "shadow-cache evictions, by retention policy",
                      policy=p).value = c.evictions
            r.counter("shadow_bytes_admitted_total",
                      "compressed bytes admitted, by retention policy",
                      policy=p).value = c.bytes_admitted
            r.gauge("shadow_occupancy_bytes",
                    "shadow-cache occupancy, by retention policy",
                    policy=p).set(c.used_bytes)
            r.gauge("shadow_entries",
                    "resident shadow entries, by retention policy",
                    policy=p).set(len(c.entries))

    def hit_rates(self) -> dict[str, float]:
        return {p: c.hit_rate() for p, c in self.caches.items()}

    # -- snapshot/restore ------------------------------------------------------

    def state(self) -> dict:
        return {"caches": {p: c.state() for p, c in self.caches.items()},
                "seq_keys": {str(s): list(k)
                             for s, k in self._seq_keys.items()}}

    def load_state(self, s: dict) -> None:
        for p, cs in s["caches"].items():
            if p in self.caches:
                self.caches[p].load_state(cs)
        self._seq_keys = {int(k): list(v)
                          for k, v in s["seq_keys"].items()}
        self._publish()


class CodecShadow:
    """Counterfactual single-codec pool byte traffic.

    Fed at publish time with each member codec's would-be compressed
    page size (plus the adaptive winner's actual size under
    ``codec="adaptive"``): ``shadow_codec_bytes_total{codec=}`` answers
    "how many compressed bytes would a pool locked to codec X have
    carried for the same pages?" — the what-if half of the adaptive
    codec's win.
    """

    def __init__(self, registry):
        self.registry = registry
        self.pages = 0
        self.bytes: dict[str, int] = {}

    def record(self, sizes: dict[str, int]) -> None:
        self.pages += 1
        for name, nb in sizes.items():
            self.bytes[name] = self.bytes.get(name, 0) + int(nb)
            self.registry.counter(
                "shadow_codec_bytes_total",
                "would-be compressed bytes under a single-codec pool",
                codec=name).value = self.bytes[name]
        self.registry.counter(
            "shadow_codec_pages_total",
            "pages sampled into the codec what-if").value = self.pages

    def state(self) -> dict:
        return {"pages": self.pages, "bytes": dict(self.bytes)}

    def load_state(self, s: dict) -> None:
        self.pages = s["pages"]
        self.bytes = dict(s["bytes"])
        for name, nb in self.bytes.items():
            self.registry.counter("shadow_codec_bytes_total",
                                  codec=name).value = nb
        self.registry.counter("shadow_codec_pages_total").value = self.pages
