"""The memory-hierarchy observatory: one attach point for all analysis
(port of ``repro/serving/observatory.py``).

Bundles the three analysis layers built on the telemetry substrate
— :class:`~repro_torch.serving.reuse.ReuseTracker` (live size↔reuse
statistics), :class:`~repro_torch.serving.shadow.ShadowSet` +
:class:`~repro_torch.serving.shadow.CodecShadow` (counterfactual policies and
codec pools), and :class:`~repro_torch.serving.audit.AuditLog` (structured
decision records) — behind a single object the engine owns as
``engine.obs``.

Attachment is strictly opt-in: ``PagedKVEngine(observatory=...)``.  A
default-constructed engine has ``obs = None`` and every hook is a
single ``is not None`` check, so the engine↔oracle equivalence suites
and the untraced fast path are untouched.  With it attached the tokens
and the engine's and scheduler's stats stay those of a run without it
(``tests/test_torch_observatory.py``).

The engine calls a handful of semantic hooks (``on_publish``,
``on_admit``, ``on_cache_insert``, ``on_dedup``, ``on_release``,
``on_retire``) rather than poking the trackers directly, keeping the
wiring in ``engine.py`` to one line per event.  The prefix cache and
scheduler reach the audit log through ``observatory.audit``.

All metrics land on the *engine's* telemetry registry, so exports
(Prometheus/JSONL) and snapshot/restore (``serving/snapshot.py`` stores
``observatory.state()`` in the engine meta) need no extra plumbing —
a restored engine's reuse histograms and shadow hit counters continue
from the snapshot, not from zero.
"""

from __future__ import annotations

from repro_torch.serving.audit import AuditLog
from repro_torch.serving.reuse import ReuseTracker, joint_table_str
from repro_torch.serving.shadow import CodecShadow, ShadowSet, block_keys


class Observatory:
    """Reuse analytics + shadow simulation + decision audit, one handle.

    ``telemetry`` is the :class:`~repro_torch.serving.telemetry.Telemetry`
    instance the engine will be constructed with (they must share a
    registry — asserted at bind time).  ``shadow_capacity_bytes`` caps
    the ghost caches; when None, ``bind_engine`` defaults it to a
    quarter of the pool's raw capacity so eviction pressure is real
    enough to separate the policies.
    """

    def __init__(self, telemetry, *, shadow_capacity_bytes: int | None = None,
                 audit_cap: int = 4096):
        self.telemetry = telemetry
        reg = telemetry.registry
        self.reuse = ReuseTracker(reg)
        self.shadow = ShadowSet(reg, shadow_capacity_bytes or (1 << 20))
        self._capacity_pinned = shadow_capacity_bytes is not None
        self.codec_shadow = CodecShadow(reg)
        self.audit = AuditLog(reg, telemetry.tracer, cap=audit_cap)
        self.page = 0                    # tokens per page; set at bind
        self.engine = None

    def bind_engine(self, engine) -> None:
        assert engine.telemetry.registry is self.telemetry.registry, \
            "observatory and engine must share one telemetry registry"
        self.engine = engine
        self.page = engine.page
        self.reuse.line = engine.page_raw_bytes()
        if not self._capacity_pinned:
            self.shadow.set_capacity(
                (engine.n_pool_pages - 1) * engine.page_raw_bytes() // 4)
        if engine.prefix_cache is not None:
            engine.prefix_cache.observatory = self

    # -- engine hooks ----------------------------------------------------------

    def on_publish(self, pid: int, nbytes: int, codec: str,
                   wouldbe: dict[str, int] | None = None) -> None:
        """A page became resident (``engine._record_publish``)."""
        self.reuse.page_birth(pid, nbytes, codec, wouldbe)
        if wouldbe:
            self.codec_shadow.record(dict(wouldbe, **{codec: nbytes}))

    def on_admit(self, sid: int, tokens, n_blocks: int, hit_pages) -> None:
        """A request entered a cohort (``engine.begin_cohort``).

        Feeds the counterfactual access stream with one key per full
        prompt block, and records a reuse access for every page the
        *real* cache served from its warm chain.
        """
        self.shadow.note_request(sid, block_keys(tokens, self.page, n_blocks))
        for pid in hit_pages:
            self.reuse.page_access(pid)

    def on_cache_insert(self, sid: int, blk: int, nbytes: int) -> None:
        """A prompt block landed in the real prefix cache."""
        self.shadow.install_for(sid, blk, nbytes)

    def on_dedup(self, sid: int, blk: int, nbytes: int,
                 dup_pids, shared_pids) -> None:
        """An in-cohort twin dedup'd onto already-resident pages."""
        for pid in dup_pids:
            self.reuse.page_cancel(pid)
        for pid in shared_pids:
            self.reuse.page_access(pid)
        self.shadow.install_for(sid, blk, nbytes)

    def on_release(self, pids) -> None:
        """Pages left the pool (private drop / eviction / purge)."""
        for pid in pids:
            self.reuse.page_release(pid)

    def on_retire(self, sid: int) -> None:
        """A sequence fully released its slot."""
        self.shadow.forget(sid)

    def sample_gauges(self) -> None:
        reg = self.telemetry.registry
        reg.gauge("obs_live_pages",
                  "pages currently tracked by the reuse observatory"
                  ).set(self.reuse.n_live())
        reg.gauge("obs_audit_records",
                  "decision-audit records retained"
                  ).set(len(self.audit.records))

    # -- reporting -------------------------------------------------------------

    def summary(self) -> dict:
        """Compact summary for run outputs (``launch/serve.py``)."""
        return {"shadow_hit_rates": self.shadow.hit_rates(),
                "shadow_capacity_bytes": self.shadow.capacity_bytes,
                "reuse_ticks": self.reuse.tick,
                "live_pages": self.reuse.n_live(),
                "codec_wouldbe_bytes": dict(self.codec_shadow.bytes),
                "audit_decisions": self.audit.counts()}

    def reuse_table(self) -> str:
        return joint_table_str(self.reuse.joint_counts())

    # -- snapshot/restore ------------------------------------------------------

    def state(self) -> dict:
        return {"reuse": self.reuse.state(),
                "shadow": self.shadow.state(),
                "codec_shadow": self.codec_shadow.state(),
                "audit": self.audit.state(),
                "page": self.page,
                "capacity_pinned": self._capacity_pinned}

    def load_state(self, s: dict) -> None:
        self.reuse.load_state(s["reuse"])
        self.shadow.load_state(s["shadow"])
        self.codec_shadow.load_state(s["codec_shadow"])
        self.audit.load_state(s["audit"])
        self.page = s["page"]
        self._capacity_pinned = s["capacity_pinned"]
