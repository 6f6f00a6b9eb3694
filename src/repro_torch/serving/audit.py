"""Structured decision audit log for the serving memory hierarchy
(port of ``repro/serving/audit.py``; records equal across packages).

Every consequential retention/admission decision the stack makes is
recorded here *with the inputs that drove it*, so a surprising eviction
or rejection can be replayed from evidence instead of re-derived from
code reading — the discipline Touché (arXiv:1909.00553) applies to its
metadata-region decisions.  Four decision kinds flow in today:

  * ``sip_evict``        — prefix-cache victim ranking
                           (``prefix_cache.evict_for``): the victim's
                           hit count, compressed size, SIP value
                           ``(hits+boost+1)/pow2(nbytes)``, pow2 bucket,
                           size bin, birth order, corrupt flag, and how
                           many candidates it beat;
  * ``camp_preempt``     — G-CAMP sequence preemption
                           (``engine._preempt_one``): the victim's
                           value, reclaimable bytes and their pow2
                           bucket, token count, pinned-chain length;
  * ``ladder_transition``— pressure-ladder level changes
                           (``scheduler.step``): new/previous level and
                           the pool pressure that drove them;
  * ``admission_reject`` — scheduler admission control
                           (``scheduler.submit``): queue depth, ladder
                           level, and which gate fired.

Records are plain dicts ``{"seq", "kind", ...inputs}`` with a monotone
sequence number, held in a bounded ring (oldest dropped past ``cap``) so
an always-on audit can't grow without bound.  Exports: JSONL
(:meth:`to_jsonl` / :meth:`to_jsonl_lines`) and Perfetto counter tracks
through the tracer — each numeric input becomes an
``audit_<kind>_<field>`` counter series keyed by decision sequence
number, riding ``Tracer.counters`` and therefore ``to_chrome_trace``.
A per-kind ``audit_decisions_total`` counter lands on the registry so
decision *rates* survive even after the ring wraps.

Stdlib only; ``state()``/``load_state()`` round-trips through engine
snapshots (``serving/snapshot.py``).
"""

from __future__ import annotations

import json

DEFAULT_CAP = 4096


class AuditLog:
    """Bounded structured log of hierarchy decisions.

    ``registry`` is a :class:`~repro_torch.serving.telemetry.MetricsRegistry`
    (per-kind decision counters); ``tracer`` is an optional
    :class:`~repro_torch.serving.trace.Tracer` — when enabled, numeric inputs
    are emitted as Perfetto counter tracks.
    """

    def __init__(self, registry, tracer=None, *, cap: int = DEFAULT_CAP):
        self.registry = registry
        self.tracer = tracer
        self.cap = int(cap)
        self.seq = 0
        self.records: list[dict] = []

    def record(self, kind: str, **inputs) -> dict:
        rec = {"seq": self.seq, "kind": kind, **inputs}
        self.seq += 1
        self.records.append(rec)
        if len(self.records) > self.cap:
            del self.records[: len(self.records) - self.cap]
        self.registry.counter(
            "audit_decisions_total",
            "hierarchy decisions recorded, by kind", kind=kind).inc()
        tr = self.tracer
        if tr is not None and tr.enabled:
            nums = {f"audit_{kind}_{k}": float(v)
                    for k, v in inputs.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)}
            if nums:
                tr.iteration(rec["seq"], **nums)
        return rec

    # -- exports ---------------------------------------------------------------

    def to_jsonl_lines(self) -> list[str]:
        return [json.dumps(r, sort_keys=True, default=float)
                for r in self.records]

    def to_jsonl(self, path) -> int:
        """Write all retained records as JSONL; returns the record count."""
        lines = self.to_jsonl_lines()
        with open(path, "w") as f:
            for ln in lines:
                f.write(ln + "\n")
        return len(lines)

    def counts(self) -> dict[str, int]:
        """Decision counts by kind over the retained window."""
        out: dict[str, int] = {}
        for r in self.records:
            out[r["kind"]] = out.get(r["kind"], 0) + 1
        return out

    # -- snapshot/restore ------------------------------------------------------

    def state(self) -> dict:
        return {"seq": self.seq, "cap": self.cap,
                "records": list(self.records)}

    def load_state(self, s: dict) -> None:
        self.seq = s["seq"]
        self.cap = s.get("cap", self.cap)
        self.records = [dict(r) for r in s["records"]]
