"""Per-request span tracer + iteration timeline → Chrome/Perfetto trace.

Port of ``repro/serving/trace.py``, unchanged: the module is plain
Python, and its Chrome trace is byte-equal to the JAX package's for the
same events and clock (``tests/test_torch_telemetry.py``).

Records the full request lifecycle the scheduler produces —
submit → queued → admitted → per-prefill-chunk → per-decode-token →
retire — together with lifecycle *instants* (cache hit, heal,
preemption, requeue, corruption retry, deadline miss, pressure-ladder
transitions) and a per-iteration counter timeline (token-budget split,
dispatch wall time, pool occupancy / free-list depth, queue depths).
``to_chrome_trace()`` exports the whole run in the Chrome
``trace_event`` JSON format, which Perfetto (https://ui.perfetto.dev)
loads directly: one *thread* per request id showing its phase slices,
one counter track per timeline series.  The JAX package's
``src/repro/serving/README.md`` ("Observability") has the schema and a
worked example.

Cost model: tracing is opt-in (``Telemetry(trace=True)``).  Every
recording method starts with an ``enabled`` check and hot call sites in
the scheduler guard on ``tracer.enabled`` before building event
arguments, so the disabled path is a single attribute test.

Timestamps come from the shared monotonic :class:`~.telemetry.Clock`
in microseconds relative to the tracer's start — never wall-clock, so
the timeline is immune to NTP steps.  Event *sequences* (names per
rid, in order) are deterministic for a seeded run; timestamps are not,
which is why the determinism test compares ``event_names()``, not
times.
"""

from __future__ import annotations

import json

# Phases a request moves through; each becomes an "X" slice on the
# request's trace thread.
PHASES = ("queued", "prefill", "decode", "backoff")

# Terminal event name; args carry the FinishReason value.
FINISH = "finish"


class Tracer:
    """Append-only event recorder for one scheduler run."""

    def __init__(self, clock, enabled: bool = False):
        self.clock = clock
        self.enabled = enabled
        # (t_us, rid|None, name, args|None) — lifecycle instants
        self.events: list[tuple] = []
        # (t0_us, t1_us, rid, phase) — closed phase slices
        self.slices: list[tuple] = []
        # rid -> (phase, t0_us) — currently open phase per request
        self._open: dict = {}
        # (t_us, iteration, {series: value}) — counter timeline
        self.counters: list[tuple] = []

    # -- recording -------------------------------------------------------------

    def event(self, rid, name: str, **args) -> None:
        """Record a lifecycle instant (rid=None for a global event)."""
        if not self.enabled:
            return
        self.events.append((self.clock.us(), rid, name, args or None))

    def phase(self, rid, phase: str | None) -> None:
        """Move ``rid`` to a new phase, closing the previous slice.

        ``phase=None`` closes the open slice without opening another
        (request left the system).
        """
        if not self.enabled:
            return
        t = self.clock.us()
        prev = self._open.pop(rid, None)
        if prev is not None:
            self.slices.append((prev[1], t, rid, prev[0]))
        if phase is not None:
            self._open[rid] = (phase, t)

    def finish(self, rid, reason: str) -> None:
        """Terminal event: exactly one per finished request."""
        if not self.enabled:
            return
        self.phase(rid, None)
        self.events.append((self.clock.us(), rid, FINISH,
                            {"reason": str(reason)}))

    def iteration(self, it: int, **series) -> None:
        """One timeline sample; each kwarg becomes a counter track."""
        if not self.enabled:
            return
        self.counters.append((self.clock.us(), it, series))

    # -- queries ---------------------------------------------------------------

    def event_names(self, rid=None) -> list:
        """Ordered (rid, name) pairs — the deterministic view of a run."""
        return [(r, n) for _, r, n, _ in self.events
                if rid is None or r == rid]

    def finish_reasons(self) -> dict:
        """rid -> list of terminal-event reasons (should be length 1)."""
        out: dict = {}
        for _, rid, name, args in self.events:
            if name == FINISH:
                out.setdefault(rid, []).append(args["reason"])
        return out

    # -- export ----------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON (Perfetto-compatible).

        Request phases are "X" complete events on tid=rid; lifecycle
        instants are "i" thread-scoped events; timeline series are "C"
        counter events.  Open phases are closed at the current time so
        a mid-run export is still a valid trace.
        """
        pid = 1
        evs: list[dict] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": "repro-serving"}},
            {"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
             "args": {"name": "scheduler"}},
        ]
        rids = sorted({r for _, _, r, _ in self.slices}
                      | {r for _, r, _, _ in self.events if r is not None}
                      | set(self._open))
        for rid in rids:
            evs.append({"ph": "M", "pid": pid, "tid": _tid(rid),
                        "name": "thread_name",
                        "args": {"name": f"request {rid}"}})
        now = self.clock.us() if self.enabled else 0
        slices = list(self.slices) + [(t0, now, rid, ph)
                                      for rid, (ph, t0)
                                      in self._open.items()]
        for t0, t1, rid, ph in slices:
            evs.append({"ph": "X", "pid": pid, "tid": _tid(rid),
                        "name": ph, "cat": "request", "ts": t0,
                        "dur": max(t1 - t0, 0)})
        for t, rid, name, args in self.events:
            evs.append({"ph": "i", "pid": pid,
                        "tid": 0 if rid is None else _tid(rid),
                        "name": name, "cat": "lifecycle", "ts": t,
                        "s": "p" if rid is None else "t",
                        "args": args or {}})
        for t, it, series in self.counters:
            for k, v in series.items():
                evs.append({"ph": "C", "pid": pid, "tid": 0, "name": k,
                            "ts": t, "args": {k: v, "iteration": it}})
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, default=float)

    # -- snapshot/restore ------------------------------------------------------

    def state(self) -> dict:
        return {"enabled": self.enabled,
                "events": [list(e) for e in self.events],
                "slices": [list(s) for s in self.slices],
                "open": {str(r): list(p) for r, p in self._open.items()},
                "counters": [[t, i, dict(s)] for t, i, s in self.counters]}

    def load_state(self, s: dict) -> None:
        self.enabled = s["enabled"]
        self.events = [(t, r, n, a) for t, r, n, a in s["events"]]
        self.slices = [tuple(e) for e in s["slices"]]
        self._open = {_unkey(r): tuple(p) for r, p in s["open"].items()}
        self.counters = [(t, i, s_) for t, i, s_ in s["counters"]]


def _tid(rid) -> int:
    """Trace thread ids must be ints; rids are ints throughout the
    stack, but hash anything else defensively."""
    return rid if isinstance(rid, int) else abs(hash(rid)) % (1 << 31)


def _unkey(r: str):
    try:
        return int(r)
    except ValueError:
        return r
