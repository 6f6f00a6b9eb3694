"""Per-page lifetime and reuse-distance tracking — the live SIP probe
(port of ``repro/serving/reuse.py``; equal state on equal event streams).

The thesis's size-indicates-reuse (SIP) claim is exactly a statement
about the joint distribution of *compressed size* and *reuse*: small
compressed blocks tend to be reused sooner.  The repo enforces SIP in
retention (``prefix_cache.SIPRetention``) and global caching
(``core/camp.py``); this module *measures* the claim in a running
engine, riding the page lifecycle events the engines already emit:

  * birth   — ``engine._record_publish``: a page becomes resident with
              a known compressed ``nbytes`` and winning codec tag (and,
              under the adaptive codec, every member's would-be size);
  * access  — cross-request prefix-cache reuse: a warm ``begin_cohort``
              chain hit or an in-cohort dedup maps a new sequence onto
              already-resident pages (decode-loop gathers stay on the
              device and are deliberately *not* counted — SIP is about
              cross-request retention value, not intra-sequence reads);
  * release — the page leaves the pool (private drop, prefix eviction,
              corrupt purge).

Time is a global access tick (one per recorded birth/access), so
"reuse distance" here is the *reuse interval* — recorded events between
consecutive touches of the same page — not a stack distance; lifetimes
use the same clock.  Size bins come from ``core.camp.size_bin`` with
``line_bytes`` = the raw (uncompressed) page size, i.e. bin k means the
page compressed into the k-th eighth of its raw footprint.

Registry output (all on the telemetry ``MetricsRegistry``, so it exports via
Prometheus/JSONL and survives snapshot/restore with the telemetry):

  * ``obs_reuse_joint_total{size_bin=,dist_pow2=}`` — the joint
    size-bin × reuse-distance counter matrix (the table
    ``launch/observe.py`` renders);
  * ``obs_reuse_distance{size_bin=}``  — reuse-interval histogram;
  * ``obs_page_lifetime{size_bin=}``   — birth→release tick histogram;
  * ``obs_page_reuses{size_bin=}``     — per-page reuse count at death;
  * ``obs_pages_born_total{size_bin=,codec=}`` — births by bin and
    winning codec;
  * ``obs_page_bytes{codec=}`` / ``obs_wouldbe_page_bytes{codec=}`` —
    actual vs would-be per-codec compressed page sizes (the adaptive
    publish path computes every member's ``page_nbytes``, so the
    breakdown covers losers too, not just the winner).

Host-side bookkeeping (live-page table, tick) serializes through
``state()``/``load_state()`` for engine snapshots.  Stdlib only.
"""

from __future__ import annotations

from repro_torch.core.camp import N_SIZE_BINS, size_bin


def dist_pow2(d: int) -> int:
    """Log2 bucket for a reuse distance/lifetime (0 ticks -> bucket 0)."""
    return max(0, int(d)).bit_length()


class ReuseTracker:
    """Joint size↔reuse statistics over live pool pages.

    ``registry`` is a :class:`~repro_torch.serving.telemetry.MetricsRegistry`;
    ``line_bytes`` is the raw per-page byte size used to bin compressed
    sizes (set by ``Observatory.bind_engine``).  All entry points are
    tolerant of unknown page ids — hierarchy code paths free pages the
    tracker never saw born (e.g. pages published before the observatory
    attached, or restored pools), and that must never throw.
    """

    def __init__(self, registry, *, line_bytes: int = 64):
        self.registry = registry
        self.line = int(line_bytes)
        self.tick = 0
        # pid -> [born_tick, last_tick, nbytes, size_bin, reuses]
        self.live: dict[int, list] = {}

    # -- lifecycle events ------------------------------------------------------

    def page_birth(self, pid: int, nbytes: int, codec: str,
                   wouldbe: dict[str, int] | None = None) -> None:
        """A page became resident with compressed size ``nbytes``.

        ``wouldbe`` maps member codec name -> would-be compressed size
        (adaptive publish); the winner's actual size is recorded under
        ``obs_page_bytes`` regardless.
        """
        t = self.tick
        self.tick += 1
        sb = size_bin(int(nbytes), self.line)
        self.live[int(pid)] = [t, t, int(nbytes), sb, 0]
        self.registry.counter(
            "obs_pages_born_total",
            "pages published, by compressed-size bin and winning codec",
            size_bin=sb, codec=codec).inc()
        self.registry.histogram(
            "obs_page_bytes", "compressed page size (winner)",
            codec=codec).observe(int(nbytes))
        if wouldbe:
            for name, wb in wouldbe.items():
                self.registry.histogram(
                    "obs_wouldbe_page_bytes",
                    "would-be compressed page size per member codec",
                    codec=name).observe(int(wb))
                self.registry.counter(
                    "obs_wouldbe_bytes_total",
                    "cumulative would-be compressed bytes per member codec",
                    codec=name).inc(int(wb))

    def page_access(self, pid: int) -> None:
        """A resident page was reused by a later request."""
        rec = self.live.get(int(pid))
        if rec is None:
            return
        t = self.tick
        self.tick += 1
        d = t - rec[1]
        rec[1] = t
        rec[4] += 1
        sb = rec[3]
        self.registry.histogram(
            "obs_reuse_distance",
            "reuse interval in access ticks, by size bin",
            size_bin=sb).observe(d)
        self.registry.counter(
            "obs_reuse_joint_total",
            "joint size-bin x reuse-distance (pow2 ticks) counts",
            size_bin=sb, dist_pow2=dist_pow2(d)).inc()

    def page_release(self, pid: int) -> None:
        """A page left the pool; records lifetime and reuse count."""
        rec = self.live.pop(int(pid), None)
        if rec is None:
            return
        sb = rec[3]
        self.registry.histogram(
            "obs_page_lifetime",
            "page lifetime in access ticks, by size bin",
            size_bin=sb).observe(self.tick - rec[0])
        self.registry.histogram(
            "obs_page_reuses",
            "reuses accumulated over a page's lifetime, by size bin",
            size_bin=sb).observe(rec[4])

    def page_cancel(self, pid: int) -> None:
        """Forget a page without death stats (dedup'd before residency)."""
        self.live.pop(int(pid), None)

    # -- summaries -------------------------------------------------------------

    def joint_counts(self) -> dict[tuple[int, int], int]:
        """``{(size_bin, dist_pow2): count}`` from the registry."""
        out: dict[tuple[int, int], int] = {}
        for labels, m in self.registry.series("obs_reuse_joint_total"):
            out[(int(labels["size_bin"]), int(labels["dist_pow2"]))] = m.value
        return out

    def n_live(self) -> int:
        return len(self.live)

    # -- snapshot/restore ------------------------------------------------------

    def state(self) -> dict:
        return {"line": self.line, "tick": self.tick,
                "live": {str(pid): list(rec)
                         for pid, rec in self.live.items()}}

    def load_state(self, s: dict) -> None:
        self.line = s["line"]
        self.tick = s["tick"]
        self.live = {int(pid): list(rec) for pid, rec in s["live"].items()}


def joint_table_str(joint: dict[tuple[int, int], int]) -> str:
    """Render a ``{(size_bin, dist_pow2): count}`` matrix as text.

    Rows are compressed-size bins (0 = smallest eighth of the raw page),
    columns are pow2 reuse-distance buckets — the SIP claim predicts
    mass concentrating in the upper-left (small pages, short reuse
    distance).  Shared by ``launch/serve.py`` and ``launch/observe.py``.
    """
    if not joint:
        return "(no reuse events recorded)"
    cols = sorted({c for _, c in joint})
    head = "size_bin \\ dist_2^k | " + " ".join(f"{c:>6d}" for c in cols)
    lines = [head, "-" * len(head)]
    for sb in range(N_SIZE_BINS):
        row = [joint.get((sb, c), 0) for c in cols]
        if not any(row):
            continue
        lines.append(f"{sb:>19d} | " + " ".join(f"{v:>6d}" for v in row))
    return "\n".join(lines)
