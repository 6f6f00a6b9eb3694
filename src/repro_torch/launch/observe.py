"""Observatory report CLI: size↔reuse, shadow deltas, pool timeline
(port of ``repro/launch/observe.py``; the same report, byte for byte, on
the same artifacts).

Renders the memory-hierarchy observatory's evidence into one text
report, from saved serving artifacts or a live metrics endpoint:

  * ``--metrics-jsonl`` — a JSONL metrics log (``launch/serve.py
    --metrics-jsonl`` or ``MetricsRegistry.to_jsonl_line``): the last
    record is the registry snapshot the report reads; *all* records
    feed the pool occupancy/fragmentation timeline;
  * ``--prom`` — a saved Prometheus text exposition
    (``--metrics-out``); scalar series only (histogram quantiles appear
    as their exported ``{quantile=...}`` samples);
  * ``--url`` — a live ``--metrics-port`` endpoint (``/metrics``);
  * ``--audit`` — a decision-audit JSONL (``AuditLog.to_jsonl`` /
    ``launch/serve.py --audit-out``).

Report sections: the joint size-bin × reuse-distance table (the live
measurement of the SIP size-indicates-reuse claim), per-bin reuse/
lifetime quantiles with a size↔reuse rank correlation, shadow-policy
hit rates vs the real prefix cache (SIP / LRU / FIFO / size-oblivious
G-CAMP counterfactuals), the single-codec what-if byte traffic, the
pool occupancy timeline, and the decision-audit summary.

Usage::

    python -m repro_torch.launch.observe \
        --metrics-jsonl results/telemetry/metrics.jsonl \
        --audit results/telemetry/audit.jsonl [--out report.txt]

Pure host code: it reads exported text, never the engine.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.serving.reuse import joint_table_str
from repro_torch.serving.telemetry import _unescape


# ---------------------------------------------------------------------------
# input normalization: registry snapshot dicts are the common currency
# ---------------------------------------------------------------------------

def load_jsonl(path: str) -> tuple[dict, list[dict]]:
    """Read a metrics JSONL log -> (last snapshot, all records)."""
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    if not recs:
        raise SystemExit(f"no records in {path}")
    return recs[-1]["metrics"], recs


def parse_prometheus(text: str) -> dict:
    """Prometheus text exposition -> snapshot-shaped dict (scalars).

    Inverse of ``MetricsRegistry.to_prometheus`` as far as scalar
    samples go; label values round-trip through the exporter's escaping
    (``telemetry._unescape``).
    """
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, labels, val = _parse_sample(line)
        if name is None:
            continue
        e = out.setdefault(name, {"type": "scalar", "series": []})
        e["series"].append({"labels": labels, "value": val})
    return out


def _parse_sample(line: str):
    brace = line.find("{")
    if brace < 0:
        parts = line.rsplit(None, 1)
        if len(parts) != 2:
            return None, None, None
        return parts[0], {}, float(parts[1])
    name = line[:brace]
    end = line.rfind("}")
    labels: dict = {}
    body = line[brace + 1:end]
    i = 0
    while i < len(body):
        eq = body.find("=", i)
        if eq < 0:
            break
        key = body[i:eq].strip().strip(",").strip()
        # value is a quoted string; find its unescaped closing quote
        j = eq + 2
        while j < len(body):
            if body[j] == "\\":
                j += 2
                continue
            if body[j] == '"':
                break
            j += 1
        labels[key] = _unescape(body[eq + 2:j])
        i = j + 1
    return name, labels, float(line[end + 1:].strip())


def series(snapshot: dict, name: str) -> list[dict]:
    return snapshot.get(name, {}).get("series", [])


def scalar(snapshot: dict, name: str, default=None, **labels):
    """First series value under ``name`` whose labels superset ``labels``."""
    want = {k: str(v) for k, v in labels.items()}
    for s in series(snapshot, name):
        have = {k: str(v) for k, v in s["labels"].items()}
        if all(have.get(k) == v for k, v in want.items()):
            return s.get("value")
    return default


def joint_from_snapshot(snapshot: dict) -> dict[tuple[int, int], int]:
    out: dict[tuple[int, int], int] = {}
    for s in series(snapshot, "obs_reuse_joint_total"):
        lab = s["labels"]
        if "quantile" in lab:
            continue
        out[(int(lab["size_bin"]), int(lab["dist_pow2"]))] = int(s["value"])
    return out


def shadow_hit_rates(snapshot: dict) -> dict[str, float]:
    rates: dict[str, float] = {}
    for s in series(snapshot, "shadow_hits_total"):
        if "quantile" in s["labels"]:
            continue
        p = s["labels"]["policy"]
        hits = s["value"]
        misses = scalar(snapshot, "shadow_misses_total", 0, policy=p)
        n = hits + misses
        rates[p] = hits / n if n else 0.0
    return rates


# ---------------------------------------------------------------------------
# report sections
# ---------------------------------------------------------------------------

def _rank_correlation(joint: dict[tuple[int, int], int]) -> float | None:
    """Spearman rank correlation between size bin and reuse distance
    over the joint event counts (ties get midranks).  Positive means
    bigger compressed pages see *longer* reuse distances — the SIP
    claim's signature."""
    events = [(sb, dp, c) for (sb, dp), c in joint.items() if c > 0]
    n = sum(c for _, _, c in events)
    if n < 2:
        return None

    def midranks(axis: int) -> dict[float, float]:
        totals: dict[float, int] = {}
        for e in events:
            totals[e[axis]] = totals.get(e[axis], 0) + e[2]
        ranks, cum = {}, 0
        for v in sorted(totals):
            c = totals[v]
            ranks[v] = cum + (c + 1) / 2
            cum += c
        return ranks

    rx, ry = midranks(0), midranks(1)
    mean = (n + 1) / 2
    sxy = sxx = syy = 0.0
    for sb, dp, c in events:
        dx, dy = rx[sb] - mean, ry[dp] - mean
        sxy += c * dx * dy
        sxx += c * dx * dx
        syy += c * dy * dy
    if sxx == 0 or syy == 0:
        return None
    return sxy / (sxx * syy) ** 0.5


def _sec_reuse(snapshot: dict) -> list[str]:
    out = ["== size <-> reuse (joint size-bin x reuse-distance) =="]
    joint = joint_from_snapshot(snapshot)
    out.append(joint_table_str(joint))
    rho = _rank_correlation(joint)
    if rho is not None:
        out.append(f"rank correlation (size bin vs reuse distance): "
                   f"{rho:+.3f}  (positive = bigger pages reused later; "
                   f"SIP predicts positive)")
    rows = []
    for s in series(snapshot, "obs_reuse_distance"):
        lab = s["labels"]
        if "quantile" in lab or "count" not in s:
            continue
        rows.append((int(lab["size_bin"]), s["count"], s["p50"], s["p95"]))
    if rows:
        out.append("reuse-distance quantiles by size bin:")
        out.append("  bin  events   p50     p95")
        for sb, c, p50, p95 in sorted(rows):
            out.append(f"  {sb:>3d} {c:>7d} {p50:>7.1f} {p95:>7.1f}")
    return out


def _sec_shadow(snapshot: dict) -> list[str]:
    out = ["== shadow policies vs real cache =="]
    rates = shadow_hit_rates(snapshot)
    if not rates:
        out.append("(no shadow data)")
        return out
    real = scalar(snapshot, "prefix_cache_hit_rate")
    for p in ("sip", "lru", "fifo", "gcamp"):
        if p not in rates:
            continue
        ev = scalar(snapshot, "shadow_evictions_total", 0, policy=p)
        occ = scalar(snapshot, "shadow_occupancy_bytes", 0, policy=p)
        out.append(f"  {p:>6s}: hit_rate={rates[p]:.3f}  "
                   f"evictions={int(ev)}  occupancy={int(occ)}B")
    if real is not None:
        out.append(f"  real prefix-cache token hit rate: {real:.3f} "
                   f"(token-weighted; shadow rates are block-weighted)")
    return out


def _sec_codec(snapshot: dict) -> list[str]:
    out = ["== single-codec what-if (would-be compressed bytes) =="]
    rows = [(s["labels"]["codec"], int(s["value"]))
            for s in series(snapshot, "shadow_codec_bytes_total")
            if "quantile" not in s["labels"]]
    if not rows:
        out.append("(no codec what-if data; needs the adaptive codec)")
        return out
    best = min(v for _, v in rows)
    for name, v in sorted(rows, key=lambda e: e[1]):
        out.append(f"  {name:>9s}: {v:>12d} B  ({v / max(best, 1):.2f}x best)")
    return out


def _sec_timeline(records: list[dict]) -> list[str]:
    out = ["== pool occupancy / fragmentation timeline =="]
    pts = []
    for rec in records:
        m = rec.get("metrics", {})
        used = scalar(m, "engine_pool_used_pages")
        if used is None:
            continue
        pts.append((used, scalar(m, "engine_free_list_depth", 0),
                    scalar(m, "engine_pool_pressure", 0.0)))
    if len(pts) < 2:
        out.append("(need >= 2 JSONL records for a timeline)")
        return out
    out.append(f"  {len(pts)} samples "
               f"(used pages / free-list depth / pressure):")
    out.append("  used:     " + _spark([p[0] for p in pts]))
    out.append("  free:     " + _spark([p[1] for p in pts]))
    out.append("  pressure: " + _spark([p[2] for p in pts]))
    lo, hi = pts[0], pts[-1]
    out.append(f"  first -> last: used {int(lo[0])} -> {int(hi[0])}, "
               f"free {int(lo[1])} -> {int(hi[1])}, "
               f"pressure {lo[2]:.3f} -> {hi[2]:.3f}")
    return out


_SPARK = " .:-=+*#%@"


def _spark(vals: list[float]) -> str:
    hi = max(vals)
    if hi <= 0:
        return "0" * len(vals)
    return "".join(_SPARK[min(int(v / hi * (len(_SPARK) - 1)), 9)]
                   for v in vals)


def _sec_audit(records: list[dict], tail: int = 8) -> list[str]:
    out = ["== decision audit =="]
    if not records:
        out.append("(no audit records)")
        return out
    counts: dict[str, int] = {}
    for r in records:
        counts[r.get("kind", "?")] = counts.get(r.get("kind", "?"), 0) + 1
    out.append("  decisions by kind: " + ", ".join(
        f"{k}={v}" for k, v in sorted(counts.items())))
    out.append(f"  last {min(tail, len(records))} decisions:")
    for r in records[-tail:]:
        kind = r.get("kind", "?")
        inputs = {k: v for k, v in r.items() if k not in ("seq", "kind")}
        body = ", ".join(f"{k}={v}" for k, v in sorted(inputs.items()))
        out.append(f"    #{r.get('seq', '?')} {kind}: {body}")
    return out


def render_report(snapshot: dict, *, jsonl_records: list[dict] | None = None,
                  audit_records: list[dict] | None = None) -> str:
    """The full observatory report as one string."""
    sections = [_sec_reuse(snapshot), _sec_shadow(snapshot),
                _sec_codec(snapshot)]
    if jsonl_records is not None:
        sections.append(_sec_timeline(jsonl_records))
    if audit_records is not None:
        sections.append(_sec_audit(audit_records))
    return "\n".join("\n".join(s) for s in sections) + "\n"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="render the memory-hierarchy observatory report",
        epilog=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_argument_group("metric sources (pick one)")
    src.add_argument("--metrics-jsonl", metavar="PATH",
                     help="JSONL metrics log; last record is the snapshot, "
                          "all records feed the pool timeline")
    src.add_argument("--prom", metavar="PATH",
                     help="saved Prometheus text exposition")
    src.add_argument("--url", metavar="URL",
                     help="live /metrics endpoint "
                          "(e.g. http://127.0.0.1:9100/metrics)")
    ap.add_argument("--audit", metavar="PATH",
                    help="decision-audit JSONL (AuditLog.to_jsonl)")
    ap.add_argument("--out", metavar="PATH",
                    help="also write the report to this file")
    args = ap.parse_args(argv)

    picked = [s for s in (args.metrics_jsonl, args.prom, args.url) if s]
    if len(picked) != 1:
        ap.error("pick exactly one of --metrics-jsonl / --prom / --url")

    records = None
    if args.metrics_jsonl:
        snapshot, records = load_jsonl(args.metrics_jsonl)
    elif args.prom:
        with open(args.prom) as f:
            snapshot = parse_prometheus(f.read())
    else:
        from urllib.request import urlopen
        with urlopen(args.url) as resp:            # noqa: S310 (localhost)
            snapshot = parse_prometheus(resp.read().decode())

    audit = None
    if args.audit:
        with open(args.audit) as f:
            audit = [json.loads(ln) for ln in f if ln.strip()]

    report = render_report(snapshot, jsonl_records=records,
                           audit_records=audit)
    print(report, end="")
    if args.out:
        with open(args.out, "w") as f:
            f.write(report)


if __name__ == "__main__":
    main()
