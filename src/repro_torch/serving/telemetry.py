"""Zero-dependency serving metrics: counters, gauges, histograms, clock.

Port of ``repro/serving/telemetry.py``, unchanged but for the tracer's
import: the module is plain Python, and its exporters give byte-equal
output to the JAX package's for the same metrics and clock
(``tests/test_torch_telemetry.py``).

The thesis's central claim is that *access time*, not just ratio,
decides whether compression pays off — which makes latency telemetry a
first-class part of this serving stack, not an afterthought.  This
module is the measurement half of that argument:

  * :class:`Clock` — one monotonic time source (``time.perf_counter``)
    threaded through the scheduler, engine and tracer, so a
    wall-clock (NTP) step can never corrupt TTFT stats or fire a
    deadline early;
  * :class:`Counter` / :class:`Gauge` — plain scalar metrics.  Counters
    accept *negative* deltas deliberately: the engines reverse
    compression accounting when the prefix cache dedups a just-published
    page, and that reversal must flow through the same metric;
  * :class:`Histogram` — a streaming log-bucketed histogram giving
    p50/p95/p99 estimates with ~2% relative error at O(1) memory per
    decade of dynamic range (the classic DDSketch/HDR trick, stdlib
    only);
  * :class:`MetricsRegistry` — a labeled registry with three exporters:
    ``snapshot()`` (plain dicts), ``to_jsonl_line()`` (JSON-lines
    metrics logs), ``to_prometheus()`` (text exposition format, served
    by ``launch/serve.py --metrics-port`` over stdlib http);
  * :class:`Telemetry` — the facade bundling a registry, a clock, and a
    request tracer (``serving/trace.py``); one instance can be shared
    by an engine and its scheduler, or each can own its own.

Everything here serializes through ``state()`` / ``load_state()``, the
hook engine snapshot/restore uses in the JAX package.  No third-party
imports anywhere in this file.
"""

from __future__ import annotations

import json
import math
import threading
import time

# Log-bucket growth factor.  A value v lands in bucket
# floor(log(v)/log(GAMMA)); the bucket's representative is the
# geometric midpoint GAMMA**(i+0.5), so the worst-case relative
# quantile error is sqrt(GAMMA)-1 ~ 2%.
GAMMA = 1.04
_LOG_GAMMA = math.log(GAMMA)


class Clock:
    """Monotonic clock (``perf_counter``) with a fixed origin.

    ``now()`` is an absolute monotonic timestamp (seconds, arbitrary
    epoch — only differences are meaningful); ``elapsed()`` / ``us()``
    are relative to this clock's construction, which is what the tracer
    uses for trace-event timestamps.
    """

    def __init__(self):
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def us(self) -> int:
        """Microseconds since this clock's origin (trace timestamps)."""
        return int((time.perf_counter() - self.t0) * 1e6)


class Counter:
    """Monotone-by-convention scalar; negative deltas are allowed for
    accounting reversals (prefix-cache dedup un-publishes a page)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, delta=1):
        self.value += delta

    def merge(self, other: "Counter") -> "Counter":
        """Fold another counter in (per-host aggregation): totals add."""
        self.value += other.value
        return self

    def state(self):
        return self.value

    def load_state(self, s):
        self.value = s


class Gauge:
    """A value that goes up and down (pool occupancy, ladder level)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0

    def set(self, v):
        self.value = v

    def inc(self, delta=1):
        self.value += delta

    def merge(self, other: "Gauge") -> "Gauge":
        """Fold another gauge in.  Gauges aggregate by *sum* — the
        cross-host reading of occupancy/depth gauges is total bytes or
        total pages; rate-style gauges should be exported per-host
        instead of merged."""
        self.value += other.value
        return self

    def state(self):
        return self.value

    def load_state(self, s):
        self.value = s


class Histogram:
    """Streaming log-bucketed histogram with quantile estimation.

    Sparse ``{bucket_index: count}`` storage; non-positive samples share
    a dedicated zero bucket (observed values here — latencies, byte
    sizes, ratios — are non-negative).  ``quantile(q)`` walks the
    cumulative counts and returns the target bucket's geometric
    midpoint clamped to the observed [min, max], which keeps estimates
    within ~2% relative error of an exact percentile
    (tests/test_telemetry.py pins this against numpy).
    """

    __slots__ = ("count", "sum", "min", "max", "zero", "buckets")
    kind = "histogram"

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.zero = 0                 # samples <= 0
        self.buckets: dict[int, int] = {}

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.zero += 1
            return
        i = math.floor(math.log(v) / _LOG_GAMMA)
        self.buckets[i] = self.buckets.get(i, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        cum = self.zero
        if rank < cum:
            return max(0.0, self.min)
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if rank < cum:
                rep = GAMMA ** (i + 0.5)
                return min(max(rep, self.min), self.max)
        return self.max

    def percentiles(self, qs=(0.5, 0.95, 0.99)) -> dict[float, float]:
        return {q: self.quantile(q) for q in qs}

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold another histogram into this one.

        Log-bucketed histograms merge exactly: same GAMMA means the same
        bucket boundaries everywhere, so bucket-wise addition loses
        nothing — the merged quantile error stays within the single
        histogram's ~2% bound (pinned in tests/test_telemetry.py).  This
        is what makes per-host registries aggregatable.
        """
        self.count += other.count
        self.sum += other.sum
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max
        self.zero += other.zero
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c
        return self

    def state(self):
        return {"count": self.count, "sum": self.sum,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max,
                "zero": self.zero,
                "buckets": {str(i): c for i, c in self.buckets.items()}}

    def load_state(self, s):
        self.count = s["count"]
        self.sum = s["sum"]
        self.min = math.inf if s["min"] is None else s["min"]
        self.max = -math.inf if s["max"] is None else s["max"]
        self.zero = s["zero"]
        self.buckets = {int(i): c for i, c in s["buckets"].items()}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Labeled metric registry with JSON-lines and Prometheus export.

    Metrics are identified by ``(name, sorted(labels))``; the first
    access creates the series, later accesses return the same object —
    so call sites just do ``reg.counter("x_total", codec="bdi").inc()``.
    A name is pinned to one metric kind; mixing kinds is a bug and
    raises.
    """

    def __init__(self):
        self._metrics: dict[tuple, Counter | Gauge | Histogram] = {}
        self._kinds: dict[str, str] = {}
        self._help: dict[str, str] = {}

    # -- accessors -------------------------------------------------------------

    def _get(self, cls, name: str, help_: str, labels: dict):
        kind = self._kinds.get(name)
        if kind is None:
            self._kinds[name] = cls.kind
            if help_:
                self._help[name] = help_
        elif kind != cls.kind:
            raise ValueError(f"metric {name!r} is a {kind}, not {cls.kind}")
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls()
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return self._get(Histogram, name, help, labels)

    def series(self, name: str) -> list[tuple[dict, object]]:
        """All (labels, metric) series registered under ``name``."""
        return [(dict(lk), m) for (n, lk), m in self._metrics.items()
                if n == name]

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry into this one (per-host aggregation).

        Series are matched by ``(name, labels)``; missing series are
        created, existing ones are merged metric-wise (counters and
        gauges add, histograms add bucket-wise).  A name registered with
        different kinds on the two sides raises, same as ``_get``.  To
        keep hosts distinguishable, label per-host series (e.g.
        ``host="a"``) before merging.
        """
        cls = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}
        for (name, lk), m in other._metrics.items():
            mine = self._get(cls[m.kind], name,
                             other._help.get(name, ""), dict(lk))
            mine.merge(m)
        return self

    # -- exporters -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict snapshot: {name: {type, help, series: [...]}}.

        Histogram series carry count/sum/min/max plus p50/p95/p99
        estimates; counters and gauges carry their scalar value.
        """
        out: dict = {}
        for (name, lk), m in sorted(self._metrics.items()):
            e = out.setdefault(name, {"type": m.kind,
                                      "help": self._help.get(name, ""),
                                      "series": []})
            s: dict = {"labels": dict(lk)}
            if m.kind == "histogram":
                s.update(count=m.count, sum=m.sum,
                         min=None if m.count == 0 else m.min,
                         max=None if m.count == 0 else m.max,
                         p50=m.quantile(0.5), p95=m.quantile(0.95),
                         p99=m.quantile(0.99))
            else:
                s["value"] = m.value
            e["series"].append(s)
        return out

    def to_jsonl_line(self, **extra) -> str:
        """One JSON-lines record of the full registry snapshot."""
        rec = {"ts": time.time(), **extra, "metrics": self.snapshot()}
        return json.dumps(rec, sort_keys=True, default=float)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format.

        Histograms are exported summary-style — ``{quantile="..."}``
        sample lines plus ``_sum`` / ``_count`` — because log-bucketed
        quantiles are computed client-side here, which is exactly what
        summaries model.
        """
        lines: list[str] = []
        for name in sorted(self._kinds):
            kind = self._kinds[name]
            help_ = self._help.get(name, "")
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} "
                         f"{'summary' if kind == 'histogram' else kind}")
            for labels, m in sorted(self.series(name),
                                    key=lambda e: sorted(e[0].items())):
                if kind == "histogram":
                    for q in (0.5, 0.95, 0.99):
                        ql = dict(labels, quantile=str(q))
                        lines.append(f"{name}{_fmt_labels(ql)} "
                                     f"{_fmt_val(m.quantile(q))}")
                    lines.append(f"{name}_sum{_fmt_labels(labels)} "
                                 f"{_fmt_val(m.sum)}")
                    lines.append(f"{name}_count{_fmt_labels(labels)} "
                                 f"{m.count}")
                else:
                    lines.append(f"{name}{_fmt_labels(labels)} "
                                 f"{_fmt_val(m.value)}")
        return "\n".join(lines) + "\n"

    # -- snapshot/restore ------------------------------------------------------

    def state(self) -> dict:
        """JSON-serializable registry state (snapshot/restore)."""
        return {"kinds": dict(self._kinds), "help": dict(self._help),
                "series": [{"name": n, "labels": dict(lk),
                            "state": m.state()}
                           for (n, lk), m in self._metrics.items()]}

    def load_state(self, s: dict) -> None:
        cls = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}
        self._kinds.update(s["kinds"])
        self._help.update(s.get("help", {}))
        for e in s["series"]:
            m = self._get(cls[s["kinds"][e["name"]]], e["name"], "",
                          e["labels"])
            m.load_state(e["state"])


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_escape(str(v))}"'
                    for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _unescape(v: str) -> str:
    """Inverse of :func:`_escape` (Prometheus label-value escaping).

    Left-to-right scan so ``\\\\n`` stays a literal backslash-n instead
    of being misread as a newline — the property the round-trip test
    pins.  Its consumer in the JAX package, ``launch/observe.py``
    (parsing saved ``.prom`` artifacts back into label dicts), is not
    ported yet.
    """
    out: list[str] = []
    i, n = 0, len(v)
    while i < n:
        c = v[i]
        if c == "\\" and i + 1 < n:
            nxt = v[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == '"':
                out.append('"')
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _fmt_val(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Telemetry:
    """Registry + clock + tracer bundle threaded through the stack.

    Construct with ``trace=True`` to record per-request spans and the
    iteration timeline (``serving/trace.py``); the default leaves the
    tracer on its disabled fast path, so always-on users pay only for
    counter/histogram updates.  One instance may be shared between an
    engine and its scheduler (one merged registry — how
    ``launch/serve.py`` runs), or each component builds its own.
    """

    def __init__(self, *, trace: bool = False, clock: Clock | None = None):
        self.clock = clock or Clock()
        self.registry = MetricsRegistry()
        from repro_torch.serving.trace import Tracer   # avoid import cycle
        self.tracer = Tracer(self.clock, enabled=trace)

    def state(self) -> dict:
        return {"registry": self.registry.state(),
                "trace": self.tracer.state()}

    def load_state(self, s: dict) -> None:
        self.registry.load_state(s["registry"])
        if "trace" in s:
            self.tracer.load_state(s["trace"])


def start_metrics_server(sources, port: int = 0):
    """Serve Prometheus text over stdlib http in a daemon thread.

    ``sources`` is a list of :class:`MetricsRegistry` (their expositions
    are concatenated — e.g. the engine's and the scheduler's).  Returns
    the ``ThreadingHTTPServer``; read the bound port from
    ``server.server_address[1]`` (pass ``port=0`` for an ephemeral one)
    and stop it with :func:`stop_metrics_server` — which also closes the
    listening socket and joins the serving thread, so back-to-back runs
    in one process don't leak daemon threads or bound ports.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):                          # noqa: N802 (stdlib API)
            if self.path.rstrip("/") not in ("", "/metrics", "/health"):
                self.send_error(404)
                return
            body = ("ok\n" if self.path.rstrip("/") == "/health" else
                    "".join(r.to_prometheus() for r in sources)
                    ).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                 # keep stdout clean
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="metrics-http")
    t.start()
    server._serve_thread = t          # joined by stop_metrics_server
    return server


def stop_metrics_server(server) -> None:
    """Fully stop a server from :func:`start_metrics_server`.

    ``shutdown()`` alone stops the accept loop but leaves the listening
    socket open and the serving thread alive; this also closes the
    socket and joins the thread so nothing outlives the run.
    """
    server.shutdown()
    server.server_close()
    t = getattr(server, "_serve_thread", None)
    if t is not None:
        t.join(timeout=5.0)
