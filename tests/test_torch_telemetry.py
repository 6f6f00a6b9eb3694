"""The port's telemetry (``serving/telemetry.py``) and tracer
(``serving/trace.py``) vs the JAX package's.

Each scenario of ``tests/test_telemetry.py`` runs once against each
package's modules and returns what it exported; the two results must be
equal — exactly, floats included: ``snapshot()``, the Prometheus text,
the JSON-lines record (``time.time`` pinned), the Chrome trace, state
dicts, histogram quantiles (equal inputs give equal quantiles) — and the
port's result must show what the original test asserts (quantiles within
5% of numpy's exact percentiles, the sqrt(GAMMA) - 1 error bound, one
terminal event a request, the trace schemas).  Time comes from a fake
clock, the same in both packages, so time-valued series compare too.

The scheduler-driven scenarios (span completeness, rejected requests,
the Chrome-trace schema, two seeded runs, a mid-flight state round
trip) drive a scheduler over an engine on the tiny config: the JAX side
in a subprocess with ``XLA_FLAGS=--xla_allow_excess_precision=false``
(``tests/test_torch_scheduler.py``'s harness), the port on the CPU.
Their traces carry the decoded tokens, so they compare only because the
tokens are equal.  The JAX suite's snapshot/restore test becomes a
``Telemetry.state()`` round trip: ``serving/snapshot.py`` is not ported.
"""

import json
import urllib.request

import numpy as np
import pytest

from repro.serving import telemetry as jax_telemetry
from repro.serving import trace as jax_trace
from repro_torch.serving import telemetry as port_telemetry
from repro_torch.serving import trace as port_trace
from test_torch_scheduler import (_norm, check_against_jax, port_kit,
                                  run_jax_records, tracks)

PAGE = 8
SIDES = {"jax": (jax_telemetry, jax_trace),
         "port": (port_telemetry, port_trace)}


class FakeClock:
    """A deterministic stand-in for ``telemetry.Clock``: every reading
    advances one tick (1 ms for ``now``, 1 us for ``us``)."""

    def __init__(self):
        self.ticks = 0

    def now(self) -> float:
        self.ticks += 1
        return self.ticks * 1e-3

    def elapsed(self) -> float:
        return self.now()

    def us(self) -> int:
        self.ticks += 1
        return self.ticks


# ---------------------------------------------------------------------------
# scenarios on the modules alone
# ---------------------------------------------------------------------------

QS = (0.05, 0.5, 0.9, 0.95, 0.99)


def _samples(dist: str, seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return {"uniform": rng.uniform(1e-4, 10.0, n),
            "lognormal": rng.lognormal(0.0, 2.0, n),
            "exponential": rng.exponential(0.05, n)}[dist]


def histogram_quantiles(tel, tr, dist):
    xs = _samples(dist, 0, 5000)
    h = tel.Histogram()
    for v in xs:
        h.observe(float(v))
    return {"q": [h.quantile(q) for q in QS], "count": h.count,
            "sum": h.sum, "mean": h.mean, "state": h.state(),
            "exact": [float(np.percentile(xs, 100 * q)) for q in QS]}


def merged_histogram_quantiles(tel, tr, dist):
    xs = _samples(dist, 1, 6000)
    a, b = tel.Histogram(), tel.Histogram()
    for v in xs[:2000]:
        a.observe(float(v))
    for v in xs[2000:]:
        b.observe(float(v))
    a.merge(b)
    snap = a.state()
    a.merge(tel.Histogram())
    return {"q": [a.quantile(q) for q in QS], "count": a.count,
            "sum": a.sum, "identity": a.state() == snap,
            "exact": [float(np.percentile(xs, 100 * q)) for q in QS]}


def histogram_edge_cases(tel, tr):
    h = tel.Histogram()
    out = {"empty": h.quantile(0.5)}
    for v in (0.0, -1.0, 5.0):
        h.observe(v)
    h1 = tel.Histogram()
    h1.observe(3.0)
    h2 = tel.Histogram()
    h2.load_state(json.loads(json.dumps(h.state())))
    return dict(out, zero=h.zero, q0=h.quantile(0.0), q1=h.quantile(1.0),
                single=h1.quantile(0.5), rt=h2.quantile(0.95) == h.quantile(
                    0.95), rt_fields=[h2.count, h2.sum, h2.zero])


def histogram_relative_error_bound(tel, tr):
    out = []
    for v in (0.001, 0.37, 1.0, 42.0, 9999.0):
        h = tel.Histogram()
        for _ in range(10):
            h.observe(v)
        out.append(abs(h.quantile(0.5) - v) / v)
    return {"err": out, "bound": tel.GAMMA ** 0.5 - 1}


def registry_kinds_labels_and_state(tel, tr):
    reg = tel.MetricsRegistry()
    c = reg.counter("req_total", codec="bdi")
    c.inc()
    c.inc(-1)
    c.inc(5)
    same = reg.counter("req_total", codec="bdi") is c
    other = reg.counter("req_total", codec="raw") is not c
    reg.gauge("depth").set(7)
    reg.histogram("lat_seconds", codec="bdi").observe(0.25)
    with pytest.raises(ValueError):
        reg.gauge("req_total")
    reg2 = tel.MetricsRegistry()
    reg2.load_state(json.loads(json.dumps(reg.state())))
    return {"same": same, "other": other, "snapshot": reg.snapshot(),
            "state": reg.state(), "rt": reg2.snapshot() == reg.snapshot(),
            "labels": sorted(lb["codec"] for lb, _ in
                             reg.series("req_total"))}


def registry_merge_aggregates_hosts(tel, tr):
    a, b = tel.MetricsRegistry(), tel.MetricsRegistry()
    a.counter("req_total", codec="bdi").inc(3)
    b.counter("req_total", codec="bdi").inc(4)
    b.counter("req_total", codec="raw").inc(1)
    a.gauge("depth").set(2)
    b.gauge("depth").set(5)
    for v in (0.1, 0.2):
        a.histogram("lat_seconds").observe(v)
    b.histogram("lat_seconds").observe(0.4)
    a.merge(b)
    c = tel.MetricsRegistry()
    c.gauge("req_total").set(1)
    with pytest.raises(ValueError):
        c.merge(a)
    return {"a": a.snapshot(), "b": b.snapshot()}


ESCAPES = ('plain', 'a"b', 'back\\slash', 'multi\nline',
           '\\n is not a newline', 'tricky\\"\\n\\\\end', '')


def label_escape_round_trip(tel, tr):
    reg = tel.MetricsRegistry()
    reg.counter("esc_total", tag='a"b\\c\nd\\ne').inc()
    line = [ln for ln in reg.to_prometheus().splitlines()
            if ln.startswith("esc_total{")][0]
    quoted = line[line.index('="') + 2:line.rindex('"}')]
    return {"escaped": [tel._escape(s) for s in ESCAPES],
            "rt": [tel._unescape(tel._escape(s)) for s in ESCAPES],
            "line": tel._unescape(quoted)}


def prometheus_exposition_format(tel, tr):
    reg = tel.MetricsRegistry()
    reg.counter("req_total", help="requests", codec="bdi").inc(3)
    reg.gauge("pool_used").set(11)
    h = reg.histogram("lat_seconds", codec="bdi")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    reg.counter("esc_total", tag='a"b\\c\nd').inc()
    return {"text": reg.to_prometheus()}


def jsonl_line(tel, tr):
    reg = tel.MetricsRegistry()
    reg.histogram("lat_seconds").observe(0.5)
    return {"line": reg.to_jsonl_line(iteration=3, final=True)}


def metrics_http_server(tel, tr):
    reg = tel.MetricsRegistry()
    reg.counter("x_total", codec="bdi").inc(3)
    server = tel.start_metrics_server([reg], port=0)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            body, ctype = r.read().decode(), r.headers["Content-Type"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=10) as r:
            health = r.read().decode()
    finally:
        tel.stop_metrics_server(server)
    return {"body": body, "ctype": ctype, "health": health}


def stop_metrics_server(tel, tr):
    reg = tel.MetricsRegistry()
    reg.counter("x_total").inc()
    server = tel.start_metrics_server([reg], port=0)
    port = server.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                timeout=10) as r:
        health = r.read().decode()
    tel.stop_metrics_server(server)
    closed = False
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2)
    except OSError:
        closed = True
    tel.stop_metrics_server(server)             # idempotent
    return {"health": health, "alive": server._serve_thread.is_alive(),
            "closed": closed}


def disabled_tracer_records_nothing(tel, tr):
    t = tr.Tracer(FakeClock(), enabled=False)
    t.event(1, "submit")
    t.phase(1, "queued")
    t.iteration(0, decode_tokens=3)
    t.finish(1, "length")
    return {"recorded": [t.events, t.slices, t.counters, t._open],
            "trace": t.to_chrome_trace()}


def tracer_phases_and_finish(tel, tr):
    t = tr.Tracer(FakeClock(), enabled=True)
    t.event(7, "submit")
    for ph in ("queued", "prefill", "decode"):
        t.phase(7, ph)
    t.finish(7, "eos")
    return {"slices": t.slices, "open": t._open,
            "reasons": t.finish_reasons(), "names": t.event_names(7),
            "trace": t.to_chrome_trace(), "state": t.state()}


SCENARIOS = {f"{f.__name__}[{d}]": (f, (d,))
             for f in (histogram_quantiles, merged_histogram_quantiles)
             for d in ("uniform", "lognormal", "exponential")}
SCENARIOS.update({f.__name__: (f, ()) for f in (
    histogram_edge_cases, histogram_relative_error_bound,
    registry_kinds_labels_and_state, registry_merge_aggregates_hosts,
    label_escape_round_trip, prometheus_exposition_format, jsonl_line,
    metrics_http_server, stop_metrics_server,
    disabled_tracer_records_nothing, tracer_phases_and_finish)})


def _check_scenario(name: str, got: dict) -> None:
    """The assertions of the matching test in tests/test_telemetry.py."""
    base = name.split("[")[0]
    if base in ("histogram_quantiles", "merged_histogram_quantiles"):
        assert got["q"] == pytest.approx(got["exact"], rel=0.05)
        assert got["count"] == (5000 if base == "histogram_quantiles"
                                else 6000)
        if base == "merged_histogram_quantiles":
            assert got["identity"]
    elif base == "histogram_edge_cases":
        assert got["empty"] == 0.0 and got["zero"] == 2
        assert got["q0"] == 0.0 and got["q1"] == 5.0
        assert got["single"] == 3.0 and got["rt"]
        assert got["rt_fields"][0] == 3 and got["rt_fields"][2] == 2
    elif base == "histogram_relative_error_bound":
        assert all(e <= got["bound"] + 1e-12 for e in got["err"])
    elif base == "registry_kinds_labels_and_state":
        assert got["same"] and got["other"] and got["rt"]
        assert got["labels"] == ["bdi", "raw"]
        assert got["snapshot"]["req_total"]["series"][0]["value"] == 5
    elif base == "registry_merge_aggregates_hosts":
        a = got["a"]
        vals = {s["labels"]["codec"]: s["value"]
                for s in a["req_total"]["series"]}
        assert vals == {"bdi": 7, "raw": 1}
        assert a["depth"]["series"][0]["value"] == 7
        h = a["lat_seconds"]["series"][0]
        assert h["count"] == 3 and h["sum"] == pytest.approx(0.7)
        assert (h["min"], h["max"]) == (0.1, 0.4)
        assert got["b"]["req_total"]["series"][0]["value"] == 4
    elif base == "label_escape_round_trip":
        assert got["rt"] == list(ESCAPES)
        assert got["line"] == 'a"b\\c\nd\\ne'
    elif base == "prometheus_exposition_format":
        text = got["text"]
        for want in ("# HELP req_total requests", "# TYPE req_total counter",
                     '\nreq_total{codec="bdi"} 3\n', "\npool_used 11\n",
                     "# TYPE lat_seconds summary",
                     '\nlat_seconds{codec="bdi",quantile="0.5"} ',
                     '\nlat_seconds_count{codec="bdi"} 3\n',
                     r'esc_total{tag="a\"b\\c\nd"} 1'):
            assert want in text, want
    elif base == "jsonl_line":
        rec = json.loads(got["line"])
        assert rec["iteration"] == 3 and rec["final"] is True and "ts" in rec
        (s,) = rec["metrics"]["lat_seconds"]["series"]
        assert s["count"] == 1 and "p95" in s
    elif base == "metrics_http_server":
        assert 'x_total{codec="bdi"} 3' in got["body"]
        assert got["ctype"].startswith("text/plain")
        assert got["health"] == "ok\n"
    elif base == "stop_metrics_server":
        assert got["health"] == "ok\n" and not got["alive"] and got["closed"]
    elif base == "disabled_tracer_records_nothing":
        assert not any(got["recorded"])
        assert [e["ph"] for e in got["trace"]["traceEvents"]] == ["M", "M"]
    elif base == "tracer_phases_and_finish":
        assert [s[3] for s in got["slices"]] == ["queued", "prefill",
                                                 "decode"]
        assert not got["open"] and got["reasons"] == {7: ["eos"]}
        assert got["names"] == [(7, "submit"), (7, port_trace.FINISH)]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_telemetry_matches_jax(name, monkeypatch):
    import time
    monkeypatch.setattr(time, "time", lambda: 1.7e9)   # jsonl's ts
    fn, args = SCENARIOS[name]
    got = fn(*SIDES["port"], *args)
    assert _norm(got) == _norm(fn(*SIDES["jax"], *args))
    _check_scenario(name, got)


# ---------------------------------------------------------------------------
# scheduler-driven scenarios (JAX side in the harness's subprocess)
# ---------------------------------------------------------------------------

def _workload():
    # normal finishes, a chunk-split long prompt, and a sure deadline
    # miss (a 30-token prompt cannot prefill in 1 iteration at budget 24)
    return [(0, [1 + j for j in range(12)], {"max_new_tokens": 4}),
            (1, [5, 6, 7], {"max_new_tokens": 6}),
            (2, [9] * 30, {"max_new_tokens": 3}),
            (3, [2] * 30, {"max_new_tokens": 50, "deadline": 1})]


def _exports(tel, sched) -> dict:
    t = tel.tracer
    return {"trace": t.to_chrome_trace(), "snapshot": tel.registry.snapshot(),
            "prometheus": tel.registry.to_prometheus(),
            "reasons": t.finish_reasons(), "names": t.event_names(),
            "slices": [[r, ph] for _, _, r, ph in t.slices],
            "open": len(t._open), "tracks": tracks(sched),
            "stats": sched.stats}


def w_traced_run(kit):
    tel = kit.Telemetry(trace=True, clock=FakeClock())
    sched = kit.sched(kit.engine(max_batch=3, telemetry=tel),
                      token_budget=24, telemetry=tel)
    for rid, prompt, kw in _workload():
        sched.submit(rid, prompt, **kw)
    sched.run()
    return _exports(tel, sched)


def w_rejected_requests(kit):
    tel = kit.Telemetry(trace=True, clock=FakeClock())
    sched = kit.sched(kit.engine(max_batch=2, telemetry=tel),
                      token_budget=24, max_queue=1, telemetry=tel)
    for rid in range(4):
        sched.submit(rid, [1 + rid] * 6, max_new_tokens=2)
    sched.run()
    return _exports(tel, sched)


def w_state_round_trip(kit):
    """Mid-flight ``Telemetry.state()`` into a fresh Telemetry: registry
    and tracer history carried whole; the run then goes on recording."""
    tel = kit.Telemetry(trace=True, clock=FakeClock())
    eng = kit.engine(max_batch=3, telemetry=tel)
    sched = kit.sched(eng, token_budget=24, telemetry=tel)
    sched.submit(0, [1 + j for j in range(12)], max_new_tokens=8)
    sched.submit(1, [3] * 5, max_new_tokens=6)
    for _ in range(4):
        sched.step()
    st = json.loads(json.dumps(tel.state()))
    tel2 = kit.Telemetry(trace=False, clock=FakeClock())
    tel2.load_state(st)
    same = {"snapshot": tel2.registry.snapshot() == tel.registry.snapshot(),
            "events": tel2.tracer.events == [tuple(e) for e in st["trace"][
                "events"]] and tel2.tracer.enabled,
            "slices": tel2.tracer.slices == tel.tracer.slices}
    sched.run()
    h = tel.registry.histogram("serve_ttft_seconds", codec=eng.codec.name)
    return dict(_exports(tel, sched), state=st, same=same, ttft_n=h.count)


def w_engine_registry(kit):
    """The engine's registry-backed ``stats``, ``sample_gauges`` (pool
    gauges and the prefix cache's series) and ``load_stats_dict`` after
    a shared-prefix run."""
    tel = kit.Telemetry(clock=FakeClock())
    eng = kit.engine(cache=True, telemetry=tel)
    sched = kit.sched(eng, token_budget=24, telemetry=tel)
    sysp = [3 + (j * 5) % 200 for j in range(17)]
    for rid in range(3):
        sched.submit(rid, sysp + [rid + 1] * (rid + 2), max_new_tokens=5)
    sched.run()
    eng.sample_gauges()
    fresh = kit.engine(telemetry=kit.Telemetry(clock=FakeClock()))
    fresh.load_stats_dict(eng.stats)
    return {"stats": eng.stats, "loaded": fresh.stats,
            "snapshot": tel.registry.snapshot(),
            "gauges": [eng.pool_used_pages(), len(eng.free),
                       round(eng.pool_pressure(), 6)]}


WORKLOADS = {f.__name__[2:]: f for f in (w_traced_run, w_rejected_requests,
                                         w_state_round_trip,
                                         w_engine_registry)}
CASES = {name: (name, {}) for name in WORKLOADS}


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    return run_jax_records("test_torch_telemetry", tmp_path_factory)


def test_span_lifecycle_completeness(jax_records):
    _, got = check_against_jax(w_traced_run, jax_records["traced_run"])
    reasons, fin = got["reasons"], got["tracks"]
    assert fin and set(reasons) == set(fin)
    for rid, tr in fin.items():
        assert reasons[rid] == [tr["reason"]], rid
    assert "deadline" in {r for rs in reasons.values() for r in rs}
    for rid, tr in fin.items():
        assert [int(rid), "submit"] in got["names"]
        if tr["n_out"]:
            assert [int(rid), "first_token"] in got["names"]
    assert got["open"] == 0


def test_rejected_requests_get_terminal_events(jax_records):
    _, got = check_against_jax(w_rejected_requests,
                               jax_records["rejected_requests"])
    reasons = got["reasons"]
    assert set(reasons) == set(got["tracks"]) == {"0", "1", "2", "3"}
    assert all(len(rs) == 1 for rs in reasons.values())
    assert "rejected" in {rs[0] for rs in reasons.values()}
    assert got["stats"]["rejected"] >= 1


def test_chrome_trace_schema(jax_records):
    _, got = check_against_jax(w_traced_run, jax_records["traced_run"])
    trace = got["trace"]
    assert trace["displayTimeUnit"] == "ms"
    evs = trace["traceEvents"]
    assert {e["ph"] for e in evs} == {"M", "X", "i", "C"}
    for e in evs:
        assert {"ph", "pid", "tid", "name"} <= set(e)
        if e["ph"] == "X":
            assert e["cat"] == "request" and e["name"] in port_trace.PHASES
            assert e["dur"] >= 0 and e["ts"] >= 0
        elif e["ph"] == "i":
            assert e["s"] in ("t", "p") and isinstance(e["args"], dict)
        elif e["ph"] == "C":
            assert "iteration" in e["args"]
    assert {"decode_tokens", "prefill_tokens", "token_budget",
            "pool_used_pages", "free_list_depth", "dispatch_ms"} \
        <= {e["name"] for e in evs if e["ph"] == "C"}


def test_two_seeded_runs_trace_identically(jax_records):
    """Two port runs give the same event sequence (with the fake clock,
    the same trace byte for byte), and each equals the JAX run's."""
    a = _norm(w_traced_run(port_kit()))
    b = _norm(w_traced_run(port_kit()))
    assert a == b
    assert a == jax_records["traced_run"]["result"]


def test_telemetry_state_round_trip(jax_records):
    _, got = check_against_jax(w_state_round_trip,
                               jax_records["state_round_trip"])
    assert all(got["same"].values()), got["same"]
    assert set(got["reasons"]) == {"0", "1"}
    assert all(len(rs) == 1 for rs in got["reasons"].values())
    assert got["ttft_n"] == 2


def test_engine_registry_matches_jax(jax_records):
    _, got = check_against_jax(w_engine_registry,
                               jax_records["engine_registry"])
    assert got["loaded"] == got["stats"]
    snap = got["snapshot"]
    assert {s["labels"]["codec"] for s in
            snap["engine_pages_compressed_total"]["series"]} == {"bdi"}
    gauges = [snap[k]["series"][0]["value"] for k in (
        "engine_pool_used_pages", "engine_free_list_depth",
        "engine_pool_pressure")]
    assert gauges == got["gauges"]
    # one cohort: the three prompts dedup their shared pages in publish
    assert snap["prefix_cache_lookups"]["series"][0]["value"] == 3
    assert snap["prefix_cache_deduped"]["series"][0]["value"] > 0
