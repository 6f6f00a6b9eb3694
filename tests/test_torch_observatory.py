"""The port's memory-hierarchy observatory (``serving/audit.py``,
``reuse.py``, ``shadow.py``, ``observatory.py``, ``launch/observe.py``)
against the JAX package's.

- **Units** (``tests/test_observatory.py``'s eleven): each scenario feeds
  the same event stream into both packages' ``ReuseTracker``,
  ``ShadowCache``/``ShadowSet``, ``CodecShadow`` and ``AuditLog`` in this
  process and returns what they hold — ``state()``, hit rates, joint
  tables, registry snapshots, JSONL lines, tracer counter series without
  their timestamps; the two records must be equal, and the port's must
  show what the original test asserts.
- **Engine workloads** (the JAX suite's five: two waves on a shared
  prefix under adaptive, the pure-observer check, admission rejects, SIP
  evictions on a 20-page pool, a snapshot carrying the observatory) run
  through the port's and the JAX engine with an observatory attached (JAX
  side in a subprocess with ``XLA_FLAGS=--xla_allow_excess_precision=
  false``: ``tests/test_torch_scheduler.py``'s harness).  Exactly equal
  after every scheduler iteration: the engine's host state, the
  observatory's ``state()`` (reuse tracker, shadow caches, codec shadow,
  audit ring) and its registry series; at the end the summary, joint
  counts, shadow hit rates, each member codec's would-be bytes and the
  audit records.  Tokens step by step up to reported bf16 ties.  The
  prompts stay inside the tiny model's 256-token vocabulary (the JAX
  suite's 100..403 and 1000.. token ids are out of it: JAX clamps the
  embedding gather, PyTorch refuses it).
- **Snapshots cross the packages both ways**: before the JAX subprocess
  the port writes its snapshot with an observatory; the JAX side restores
  it and the port restores the JAX side's; each restored observatory's
  state equals the saved one, and the run continues its series.
- **The report**: ``repro_torch.launch.observe.render_report`` on the
  Prometheus text, metrics JSONL and audit JSONL a port run exported is
  byte-equal to ``repro.launch.observe.render_report`` on the same files.
"""

import json
import os
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro.launch import observe as jax_observe
from repro.serving import audit as j_audit
from repro.serving import reuse as j_reuse
from repro.serving import shadow as j_shadow
from repro.serving import telemetry as j_tel
from repro_torch.launch import observe as port_observe
from repro_torch.serving import audit as p_audit
from repro_torch.serving import reuse as p_reuse
from repro_torch.serving import shadow as p_shadow
from repro_torch.serving import telemetry as p_tel
from test_torch_scheduler import (_norm, check_against_jax, host_state,
                                  port_kit, run_jax_records, tracks)

PAGE = 8
SNAP_ENV = "REPRO_TORCH_TEST_OBS_SNAPSHOTS"
OTHER = {"jax": "port", "port": "jax"}
SIDES = {
    "jax": SimpleNamespace(audit=j_audit, reuse=j_reuse, shadow=j_shadow,
                           tel=j_tel),
    "port": SimpleNamespace(audit=p_audit, reuse=p_reuse, shadow=p_shadow,
                            tel=p_tel),
}
OBS_SERIES = ("obs_", "shadow_", "audit_")


def _joint(j: dict) -> list:
    return sorted([list(k), v] for k, v in j.items())


def _series(reg) -> dict:
    """The observatory's registry series (the engine and scheduler series
    carry wall times)."""
    return {k: v for k, v in reg.snapshot().items()
            if k.startswith(OBS_SERIES)}


# ---------------------------------------------------------------------------
# units (tests/test_observatory.py), one scenario per test, both packages
# ---------------------------------------------------------------------------

def u_reuse_tracker_joint_accounting(ns):
    reg = ns.tel.MetricsRegistry()
    rt = ns.reuse.ReuseTracker(reg, line_bytes=64)
    rt.page_birth(1, 32, "bdi")            # tick 0; bin 3
    rt.page_birth(2, 64, "bdi")            # tick 1; bin 7
    rt.page_access(1)                      # tick 2, d=2
    rt.page_access(1)                      # tick 3, d=1
    rt.page_access(999)                    # unknown pid: no tick
    out = {"tick": rt.tick, "joint": _joint(rt.joint_counts()),
           "state": rt.state()}
    rt.page_release(1)
    rt.page_release(2)
    rt.page_release(2)                     # double release: tolerated
    life = reg.histogram("obs_page_lifetime", size_bin=3)
    reuses = reg.histogram("obs_page_reuses", size_bin=3)
    return dict(out, live=rt.n_live(), life=[life.count, life.sum],
                reuses=[reuses.count, reuses.sum],
                born=reg.counter("obs_pages_born_total", size_bin=3,
                                 codec="bdi").value,
                table=ns.reuse.joint_table_str(rt.joint_counts()),
                empty=ns.reuse.joint_table_str({}), series=_series(reg))


def u_reuse_tracker_wouldbe_member_sizes(ns):
    reg = ns.tel.MetricsRegistry()
    rt = ns.reuse.ReuseTracker(reg, line_bytes=512)
    rt.page_birth(7, 100, "gbdi",
                  wouldbe={"bdi": 200, "gbdi": 100, "raw": 512})
    return {"wouldbe": {n: reg.counter("obs_wouldbe_bytes_total",
                                       codec=n).value
                        for n in ("bdi", "gbdi", "raw")},
            "hist": {n: reg.histogram("obs_wouldbe_page_bytes",
                                      codec=n).count
                     for n in ("bdi", "gbdi", "raw")},
            "winner": reg.histogram("obs_page_bytes", codec="gbdi").count,
            "series": _series(reg)}


def u_dist_pow2_buckets(ns):
    return [ns.reuse.dist_pow2(d) for d in (0, 1, 2, 3, 4, 1000, -3)]


def u_reuse_tracker_state_roundtrip(ns):
    rt = ns.reuse.ReuseTracker(ns.tel.MetricsRegistry(), line_bytes=64)
    rt.page_birth(1, 32, "bdi")
    rt.page_access(1)
    rt2 = ns.reuse.ReuseTracker(ns.tel.MetricsRegistry())
    rt2.load_state(json.loads(json.dumps(rt.state())))
    return {"state": rt.state(), "restored": rt2.state(),
            "live_equal": rt2.live == rt.live}


def _policy_separating_stream(cache):
    """Small hot blocks + large one-shot blocks under byte pressure."""
    smalls = [f"s{i}" for i in range(4)]
    for r in range(12):
        for k in smalls:
            if not cache.access(k):
                cache.install(k, 64)
        cache.install(f"big{r}", 512)
    return cache


def u_shadow_cache_basic(ns, policy):
    c = ns.shadow.ShadowCache(policy, capacity_bytes=1024)
    cold = c.access("a")
    c.install("a", 100)
    warm = c.access("a")
    c.install("a", 80)                     # twin install: size refresh
    used = c.used_bytes
    c.install("huge", 4096)                # larger than the budget
    c2 = ns.shadow.ShadowCache(policy, capacity_bytes=1024)
    c2.load_state(json.loads(json.dumps(c.state())))
    return {"cold": cold, "warm": warm, "used": used,
            "huge": "huge" in c.entries, "rate": c.hit_rate(),
            "state": c.state(), "restored": c2.state()}


def u_shadow_sip_beats_fifo_on_hot_small_blocks(ns):
    caches = {p: _policy_separating_stream(
        ns.shadow.ShadowCache(p, capacity_bytes=1024))
        for p in ns.shadow.POLICIES}
    return {p: {"rate": c.hit_rate(), "state": c.state()}
            for p, c in caches.items()}


def u_shadow_cache_rejects_unknown_policy(ns):
    try:
        ns.shadow.ShadowCache("belady", 1024)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def u_block_keys_prefix_identity(ns):
    bk = ns.shadow.block_keys
    return {"a": bk([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], 4),
            "b": bk([1, 2, 3, 4, 5, 6, 7, 8, 99, 98, 97, 96], 4),
            "c": bk([7, 7, 7, 7, 5, 6, 7, 8], 4),
            "n": bk(list(range(1, 30)), 8, 2)}


def u_shadow_set_publishes_per_policy_counters(ns):
    reg = ns.tel.MetricsRegistry()
    ss = ns.shadow.ShadowSet(reg, capacity_bytes=1024)
    ss.note_request(0, ["k0", "k1"])
    ss.install_for(0, 0, 64)
    ss.install_for(0, 5, 64)               # out-of-range block: ignored
    ss.note_request(1, ["k0"])
    counters = {p: [reg.counter("shadow_hits_total", policy=p).value,
                    reg.counter("shadow_misses_total", policy=p).value,
                    reg.gauge("shadow_occupancy_bytes", policy=p).value]
                for p in ns.shadow.POLICIES}
    ss.forget(0)
    ss2 = ns.shadow.ShadowSet(ns.tel.MetricsRegistry(), capacity_bytes=1024)
    ss2.load_state(json.loads(json.dumps(ss.state())))
    cs = ns.shadow.CodecShadow(reg)
    cs.record({"bdi": 96, "fpc": 120, "adaptive": 90})
    cs.record({"bdi": 100, "fpc": 70, "adaptive": 71})
    cs2 = ns.shadow.CodecShadow(ns.tel.MetricsRegistry())
    cs2.load_state(json.loads(json.dumps(cs.state())))
    return {"counters": counters, "forgot": 0 not in ss._seq_keys,
            "state": ss.state(), "rates": ss.hit_rates(),
            "restored_rates": ss2.hit_rates(), "codec": cs.state(),
            "codec_restored": cs2.state(), "series": _series(reg)}


def u_audit_log_ring_counts_and_jsonl(ns):
    reg = ns.tel.MetricsRegistry()
    log = ns.audit.AuditLog(reg, cap=3)
    for i in range(5):
        log.record("sip_evict", eid=i, nbytes=64 * (i + 1),
                   value=0.5 / (i + 1), corrupt=bool(i % 2))
    log2 = ns.audit.AuditLog(ns.tel.MetricsRegistry())
    log2.load_state(json.loads(json.dumps(log.state())))
    return {"seq": log.seq, "records": log.records, "counts": log.counts(),
            "total": reg.counter("audit_decisions_total",
                                 kind="sip_evict").value,
            "lines": log.to_jsonl_lines(), "restored": log2.state()}


def u_audit_log_emits_tracer_counters(ns):
    tel = ns.tel.Telemetry(trace=True)
    log = ns.audit.AuditLog(tel.registry, tel.tracer)
    log.record("camp_preempt", sid=3, value=0.25, note="text-skipped",
               corrupt=False)
    return {"counters": [[it, series] for _, it, series in
                         tel.tracer.counters]}


UNITS = {f.__name__[2:]: (f, {}) for f in (
    u_reuse_tracker_joint_accounting, u_reuse_tracker_wouldbe_member_sizes,
    u_dist_pow2_buckets, u_reuse_tracker_state_roundtrip,
    u_shadow_sip_beats_fifo_on_hot_small_blocks,
    u_shadow_cache_rejects_unknown_policy, u_block_keys_prefix_identity,
    u_shadow_set_publishes_per_policy_counters,
    u_audit_log_ring_counts_and_jsonl, u_audit_log_emits_tracer_counters)}
for _p in p_shadow.POLICIES:
    UNITS[f"shadow_cache_basic[{_p}]"] = (u_shadow_cache_basic,
                                         {"policy": _p})


@pytest.mark.parametrize("name", list(UNITS))
def test_observatory_units_match_jax(name):
    fn, kw = UNITS[name]
    want = _norm(fn(SIDES["jax"], **kw))
    got = _norm(fn(SIDES["port"], **kw))
    assert got == want
    # what tests/test_observatory.py asserts, on the port's record
    if name == "reuse_tracker_joint_accounting":
        assert got["tick"] == 4 and got["joint"] == [[[3, 1], 1], [[3, 2], 1]]
        assert got["live"] == 0 and got["life"] == [1, 4.0]
        assert got["reuses"] == [1, 2.0] and got["born"] == 1
        assert "size_bin" in got["table"]
        assert got["empty"] == "(no reuse events recorded)"
    elif name == "reuse_tracker_wouldbe_member_sizes":
        assert got["wouldbe"] == {"bdi": 200, "gbdi": 100, "raw": 512}
        assert set(got["hist"].values()) == {1} and got["winner"] == 1
    elif name == "dist_pow2_buckets":
        assert got == [0, 1, 2, 2, 3, 10, 0]
    elif name == "reuse_tracker_state_roundtrip":
        assert got["restored"] == got["state"] and got["live_equal"]
    elif name.startswith("shadow_cache_basic"):
        assert not got["cold"] and got["warm"] and got["used"] == 80
        assert not got["huge"] and got["rate"] == 0.5
        assert got["restored"] == got["state"]
    elif name == "shadow_sip_beats_fifo_on_hot_small_blocks":
        rates = {p: r["rate"] for p, r in got.items()}
        assert rates["sip"] > rates["fifo"] and rates["sip"] >= rates["gcamp"]
        assert rates["sip"] > 0.8 and rates["fifo"] < 0.6
    elif name == "shadow_cache_rejects_unknown_policy":
        assert got["error"]
    elif name == "block_keys_prefix_identity":
        assert got["a"][:2] == got["b"][:2] and got["a"][2] != got["b"][2]
        assert got["c"][1] != got["a"][1] and len(got["n"]) == 2
    elif name == "shadow_set_publishes_per_policy_counters":
        assert all(c == [1, 2, 64] for c in got["counters"].values())
        assert got["forgot"] and got["restored_rates"] == got["rates"]
        assert got["codec_restored"] == got["codec"]
    elif name == "audit_log_ring_counts_and_jsonl":
        assert got["seq"] == 5 and got["counts"] == {"sip_evict": 3}
        assert [r["seq"] for r in got["records"]] == [2, 3, 4]
        assert got["total"] == 5
        assert [json.loads(ln)["eid"] for ln in got["lines"]] == [2, 3, 4]
        assert got["restored"]["records"] == got["records"]
    elif name == "audit_log_emits_tracer_counters":
        names = {k for _, series in got["counters"] for k in series}
        assert names == {"audit_camp_preempt_sid", "audit_camp_preempt_value"}


# ---------------------------------------------------------------------------
# engine workloads (tests/test_observatory.py), through the shared harness
# ---------------------------------------------------------------------------

def _build(kit, *, observe=True, codec="adaptive", max_queue=None, pool=96):
    tel = kit.Telemetry()
    obs = kit.Observatory(tel) if observe else None
    eng = kit.engine(pool=pool, max_batch=3, cache=True, codec=codec,
                     telemetry=tel, observatory=obs)
    sched = kit.sched(eng, token_budget=24, max_queue=max_queue,
                      telemetry=tel)
    return eng, sched, obs


def _obs_state(obs) -> dict | None:
    if obs is None:
        return None
    return {"state": obs.state(), "series": _series(obs.telemetry.registry)}


def run(kit, sched, obs, max_iters: int = 500) -> dict:
    """``sched.run()`` recording the engine's host state and the
    observatory's after every iteration."""
    for _ in range(max_iters):
        if sched.idle:
            break
        sched.step()
        kit.rec.state(sched.engine, obs=_obs_state(obs))
    assert sched.idle, "not drained"
    return sched.finished()


def obs_record(obs) -> dict:
    return {"summary": obs.summary(),
            "joint": _joint(obs.reuse.joint_counts()),
            "hit_rates": obs.shadow.hit_rates(),
            "wouldbe": dict(obs.codec_shadow.bytes),
            "audit": obs.audit.to_jsonl_lines(),
            "table": obs.reuse_table(), "state": obs.state(),
            "series": _series(obs.telemetry.registry)}


_SHARED = [1 + j for j in range(16)]
_TAILS = ([100, 101, 102, 103], [200, 201, 202, 203], [60, 61, 62, 63],
          [160, 161, 162, 163])


def _two_waves(kit, sched, obs, gen=4) -> dict:
    sched.submit(0, _SHARED + _TAILS[0], max_new_tokens=gen)
    sched.submit(1, _SHARED + _TAILS[1], max_new_tokens=gen)
    run(kit, sched, obs)
    sched.submit(2, _SHARED + _TAILS[2], max_new_tokens=gen)
    sched.submit(3, _SHARED + _TAILS[3], max_new_tokens=gen)
    return run(kit, sched, obs)


def w_two_wave_shared_prefix(kit):
    eng, sched, obs = _build(kit)
    fin = _two_waves(kit, sched, obs)
    eng.debug_validate()
    return {"tokens": {str(r): t.out_tokens for r, t in sorted(fin.items())},
            "tracks": tracks(sched), "obs": obs_record(obs)}


def w_pure_observer(kit):
    out = {}
    for observe in (True, False):
        eng, sched, obs = _build(kit, observe=observe)
        fin = _two_waves(kit, sched, obs)
        out[str(observe)] = {
            "tokens": {str(r): t.out_tokens for r, t in sorted(fin.items())},
            "engine_stats": eng.stats, "sched_stats": sched.stats,
            "engine": host_state(eng)}
    return out


def w_admission_rejects(kit):
    eng, sched, obs = _build(kit, max_queue=1)
    for rid in range(4):
        sched.submit(rid, [1 + rid] * 6, max_new_tokens=2)
    run(kit, sched, obs)
    return {"sched_stats": sched.stats, "tracks": tracks(sched),
            "total": eng.telemetry.registry.counter(
                "audit_decisions_total", kind="admission_reject").value,
            "obs": obs_record(obs)}


def _evict_prompt(wave: int, tail: int) -> list[int]:
    return [1 + (41 * (2 * wave + tail) + j) % 250 for j in range(20)]


def w_sip_evictions(kit):
    eng, sched, obs = _build(kit, pool=20)
    rid = 0
    for wave in range(6):
        for tail in (0, 1):
            sched.submit(rid, _evict_prompt(wave, tail), max_new_tokens=2)
            rid += 1
        run(kit, sched, obs)
    eng.debug_validate()
    return {"engine_stats": eng.stats, "tracks": tracks(sched),
            "obs": obs_record(obs)}


def _snap_dirs(kit) -> tuple[Path, Path]:
    root = Path(os.environ[SNAP_ENV])
    return root / kit.side, root / OTHER[kit.side]


def _born(reg) -> int:
    return sum(m.value for _, m in reg.series("obs_pages_born_total"))


def _restore_and_finish(kit, path) -> dict:
    eng2, sched2 = kit.restore(path)
    obs2 = eng2.obs
    restored = {"state": obs2.state(), "page": obs2.page == eng2.page,
                "born": _born(eng2.telemetry.registry),
                "series": _series(eng2.telemetry.registry)}
    fin = run(kit, sched2, obs2)
    eng2.debug_validate()
    return {"restored": restored,
            "tokens": {str(r): t.out_tokens for r, t in sorted(fin.items())},
            "born_after": _born(eng2.telemetry.registry),
            "tick_after": obs2.reuse.tick}


def w_snapshot_carries_observatory(kit):
    mine, other = _snap_dirs(kit)
    eng, sched, obs = _build(kit)
    sched.submit(0, _SHARED + _TAILS[0], max_new_tokens=4)
    sched.submit(1, _SHARED + _TAILS[1], max_new_tokens=4)
    run(kit, sched, obs)                   # wave 1: the cache filled
    sched.submit(2, _SHARED + _TAILS[2], max_new_tokens=6)
    for _ in range(3):                     # wave 2 mid-flight
        sched.step()
    kit.save_snapshot(mine, eng, sched, step=1)
    saved = {"state": obs.state(), "series": _series(eng.telemetry.registry)}
    fin = run(kit, sched, obs)
    return {"saved": saved,
            "uninterrupted": {str(r): t.out_tokens
                              for r, t in sorted(fin.items())},
            "restored": _restore_and_finish(kit, mine),
            "cross": (_restore_and_finish(kit, other) if other.exists()
                      else None)}


WORKLOADS = {f.__name__[2:]: f for f in (
    w_two_wave_shared_prefix, w_pure_observer, w_admission_rejects,
    w_sip_evictions, w_snapshot_carries_observatory)}
CASES = {name: (name, {}) for name in WORKLOADS}


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs_snapshots")
    os.environ[SNAP_ENV] = str(root)
    w_snapshot_carries_observatory(port_kit())     # the port's, for JAX
    return run_jax_records("test_torch_observatory", tmp_path_factory,
                           **{SNAP_ENV: str(root)})


@pytest.mark.parametrize("name", list(CASES))
def test_observatory_engine_matches_jax(name, jax_records):
    _, got = check_against_jax(WORKLOADS[name], jax_records[name])
    # what tests/test_observatory.py asserts, on the port's run
    if name == "two_wave_shared_prefix":
        ob = got["obs"]
        rates = ob["hit_rates"]
        assert set(rates) == set(p_shadow.POLICIES)
        assert all(r > 0 for r in rates.values())
        assert rates["sip"] >= rates["fifo"]
        assert ob["joint"] and "size_bin" in ob["table"]
        assert {"bdi", "zero", "raw", "gbdi", "fpc"} <= set(ob["wouldbe"])
        assert all(v > 0 for v in ob["wouldbe"].values())
        assert ob["summary"]["reuse_ticks"] > 0
    elif name == "pure_observer":
        on, off = got["True"], got["False"]
        assert on["tokens"] == off["tokens"]
        assert on["engine_stats"] == off["engine_stats"]
        assert on["sched_stats"] == off["sched_stats"]
    elif name == "admission_rejects":
        rejects = [json.loads(ln) for ln in got["obs"]["audit"]
                   if json.loads(ln)["kind"] == "admission_reject"]
        assert got["sched_stats"]["rejected"] >= 1
        assert len(rejects) == got["sched_stats"]["rejected"] == got["total"]
        assert all(r["over_queue"] or r["shedding"] for r in rejects)
    elif name == "sip_evictions":
        assert got["engine_stats"]["prefix_pages_evicted"] > 0
        evicts = [json.loads(ln) for ln in got["obs"]["audit"]
                  if json.loads(ln)["kind"] == "sip_evict"]
        assert evicts
        for r in evicts:
            assert {"eid", "hits", "nbytes", "value", "pow2_bucket",
                    "size_bin", "candidates"} <= set(r)
            assert r["nbytes"] > 0 and r["candidates"] >= 1
    elif name == "snapshot_carries_observatory":
        for key in ("restored", "cross"):
            res = got[key]
            assert res["restored"]["state"] == got["saved"]["state"]
            assert res["restored"]["series"] == got["saved"]["series"]
            assert res["restored"]["page"] and res["restored"]["born"] > 0
            assert res["born_after"] > res["restored"]["born"]
            assert res["tokens"] == got["uninterrupted"]


# ---------------------------------------------------------------------------
# the report over exported artifacts
# ---------------------------------------------------------------------------

def test_observe_report_equals_jax(tmp_path, monkeypatch, capsys):
    """A port run with an observatory exports Prometheus text, a metrics
    JSONL log and the audit JSONL; both packages render the same report
    from those files, byte for byte."""
    kit = port_kit()
    eng, sched, obs = _build(kit, pool=20)
    reg = eng.telemetry.registry
    jsonl = tmp_path / "metrics.jsonl"
    with open(jsonl, "w") as f:
        for wave in range(4):
            for tail in (0, 1):
                sched.submit(2 * wave + tail, _evict_prompt(wave, tail),
                             max_new_tokens=2)
            sched.run()
            eng.sample_gauges()
            f.write(reg.to_jsonl_line(iteration=sched.iteration) + "\n")
    prom = tmp_path / "metrics.prom"
    prom.write_text(reg.to_prometheus())
    audit = tmp_path / "audit.jsonl"
    assert obs.audit.to_jsonl(audit) > 0
    records = [json.loads(ln) for ln in audit.read_text().splitlines()]
    reports = {}
    for side, mod in (("jax", jax_observe), ("port", port_observe)):
        snap, recs = mod.load_jsonl(str(jsonl))
        reports[side] = (
            mod.render_report(snap, jsonl_records=recs,
                              audit_records=records),
            mod.render_report(mod.parse_prometheus(prom.read_text()),
                              audit_records=records))
    assert reports["port"] == reports["jax"]
    assert "size_bin" in reports["port"][0]
    out = tmp_path / "report.txt"
    port_observe.main(["--metrics-jsonl", str(jsonl), "--audit", str(audit),
                       "--out", str(out)])
    assert capsys.readouterr().out == out.read_text() == reports["port"][0]
