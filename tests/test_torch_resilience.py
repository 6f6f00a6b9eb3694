"""The port's resilience layer (``serving/faults.py``: fault injection,
page integrity, ``debug_validate``; ``serving/snapshot.py``) over its
engine and scheduler vs the JAX package's.

The batched cases of the 21 tests of ``tests/test_resilience.py`` run as
workloads through the harness of ``tests/test_torch_scheduler.py`` (JAX
side in one subprocess with ``XLA_FLAGS=--xla_allow_excess_precision=
false``, on the same bridged weights).  What must match exactly: the
injector's ``log`` and stats, every request's finish reason and tokens,
scheduler and engine ``stats`` (``integrity_failures`` included), and
after every iteration the engine's host state — free list, page tables,
each sequence's pages, chain and corrupted flag, the publish-time
checksums of every pool page, the prefix cache's state — beside what
``tests/test_resilience.py`` itself asserts, checked on the port's run.
Greedy tokens go through ``GreedyParity`` step by step as well.

Snapshots cross the packages both ways: before the JAX subprocess starts,
the port writes its snapshots of the three snapshot workloads; the JAX
side restores them and finishes their requests, and the port restores the
JAX package's snapshots; each restored engine must finish with the tokens
of the uninterrupted run, with a cohort in flight and with a warm cache
too.

The ``batched=False`` cases (and the second half of the chaos composite),
which run the host-looped oracle, are in
``tests/test_torch_reference_faults.py``.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from test_torch_scheduler import (check_against_jax, host_state, port_kit,
                                  run_jax_records, tracks)

PAGE = 8
SNAP_ENV = "REPRO_TORCH_TEST_SNAPSHOTS"
OTHER = {"jax": "port", "port": "jax"}

PROMPTS = {
    0: [5, 9, 2, 7, 11, 3, 8, 1, 6, 4, 13, 2],
    1: [1 + (j * 3) % 50 for j in range(21)],
    2: [4, 4, 8, 1, 9, 7],
}


# ---------------------------------------------------------------------------
# helpers over the API both packages share
# ---------------------------------------------------------------------------

def _engine(kit, *, cache=False, faults=None, n_pool_pages=96, max_batch=4,
            **kw):
    return kit.engine(pool=n_pool_pages, max_batch=max_batch, cache=cache,
                      faults=faults, **kw)


def _sched(kit, eng, **kw):
    return kit.sched(eng, token_budget=24, **kw)


def res_state(kit, eng) -> dict:
    """Host state plus what the resilience layer adds: each sequence's
    corrupted flag and whether its pages verify now, the injector's
    counters.  (The checksums themselves are compared where the page
    bytes are the same in both packages: a decode-published page's K/V
    may differ by float rounding across the packages.)"""
    inj, lyr = eng.faults, eng.cfg.n_layers
    return dict(host_state(eng),
                corrupted={str(s): q.corrupted
                           for s, q in sorted(eng.seqs.items())},
                verifies={str(s): bool(kit.F.verify_pages(
                    eng, [(li, p) for li in range(lyr)
                          for p in q.pages[li]]).all())
                    for s, q in sorted(eng.seqs.items())},
                faults=None if inj is None else
                [dict(inj.stats), len(inj.log), sorted(inj.held_pages)])


def step(kit, sched):
    ev = sched.step()
    kit.rec.states.append(res_state(kit, sched.engine))
    return ev


def run(kit, sched, max_iters: int = 2000) -> dict:
    """``sched.run()`` with the host state recorded after every
    iteration."""
    for _ in range(max_iters):
        if sched.idle:
            break
        step(kit, sched)
    assert sched.idle, "not drained"
    return sched.finished()


def toks(fin) -> dict:
    return {str(r): [str(t.finish_reason), list(t.out_tokens)]
            for r, t in sorted(fin.items())}


def _drained(eng) -> dict:
    """``debug_validate`` and the pool owned only by the cache and holds."""
    eng.debug_validate()
    cache = eng.prefix_cache
    retained = cache.retained_pages() if cache is not None else 0
    held = len(eng.faults.held_pages) if eng.faults is not None else 0
    assert eng.pool_used_pages() == retained + held
    return {"used": eng.pool_used_pages(), "retained": retained,
            "held": held}


def _run(kit, sched, *, gen=10, **submit_kw):
    for rid, p in PROMPTS.items():
        sched.submit(rid, p, max_new_tokens=gen, **submit_kw)
    fin = run(kit, sched)
    return fin, _drained(sched.engine)


def _summary(sched, fin) -> dict:
    return {"tracks": tracks(sched), "tokens": toks(fin),
            "sched_stats": sched.stats,
            "engine_stats": {k: int(v) for k, v in
                             sched.engine.stats.items()}}


def _inj(inj) -> dict:
    return {"log": inj.log, "stats": dict(inj.stats)}


# ---------------------------------------------------------------------------
# workloads (tests/test_resilience.py, batched engine)
# ---------------------------------------------------------------------------

def w_injector_determinism(kit):
    out = []
    for _ in range(2):
        inj = kit.F.FaultInjector(kit.F.FaultSpec(corrupt_page_every=3,
                                                  garble_decode_every=4),
                                  seed=11)
        sched = _sched(kit, _engine(kit, faults=inj))
        fin, drained = _run(kit, sched, gen=10)
        out.append(dict(_summary(sched, fin), injector=_inj(inj),
                        drained=drained))
    return {"runs": out}


def w_checksum_detects_single_bit_flip(kit):
    F = kit.F
    eng = _engine(kit)
    eng.add_requests({0: PROMPTS[1]})
    pairs = [(li, pid) for li in range(kit.cfg.n_layers)
             for pid in eng.seqs[0].pages[li]]
    before = F.verify_pages(eng, pairs).tolist()
    sums = [int(c) for c in F.pair_checksums(eng, pairs)]
    inj = F.FaultInjector(seed=0)
    li, pid = pairs[-1]
    inj.corrupt_page(eng, li, pid)
    after = F.verify_pages(eng, pairs).tolist()
    ok = eng.verify_seq(0)
    kit.rec.states.append(res_state(kit, eng))
    return {"pairs": pairs, "before": before, "sums": sums, "after": after,
            "sums_after": [int(c) for c in F.pair_checksums(eng, pairs)],
            "verify_seq": ok, "corrupted": eng.seqs[0].corrupted,
            "injector": _inj(inj)}


def w_corruption_restart_token_identical(kit):
    csched = _sched(kit, _engine(kit))
    clean, _ = _run(kit, csched, gen=10)
    inj = kit.F.FaultInjector(kit.F.FaultSpec(corrupt_page_every=4,
                                              corrupt_max=1), seed=3)
    sched = _sched(kit, _engine(kit, faults=inj))
    fin, drained = _run(kit, sched, gen=10)
    return {"clean": _summary(csched, clean), "faulty": _summary(sched, fin),
            "injector": _inj(inj), "drained": drained}


def w_corruption_retries_exhausted_terminal(kit):
    inj = kit.F.FaultInjector(kit.F.FaultSpec(corrupt_page_every=1), seed=0)
    eng = _engine(kit, faults=inj)
    sched = _sched(kit, eng, max_retries=2, retry_backoff=1)
    sched.submit(0, PROMPTS[1], max_new_tokens=6)
    fin = run(kit, sched)
    eng.debug_validate()
    return dict(_summary(sched, fin), injector=_inj(inj),
                used=eng.pool_used_pages())


def w_warm_hit_corruption_recomputes(kit):
    prompt = PROMPTS[1]

    def one(eng, rid):
        s = _sched(kit, eng)
        s.submit(rid, prompt, max_new_tokens=8)
        return run(kit, s)[rid]

    cold = one(_engine(kit), 0)
    inj = kit.F.FaultInjector(seed=0)
    eng = _engine(kit, cache=True, faults=inj)
    one(eng, 0)                                    # populate the cache
    cache = eng.prefix_cache
    eid = min(cache.entries)                       # the first prompt block
    inj.corrupt_page(eng, 0, cache.entries[eid].pages[0])
    warm = one(eng, 1)                             # warm hit on a bad page
    ent = cache.entries[eid]
    healed_ok = kit.F.verify_pages(eng, list(enumerate(ent.pages))).tolist()
    eng.debug_validate()
    return {"cold": list(cold.out_tokens), "warm": list(warm.out_tokens),
            "pf_start": warm.pf_start, "cache_stats": dict(cache.stats),
            "n_corrupt": cache._n_corrupt, "entry_corrupt": ent.corrupt,
            "healed_ok": healed_ok,
            "engine_stats": {k: int(v) for k, v in eng.stats.items()},
            "injector": _inj(inj)}


def w_garbage_decode_token_recovered(kit):
    csched = _sched(kit, _engine(kit))
    clean, _ = _run(kit, csched, gen=10)
    inj = kit.F.FaultInjector(kit.F.FaultSpec(garble_decode_every=6,
                                              garble_max=2), seed=5)
    sched = _sched(kit, _engine(kit, faults=inj))
    fin, drained = _run(kit, sched, gen=10)
    return {"clean": _summary(csched, clean), "faulty": _summary(sched, fin),
            "injector": _inj(inj), "drained": drained,
            "garbage": kit.F.GARBAGE_TOKEN}


def _preempt_pair(kit, faults=None) -> tuple:
    eng = _engine(kit, faults=faults, n_pool_pages=17)
    sched = _sched(kit, eng, requeue_preempted=True)
    sched.submit(0, [2 + (j * 7) % 40 for j in range(25)], max_new_tokens=24)
    sched.submit(1, [3 + (j * 5) % 40 for j in range(41)], max_new_tokens=4)
    fin = run(kit, sched)
    eng.debug_validate()
    return sched, fin


def w_preemption_victim_verified_before_absorb(kit):
    inj = kit.F.FaultInjector(kit.F.FaultSpec(corrupt_page_every=2,
                                              corrupt_max=1), seed=1)
    sched, fin = _preempt_pair(kit, inj)
    csched, clean = _preempt_pair(kit)
    return {"faulty": _summary(sched, fin), "clean": _summary(csched, clean),
            "used": sched.engine.pool_used_pages(), "injector": _inj(inj)}


def w_ttft_deadline_expires_waiting_request(kit):
    eng = _engine(kit, max_batch=1)
    sched = _sched(kit, eng)
    sched.submit(0, PROMPTS[1], max_new_tokens=20)   # hogs the one slot
    sched.submit(1, PROMPTS[0], max_new_tokens=4, ttft_deadline=3)
    fin = run(kit, sched)
    eng.debug_validate()
    return _summary(sched, fin)


def w_total_deadline_truncates_running_request(kit):
    cs = _sched(kit, _engine(kit))
    cs.submit(0, PROMPTS[0], max_new_tokens=30)
    clean = run(kit, cs)[0].out_tokens
    eng = _engine(kit)
    sched = _sched(kit, eng)
    sched.submit(0, PROMPTS[0], max_new_tokens=30, deadline=8)
    fin = run(kit, sched)
    eng.debug_validate()
    tr = fin[0]
    return dict(_summary(sched, fin), clean=list(clean),
                span=tr.finished_iter - tr.submitted_iter,
                used=eng.pool_used_pages())


def w_bounded_queue_rejects_with_backpressure(kit):
    eng = _engine(kit)
    sched = _sched(kit, eng, max_queue=2)
    ok = [sched.submit(0, PROMPTS[0], max_new_tokens=3),
          sched.submit(1, PROMPTS[1], max_new_tokens=3),
          sched.submit(2, PROMPTS[2], max_new_tokens=3)]
    fin = run(kit, sched)
    eng.debug_validate()
    return dict(_summary(sched, fin), accepted=ok)


def w_overload_ladder_degrades_and_recovers(kit):
    # 44 allocatable pages, 31 held from iteration 0 (tests/test_resilience)
    inj = kit.F.FaultInjector(kit.F.FaultSpec(holds=((0, 31, 50),)), seed=0)
    eng = _engine(kit, cache=True, faults=inj, n_pool_pages=45)
    sched = _sched(kit, eng, ladder=kit.PressureLadder(), verify_finish=False)
    sched.submit(0, PROMPTS[1], max_new_tokens=30)
    rejected_at, refused = None, None
    for _ in range(200):
        if sched.idle and not inj.held_pages:
            break
        step(kit, sched)
        if rejected_at is None and sched.stats["ladder_level"] \
                >= sched.ladder.n_levels:
            refused = sched.submit(9, PROMPTS[2], max_new_tokens=3)
            rejected_at = sched.iteration
    after = dict(sched.stats)
    readmitted = sched.submit(10, PROMPTS[2], max_new_tokens=3)
    fin = run(kit, sched)
    eng.debug_validate()
    return dict(_summary(sched, fin), rejected_at=rejected_at,
                refused=refused, after=after, readmitted=readmitted,
                injector=_inj(inj))


def w_stall_watchdog_raises(kit):
    sched = _sched(kit, _engine(kit), stall_limit=12)

    class StuckLadder:                  # admission blocked forever
        level, transitions, n_levels = 3, 0, 3

        def update(self, pressure):
            return self.level

    sched.submit(0, PROMPTS[0], max_new_tokens=3)
    sched.ladder = StuckLadder()
    raised = None
    try:
        run(kit, sched)
    except kit.F.SchedulerStalledError as e:
        raised = type(e).__name__
    return {"raised": raised, "stats": sched.stats,
            "iteration": sched.iteration}


def w_requeue_limit_uses_finish_reason_enum(kit):
    eng = _engine(kit, n_pool_pages=10)
    sched = _sched(kit, eng, requeue_preempted=True, max_requeues=1)
    sched.submit(0, [3, 1, 4], max_new_tokens=4)
    sched.submit(1, [1 + (j * 11) % 60 for j in range(72)], max_new_tokens=5)
    fin = run(kit, sched)
    eng.debug_validate()
    return dict(_summary(sched, fin),
                enum=fin[1].finish_reason is kit.F.FinishReason.PREEMPTED)


def w_arrival_burst_hook(kit):
    inj = kit.F.FaultInjector(kit.F.FaultSpec(bursts={2: 6}), seed=0)
    eng = _engine(kit, max_batch=2, faults=inj)
    sched = _sched(kit, eng, max_queue=3)
    outcomes, nxt = {}, 0
    for _ in range(300):
        for _ in range(inj.burst(sched.iteration)):
            outcomes[str(nxt)] = sched.submit(
                nxt, [1 + (nxt * 7 + j) % 50 for j in range(6)],
                max_new_tokens=3)
            nxt += 1
        if nxt and sched.idle:
            break
        step(kit, sched)
    eng.debug_validate()
    return dict(_summary(sched, sched.finished()), outcomes=outcomes,
                submitted=nxt, idle=sched.idle)


def w_debug_validate_catches_manufactured_leak(kit):
    eng = _engine(kit)
    eng.add_requests({0: PROMPTS[0]})
    eng.debug_validate()                             # live state: clean
    caught = []
    leaked = eng.free.pop()                          # drop a page
    try:
        eng.debug_validate()
    except AssertionError as e:
        caught.append(str(e))
    eng.free.append(leaked)
    eng.seqs[0].pages[0].append(eng.seqs[0].pages[0][-1])
    try:                                             # a double-mapped page
        eng.debug_validate()
    except AssertionError as e:
        caught.append(str(e))
    return {"caught": caught}


def _snap_dirs(kit, name: str) -> tuple[Path, Path]:
    root = Path(os.environ[SNAP_ENV])
    return root / kit.side / name, root / OTHER[kit.side] / name


def _restore_and_finish(kit, path) -> dict:
    eng, sched = kit.restore(path)
    fin = run(kit, sched)
    eng.debug_validate()
    return {"tokens": toks(fin), "cohort": eng._cohort is not None,
            "drained": _drained(eng)}


def _cross(kit, other: Path) -> dict | None:
    """Restore the other package's snapshot and finish it (absent on the
    port's pre-pass, which writes the snapshots the JAX side restores)."""
    return _restore_and_finish(kit, other) if other.exists() else None


def w_snapshot_restore_midstream_token_identical(kit):
    mine, other = _snap_dirs(kit, "midstream")
    eng = _engine(kit, cache=True, max_batch=2)
    sched = _sched(kit, eng)
    for rid, p in PROMPTS.items():
        sched.submit(rid, p, max_new_tokens=8)
    while not sched._running:
        step(kit, sched)
    for _ in range(2):
        step(kit, sched)               # a few tokens into decode
    man = kit.save_snapshot(mine, eng, sched, step=sched.iteration)
    fin1 = run(kit, sched)
    return {"uninterrupted": toks(fin1), "entries": len(man["entries"]),
            "restored": _restore_and_finish(kit, mine),
            "cross": _cross(kit, other)}


def w_snapshot_restore_with_cohort_in_flight(kit):
    mine, other = _snap_dirs(kit, "cohort")
    eng = _engine(kit)
    sched = _sched(kit, eng)
    sched.submit(0, PROMPTS[1], max_new_tokens=6)
    sched.submit(1, [9 + (j * 5) % 40 for j in range(30)], max_new_tokens=6)
    while not sched._prefill:
        step(kit, sched)
    step(kit, sched)                   # advance the grid partway
    in_flight = eng._cohort is not None
    kit.save_snapshot(mine, eng, sched)
    fin1 = run(kit, sched)
    eng2, sched2 = kit.restore(mine)
    restored_cohort = eng2._cohort is not None
    fin2 = run(kit, sched2)
    eng2.debug_validate()
    return {"in_flight": in_flight, "restored_cohort": restored_cohort,
            "uninterrupted": toks(fin1), "restored": toks(fin2),
            "cross": _cross(kit, other)}


def w_snapshot_restores_warm_prefix_cache(kit):
    mine, other = _snap_dirs(kit, "warm")
    prompt = PROMPTS[1]
    eng = _engine(kit, cache=True)
    sched = _sched(kit, eng)
    sched.submit(0, prompt, max_new_tokens=6)
    run(kit, sched)
    kit.save_snapshot(mine, eng, sched)
    out = {"first": toks(sched.finished())}
    for name, path in (("restored", mine), ("cross", other)):
        if not path.exists():
            out[name] = None
            continue
        eng2, sched2 = kit.restore(path)
        entries = len(eng2.prefix_cache.entries)
        sched2.submit(7, list(prompt), max_new_tokens=6)
        fin = run(kit, sched2)
        eng2.debug_validate()
        out[name] = {"entries": entries, "pf_start": fin[7].pf_start,
                     "tokens": toks(fin)}
    return out


def w_chaos_composite_all_faults(kit):
    spec = kit.F.FaultSpec(corrupt_page_every=5, corrupt_max=2,
                           garble_decode_every=7, garble_max=2,
                           holds=((3, 8, 10),))
    csched = _sched(kit, _engine(kit, cache=True, n_pool_pages=48))
    clean, _ = _run(kit, csched, gen=8)
    inj = kit.F.FaultInjector(spec, seed=13)
    sched = _sched(kit, _engine(kit, cache=True, faults=inj,
                                n_pool_pages=48), requeue_preempted=True)
    fin, drained = _run(kit, sched, gen=8)
    return {"clean": _summary(csched, clean), "faulty": _summary(sched, fin),
            "injector": _inj(inj), "drained": drained}


WORKLOADS = {f.__name__[2:]: f for f in (
    w_injector_determinism, w_checksum_detects_single_bit_flip,
    w_corruption_restart_token_identical,
    w_corruption_retries_exhausted_terminal,
    w_warm_hit_corruption_recomputes, w_garbage_decode_token_recovered,
    w_preemption_victim_verified_before_absorb,
    w_ttft_deadline_expires_waiting_request,
    w_total_deadline_truncates_running_request,
    w_bounded_queue_rejects_with_backpressure,
    w_overload_ladder_degrades_and_recovers, w_stall_watchdog_raises,
    w_requeue_limit_uses_finish_reason_enum, w_arrival_burst_hook,
    w_debug_validate_catches_manufactured_leak,
    w_snapshot_restore_midstream_token_identical,
    w_snapshot_restore_with_cohort_in_flight,
    w_snapshot_restores_warm_prefix_cache, w_chaos_composite_all_faults)}
CASES = {name: (name, {}) for name in WORKLOADS}
SNAPSHOT_CASES = [n for n in WORKLOADS if n.startswith("snapshot_")]


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    root = tmp_path_factory.mktemp("snapshots")
    os.environ[SNAP_ENV] = str(root)
    for name in SNAPSHOT_CASES:        # the port's snapshots, for JAX
        WORKLOADS[name](port_kit())
    return run_jax_records("test_torch_resilience", tmp_path_factory,
                           **{SNAP_ENV: str(root)})


# ---------------------------------------------------------------------------
# host-only units: both packages in this process
# ---------------------------------------------------------------------------

def test_finish_reason_is_str_compatible():
    from repro.serving import faults as JF
    from repro_torch.serving import faults as F
    assert F.FinishReason.EOS == "eos"
    assert str(F.FinishReason.CORRUPTED) == "corrupted-retries-exhausted"
    assert F.FinishReason("deadline") is F.FinishReason.DEADLINE
    assert [(r.name, r.value) for r in F.FinishReason] \
        == [(r.name, r.value) for r in JF.FinishReason]
    assert F.GARBAGE_TOKEN == JF.GARBAGE_TOKEN


def test_pressure_ladder_hysteresis():
    from repro.core.camp import PressureLadder as JL
    from repro_torch.core.camp import PressureLadder as PL
    seq = [0.5, 0.72, 0.97, 0.90, 0.86, 0.84, 0.2, 0.99, 0.6]
    got = []
    for cls in (PL, JL):
        lad = cls()
        got.append(([lad.update(p) for p in seq], lad.transitions))
    assert got[0] == got[1]
    assert got[0][0][:7] == [0, 1, 3, 3, 3, 2, 0]
    with pytest.raises(AssertionError):
        PL(enter=(0.5, 0.4, 0.9))                 # not monotonic
    with pytest.raises(AssertionError):
        PL(enter=(0.5,), exit=(0.6,))             # exit >= enter


# ---------------------------------------------------------------------------
# the workloads, held against the JAX run
# ---------------------------------------------------------------------------

def _clean_tokens_equal(got: dict) -> None:
    for rid, (reason, out) in got["faulty"]["tokens"].items():
        assert [reason, out] == got["clean"]["tokens"][rid], rid


@pytest.mark.parametrize("name", list(CASES))
def test_resilience_matches_jax(name, jax_records):
    kit, got = check_against_jax(WORKLOADS[name], jax_records[name])
    # what tests/test_resilience.py asserts, on the port's run
    if name == "injector_determinism":
        a, b = got["runs"]
        assert a["injector"]["log"] and a["injector"] == b["injector"]
        assert a["tokens"] == b["tokens"]
    elif name == "checksum_detects_single_bit_flip":
        assert all(got["before"]) and sum(got["after"]) == len(got["after"]) - 1
        assert not got["verify_seq"] and got["corrupted"]
        assert got["sums"][:-1] == got["sums_after"][:-1]
    elif name == "corruption_restart_token_identical":
        assert got["injector"]["stats"]["corruptions"] == 1
        assert got["faulty"]["sched_stats"]["corrupt_retries"] >= 1
        _clean_tokens_equal(got)
    elif name == "corruption_retries_exhausted_terminal":
        assert got["tokens"]["0"][0] == "corrupted-retries-exhausted"
        assert got["sched_stats"]["corrupt_retries"] == 2
        assert got["used"] == 0
    elif name == "warm_hit_corruption_recomputes":
        assert got["warm"] == got["cold"] and got["pf_start"] == 0
        assert got["cache_stats"]["quarantined"] == 1
        assert got["cache_stats"]["healed"] == 1
        assert got["engine_stats"]["integrity_failures"] >= 1
        assert got["n_corrupt"] == 0 and not got["entry_corrupt"]
        assert all(got["healed_ok"])
    elif name == "garbage_decode_token_recovered":
        assert got["injector"]["stats"]["garbled"] == 2
        assert got["faulty"]["sched_stats"]["corrupt_events"] >= 1
        _clean_tokens_equal(got)
        assert all(got["garbage"] not in out
                   for _, out in got["faulty"]["tokens"].values())
    elif name == "preemption_victim_verified_before_absorb":
        assert got["used"] == 0
        for rid in ("0", "1"):
            assert got["faulty"]["tokens"][rid][1] \
                == got["clean"]["tokens"][rid][1]
    elif name == "ttft_deadline_expires_waiting_request":
        t = got["tracks"]
        assert got["tokens"]["1"] == ["deadline", []]
        assert t["1"]["first_token"] is None
        assert got["tokens"]["0"][0] == "length"
        assert got["sched_stats"]["deadline_missed"] == 1
    elif name == "total_deadline_truncates_running_request":
        reason, out = got["tokens"]["0"]
        assert reason == "deadline" and got["span"] == 8
        assert 0 < len(out) < 30 and out == got["clean"][:len(out)]
        assert got["used"] == 0
    elif name == "bounded_queue_rejects_with_backpressure":
        assert got["accepted"] == [True, True, False]
        assert got["sched_stats"]["rejected"] == 1
        assert [got["tokens"][r][0] for r in "012"] \
            == ["length", "length", "rejected"]
    elif name == "overload_ladder_degrades_and_recovers":
        assert got["rejected_at"] is not None and got["refused"] is False
        assert got["after"]["rejected"] == 1
        assert got["engine_stats"]["shed_inserts"] > 0
        assert got["after"]["ladder_level"] == 0
        assert got["after"]["ladder_transitions"] >= 2
        assert got["readmitted"]
        assert got["tokens"]["10"][0] == got["tokens"]["0"][0] == "length"
    elif name == "stall_watchdog_raises":
        assert got["raised"] == "SchedulerStalledError"
        assert got["stats"]["stalled"] is True
    elif name == "requeue_limit_uses_finish_reason_enum":
        assert got["enum"] and got["tokens"]["1"][0] == "preempted"
        assert got["tracks"]["1"]["requeues"] == 1
        assert got["tokens"]["0"][0] == "length"
    elif name == "arrival_burst_hook":
        assert got["submitted"] == 6 and got["idle"]
        reasons = [r for r, _ in got["tokens"].values()]
        n_rej = reasons.count("rejected")
        assert n_rej == sum(not ok for ok in got["outcomes"].values()) >= 1
        assert set(reasons) == {"length", "rejected"}
    elif name == "debug_validate_catches_manufactured_leak":
        assert len(got["caught"]) == 2 and "page leak" in got["caught"][0]
    elif name.startswith("snapshot_"):
        want = jax_records[name]["result"]
        if name == "snapshot_restores_warm_prefix_cache":
            first = got["first"]["0"][1]
            for side in (got, want):          # port<-jax and jax<-port
                for k in ("restored", "cross"):
                    assert side[k]["entries"] > 0
                    assert side[k]["pf_start"] == (len(PROMPTS[1]) - 1) \
                        // PAGE * PAGE
                    assert side[k]["tokens"]["7"][1] == first
        else:
            for side in (got, want):
                restored = side["restored"]
                if isinstance(restored, dict) and "tokens" in restored:
                    restored = restored["tokens"]
                assert restored == side["uninterrupted"]
                assert side["cross"]["tokens"] == side["uninterrupted"]
            if name == "snapshot_restore_with_cohort_in_flight":
                assert got["in_flight"] and got["restored_cohort"]
                assert got["cross"]["cohort"] is False   # it drained
    elif name == "chaos_composite_all_faults":
        reasons = {"eos", "length", "preempted", "rejected", "deadline",
                   "corrupted-retries-exhausted"}
        for rid, (reason, out) in got["faulty"]["tokens"].items():
            assert reason in reasons
            if reason in ("eos", "length"):
                assert out == got["clean"]["tokens"][rid][1], rid
            assert -(1 << 20) not in out
        assert got["injector"]["stats"]["corruptions"] >= 1


# ---------------------------------------------------------------------------
# the serve CLI's chaos and snapshot paths (port only)
# ---------------------------------------------------------------------------

# the report keys of repro/launch/serve.py's scheduler path with
# --prefix-cache --chaos --snapshot-dir; the port adds the three after it
JAX_SCHEDULER_KEYS = {"tokens", "codec", "kv_compression_ratio", "stats",
                      "sched_stats", "per_request", "tok_per_s", "faults",
                      "prefix_cache", "snapshot"}
PORT_EXTRA_KEYS = {"device", "iterations", "wall_s"}


def test_serve_cli_chaos_and_snapshot(monkeypatch, tmp_path, capsys):
    """``--scheduler --prefix-cache --chaos 0 --snapshot-dir`` on the CPU:
    faults fire and are logged, every request still finishes by length,
    and the snapshot taken mid-stream restores and finishes with the
    run's tokens."""
    import sys
    from repro_torch.launch import serve
    reports = []
    inner = serve.generate
    monkeypatch.setattr(serve, "generate",
                        lambda *a, **kw: reports.append(inner(*a, **kw))
                        or reports[-1])
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "yi-6b", "--smoke", "--device", "cpu",
        "--scheduler", "--prefix-cache", "--shared-prefix", "8", "--gen",
        "12", "--chaos", "0", "--snapshot-dir", str(tmp_path / "snap")])
    serve.main()
    out = reports[0]
    assert set(out) == JAX_SCHEDULER_KEYS | PORT_EXTRA_KEYS
    f = out["faults"]
    assert f["corruptions"] + f["garbled"] > 0 and f["log"]
    assert {r["reason"] for r in out["per_request"].values()} == {"length"}
    assert out["sched_stats"]["corrupt_retries"] > 0
    snap = out["snapshot"]
    assert set(snap) == {"step", "restored_match", "restored_requests"}
    assert snap["restored_match"] is True and snap["restored_requests"] == 4
    assert "[serve] faults:" in capsys.readouterr().out
