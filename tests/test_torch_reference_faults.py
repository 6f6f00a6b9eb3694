"""The ``batched=False`` cases of ``tests/test_resilience.py``: the port's
oracle (``serving/reference.py``) under fault injection, driven by
``make_reference_scheduler``, against the JAX package's oracle.

Each workload runs once on each package (the JAX side in a subprocess
with ``XLA_FLAGS=--xla_allow_excess_precision=false``, on the same
bridged weights: ``tests/test_torch_scheduler.py``'s harness).  What must
match exactly: the injector's ``log`` (which pool page of which layer
took which bit flip, which decode was garbled) and stats, every
request's finish reason, lifecycle iterations and tokens, scheduler and
engine ``stats`` (``integrity_failures`` included), and after every
scheduler iteration the oracle's host state — free list, each
sequence's pool ids, tail, flags and chain, page bytes and codec tags,
the prefix cache's state — with whether each sequence's pages verify
now.  Greedy tokens also go step by step through ``GreedyParity``.  The
properties ``tests/test_resilience.py`` asserts are checked on the
port's run.
"""

import pytest

from test_torch_reference import oracle_state
from test_torch_scheduler import check_against_jax, run_jax_records, tracks

PAGE = 8
PROMPTS = {
    0: [5, 9, 2, 7, 11, 3, 8, 1, 6, 4, 13, 2],
    1: [1 + (j * 3) % 50 for j in range(21)],
    2: [4, 4, 8, 1, 9, 7],
}


def _engine(kit, *, cache=False, faults=None, n_pool_pages=96):
    return kit.ref_engine(pool=n_pool_pages, cache=cache, faults=faults)


def _sched(kit, eng, **kw):
    return kit.make_reference_scheduler(eng, token_budget=24, max_batch=4,
                                        prefill_chunk=2 * PAGE, **kw)


def _state(kit, eng) -> dict:
    inj, lyr = eng.faults, eng.cfg.n_layers
    return dict(oracle_state(eng),
                corrupted={str(s): q.corrupted
                           for s, q in sorted(eng.seqs.items())},
                verifies={str(s): bool(kit.F.verify_pages(
                    eng, [(li, p) for li in range(lyr)
                          for p in q.pages[li]]).all())
                    for s, q in sorted(eng.seqs.items())},
                faults=None if inj is None else
                [dict(inj.stats), len(inj.log), sorted(inj.held_pages)])


def run(kit, sched, max_iters: int = 2000) -> dict:
    """``sched.run()`` with the host state recorded every iteration."""
    for _ in range(max_iters):
        if sched.idle:
            break
        sched.step()
        kit.rec.states.append(_state(kit, sched.engine))
    assert sched.idle, "not drained"
    return sched.finished()


def _drained(eng) -> dict:
    """``debug_validate``, and the pool owned only by the cache and the
    injector's holds."""
    eng.debug_validate()
    cache = eng.prefix_cache
    retained = cache.retained_pages() if cache is not None else 0
    held = len(eng.faults.held_pages) if eng.faults is not None else 0
    assert eng.pool_used_pages() == retained + held
    return {"used": eng.pool_used_pages(), "retained": retained,
            "held": held}


def _run(kit, sched, *, gen=10):
    for rid, p in PROMPTS.items():
        sched.submit(rid, p, max_new_tokens=gen)
    fin = run(kit, sched)
    return fin, _drained(sched.engine)


def _summary(sched, fin) -> dict:
    return {"tracks": tracks(sched),
            "tokens": {str(r): [str(t.finish_reason), list(t.out_tokens)]
                       for r, t in sorted(fin.items())},
            "sched_stats": sched.stats,
            "engine_stats": {k: int(v) for k, v in
                             sched.engine.stats.items()}}


def _inj(inj) -> dict:
    return {"log": inj.log, "stats": dict(inj.stats)}


def w_corruption_restart_token_identical(kit):
    csched = _sched(kit, _engine(kit))
    clean, _ = _run(kit, csched)
    inj = kit.F.FaultInjector(kit.F.FaultSpec(corrupt_page_every=4,
                                              corrupt_max=1), seed=3)
    sched = _sched(kit, _engine(kit, faults=inj))
    fin, drained = _run(kit, sched)
    return {"clean": _summary(csched, clean), "faulty": _summary(sched, fin),
            "injector": _inj(inj), "drained": drained}


def w_warm_hit_corruption_recomputes(kit):
    prompt = PROMPTS[1]

    def one(eng, rid):
        s = _sched(kit, eng)
        s.submit(rid, prompt, max_new_tokens=8)
        return run(kit, s)[rid]

    cold = one(_engine(kit), 0)
    eng = _engine(kit, cache=True, faults=kit.F.FaultInjector(seed=0))
    one(eng, 0)                                    # populate the cache
    cache = eng.prefix_cache
    eid = min(cache.entries)                       # the first prompt block
    eng.faults.corrupt_page(eng, 0, cache.entries[eid].pages[0])
    warm = one(eng, 1)                             # warm hit on a bad page
    ent = cache.entries[eid]
    healed = bool(kit.F.verify_pages(eng, list(enumerate(ent.pages))).all())
    eng.debug_validate()
    return {"cold": cold.out_tokens, "warm": warm.out_tokens,
            "pf_start": warm.pf_start, "cache_stats": dict(cache.stats),
            "n_corrupt": cache._n_corrupt, "entry_corrupt": ent.corrupt,
            "healed": healed, "engine_stats": dict(eng.stats),
            "injector": _inj(eng.faults), "state": _state(kit, eng)}


def w_garbage_decode_token_recovered(kit):
    csched = _sched(kit, _engine(kit))
    clean, _ = _run(kit, csched)
    inj = kit.F.FaultInjector(kit.F.FaultSpec(garble_decode_every=6,
                                              garble_max=2), seed=5)
    sched = _sched(kit, _engine(kit, faults=inj))
    fin, drained = _run(kit, sched)
    return {"clean": _summary(csched, clean), "faulty": _summary(sched, fin),
            "injector": _inj(inj), "drained": drained}


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
    w_corruption_restart_token_identical, w_warm_hit_corruption_recomputes,
    w_garbage_decode_token_recovered, w_chaos_composite_all_faults)}
CASES = {name: (name, {}) for name in WORKLOADS}


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    return run_jax_records("test_torch_reference_faults", tmp_path_factory)


@pytest.mark.parametrize("name", list(CASES))
def test_oracle_resilience_matches_jax(name, jax_records):
    kit, got = check_against_jax(WORKLOADS[name], jax_records[name])
    garbage = kit.F.GARBAGE_TOKEN
    # what tests/test_resilience.py asserts, on the port's oracle
    if name == "warm_hit_corruption_recomputes":
        assert got["warm"] == got["cold"] and got["pf_start"] == 0
        assert got["cache_stats"]["quarantined"] == 1
        assert got["cache_stats"]["healed"] == 1
        assert got["n_corrupt"] == 0 and not got["entry_corrupt"]
        assert got["healed"] and got["engine_stats"]["integrity_failures"]
        return
    clean, faulty = got["clean"]["tokens"], got["faulty"]["tokens"]
    if name == "corruption_restart_token_identical":
        assert got["injector"]["stats"]["corruptions"] == 1
        assert got["faulty"]["sched_stats"]["corrupt_retries"] >= 1
        assert faulty == clean
    elif name == "garbage_decode_token_recovered":
        assert got["injector"]["stats"]["garbled"] == 2
        assert got["faulty"]["sched_stats"]["corrupt_events"] >= 1
        assert faulty == clean
    elif name == "chaos_composite_all_faults":
        for rid, (reason, toks) in faulty.items():
            if reason in ("eos", "length"):
                assert toks == clean[rid][1], rid
            assert garbage not in toks
