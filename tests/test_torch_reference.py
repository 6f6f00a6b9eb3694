"""The port's host-looped oracle (``serving/reference.py``) against the
JAX package's, and the port's batched engine against the port's oracle.

Two comparisons:

- **port oracle vs JAX oracle** on the workloads of
  ``tests/test_serving_batched.py`` (ragged prompts across page
  publishes, padded-page-table growth, a CAMP preemption mid-decode,
  chunked-prefill admission, a preemption mid-prefill, a self-preempting
  publish), the JAX side in a subprocess with
  ``XLA_FLAGS=--xla_allow_excess_precision=false`` on the same bridged
  weights (``tests/test_torch_scheduler.py``'s harness).  Exactly equal:
  ``stats``, the free list, every sequence's pool ids, tail length,
  preemption flag and chain, per-page compressed bytes and codec tags,
  ``request_bytes`` — the oracles allocate one page at a time in the same
  order, so pool ids match — after every decode round; greedy tokens
  step by step up to the one-bf16-ULP ties ``GreedyParity`` reports.
- **port batched engine vs port oracle** (no JAX), on the three
  ``test_serving_batched.py`` workloads that fail in the JAX package under
  XLA's default excess precision, the oracle workloads of
  ``tests/test_scheduler.py`` (staggered arrivals, EOS retirement, budget
  chunk splits) and the oracle cases of ``tests/test_prefix_cache.py``
  (scheduler-driven warm paths; requeue after preemption with and without
  a cache).  Exactly equal: engine and scheduler ``stats``, every
  request's finish reason and lifecycle iterations, the prefix cache's
  stats, and after every round the allocation-order-free host state
  (:func:`shape_state`: per-sequence page counts, tail lengths, flags and
  chains, pool use and pressure, the cache trie without pool ids).  Pool
  ids themselves differ by design: the batched engine reserves all of a
  step's pages at once, layer-major across sequences, the oracle one
  page at a time.  Greedy tokens per round up to reported ties.

The ``batched=False`` cases of ``tests/test_resilience.py`` run against
the JAX oracle in ``tests/test_torch_reference_faults.py``.
"""

import pytest

from repro_torch.serving.parity import GreedyParity
from test_torch_scheduler import (check_against_jax, port_kit,
                                  run_jax_records, tracks)

PAGE = 8


# ---------------------------------------------------------------------------
# host state and per-round records, for either engine
# ---------------------------------------------------------------------------

def oracle_state(eng) -> dict:
    """The oracle's host state, pool ids included."""
    cache = eng.prefix_cache
    used = sorted({p for s in eng.seqs.values() for lp in s.pages
                   for p in lp})
    return {"stats": {k: int(v) for k, v in eng.stats.items()},
            "free": [int(p) for p in eng.free],
            "seqs": {str(sid): [[list(map(int, lp)) for lp in s.pages],
                                s.tail_len, s.preempted, list(s.chain),
                                s.prefilling]
                     for sid, s in sorted(eng.seqs.items())},
            "page_bytes": {str(p): int(eng.page_bytes[p]) for p in used},
            "codec_ids": {str(p): int(eng.page_codec_id[p]) for p in used},
            "request_bytes": {str(k): [int(b) for b in v]
                              for k, v in sorted(eng.request_bytes.items())},
            "pool_pressure": eng.pool_pressure(),
            "cache": None if cache is None else cache.state()}


def shape_state(eng) -> dict:
    """Host state that does not depend on which pool ids were handed out:
    what the batched engine and the oracle must agree on."""
    cache = eng.prefix_cache
    st = {"stats": {k: int(v) for k, v in eng.stats.items()},
          "used": eng.pool_used_pages(),
          "seqs": {str(sid): [[len(lp) for lp in s.pages], s.tail_len,
                              s.preempted, s.done, list(s.chain)]
                   for sid, s in sorted(eng.seqs.items())},
          "request_bytes": {str(k): [int(b) for b in v]
                            for k, v in sorted(eng.request_bytes.items())},
          "pool_pressure": eng.pool_pressure(),
          "cache": None, "hit_rate": None}
    if cache is not None:
        cs = cache.state()
        for e in cs["entries"]:
            del e["pages"]
        st["cache"], st["hit_rate"] = cs, cache.hit_rate()
    return st


def _batched(eng) -> bool:
    return hasattr(eng, "mixed_step")


def decode_round(kit, eng, sids) -> dict:
    """One decode round over ``sids``: one batched step, or one
    ``decode_one`` per sequence on the oracle.  Records the round's tokens
    and (port) logits in ``kit.rounds`` and the engine's state."""
    n0 = len(kit.rec.logits)
    if _batched(eng):
        out = eng.decode_batch(list(sids))
    else:
        out = {sid: eng.decode_one(sid) for sid in sids}
    _note_round(kit, eng, out, n0)
    return out


def _note_round(kit, eng, out: dict, n0: int) -> None:
    """Record a round: its tokens, the port's logits rows of the round
    (``kit.rounds``), and the engine's state."""
    logits = {}
    for d in kit.rec.logits[n0:]:
        logits.update(d)
    kit.__dict__.setdefault("rounds", []).append(
        ({int(s): int(t) for s, t in out.items()}, logits))
    _note_state(kit, eng)


def _note_state(kit, eng) -> None:
    """:func:`oracle_state` when oracles are compared (pool ids included),
    :func:`shape_state` when a batched engine is in the comparison."""
    shape = getattr(kit, "shape_only", False) or _batched(eng)
    kit.rec.states.append(shape_state(eng) if shape else oracle_state(eng))


def _tokens(eng, sids) -> dict:
    return {str(s): list(eng.seqs[s].tokens) for s in sids}


# ---------------------------------------------------------------------------
# workloads of tests/test_serving_batched.py, for either engine
# ---------------------------------------------------------------------------

def _engine(kit, batched: bool, pool: int, max_batch: int = 8, **kw):
    if batched:
        return kit.engine(pool=pool, max_batch=max_batch, **kw)
    return kit.ref_engine(pool=pool, **kw)


def w_decode_batch_matches_reference_engine(kit, batched=False):
    eng = _engine(kit, batched, 96)
    prompts = {0: [5, 9, 2, 7, 11, 3], 1: [4, 4, 8, 1],
               2: list(range(1, 13))}
    for sid, p in prompts.items():
        eng.add_request(sid, p)
    for _ in range(16):
        decode_round(kit, eng, list(prompts))
    return {"tokens": _tokens(eng, prompts), "stats": dict(eng.stats),
            "used": eng.pool_used_pages()}


def w_decode_batch_page_table_growth(kit, batched=False):
    eng = _engine(kit, batched, 64, max_batch=2)
    prompt = [1 + (j * 5) % (kit.cfg.vocab - 1) for j in range(62)]
    eng.add_request(0, prompt)
    for _ in range(12):                        # crosses 8 pages a layer
        decode_round(kit, eng, [0])
    return {"tokens": _tokens(eng, [0]), "stats": dict(eng.stats)}


def w_camp_preemption_mid_decode_matches_reference(kit, batched=False):
    eng = _engine(kit, batched, 24)
    prompts = {0: [5, 9, 2, 7, 11, 3], 1: [3, 1, 4, 1, 5],
               2: [2, 7, 1, 8, 2, 8], 3: list(range(1, 40))}
    for sid, p in prompts.items():
        eng.add_request(sid, p)
    eng.seqs[3].done = True                    # CAMP value -1: the victim
    live = [0, 1, 2]
    preempt_step = None
    for step in range(20):
        decode_round(kit, eng, live)
        if eng.seqs[3].preempted:
            preempt_step = step
            break
    for _ in range(4):                         # decode on after the evict
        decode_round(kit, eng, live)
    return {"tokens": _tokens(eng, live), "stats": dict(eng.stats),
            "preempt_step": preempt_step}


def w_chunked_prefill_batched_admission_matches_reference(kit,
                                                          batched=False):
    eng = _engine(kit, batched, 96)
    prompts = {0: [5, 9, 2, 7, 11, 3], 1: list(range(1, 20)),
               2: [4, 4, 8, 1], 3: [1 + (j * 3) % 50 for j in range(34)]}
    eng.add_requests(prompts)
    tails = {str(s): eng.seqs[s].tail_len for s in prompts}
    prefill_stats = dict(eng.stats)
    for _ in range(12):
        decode_round(kit, eng, list(prompts))
    return {"tails": tails, "prefill_stats": prefill_stats,
            "tokens": _tokens(eng, prompts), "stats": dict(eng.stats),
            "used": eng.pool_used_pages()}


def w_prefill_camp_preemption_mid_prefill(kit, batched=False):
    eng = _engine(kit, batched, 15)
    eng.add_request(0, [2 + (j * 7) % 40 for j in range(41)])
    eng.seqs[0].done = True
    eng.add_request(1, [3 + (j * 5) % 40 for j in range(41)])
    flags = [eng.seqs[0].preempted, eng.seqs[1].preempted]
    for _ in range(6):
        decode_round(kit, eng, [1])
    return {"flags": flags, "tokens": _tokens(eng, [1]),
            "stats": dict(eng.stats)}


def w_self_preemption_publish_drops_pages(kit, batched=False):
    eng = _engine(kit, batched, 9)
    eng.add_request(0, [1 + (j * 11) % 60 for j in range(72)])
    seq = eng.seqs[0]
    _note_state(kit, eng)
    return {"preempted": seq.preempted, "pages": [len(lp) for lp in
                                                  seq.pages],
            "tail_len": seq.tail_len, "used": eng.pool_used_pages(),
            "stats": dict(eng.stats)}


WORKLOADS = {f.__name__[2:]: f for f in (
    w_decode_batch_matches_reference_engine,
    w_decode_batch_page_table_growth,
    w_camp_preemption_mid_decode_matches_reference,
    w_chunked_prefill_batched_admission_matches_reference,
    w_prefill_camp_preemption_mid_prefill,
    w_self_preemption_publish_drops_pages)}
CASES = {name: (name, {}) for name in WORKLOADS}


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    return run_jax_records("test_torch_reference", tmp_path_factory)


@pytest.mark.parametrize("name", list(CASES))
def test_oracle_matches_jax_oracle(name, jax_records):
    kit, got = check_against_jax(WORKLOADS[name], jax_records[name])
    # what tests/test_serving_batched.py pins, on the port's oracle
    if name == "decode_batch_page_table_growth":
        assert len(got["tokens"]["0"]) == 62 + 12
    elif name == "camp_preemption_mid_decode_matches_reference":
        assert got["preempt_step"] is not None
        assert got["stats"]["preemptions"] == 1
    elif name == "prefill_camp_preemption_mid_prefill":
        assert got["flags"] == [True, False]
        assert got["stats"]["preemptions"] == 1
        assert got["stats"]["pages_evicted"] == 10
    elif name == "self_preemption_publish_drops_pages":
        assert got["preempted"] and got["pages"] == [0, 0]
        assert got["tail_len"] == 0 and got["used"] == 0
        assert got["stats"]["preemptions"] == 1


# ---------------------------------------------------------------------------
# the port's batched engine against the port's oracle
# ---------------------------------------------------------------------------

def compare_rounds(bk, rk, what: str) -> GreedyParity:
    """Round-by-round greedy parity, batched (candidate) against the
    oracle (reference), each with its own logits; ties are reported and
    end the comparison of that sequence."""
    parity = GreedyParity()
    br, rr = getattr(bk, "rounds", []), getattr(rk, "rounds", [])
    assert len(br) == len(rr), what
    for i, ((bt, bl), (rt, rl)) in enumerate(zip(br, rr)):
        assert set(bt) == set(rt), (what, i)
        parity.check(i, rt, bt, bl.__getitem__, rl.__getitem__)
    for tie in parity.ties:
        print(f"{what}: bf16 tie {tie}")
    return parity


def _pair_run(workload, **kw):
    """Run ``workload`` on the port's batched engine and on its oracle."""
    out = {}
    for batched in (True, False):
        kit = port_kit()
        kit.shape_only = True
        out[batched] = (kit, workload(kit, batched=batched, **kw))
    return out[True], out[False]


@pytest.mark.parametrize("name", [
    "decode_batch_matches_reference_engine",
    "camp_preemption_mid_decode_matches_reference",
    "chunked_prefill_batched_admission_matches_reference",
    "decode_batch_page_table_growth",
    "prefill_camp_preemption_mid_prefill",
    "self_preemption_publish_drops_pages"])
def test_batched_engine_matches_port_oracle(name):
    (bk, got_b), (rk, got_r) = _pair_run(WORKLOADS[name])
    parity = compare_rounds(bk, rk, name)
    assert not parity.ties, "a tie makes the runs diverge"
    assert bk.rec.states == rk.rec.states
    assert got_b == got_r
    if name == "camp_preemption_mid_decode_matches_reference":
        assert got_b["stats"]["preemptions"] == 1
        assert got_b["stats"]["pages_evicted"] > 0


# -- scheduler-driven: tests/test_scheduler.py and tests/test_prefix_cache.py

def sched_drive(kit, sched, arrivals: dict, *, max_iters: int = 400) -> None:
    """Open-loop drive (``tests/test_scheduler.py``'s ``_drive``), one
    round a scheduler iteration."""
    pending = dict(arrivals)
    for it in range(max_iters):
        for rid, (t, prompt, kw) in list(pending.items()):
            if t <= it:
                sched.submit(rid, list(prompt), **kw)
                del pending[rid]
        if not pending and sched.idle:
            break
        n0 = len(kit.rec.logits)
        ev = sched.step()
        _note_round(kit, sched.engine, ev["decoded"], n0)
    assert sched.idle and not pending, "workload did not drain"
    sched.engine.debug_validate()


def _sched_pair(kit, batched, *, pool=96, max_batch=4, budget=24,
                cache=False, **kw):
    if batched:
        eng = kit.engine(pool=pool, max_batch=max_batch, cache=cache)
        return kit.sched(eng, token_budget=budget, **kw)
    eng = kit.ref_engine(pool=pool, cache=cache)
    return kit.make_reference_scheduler(
        eng, token_budget=budget, max_batch=max_batch,
        prefill_chunk=2 * PAGE, **kw)


def _sched_summary(sched) -> dict:
    eng = sched.engine
    return {"tracks": tracks(sched),
            "tokens": {str(r): t.out_tokens
                       for r, t in sorted(sched.finished().items())},
            "sched_stats": sched.stats,
            "engine_stats": {k: int(v) for k, v in eng.stats.items()},
            "cache_stats": (None if eng.prefix_cache is None
                            else dict(eng.prefix_cache.stats)),
            "used": eng.pool_used_pages()}


_STAGGERED = {
    0: (0, [5, 9, 2, 7, 11, 3], {"max_new_tokens": 9}),
    1: (2, list(range(1, 20)), {"max_new_tokens": 6}),
    2: (3, [4, 4, 8, 1], {"max_new_tokens": 11}),
    3: (7, [1 + (j * 3) % 50 for j in range(34)], {"max_new_tokens": 4}),
}
_SPLITS = {
    0: (0, [5, 9, 2, 7, 11, 3], {"max_new_tokens": 8}),
    1: (1, [1 + (j * 3) % 50 for j in range(34)], {"max_new_tokens": 5}),
    2: (4, list(range(1, 20)), {"max_new_tokens": 6}),
}
_SYS = [7 + (j * 11) % 45 for j in range(25)]
_WARM = {
    0: (0, _SYS + [9, 1, 4], {"max_new_tokens": 6}),
    1: (8, _SYS + [3, 3, 8, 2, 6], {"max_new_tokens": 5}),
    2: (16, _SYS + [1], {"max_new_tokens": 5}),
    3: (24, list(_SYS), {"max_new_tokens": 4}),
}
_REQUEUE = {
    0: (0, [2 + (j * 7) % 40 for j in range(41)], {"max_new_tokens": 30}),
    1: (4, [1 + (j * 11) % 60 for j in range(73)], {"max_new_tokens": 1}),
}


def s_staggered_arrivals(kit, batched):
    sched = _sched_pair(kit, batched)
    sched_drive(kit, sched, _STAGGERED)
    return _sched_summary(sched)


def s_eos_retirement(kit, batched):
    prompt = [5, 9, 2, 7, 11, 3]
    probe = _sched_pair(port_kit(), True)      # the eos id, from a probe
    probe.submit(0, prompt, max_new_tokens=12)
    eos = probe.run()[0].out_tokens[3]
    sched = _sched_pair(kit, batched)
    sched_drive(kit, sched, {
        0: (0, prompt, {"max_new_tokens": 12, "eos_id": eos}),
        1: (1, list(range(1, 14)), {"max_new_tokens": 8})})
    return dict(_sched_summary(sched), eos=eos)


def s_budget_boundary_chunk_splits(kit, batched):
    sched = _sched_pair(kit, batched, budget=7)    # < prefill_chunk (16)
    sched_drive(kit, sched, _SPLITS)
    return _sched_summary(sched)


def s_warm_path_scheduler_equivalence(kit, batched):
    sched = _sched_pair(kit, batched, cache=True)
    sched_drive(kit, sched, _WARM)
    return _sched_summary(sched)


def s_requeue_after_preemption(kit, batched, cache=True):
    sched = _sched_pair(kit, batched, pool=21, budget=20, cache=cache,
                        requeue_preempted=True)
    sched_drive(kit, sched, _REQUEUE)
    return _sched_summary(sched)


SCHED_CASES = {
    "staggered_arrivals": (s_staggered_arrivals, {}),
    "eos_retirement": (s_eos_retirement, {}),
    "budget_boundary_chunk_splits": (s_budget_boundary_chunk_splits, {}),
    "warm_path_scheduler_equivalence": (s_warm_path_scheduler_equivalence,
                                        {}),
    "requeue_after_preemption_round_trip": (s_requeue_after_preemption, {}),
    "requeue_without_cache_still_completes": (s_requeue_after_preemption,
                                              {"cache": False}),
}


@pytest.mark.parametrize("name", list(SCHED_CASES))
def test_scheduler_matches_port_oracle(name):
    fn, kw = SCHED_CASES[name]
    (bk, got_b), (rk, got_r) = _pair_run(fn, **kw)
    parity = compare_rounds(bk, rk, name)
    assert not parity.ties, "a tie makes the schedules diverge"
    assert bk.rec.states == rk.rec.states
    assert got_b == got_r
    # what the JAX suites pin, on the port's batched run
    tr, st = got_b["tracks"], got_b["sched_stats"]
    if name == "staggered_arrivals":
        assert st["mixed_iterations"] > 0 and got_b["used"] == 0
    elif name == "eos_retirement":
        assert tr["0"]["reason"] == "eos"
        assert got_b["tokens"]["0"][-1] == got_b["eos"]
    elif name == "budget_boundary_chunk_splits":
        assert st["chunk_splits"] > 0
    elif name == "warm_path_scheduler_equivalence":
        assert st["prefix_cached_tokens"] > 0
        assert tr["1"]["pf_start"] == 24 and tr["3"]["pf_start"] == 24
    elif name.startswith("requeue"):
        assert st["requeues"] >= 1
        assert len(got_b["tokens"]["0"]) == 30
        assert {t["reason"] for t in tr.values()} <= {"length", "eos"}
