"""The port's SIP prefix cache (``PrefixCache``, ``SIPRetention``) and its
wiring into ``PagedKVEngine`` vs the JAX package's.

The 16 workloads of ``tests/test_prefix_cache.py``:

- the four pure-host SIP tests (size bins, priority bins, leaf-first,
  pinned entries), and a fifth for the FIFO tiebreak, run the same
  operations on the JAX classes and the port's, in this process, and
  compare the eviction order and ``state()`` exactly;
- the engine and scheduler workloads run through the harness of
  ``tests/test_torch_scheduler.py`` (JAX side in a subprocess with
  ``XLA_FLAGS=--xla_allow_excess_precision=false``, held against the
  JAX ``PagedKVEngine``): cached-token counts, hit rate, resident and
  retained pages, every entry (pages, ``codec_ids``, refcount, hits, SIP
  state) and the rest of the engine's host state are exactly equal at
  every recorded point; greedy tokens are equal up to the one-bf16-ULP
  ties ``GreedyParity`` reports;
- the prefill dispatch's shape invariance is held bit for bit inside
  the port (scratch rows, scratch length, chunk splits), and its result
  against the JAX dispatch's exactly.

One engine case is new: CAMP values a sequence that shares its chain by
the bytes its preemption would free (``_seq_reclaimable_bytes``), so a
private sequence is the victim.  Two cases run again under ``gbdi``, a
lossy codec other than bdi, so the warm fill writes its decompressed
pages into the canonical view too.
A port-only test holds warm against cold runs on the CPU under bdi and
gbdi: the same tokens, bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_scheduler import (check_against_jax, drive, host_state,
                                  port_kit, run_jax_records, summary)

PAGE = 8


def _run(eng, sid, prompt, steps):
    eng.add_requests({sid: prompt})
    return [eng.decode_batch([sid])[sid] for _ in range(steps)]


def _no_refcounts(cache) -> bool:
    return all(e.refcount == 0 for e in cache.entries.values())


def _pool_consistent(eng) -> bool:
    """Every non-free page is held by a sequence or the cache, once."""
    cache = eng.prefix_cache
    held = {p for s in eng.seqs.values() for lp in s.pages for p in lp}
    if cache is not None:
        held |= {p for e in cache.entries.values() for p in e.pages}
    return (len(eng.free) == len(set(eng.free)) and held.isdisjoint(eng.free)
            and len(held) + len(eng.free) == eng.n_pool_pages - 1)


def _cache_view(cache) -> dict:
    return {"resident": cache.resident_pages(),
            "retained": cache.retained_pages(),
            "hit_rate": cache.hit_rate(), "stats": dict(cache.stats),
            "no_refcounts": _no_refcounts(cache),
            "codec_ids": {str(e.eid): list(e.codec_ids)
                          for e in cache.entries.values()}}


# ---------------------------------------------------------------------------
# engine workloads (tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------

def w_same_prompt_twice_warm_equals_cold(kit, codec=None):
    prompt = [1 + (j * 3) % 50 for j in range(34)]      # 33 stored: 4 pages
    cold_plain = _run(kit.engine(codec=codec), 0, prompt, 8)
    eng = kit.engine(cache=True, codec=codec)
    cache = eng.prefix_cache
    cold = _run(eng, 0, prompt, 8)
    eng.release(0)
    released = _cache_view(cache)
    starts = eng.begin_cohort({1: prompt})
    kit.rec.state(eng)
    while eng._cohort is not None:
        eng.mixed_step(decode_sids=[], pf_tokens=eng.prefill_chunk)
    warm = [eng.decode_batch([1])[1] for _ in range(8)]
    kit.rec.state(eng)
    eng.release(1)
    return {"cold_plain": cold_plain, "cold": cold, "warm": warm,
            "starts": starts, "released": released,
            "end": _cache_view(cache), "pool_ok": _pool_consistent(eng),
            "engine": host_state(eng)}


def w_partial_hit_at_non_chunk_aligned_boundary(kit, codec=None):
    base = [1 + (j * 3) % 50 for j in range(34)]
    fork = base[:8] + [41, 17, 3, 9, 28, 7, 2]          # shares page 0 only
    eng = kit.engine(cache=True, codec=codec)
    _run(eng, 0, base, 2)
    eng.release(0)
    starts = eng.begin_cohort({1: fork})
    while eng._cohort is not None:
        eng.mixed_step(decode_sids=[], pf_tokens=eng.prefill_chunk)
        kit.rec.state(eng)
    warm = [eng.decode_batch([1])[1] for _ in range(8)]
    cold = _run(kit.engine(codec=codec), 0, fork, 8)
    return {"starts": starts, "warm": warm, "cold": cold,
            "cache": _cache_view(eng.prefix_cache), "engine": host_state(eng)}


def w_full_hit_skips_prefill_entirely(kit):
    prompt = [2 + (j * 5) % 40 for j in range(33)]      # 32 stored: 4 pages
    eng = kit.engine(cache=True)
    cold = _run(eng, 0, prompt, 6)
    eng.release(0)
    starts = eng.begin_cohort({1: prompt})
    no_cohort = eng._cohort is None and not eng.seqs[1].prefilling
    kit.rec.state(eng)
    warm = [eng.decode_batch([1])[1] for _ in range(6)]
    return {"starts": starts, "no_cohort": no_cohort, "warm": warm,
            "cold": cold, "cache": _cache_view(eng.prefix_cache),
            "engine": host_state(eng)}


def w_warm_path_scheduler_equivalence(kit):
    sys_prompt = [7 + (j * 11) % 45 for j in range(25)]
    bs = kit.sched(kit.engine(cache=True), token_budget=24)
    drive(kit, bs, {
        0: (0, sys_prompt + [9, 1, 4], {"max_new_tokens": 6}),
        1: (8, sys_prompt + [3, 3, 8, 2, 6], {"max_new_tokens": 5}),
        2: (16, sys_prompt + [1], {"max_new_tokens": 5}),
        3: (24, list(sys_prompt), {"max_new_tokens": 4}),
    })
    return dict(summary(bs), cache=_cache_view(bs.engine.prefix_cache),
                pool_ok=_pool_consistent(bs.engine))


def w_in_cohort_same_prefix_dedup(kit):
    prompt = [1 + (j * 3) % 50 for j in range(20)]      # 19 stored: 2 pages
    eng = kit.engine(cache=True)
    eng.add_requests({0: list(prompt), 1: list(prompt)})
    kit.rec.state(eng)
    shared = all(eng.seqs[0].pages[li][:2] == eng.seqs[1].pages[li][:2]
                 for li in range(kit.cfg.n_layers))
    out = [eng.decode_batch() for _ in range(6)]
    cold = _run(kit.engine(), 0, list(prompt), 6)
    eng.release(0)
    eng.release(1)
    return {"shared": shared, "out": [[o[0], o[1]] for o in out],
            "cold": cold, "cache": _cache_view(eng.prefix_cache),
            "pool_ok": _pool_consistent(eng), "engine": host_state(eng)}


def w_refcount_safety_under_camp_preemption_of_sharer(kit):
    base = [2 + (j * 7) % 40 for j in range(33)]        # 4 shared pages
    longer = base + [5, 9, 2, 7, 11, 3, 1, 8]           # +1 private page
    eng = kit.engine(cache=True, pool=13)
    cache = eng.prefix_cache
    cold = _run(kit.engine(), 0, list(base), 16)
    eng.add_requests({0: list(base)})
    eng.add_requests({1: list(longer)})                 # warm: shares chain
    chain, chain0 = list(eng.seqs[1].chain), list(eng.seqs[0].chain)
    refs_before = [cache.entries[e].refcount for e in chain[:4]]
    eng.seqs[1].done = True                             # deterministic victim
    toks0, preempted_at = [], None
    for step in range(16):
        toks0.append(eng.decode_batch([0])[0])
        kit.rec.state(eng)
        if eng.seqs[1].preempted and preempted_at is None:
            preempted_at = step
    refs_after = [cache.entries[e].refcount for e in chain[:4]]
    survivor_ok = not eng.seqs[0].preempted
    victim_empty = not eng.seqs[1].pages[0] and not eng.seqs[1].chain
    eng.release(1)
    eng.release(0)
    return {"chain_shared": chain[:4] == chain0,
            "refs_before": refs_before, "refs_after": refs_after,
            "preempted_at": preempted_at, "survivor_ok": survivor_ok,
            "victim_empty": victim_empty, "toks0": toks0, "cold": cold,
            "cache": _cache_view(cache), "pool_ok": _pool_consistent(eng),
            "engine": host_state(eng)}


def w_retained_entries_evict_before_live_preemption(kit):
    eng = kit.engine(cache=True, pool=16)
    a = [1 + (j * 3) % 50 for j in range(33)]           # 4 pages x 2 layers
    _run(eng, 0, a, 1)
    eng.release(0)                                      # 8 retained pages
    retained = eng.prefix_cache.retained_pages()
    b = [9 + (j * 5) % 40 for j in range(41)]           # 5 pages x 2 layers
    _run(eng, 1, b, 1)                                  # needs 10, 7 free
    return {"retained": retained, "live_ok": not eng.seqs[1].preempted,
            "cache": _cache_view(eng.prefix_cache),
            "pool_ok": _pool_consistent(eng), "engine": host_state(eng)}


def w_camp_victim_counts_only_reclaimable_bytes(kit):
    """Not in tests/test_prefix_cache.py: two live sharers of a 4-page
    chain and a private 2-page sequence under pool pressure.  Preempting
    a sharer frees none of the shared pages (the other still pins them),
    so CAMP must value it by its private pages alone and pick the
    private sequence."""
    base = [2 + (j * 7) % 40 for j in range(33)]
    eng = kit.engine(cache=True, pool=15)
    eng.add_requests({0: list(base)})
    eng.add_requests({1: base + [5, 9]})                 # warm sharer
    eng.add_requests({2: [3 + (j * 5) % 40 for j in range(17)]})
    values = {str(s): eng._seq_value(eng.seqs[s]) for s in eng.seqs}
    for _ in range(10):
        eng.decode_batch()
        kit.rec.state(eng)
    return {"values": values,
            "preempted": [s for s in eng.seqs if eng.seqs[s].preempted],
            "cache": _cache_view(eng.prefix_cache), "engine": host_state(eng)}


_REQUEUE_ARRIVALS = {
    0: (0, [2 + (j * 7) % 40 for j in range(41)], {"max_new_tokens": 30}),
    1: (4, [1 + (j * 11) % 60 for j in range(73)], {"max_new_tokens": 1}),
}


def w_requeue_after_preemption(kit, cache=True):
    bs = kit.sched(kit.engine(pool=21, cache=cache), token_budget=20,
                   requeue_preempted=True)
    drive(kit, bs, _REQUEUE_ARRIVALS, max_iters=400)
    fin = bs.finished()
    out = dict(summary(bs), prompt_tail=fin[0].req.prompt[41:],
               out_head=fin[0].out_tokens[:fin[0].absorbed])
    if cache:
        out.update(cache=_cache_view(bs.engine.prefix_cache),
                   pool_ok=_pool_consistent(bs.engine))
    return out


def w_requeue_limit_falls_back_to_preempted_finish(kit):
    prompt = [1 + (j * 11) % 60 for j in range(73)]     # 9 pages x 2 > pool
    bs = kit.sched(kit.engine(pool=10, max_batch=2), token_budget=24,
                   requeue_preempted=True, max_requeues=2)
    bs.submit(0, prompt, max_new_tokens=4)
    for _ in range(200):
        if bs.idle:
            break
        bs.step()
        kit.rec.state(bs.engine)
    return summary(bs)


def w_warm_hit_with_non_pow2_chunk_ratio(kit):
    prompt = [1 + (j * 3) % 50 for j in range(145)]      # 18 cached pages
    eng = kit.engine(cache=True, prefill_chunk=3 * PAGE)
    _run(eng, 0, prompt, 2)
    eng.release(0)
    fork = prompt + [5, 9, 2, 7, 11]
    warm = _run(eng, 1, fork, 4)                         # deep warm start
    kit.rec.state(eng)
    cold = _run(kit.engine(prefill_chunk=3 * PAGE), 0, fork, 4)
    return {"warm": warm, "cold": cold,
            "cache": _cache_view(eng.prefix_cache), "engine": host_state(eng)}


def w_prefill_dispatch_base(kit):
    """The one-row prefill dispatch of the shape-invariance test, chunks
    [16, 16, 1] at scratch length 64: its exact scratch rows."""
    return {"kscr": _prefill_runs(kit, [16, 16, 1], 1, 64)}


def _prefill_runs(kit, chunks, nrows, tmax):
    """Prefill ``chunks`` of one 34-token prompt through the package's
    chunk dispatch; returns row 0's exact K scratch [L, 33, K, D]."""
    cfg, prompt = kit.cfg, [1 + (j * 3) % 50 for j in range(34)]
    kvh, dh, lyr = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    buf = np.zeros((nrows, tmax), np.int32)
    buf[:, :34] = prompt
    if kit.side == "jax":
        import jax.numpy as jnp
        from repro import codecs
        from repro.serving import engine as E
        codec = codecs.get("bdi")
        kscr = jnp.zeros((lyr, nrows, tmax, kvh, dh), jnp.float32)
        vscr, kcan, vcan = (jnp.zeros_like(kscr) for _ in range(3))
    else:
        from repro_torch import codecs
        from repro_torch.models.params import layer
        from repro_torch.serving import engine as E
        codec = codecs.get("bdi")
        kscr = torch.zeros((lyr, nrows, tmax, kvh, dh))
        vscr, kcan, vcan = (torch.zeros_like(kscr) for _ in range(3))
        layers = [layer(kit.params["blocks"], li) for li in range(lyr)]
    off = 0
    for n in chunks:
        o = min(off, tmax - 16)
        pt = np.zeros((nrows, 16), np.int32)
        pt[:, :16] = buf[:, o:o + 16]
        pt[:, n:] = 0
        if kit.side == "jax":
            kscr, vscr, kcan, vcan = E._prefill_chunk(
                kit.params, jnp.asarray(pt), kscr, vscr, kcan, vcan,
                jnp.full((nrows,), o, jnp.int32), cfg=cfg, page=PAGE,
                codec=codec)
        else:
            E._prefill_core(layers, kit.params, torch.from_numpy(pt), kscr,
                            vscr, kcan, vcan,
                            torch.full((nrows,), o, dtype=torch.int64),
                            cfg=cfg, page=PAGE, codec=codec)
        off += n
    return np.asarray(kscr[:, 0, :33]).tolist()


WORKLOADS = {f.__name__[2:]: f for f in (
    w_same_prompt_twice_warm_equals_cold,
    w_partial_hit_at_non_chunk_aligned_boundary,
    w_full_hit_skips_prefill_entirely, w_warm_path_scheduler_equivalence,
    w_in_cohort_same_prefix_dedup,
    w_refcount_safety_under_camp_preemption_of_sharer,
    w_retained_entries_evict_before_live_preemption,
    w_requeue_after_preemption,
    w_requeue_limit_falls_back_to_preempted_finish,
    w_warm_hit_with_non_pow2_chunk_ratio, w_prefill_dispatch_base,
    w_camp_victim_counts_only_reclaimable_bytes)}

CASES = {name: (name, {}) for name in WORKLOADS}
CASES["requeue_without_cache_still_completes"] = (
    "requeue_after_preemption", {"cache": False})
for _name in ("same_prompt_twice_warm_equals_cold",
              "partial_hit_at_non_chunk_aligned_boundary"):
    CASES[f"gbdi-{_name}"] = (_name, {"codec": "gbdi"})


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    return run_jax_records("test_torch_prefix_cache", tmp_path_factory)


def _check(key, jax_records):
    name, kw = CASES[key]
    return check_against_jax(WORKLOADS[name], jax_records[key], **kw)[1]


@pytest.mark.parametrize("key", [k for k in CASES
                                 if k != "prefill_dispatch_base"])
def test_prefix_cache_engine_matches_jax(key, jax_records):
    got = _check(key, jax_records)
    name = CASES[key][0]
    # the properties tests/test_prefix_cache.py pins, on the port's run
    if name == "same_prompt_twice_warm_equals_cold":
        assert got["cold"] == got["cold_plain"] == got["warm"]
        assert got["starts"] == {"1": 32}
        assert got["released"]["retained"] == got["released"]["resident"] \
            == 8
        assert got["end"]["stats"]["hits"] == 1
        assert got["end"]["stats"]["hit_tokens"] == 32
        assert got["end"]["no_refcounts"] and got["pool_ok"]
    elif name == "partial_hit_at_non_chunk_aligned_boundary":
        assert got["starts"] == {"1": 8} and got["warm"] == got["cold"]
    elif name == "full_hit_skips_prefill_entirely":
        assert got["starts"] == {"1": 32} and got["no_cohort"]
        assert got["warm"] == got["cold"]
    elif name == "warm_path_scheduler_equivalence":
        tr = got["tracks"]
        assert got["sched_stats"]["prefix_cached_tokens"] > 0
        assert tr["1"]["pf_start"] == 24 and tr["3"]["pf_start"] == 24
        assert got["cache"]["no_refcounts"] and got["pool_ok"]
    elif name == "in_cohort_same_prefix_dedup":
        assert got["cache"]["stats"]["deduped"] == 2
        assert got["cache"]["resident"] == 4 and got["shared"]
        assert all(a == b for a, b in got["out"])
        assert [a for a, _ in got["out"]] == got["cold"]
        assert got["cache"]["no_refcounts"] and got["pool_ok"]
    elif name == "refcount_safety_under_camp_preemption_of_sharer":
        assert got["chain_shared"]
        assert got["refs_before"] == [2] * 4 and got["refs_after"] == [1] * 4
        assert got["preempted_at"] is not None and got["survivor_ok"]
        assert got["victim_empty"] and got["toks0"] == got["cold"]
        assert got["cache"]["no_refcounts"] and got["pool_ok"]
    elif name == "retained_entries_evict_before_live_preemption":
        assert got["retained"] == 8 and got["live_ok"]
        est = got["engine"]["stats"]
        assert est["prefix_pages_evicted"] > 0 and est["preemptions"] == 0
        assert got["pool_ok"]
    elif name == "requeue_after_preemption":
        tr = got["tracks"]
        assert got["sched_stats"]["requeues"] >= 1
        assert all(t["reason"] in ("length", "eos") for t in tr.values())
        assert tr["0"]["requeues"] >= 1 and tr["0"]["n_out"] == 30
        assert got["prompt_tail"] == got["out_head"]
        if "cache" in got:
            assert got["sched_stats"]["prefix_cached_tokens"] > 0
            assert got["cache"]["no_refcounts"] and got["pool_ok"]
    elif name == "requeue_limit_falls_back_to_preempted_finish":
        assert got["tracks"]["0"]["reason"] == "preempted"
        assert got["tracks"]["0"]["requeues"] == 2
        assert got["sched_stats"]["requeues"] == 2
    elif name == "warm_hit_with_non_pow2_chunk_ratio":
        assert got["warm"] == got["cold"]
    elif name == "camp_victim_counts_only_reclaimable_bytes":
        assert got["preempted"] == [2]
        assert got["engine"]["stats"]["preemptions"] == 1


def test_prefill_dispatch_shape_invariance(jax_records):
    """The chunk dispatch is bit-invariant to scratch rows, scratch
    length and chunk-grid splits (what lets warm rows start mid-grid),
    and equal to the JAX dispatch on the same inputs."""
    kit = port_kit()
    base = _prefill_runs(kit, [16, 16, 1], 1, 64)
    assert base == _prefill_runs(kit, [16, 16, 1], 4, 64)
    assert base == _prefill_runs(kit, [16, 16, 1], 1, 128)
    assert base == _prefill_runs(kit, [9, 7, 16, 1], 1, 64)
    assert base == _prefill_runs(kit, [5, 11, 16, 1], 1, 64)
    assert base == jax_records["prefill_dispatch_base"]["result"]["kscr"]


# ---------------------------------------------------------------------------
# the pure-host SIP tests, on both packages' classes in this process
# ---------------------------------------------------------------------------

def _mk_cache(pc, sip):
    return pc(1, 4, 1024, policy=sip(1024, train_period=4))


def sip_size_bins(pc, sip):
    c = _mk_cache(pc, sip)
    for i, nbytes in enumerate([900, 60, 400]):
        c.insert(0, (i, i, i, i), [10 + i], nbytes)
    return {"order": [c.evict_for(1)[0] for _ in range(3)]}


def sip_priority_bins(pc, sip):
    c = _mk_cache(pc, sip)
    hot, _ = c.insert(0, (1, 2, 3, 4), [11], 512)
    c.insert(0, (5, 6, 7, 8), [12], 512)
    hits = [c.lookup([1, 2, 3, 4, 99]) for _ in range(4)]
    return {"hits": [[n, ch] for n, ch in hits],
            "prio": bool(c.policy.priority[c.policy.bin(512)]),
            "order": c.evict_for(1), "hot_kept": hot in c.entries,
            "state": c.state()}


def sip_leaf_first(pc, sip):
    c = _mk_cache(pc, sip)
    parent, _ = c.insert(0, (1, 2, 3, 4), [11], 64)
    c.insert(parent, (5, 6, 7, 8), [12], 900)
    return {"order": [c.evict_for(1), c.evict_for(1)]}


def sip_pinned_never_victims(pc, sip):
    c = _mk_cache(pc, sip)
    eid, _ = c.insert(0, (1, 2, 3, 4), [11], 900)
    c.pin([eid])
    pinned = c.evict_for(1)
    c.release([eid])
    return {"order": [pinned, c.evict_for(1)], "state": c.state()}


def sip_fifo_tiebreak(pc, sip):
    """Not in tests/test_prefix_cache.py: equal value (same size, no
    hits) evicts in insertion order."""
    c = _mk_cache(pc, sip)
    for i in range(3):
        c.insert(0, (i, i, i, i), [20 + i], 300)
    return {"order": [c.evict_for(1)[0] for _ in range(3)]}


SIP_WANT = {sip_size_bins: {"order": [10, 12, 11]},
            sip_priority_bins: {"order": [12], "prio": True,
                                "hot_kept": True},
            sip_leaf_first: {"order": [[12], [11]]},
            sip_pinned_never_victims: {"order": [[], [11]]},
            sip_fifo_tiebreak: {"order": [20, 21, 22]}}


@pytest.mark.parametrize("scenario", list(SIP_WANT),
                         ids=lambda f: f.__name__)
def test_sip_eviction_order_matches_jax(scenario):
    from repro.serving import prefix_cache as J
    from repro_torch.serving import prefix_cache as P
    got = scenario(P.PrefixCache, P.SIPRetention)
    assert got == scenario(J.PrefixCache, J.SIPRetention)
    for k, v in SIP_WANT[scenario].items():
        assert got[k] == v, k


# ---------------------------------------------------------------------------
# port only: warm equals cold on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["bdi", "gbdi"])
def test_warm_equals_cold_in_the_port(codec):
    """Sixteen requests share a 24-token system prompt through the
    scheduler; with the prefix cache the later ones start prefill at the
    hit boundary (with the warm pages decompressed into the scratch), and
    every token equals the cache-less run's."""
    kit = port_kit()
    rng = np.random.default_rng(7)
    sysp = [int(t) for t in rng.integers(1, 256, 24)]
    arrivals = {r: (r, sysp + [int(t) for t in
                               rng.integers(1, 256, 3 + r % 5)],
                    {"max_new_tokens": 6}) for r in range(8)}
    runs = []
    for cache in (True, False):
        bs = kit.sched(kit.engine(cache=cache, codec=codec), token_budget=32)
        drive(kit, bs, arrivals)
        runs.append(bs.finished())
    warm, cold = runs
    assert {r: t.out_tokens for r, t in warm.items()} \
        == {r: t.out_tokens for r, t in cold.items()}
    assert sum(t.pf_start for t in warm.values()) >= 24 * 6
    assert all(t.pf_start == 0 for t in cold.values())
