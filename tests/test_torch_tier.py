"""The port's host/disk tier (``serving/tier.py``) and the engine's tier
hooks vs the JAX package's.

The 10 tests of ``tests/test_tier.py`` (the round trip under each of the
six codecs), as workloads through the harness of
``tests/test_torch_scheduler.py`` (JAX side in one subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``, the same bridged
weights).  Recorded at every step of each workload and compared exactly:
the engine's host state, the tier's stats and records (digests, slots,
levels, byte counts, codec tags, publish-time checksums, hits), cached
token counts, and a digest of every promoted page's compressed bytes;
greedy tokens go through ``GreedyParity``.  Inside the port, promoted
pages must equal the demoted ones bit for bit.

Tiers cross the packages both ways: before the JAX subprocess starts the
port persists its tiers (and a snapshot carrying one); the JAX side
restores them, and the port restores the JAX package's: identical slot
bytes, records and checksums, and the same warm hits and tokens.
Host-only units (the checksum replicas, the ``GlobalCache`` eviction
hook, the wrong-kind refusal) run both packages in this process.
"""

import hashlib
import os
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_scheduler import (check_against_jax, host_state, port_kit,
                                  run_jax_records)

PAGE = 8
CODECS = ("bdi", "zero", "raw", "gbdi", "fpc", "adaptive")
ROOT_ENV = "REPRO_TORCH_TEST_TIERS"
OTHER = {"jax": "port", "port": "jax"}


def _leaves(kit, tree) -> list:
    if kit.side == "jax":
        import jax
        return [np.asarray(x) for x in jax.tree.leaves(tree)]
    from repro_torch.serving._tree import tree_leaves
    return [x.cpu().numpy() for x in tree_leaves(tree)]


def _tiered_engine(kit, *, codec=None, host_mb=4, disk_dir=None,
                   disk_mb=None, cache_decode_pages=False, pool=96):
    eng = kit.engine(pool=pool, cache=True, codec=codec,
                     cache_decode_pages=cache_decode_pages)
    tier = kit.Tier.for_model(kit.cfg, PAGE, eng.codec, host_mb=host_mb,
                              disk_dir=disk_dir, disk_mb=disk_mb)
    eng.attach_tier(tier)
    return eng, eng.prefix_cache, tier


def _prompt(n, stride=7):
    return [1 + (j * stride) % 50 for j in range(n)]


def _entry_page_state(kit, eng, eid):
    """One cache entry's pool bytes ([L, ...] per leaf) and metadata."""
    e = eng.prefix_cache.entries[eid]
    leaves = [np.stack([lf[li, e.pages[li]]
                        for li in range(kit.cfg.n_layers)])
              for lf in _leaves(kit, eng.pools)]
    meta = [(int(eng.page_bytes[p]), int(eng.page_codec_id[p]),
             int(eng.page_checksum[p])) for p in e.pages]
    return leaves, meta


def _digest(leaves) -> str:
    h = hashlib.sha256()
    for lf in leaves:
        h.update(np.ascontiguousarray(lf).tobytes())
    return h.hexdigest()[:16]


def tier_state(tier) -> dict:
    meta = tier.meta_state()
    return {"stats": dict(tier.stats), "records": meta["records"],
            "host_used": tier.host.used,
            "disk_used": None if tier.disk is None else tier.disk.used,
            "slots": {r.digest: [r.slot, r.level]
                      for r in tier._records.values()},
            "logical_bytes": tier.logical_bytes()}


def record(kit, eng, tier) -> None:
    kit.rec.states.append(dict(host_state(eng), tier=tier_state(tier)))


def _decode(kit, eng, tier, sid, n):
    out = []
    for _ in range(n):
        out.append(eng.decode_one(sid))
        record(kit, eng, tier)
    return out


def _cold_then_recycle(kit, eng, tier, prompt, steps=6):
    eng.add_requests({0: prompt})
    record(kit, eng, tier)
    cold = _decode(kit, eng, tier, 0, steps)
    chain = list(eng.seqs[0].chain)
    before = [_entry_page_state(kit, eng, eid) for eid in chain]
    eng.release(0)
    freed = eng.recycle_device_pool()
    record(kit, eng, tier)
    return cold, before, freed


def _root(kit, name: str) -> tuple[Path, Path]:
    root = Path(os.environ[ROOT_ENV])
    return root / kit.side / name, root / OTHER[kit.side] / name


# ---------------------------------------------------------------------------
# workloads (tests/test_tier.py)
# ---------------------------------------------------------------------------

def w_demote_promote_roundtrip(kit, codec):
    eng, cache, tier = _tiered_engine(kit, codec=codec)
    prompt = _prompt(33)                      # 32 stored tokens: 4 pages
    cold, before, freed = _cold_then_recycle(kit, eng, tier, prompt)
    after_recycle = {"freed": freed, "entries": len(cache.entries),
                     "stats": dict(tier.stats)}
    eng.debug_validate()
    cached = eng.add_requests({1: prompt})[1]
    record(kit, eng, tier)
    warm = _decode(kit, eng, tier, 1, 6)
    after = [_entry_page_state(kit, eng, eid) for eid in eng.seqs[1].chain]
    same = [bm == am and all(np.array_equal(x, y) for x, y in zip(bl, al))
            for (bl, bm), (al, am) in zip(before, after)]
    eng.release(1)
    eng.debug_validate()
    eng.sample_gauges()
    snap = eng.telemetry.registry.snapshot()
    return {"cold": cold, "warm": warm, "cached": cached,
            "after_recycle": after_recycle, "bit_identical": same,
            "n_before": len(before), "n_after": len(after),
            "digests": [[_digest(lv), m] for lv, m in after],
            "registry": [snap["tier_demotions_total"]["series"][0]["value"],
                         snap["tier_promotions_total"]["series"][0]["value"],
                         snap["tier_promotion_seconds"]["series"][0]
                         ["count"]]}


def w_corrupt_host_slot_quarantined_not_served(kit):
    eng, cache, tier = _tiered_engine(kit)
    prompt = _prompt(33, stride=11)
    cold, _, _ = _cold_then_recycle(kit, eng, tier, prompt)
    recs = tier.lookup(prompt)
    victim = recs[-1]
    tier.host.buf[victim.slot, 5] ^= 0xFF      # host-RAM bit rot
    cached = eng.add_requests({1: prompt})[1]
    record(kit, eng, tier)
    out = {"n_recs": len(recs), "cached": cached, "corrupt": victim.corrupt,
           "tier_corrupt": tier.stats["corrupt"],
           "integrity_failures": int(eng.stats["integrity_failures"]),
           "cold": cold, "warm": _decode(kit, eng, tier, 1, 6)}
    eng.release(1)
    out["lookup_quarantined"] = len(tier.lookup(prompt))
    eng.recycle_device_pool()                  # re-demotes block 3: heals
    record(kit, eng, tier)
    out["healed"] = not tier._records[victim.digest].corrupt
    out["lookup_healed"] = len(tier.lookup(prompt))
    eng.debug_validate()
    return out


def _warm_from(kit, tier, prompt) -> dict:
    """A fresh engine serving ``prompt`` from a restored tier."""
    eng = kit.engine(pool=96, cache=True)
    eng.attach_tier(tier)
    cached = eng.add_requests({0: prompt})[0]
    record(kit, eng, tier)
    warm = _decode(kit, eng, tier, 0, 6)
    eng.debug_validate()
    return {"cached": cached, "warm": warm,
            "promotions": tier.stats["promotions"]}


def _restored(kit, path) -> tuple:
    tier = kit.Tier.restore(str(path), kit.cfg, kit.codec_of("bdi"),
                            host_mb=4)
    data = tier.tier_arrays()["tier_data"]
    return tier, {"records": tier.record_count(),
                  "data": hashlib.sha256(data.tobytes()).hexdigest(),
                  "meta": tier.meta_state()}


def w_persist_restore_across_restart_warm(kit):
    mine, other = _root(kit, "persist")
    eng, cache, tier = _tiered_engine(kit)
    prompt = _prompt(33, stride=5)
    cold, _, _ = _cold_then_recycle(kit, eng, tier, prompt)
    n_recs = tier.record_count()
    tier.persist(str(mine), step=3)
    persisted = {"records": n_recs,
                 "data": hashlib.sha256(tier.tier_arrays()["tier_data"]
                                        .tobytes()).hexdigest(),
                 "meta": tier.meta_state()}
    tier2, got = _restored(kit, mine)
    out = {"cold": cold, "persisted": persisted, "restored": got,
           "warm": _warm_from(kit, tier2, prompt), "cross": None}
    if other.exists():
        tier3, got3 = _restored(kit, other)
        out["cross"] = dict(got3, warm=_warm_from(kit, tier3, prompt))
    return out


def w_engine_snapshot_carries_tier(kit):
    mine, other = _root(kit, "snapshot")
    eng, cache, tier = _tiered_engine(kit)
    prompt = _prompt(33, stride=13)
    cold, _, _ = _cold_then_recycle(kit, eng, tier, prompt)
    kit.save_snapshot(mine, eng, step=1)
    out = {"cold": cold, "records": tier.record_count(),
           "promotions": tier.stats["promotions"]}
    for name, path in (("restored", mine), ("cross", other)):
        if not path.exists():
            out[name] = None
            continue
        eng2, _ = kit.restore(path, step=1)
        n = eng2.tier.record_count()
        cached = eng2.add_requests({5: prompt})[5]
        record(kit, eng2, eng2.tier)
        out[name] = {"records": n, "cached": cached,
                     "promotions": eng2.tier.stats["promotions"],
                     "warm": _decode(kit, eng2, eng2.tier, 5, 6)}
        eng2.debug_validate()
    return out


def w_arithmetic_offsets_no_offset_table(kit):
    eng, cache, tier = _tiered_engine(kit)
    eng.add_requests({0: _prompt(33, stride=3)})
    eng.decode_one(0)
    eng.release(0)
    eng.recycle_device_pool()
    record(kit, eng, tier)
    offsets_ok = tier.slot_bytes == kit.cfg.n_layers * tier.layer_stride \
        and all(tier.host.slot_offset(s) == s * tier.slot_bytes
                and all(tier.page_offset(s, li) == s * tier.slot_bytes
                        + li * tier.layer_stride
                        for li in range(kit.cfg.n_layers))
                for s in range(tier.host.n_slots))
    flat = tier.host.buf.reshape(-1)
    match = []
    for rec in tier._records.values():
        leaves, ok = tier.read_record(rec)
        for li in range(kit.cfg.n_layers):
            base = tier.page_offset(rec.slot, li)
            for sp, lf in zip(tier._specs, leaves):
                if sp.nbytes:
                    raw = flat[base + sp.offset:base + sp.offset + sp.nbytes]
                    match.append(ok and raw.tobytes()
                                 == np.ascontiguousarray(lf[li]).tobytes())
    return {"offsets_ok": offsets_ok, "match": match,
            "layout": [tier.layer_stride, tier.slot_bytes,
                       tier.host.n_slots,
                       [[sp.offset, sp.nbytes, list(sp.shape)]
                        for sp in tier._specs]],
            "slot_types": sorted({type(r.slot).__name__
                                  for r in tier._records.values()})}


def w_disk_spill_roundtrip(kit):
    disk, _ = _root(kit, "disk")
    eng, cache, tier = _tiered_engine(kit, host_mb=0, disk_dir=str(disk),
                                      disk_mb=1)
    prompt = _prompt(33, stride=9)
    cold, _, _ = _cold_then_recycle(kit, eng, tier, prompt, steps=4)
    out = {"host_slots": tier.host.n_slots, "stats": dict(tier.stats),
           "file": (disk / "tier_arena.bin").exists(),
           "levels": sorted({r.level for r in tier._records.values()}),
           "cold": cold}
    out["cached"] = eng.add_requests({1: prompt})[1]
    record(kit, eng, tier)
    out["warm"] = _decode(kit, eng, tier, 1, 4)
    eng.debug_validate()
    return out


def w_decode_pages_cached_across_turns(kit):
    eng, cache, tier = _tiered_engine(kit, cache_decode_pages=True)
    prompt = _prompt(17)                       # 2 stored pages
    eng.add_requests({1: prompt})
    record(kit, eng, tier)
    reply = _decode(kit, eng, tier, 1, 16)
    seq = eng.seqs[1]                          # 33 tokens: 4 full pages
    n_blocks, n_chain = len(seq.pages[0]), len(seq.chain)
    pools = _leaves(kit, eng.pools)
    decode_bits = [[np.stack([lf[li, seq.pages[li][b]]
                              for li in range(kit.cfg.n_layers)])
                    for lf in pools] for b in range(2, n_blocks)]
    eng.release(1)
    record(kit, eng, tier)
    out = {"n_blocks": n_blocks, "n_chain": n_chain,
           "demotions": tier.stats["demotions"],
           "decode_records": sum(r.source == "decode"
                                 for r in tier._records.values())}
    eng.recycle_device_pool()
    convo2 = prompt + reply + [3, 4, 5]        # 36 tokens, 4 pages cached
    out["cached"] = eng.add_requests({2: convo2})[2]
    record(kit, eng, tier)
    after = [_entry_page_state(kit, eng, eid)[0]
             for eid in eng.seqs[2].chain[2:]]
    out["decode_bit_identical"] = [
        all(np.array_equal(x, y) for x, y in zip(want, got))
        for want, got in zip(decode_bits, after)]
    eng.decode_one(2)
    eng.release(2)
    eng.debug_validate()
    return out


WORKLOADS = {f.__name__[2:]: f for f in (
    w_demote_promote_roundtrip, w_corrupt_host_slot_quarantined_not_served,
    w_persist_restore_across_restart_warm, w_engine_snapshot_carries_tier,
    w_arithmetic_offsets_no_offset_table, w_disk_spill_roundtrip,
    w_decode_pages_cached_across_turns)}
CASES = {f"demote_promote_roundtrip[{c}]": ("demote_promote_roundtrip",
                                            {"codec": c}) for c in CODECS}
CASES.update({n: (n, {}) for n in WORKLOADS if n != "demote_promote_roundtrip"})
CROSS_CASES = ["persist_restore_across_restart_warm",
               "engine_snapshot_carries_tier"]


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiers")
    os.environ[ROOT_ENV] = str(root)
    for name in CROSS_CASES:           # the port's tiers, for JAX
        WORKLOADS[name](port_kit())
    return run_jax_records("test_torch_tier", tmp_path_factory,
                           **{ROOT_ENV: str(root)})


@pytest.mark.parametrize("key", list(CASES))
def test_tier_matches_jax(key, jax_records):
    name, kw = CASES[key]
    kit, got = check_against_jax(WORKLOADS[name], jax_records[key], **kw)
    want = jax_records[key]["result"]
    # what tests/test_tier.py asserts, on the port's run
    if name == "demote_promote_roundtrip":
        ar = got["after_recycle"]
        assert ar["freed"] >= 4 * kit.cfg.n_layers and ar["entries"] == 0
        assert ar["stats"]["demotions"] >= 4
        assert ar["stats"]["promotions"] == 0
        assert got["cached"] == 32 and got["warm"] == got["cold"]
        assert got["n_before"] == got["n_after"] == 4
        assert all(got["bit_identical"])
        assert got["registry"][0] >= 4 and got["registry"][1] == 4
        assert got["registry"][2] >= 1
    elif name == "corrupt_host_slot_quarantined_not_served":
        assert got["n_recs"] == 4 and got["cached"] == 24
        assert got["corrupt"] and got["tier_corrupt"] == 1
        assert got["integrity_failures"] == 1
        assert got["warm"] == got["cold"]
        assert got["lookup_quarantined"] == 3
        assert got["healed"] and got["lookup_healed"] == 4
    elif name == "persist_restore_across_restart_warm":
        for side in (got, want):      # own restore and the other package's
            assert side["persisted"]["records"] >= 4
            for r in (side["restored"], side["cross"]):
                assert r["records"] == side["persisted"]["records"]
                assert r["data"] == side["persisted"]["data"]
                assert r["meta"]["records"] \
                    == side["persisted"]["meta"]["records"]
            for w in (side["warm"], side["cross"]["warm"]):
                assert w["cached"] == 32 and w["promotions"] == 4
                assert w["warm"] == side["cold"]
    elif name == "engine_snapshot_carries_tier":
        for side in (got, want):
            for r in (side["restored"], side["cross"]):
                assert r["records"] == side["records"]
                assert r["cached"] == 32
                assert r["promotions"] == side["promotions"] + 4
                assert r["warm"] == side["cold"]
    elif name == "arithmetic_offsets_no_offset_table":
        assert got["offsets_ok"] and got["match"] and all(got["match"])
        assert got["slot_types"] == ["int"]
    elif name == "disk_spill_roundtrip":
        assert got["host_slots"] == 1 and got["file"]
        assert got["stats"]["spills"] >= 3 and got["stats"]["drops"] == 0
        assert "disk" in got["levels"]
        assert got["cached"] == 32 and got["warm"] == got["cold"]
    elif name == "decode_pages_cached_across_turns":
        assert got["n_blocks"] == 4 and got["n_chain"] == 2
        assert got["demotions"] >= 2 and got["decode_records"] >= 1
        assert got["cached"] == 32
        assert got["decode_bit_identical"] \
            and all(got["decode_bit_identical"])


# ---------------------------------------------------------------------------
# host-only units
# ---------------------------------------------------------------------------

def test_np_checksums_match_device_implementation():
    """The host replica equals the port's tensor ``page_checksums`` and
    both packages' functions on the same leaves."""
    import jax.numpy as jnp
    from repro.serving import faults as JF
    from repro.serving import tier as JT
    from repro_torch.serving import faults as F
    from repro_torch.serving import tier as T
    rng = np.random.default_rng(7)
    leaves = [
        rng.standard_normal((5, 3, 4)).astype(np.float32),
        rng.integers(0, 256, (5, 17), dtype=np.uint8),
        rng.integers(-2**31, 2**31 - 1, (5, 2, 3), dtype=np.int32),
        rng.integers(-128, 128, (5, 9), dtype=np.int8),
        np.zeros((5, 0, 4), np.float32),       # an empty leaf is skipped
    ]
    host = T.np_page_checksums(leaves)
    assert host.dtype == np.uint32
    pg = namedtuple("Pages", [f"l{i}" for i in range(len(leaves))])(
        *(torch.from_numpy(x) for x in leaves))     # the port's page tree
    dev = F.page_checksums(pg)
    assert np.array_equal(dev.numpy().astype(np.uint32), host)
    assert np.array_equal(JT.np_page_checksums(leaves), host)
    assert np.array_equal(
        np.asarray(JF.page_checksums([jnp.asarray(x) for x in leaves])), host)


def test_restore_refuses_wrong_component_kind(tmp_path):
    from repro_torch import codecs
    from repro_torch.checkpoint import store
    from repro_torch.serving.tier import TieredPageStore
    store.persist(str(tmp_path), 0, {"x": np.zeros(4, np.uint8)}, {"a": 1},
                  kind="engine-snapshot")
    cfg = port_kit().cfg
    with pytest.raises(ValueError, match="kind"):
        TieredPageStore.restore(str(tmp_path), cfg, codecs.get("bdi"))


def test_globalcache_evict_cb_sees_victims_order_unchanged():
    """The port's ``GlobalCache`` eviction hook sees every victim and
    leaves eviction order, occupancy and hits as without it — and as the
    JAX package's."""
    from repro.core import camp as jcamp
    from repro_torch.core import camp
    plain = camp.GlobalCache(1 << 10, "gcamp", segment=8)
    hooked = camp.GlobalCache(1 << 10, "gcamp", segment=8)
    ref = jcamp.GlobalCache(1 << 10, "gcamp", segment=8)
    victims, jvictims = [], []
    hooked.evict_cb = lambda blk: victims.append(blk.tag)
    ref.evict_cb = lambda blk: jvictims.append(blk.tag)
    for i in range(600):
        addr, size = i * 64, 8 + (i * 13) % 57
        got = hooked.access(addr, size)
        assert plain.access(addr, size) == got == ref.access(addr, size)
    assert victims and victims == jvictims
    assert all(t not in hooked.blocks for t in victims[-5:])
    assert list(plain.blocks) == list(hooked.blocks) == list(ref.blocks)
    assert plain.used_segments == hooked.used_segments
    assert (plain.hits, plain.misses) == (hooked.hits, hooked.misses)


# ---------------------------------------------------------------------------
# the serve CLI's multi-turn path (port only)
# ---------------------------------------------------------------------------

# the report keys of repro/launch/serve.py's multi-turn path
JAX_MULTI_TURN_KEYS = {"turns", "codec", "tier", "tier_logical_bytes",
                       "kv_compression_ratio", "stats", "tok_per_s",
                       "persisted"}
JAX_TURN_KEYS = {"turn", "prompt_tokens", "ttft_s", "cached_tokens",
                 "recycled_pages", "demotions", "promotions"}


def _main(monkeypatch, *argv) -> dict:
    """Run the serve CLI's ``main`` and return the report it printed."""
    import sys
    from repro_torch.launch import serve
    reports = []
    inner = serve.generate

    def generate(*a, **kw):
        reports.append(inner(*a, **kw))
        return reports[-1]

    monkeypatch.setattr(serve, "generate", generate)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "yi-6b", "--smoke",
                                      "--device", "cpu", *argv])
    serve.main()
    return reports[0]


def test_serve_cli_multi_turn_from_host_tier(monkeypatch, tmp_path, capsys):
    """``--multi-turn 3 --tier-host-mb 4`` on the CPU: each later turn
    promotes its history from the tier; a second process restores the
    persisted tier and starts warm."""
    out = _main(monkeypatch, "--multi-turn", "3", "--tier-host-mb", "4",
                "--gen", "8", "--persist-cache", str(tmp_path / "cache"))
    assert set(out) == JAX_MULTI_TURN_KEYS | {"device"}
    assert all(set(t) == JAX_TURN_KEYS for t in out["turns"])
    turns = out["turns"]
    assert [t["turn"] for t in turns] == [1, 2, 3]
    for a, b in zip(turns, turns[1:]):
        assert b["prompt_tokens"] == a["prompt_tokens"] + 8 + 8
        assert b["cached_tokens"] > a["cached_tokens"]
        assert b["promotions"] > 0
    assert out["tier"]["corrupt"] == 0 and out["tier"]["demotions"] > 0
    assert "turn 3:" in capsys.readouterr().out
    again = _main(monkeypatch, "--multi-turn", "1", "--tier-host-mb", "4",
                  "--gen", "8", "--persist-cache", str(tmp_path / "cache"))
    assert again["turns"][0]["cached_tokens"] == turns[0]["cached_tokens"]
    assert again["tier"]["promotions"] > out["tier"]["promotions"]
