"""Engine snapshot/restore through the compressed checkpoint store (port
of ``repro/serving/snapshot.py``).

Saves the whole serving state of a :class:`PagedKVEngine` — the
compressed page pools, decode tails, the in-flight prefill cohort's
scratch, page tables, free list and byte accounting, per-page checksums
and codec tags, the prefix-cache trie with its SIP state, the attached
host/disk tier, the telemetry registry, the observatory's host state
(reuse tracker, shadow caches, audit ring) — and optionally the
:class:`ContinuousScheduler`'s queue and request records, so a killed
engine restores mid-stream and finishes its in-flight requests with the
tokens the uninterrupted run gives.

The storage layer is ``checkpoint/store.py`` (atomic publish, SHA-256 per
file, BDI-compressed streams).  The arrays go through ``store.save`` as
one flat ``{name: array}`` dict — pool leaves named ``pool_000..`` in
``jax.tree.leaves`` order — and the host bookkeeping rides the
manifest's ``extra`` JSON, kind ``"serving-engine-snapshot"``, under the
JAX package's names, so a snapshot written by either package restores in
the other.  Device tensors are copied to the host once each when saved;
:func:`restore_snapshot` builds the engine on the ``device`` it is given
(the card unless the caller asks for the CPU) and copies the arrays
there.  A fault injector is not saved: a restored engine runs clean
unless the caller hands it a new one.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.kernels._device import resolve_device
from repro_torch.serving._tree import tree_leaves
from repro_torch.serving.engine import PagedKVEngine, Sequence, _Cohort
from repro_torch.serving.observatory import Observatory
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import ContinuousScheduler, Request, Track
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.tier import TieredPageStore

KIND = "serving-engine-snapshot"


def _seq_meta(s: Sequence) -> dict:
    return {"sid": s.sid, "slot": s.slot, "tokens": list(s.tokens),
            "pages": [list(lp) for lp in s.pages], "tail_len": s.tail_len,
            "done": s.done, "preempted": s.preempted,
            "corrupted": s.corrupted, "prefilling": s.prefilling,
            "chain": list(s.chain)}


def _track_meta(rid: int, tr: Track) -> dict:
    r = tr.req
    return {"rid": rid,
            "req": {"prompt": list(r.prompt),
                    "max_new_tokens": r.max_new_tokens, "eos_id": r.eos_id,
                    "ttft_deadline": r.ttft_deadline,
                    "deadline": r.deadline},
            "state": tr.state, "submitted_iter": tr.submitted_iter,
            "submitted_t": tr.submitted_t,
            "admitted_iter": tr.admitted_iter,
            "prefill_done_iter": tr.prefill_done_iter,
            "first_token_iter": tr.first_token_iter,
            "first_token_t": tr.first_token_t,
            "finished_iter": tr.finished_iter, "finished_t": tr.finished_t,
            "last_token_t": tr.last_token_t,
            "finish_reason": (None if tr.finish_reason is None
                              else str(tr.finish_reason)),
            "out_tokens": list(tr.out_tokens), "pf_pos": tr.pf_pos,
            "pf_start": tr.pf_start, "requeues": tr.requeues,
            "absorbed": tr.absorbed, "orig_prompt": list(tr.orig_prompt),
            "corrupt_retries": tr.corrupt_retries,
            "corrupt_hit": tr.corrupt_hit}


def save_snapshot(ckpt_dir: str, engine: PagedKVEngine,
                  scheduler: ContinuousScheduler | None = None, *,
                  step: int = 0, compress: bool = True) -> dict:
    """Snapshot engine (+ optional scheduler) state; returns the manifest.

    Call between scheduler iterations or engine steps, where the host
    bookkeeping is consistent.
    """
    arrays: dict = {}
    for i, leaf in enumerate(tree_leaves(engine.pools)):
        if leaf.dtype == torch.int16:
            # fpc's top halves: int16 here, uint16 in the JAX package
            # (the same bits); saved under JAX's dtype
            leaf = leaf.cpu().numpy().view(np.uint16)
        arrays[f"pool_{i:03d}"] = leaf
    arrays["tail_k"] = engine.tail_k
    arrays["tail_v"] = engine.tail_v
    arrays["page_bytes"] = engine.page_bytes
    arrays["page_checksum"] = engine.page_checksum
    arrays["page_codec_id"] = engine.page_codec_id

    co = engine._cohort
    co_meta = None
    if co is not None:
        arrays["co_toks"] = co.toks
        arrays["co_kscr"] = co.kscr
        arrays["co_vscr"] = co.vscr
        arrays["co_kcan"] = co.kcan
        arrays["co_vcan"] = co.vcan
        co_meta = {"sids": [s.sid for s in co.seqs],
                   "row": {str(k): v for k, v in co.row.items()},
                   "starts": list(co.starts), "maxrel": co.maxrel,
                   "roff": co.roff, "pub": list(co.pub),
                   "done_sids": sorted(co.done_sids)}

    tier = engine.tier
    tier_meta = None
    if tier is not None:
        # the tier rides along: packed slot bytes as one array, the trie
        # as JSON (restore re-places every row in the host arena)
        arrays.update(tier.tier_arrays())
        tier_meta = tier.meta_state()

    cache = engine.prefix_cache
    meta = {
        "kind": KIND,
        "engine": {
            "page": engine.page, "n_pool_pages": engine.n_pool_pages,
            "max_batch": engine.max_batch,
            "prefill_chunk": engine.prefill_chunk,
            "codec": engine.codec.name,
            # the JAX engine's name for "decode reads the pools through
            # the fused attention kernel" (bdi on the card)
            "use_fused": (engine.codec.has_fused_kernels
                          and engine.device.type == "cuda"),
            "integrity": engine.integrity,
            "shed_cache_inserts": engine.shed_cache_inserts,
            "cache_decode_pages": engine.cache_decode_pages,
            "free": list(engine.free),
            "free_slots": list(engine._free_slots),
            "pmax": engine._pmax, "stats": dict(engine.stats),
            "telemetry": engine.telemetry.state(),
            # observatory host state (reuse tracker, shadow caches, audit
            # ring); its registry metrics travel with the telemetry
            "observatory": (None if engine.obs is None
                            else engine.obs.state()),
            "request_bytes": {str(k): list(v)
                              for k, v in engine.request_bytes.items()},
            "seqs": [_seq_meta(s) for s in engine.seqs.values()],
        },
        "cohort": co_meta,
        "tier": tier_meta,
        "cache": None if cache is None else cache.state(),
        "cache_line": None if cache is None else cache.policy.line,
        "scheduler": None,
    }
    if scheduler is not None:
        if scheduler.engine is not engine:
            raise ValueError("the scheduler drives another engine")
        meta["scheduler"] = {
            "token_budget": scheduler.token_budget,
            "requeue_preempted": scheduler.requeue_preempted,
            "max_requeues": scheduler.max_requeues,
            "max_queue": scheduler.max_queue,
            "max_retries": scheduler.max_retries,
            "retry_backoff": scheduler.retry_backoff,
            "stall_limit": scheduler.stall_limit,
            "verify_finish": scheduler.verify_finish,
            "iteration": scheduler.iteration,
            "cohort_pos": scheduler._cohort_pos,
            "last_progress": scheduler._last_progress,
            "stats": dict(scheduler.stats),
            "telemetry": (None if scheduler.telemetry is engine.telemetry
                          else scheduler.telemetry.state()),
            "waiting": [r.rid for r in scheduler.waiting],
            "delayed": [list(e) for e in scheduler._delayed],
            "prefill": list(scheduler._prefill),
            "running": list(scheduler._running),
            "tracks": [_track_meta(rid, tr)
                       for rid, tr in scheduler.tracks.items()],
        }
    return store.save(ckpt_dir, step, arrays, extra=meta, compress=compress)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(a.copy())


def _copy_into(leaf: torch.Tensor, a: np.ndarray) -> None:
    """Copy saved bits into a pool leaf (uint16 reinterpreted as the
    port's int16)."""
    want = torch.empty(0, dtype=leaf.dtype).numpy().dtype
    leaf.copy_(torch.from_numpy(np.array(a).view(want)))


def restore_snapshot(ckpt_dir: str, cfg, params, *, step: int | None = None,
                     faults=None, ladder=None,
                     device: str | torch.device | None = None
                     ) -> tuple[PagedKVEngine, ContinuousScheduler | None]:
    """Rebuild the engine (and the scheduler, if one was saved) on
    ``device`` (default the card; raises without one).

    ``cfg``/``params`` are the model: weights are not in a snapshot.
    ``faults``/``ladder`` re-arm fault injection and overload control on
    the restored instance (both off by default).
    """
    device = resolve_device(device)    # no card: raise before any work
    arrays, manifest = store.load_flat(ckpt_dir, step=step)
    meta = manifest["extra"]
    if meta.get("kind") != KIND:
        raise ValueError(f"not an engine snapshot: {ckpt_dir}")
    em = meta["engine"]

    cache = None
    if meta["cache"] is not None:
        cache = PrefixCache(cfg.n_layers, em["page"], meta["cache_line"])
        cache.load_state(meta["cache"])

    # a saved observatory restores into a fresh one on the fresh
    # telemetry: its registry series come back with the telemetry state,
    # its host trackers with the observatory state, so reuse histograms
    # and shadow counters continue rather than restart
    tel = Telemetry()
    om = em.get("observatory")
    obs = None if om is None else Observatory(tel)
    eng = PagedKVEngine(
        cfg, params, page_size=em["page"], n_pool_pages=em["n_pool_pages"],
        max_batch=em["max_batch"], prefill_chunk=em["prefill_chunk"],
        prefix_cache=cache, codec=em["codec"], faults=faults,
        integrity=em["integrity"], telemetry=tel, observatory=obs,
        device=device)

    # the fresh engine's tensors have the saved shapes: copy in place
    for i, leaf in enumerate(tree_leaves(eng.pools)):
        _copy_into(leaf, arrays[f"pool_{i:03d}"])
    eng.tail_k.copy_(_tensor(arrays["tail_k"]))
    eng.tail_v.copy_(_tensor(arrays["tail_v"]))
    eng.page_bytes = arrays["page_bytes"].copy()
    eng.page_checksum = arrays["page_checksum"].copy()
    eng.page_codec_id = arrays["page_codec_id"].copy()
    eng.free = list(em["free"])
    eng._free_slots = list(em["free_slots"])
    eng._pmax = em["pmax"]
    eng._pt_dirty = True
    if em.get("telemetry") is not None:
        eng.telemetry.load_state(em["telemetry"])
    else:
        eng.load_stats_dict(em["stats"])
    if obs is not None:
        obs.load_state(om)
    tm = meta.get("tier")
    if tm is not None and cache is not None:
        tier = TieredPageStore.for_model(
            cfg, em["page"], eng.codec,
            host_mb=tm["host_slots"] * tm["slot_bytes"] / 2**20)
        tier.load_state(tm, {"tier_data": arrays["tier_data"]})
        eng.attach_tier(tier)
        eng.cache_decode_pages = em.get("cache_decode_pages", False)
    eng.shed_cache_inserts = em["shed_cache_inserts"]
    eng.request_bytes = {int(k): list(v)
                         for k, v in em["request_bytes"].items()}
    for d in em["seqs"]:
        eng.seqs[d["sid"]] = Sequence(
            sid=d["sid"], slot=d["slot"], tokens=list(d["tokens"]),
            pages=[list(lp) for lp in d["pages"]],
            tail_len=d["tail_len"], done=d["done"],
            preempted=d["preempted"], corrupted=d["corrupted"],
            prefilling=d["prefilling"], chain=list(d["chain"]))

    cm = meta["cohort"]
    if cm is not None:
        dev = eng.device
        eng._cohort = _Cohort(
            seqs=[eng.seqs[sid] for sid in cm["sids"]],
            row={int(k): v for k, v in cm["row"].items()},
            toks=np.asarray(arrays["co_toks"]).copy(),
            kscr=_tensor(arrays["co_kscr"]).to(dev),
            vscr=_tensor(arrays["co_vscr"]).to(dev),
            kcan=_tensor(arrays["co_kcan"]).to(dev),
            vcan=_tensor(arrays["co_vcan"]).to(dev),
            starts=list(cm["starts"]), maxrel=cm["maxrel"],
            roff=cm["roff"], pub=list(cm["pub"]),
            done_sids=set(cm["done_sids"]))

    sm = meta["scheduler"]
    if sm is None:
        return eng, None
    sched = ContinuousScheduler(
        eng, token_budget=sm["token_budget"],
        requeue_preempted=sm["requeue_preempted"],
        max_requeues=sm["max_requeues"], max_queue=sm["max_queue"],
        ladder=ladder, max_retries=sm["max_retries"],
        retry_backoff=sm["retry_backoff"], stall_limit=sm["stall_limit"],
        verify_finish=sm["verify_finish"], telemetry=eng.telemetry)
    for d in sm["tracks"]:
        rm = d["req"]
        req = Request(d["rid"], list(rm["prompt"]), rm["max_new_tokens"],
                      rm["eos_id"], rm["ttft_deadline"], rm["deadline"])
        sched.tracks[d["rid"]] = Track(
            req=req, state=d["state"],
            submitted_iter=d["submitted_iter"],
            submitted_t=d["submitted_t"],
            admitted_iter=d["admitted_iter"],
            prefill_done_iter=d["prefill_done_iter"],
            first_token_iter=d["first_token_iter"],
            first_token_t=d["first_token_t"],
            finished_iter=d["finished_iter"], finished_t=d["finished_t"],
            last_token_t=d.get("last_token_t"),
            finish_reason=d["finish_reason"],
            out_tokens=list(d["out_tokens"]), pf_pos=d["pf_pos"],
            pf_start=d["pf_start"], requeues=d["requeues"],
            absorbed=d["absorbed"], orig_prompt=list(d["orig_prompt"]),
            corrupt_retries=d["corrupt_retries"],
            corrupt_hit=d["corrupt_hit"])
    sched.waiting = deque(sched.tracks[rid].req for rid in sm["waiting"])
    sched._delayed = [(a, b) for a, b in sm["delayed"]]
    sched._prefill = list(sm["prefill"])
    sched._running = list(sm["running"])
    sched.iteration = sm["iteration"]
    sched._cohort_pos = sm["cohort_pos"]
    sched._last_progress = sm["last_progress"]
    if sm.get("telemetry") is not None:
        # saved from a registry of its own: merge into the shared one
        sched.telemetry.load_state(sm["telemetry"])
    elif "telemetry" not in sm:
        sched.load_stats_dict(sm["stats"])
    return eng, sched
