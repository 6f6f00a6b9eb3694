"""Serving CLI: batched greedy generation (port of
``repro/launch/serve.py``).

With no mode flag, dense decode through the model API: one prefill of
the batch's prompts, then one ``decode_step`` a token over the model's
decode cache, greedy argmax — the path of every config in the registry:
decoder-only transformers (dense GQA, gemma3's ring caches, MLA, MoE)
over a dense KV cache, xLSTM over its recurrent state, Hymba over ring
caches and Mamba state, and the encoder-decoder over self and cross K/V
(its encoder fed random frames, ``enc_embeds``, as JAX's ``generate``).
``--paged`` admits every prompt through ``PagedKVEngine.add_requests``
(one chunked-batch prefill pass; ``--prefill-chunk`` sets the step
width) and decodes through ``decode_batch`` (one step per token for the
whole batch); ``--paged-reference`` serves the same requests through
the host-looped oracle (``serving/reference.py``: one sequence and one
layer at a time, pools on the host), the A/B baseline.  ``--scheduler``
drives the token-budget
continuous-batching loop (``serving/scheduler.py``): requests arrive
``--arrival-stagger`` iterations apart, are admitted and retired between
iterations, and prefill chunks ride on decode steps under
``--token-budget``; the report adds per-request TTFT and latency in
scheduler iterations, cached tokens, compression ratio and finish
reason.  ``--prefix-cache`` attaches the SIP prefix cache, and
``--shared-prefix N`` makes every request share its first N prompt
tokens (a system prompt); ``--requeue-preempted`` turns CAMP preemptions
into recompute-from-prompt requeues.  ``--ttft-deadline``/``--deadline``
(iterations), ``--max-queue`` and ``--overload`` (the pool-pressure
ladder) control overload; ``--trace-out``, ``--metrics``,
``--metrics-port``, ``--metrics-out`` and ``--metrics-jsonl`` export the
shared telemetry registry and tracer.  Any registered page codec
(``--codec``; default ``REPRO_CODEC`` or bdi).

Resilience and the memory tier (scheduler mode): ``--chaos SEED`` injects
a deterministic fault schedule (page corruption and garbage decode
tokens; every request still ends with a deterministic finish reason and
the report carries the injector's log); ``--snapshot-dir DIR`` saves the
engine mid-stream, restores it into a fresh engine after the run and
drives it to the end (``snapshot.restored_match`` says whether its
tokens equal the run's); ``--tier-host-mb``/``--tier-disk-dir`` attach
the host/disk tier behind the prefix cache, and ``--persist-cache DIR``
carries it across restarts.  ``--multi-turn N`` runs one growing
conversation of N turns, the device pool recycled between turns, and
reports each turn's TTFT and tier traffic.

``--observatory`` (scheduler mode) attaches the memory-hierarchy
observatory (``serving/observatory.py``): the report adds the shadow
policies' hit rates, each adaptive member's would-be bytes and the joint
size-bin x reuse-distance table; ``--audit-out PATH`` (implies it) writes
the decision audit log as JSONL.  Render saved artifacts with
``python -m repro_torch.launch.observe``.

Weights are random, made from a seed on the device; prompts are random
token ids from a second seed.  The pool is sized so the requests never
preempt; the paged modes serve dense GQA configs only.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b [--paged] \\
      [--smoke] [--batch 4 --prompt-len 16 --gen 16] [--device cuda|cpu] \\
      [--codec bdi|zero|raw|gbdi|fpc|adaptive] \\
      [--scheduler [--prefix-cache --shared-prefix N] [--token-budget 64]
       [--chaos SEED] [--snapshot-dir DIR] [--tier-host-mb MB]
       [--observatory] [--audit-out PATH]]
      | --paged-reference
      | --multi-turn N [--tier-host-mb MB] [--tier-disk-dir DIR]
        [--persist-cache DIR]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import codecs
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tp
from repro_torch.kernels._device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.models.transformer import cache_bytes
from repro_torch.serving.engine import PagedKVEngine

PAGE = 8


def dense_generate(cfg, params: dict, prompts: torch.Tensor, gen: int, *,
                   enc_embeds: torch.Tensor | None = None,
                   keep_logits: bool = False) -> dict:
    """Greedy decode of ``prompts`` [B, S] for ``gen`` tokens: prefill,
    then one ``decode_step`` a token (JAX's dense ``generate`` loop), on
    the device of ``params``.  An encoder-decoder config takes its
    encoder's frames ``enc_embeds`` [B, S_enc, D].

    Returns ``tokens`` ([B, gen] as lists) and ``tok_per_s`` as JAX's
    does, plus ``prefill_s``, ``decode_s`` (the seconds of each of the
    gen - 1 steps, each ending in the host read of its tokens),
    ``cache_bytes`` and, with ``keep_logits``, each token's logits
    ``[gen, B, V]`` (f32, on the host).

    Under a ``(d, m)`` mesh (``distributed/axes.use_mesh``) ``params``
    are this rank's blocks (``distributed/sharding.local_params``, either
    layout) and ``prompts`` the whole batch: every rank runs its rows
    (``sharding.local_batch``; rows that do not divide d stay whole),
    takes the argmax of the whole batch's gathered logits and gets the
    same tokens; ``cache_bytes`` is this rank's.  ``collectives`` counts,
    by mesh axis (``distributed/tp.COUNTS``), the collectives of the
    prefill and of one decode step, with the bytes of their inputs
    (zeros without a mesh), and ``writes``, the cache rows a step wrote
    into this rank's block of a cache sharded over T.  Where the KV heads
    do not divide the model axis the cache of ``s + gen`` rows is laid
    out as ``cache_specs`` lays it out: over T where the rows divide the
    axis (hymba's full-attention layers too; its rings over their
    window), else over the head dim where it divides, else whole on every
    rank."""
    model = get_model(cfg)
    dev = params["embed"]["w"].device
    b, s = prompts.shape
    d = tp.data_size()
    tp.check_layout(cfg)

    def rows(t: torch.Tensor) -> torch.Tensor:
        if d == 1:
            return t.to(dev)
        return SH.local_batch({"t": t}, AX.current_mesh())["t"].to(dev)
    batch = {"tokens": rows(prompts)}
    if cfg.is_encdec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: the encoder needs enc_embeds")
        batch["enc_embeds"] = rows(enc_embeds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    c0 = tp.counts()
    t0 = time.perf_counter()
    with tp.whole_rows(d > 1 and b % d != 0):
        logits, cache = model.prefill(params, batch, s + gen)
        toks = torch.argmax(logits, -1)
        out = [toks.tolist()]
        rows_kept = [logits.float().cpu()] if keep_logits else []
        t1 = time.perf_counter()
        pre, c1 = tp.counts_since(c0), tp.counts()
        step_s = []
        for t in range(s, s + gen - 1):
            ts = time.perf_counter()
            logits, cache = model.decode_step(params, cache, rows(toks), t)
            toks = torch.argmax(logits, -1)
            out.append(toks.tolist())           # the step's one host sync
            step_s.append(time.perf_counter() - ts)
            if keep_logits:
                rows_kept.append(logits.float().cpu())
    dt = time.perf_counter() - t0
    steps = max(gen - 1, 1)
    res = {"tokens": [list(r) for r in zip(*out)],
           "tok_per_s": b * gen / dt, "prefill_s": t1 - t0,
           "decode_s": step_s, "cache_bytes": cache_bytes(cache),
           "collectives": {
               "model_axis": tp.model_size(), "data_axis": d,
               "prefill": pre,
               "per_step": {a: {k: v / steps for k, v in c.items()}
                            for a, c in tp.counts_since(c1).items()}}}
    if keep_logits:
        res["logits"] = torch.stack(rows_kept)
    return res


def generate(arch: str, *, smoke: bool = True, batch: int = 4,
             prompt_len: int = 16, gen: int = 16, paged: bool = False,
             paged_reference: bool = False,
             prefill_chunk: int | None = None,
             scheduler: bool = False, token_budget: int = 64,
             arrival_stagger: int = 2, prefix_cache: bool = False,
             shared_prefix: int = 0, requeue_preempted: bool = False,
             codec: str | None = None,
             ttft_deadline: int | None = None, deadline: int | None = None,
             max_queue: int | None = None, overload: bool = False,
             trace_out: str | None = None, metrics: bool = False,
             metrics_port: int | None = None,
             metrics_out: str | None = None,
             metrics_jsonl: str | None = None,
             observatory: bool = False, audit_out: str | None = None,
             chaos: int | None = None, snapshot_dir: str | None = None,
             tier_host_mb: float | None = None,
             tier_disk_dir: str | None = None,
             persist_cache: str | None = None, multi_turn: int = 0,
             device: str | torch.device | None = None) -> dict:
    if shared_prefix > prompt_len:
        raise ValueError(f"--shared-prefix {shared_prefix} exceeds "
                         f"--prompt-len {prompt_len}")
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    prompts = torch.randint(1, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    if not (paged or paged_reference or scheduler or multi_turn):
        enc = None
        if cfg.is_encdec:                   # random frames, f32, as JAX's
            enc = torch.randn((batch, prompt_len, cfg.d_model),
                              generator=torch.Generator().manual_seed(2)
                              ) * 0.02
        out = dense_generate(cfg, params, prompts, gen, enc_embeds=enc)
        out["device"] = str(dev)
        return out
    # shared system prompt: every request reuses request 0's first
    # ``shared_prefix`` tokens
    prompts[:, :shared_prefix] = prompts[0, :shared_prefix]
    reqs = {b: prompts[b].tolist() for b in range(batch)}
    pages_per_seq = -(-(prompt_len + gen) // PAGE)
    n_pool = 1 + cfg.n_layers * batch * pages_per_seq
    tier_args = {"host_mb": tier_host_mb, "disk_dir": tier_disk_dir,
                 "persist": persist_cache}
    if multi_turn:
        return _serve_multi_turn(cfg, params, reqs[0], dev, turns=multi_turn,
                                 gen=gen, prefill_chunk=prefill_chunk,
                                 codec=codec, tier_args=tier_args)
    if scheduler:
        return _serve_scheduler(
            cfg, params, reqs, dev, n_pool=n_pool, gen=gen,
            prefill_chunk=prefill_chunk, token_budget=token_budget,
            arrival_stagger=arrival_stagger, prefix_cache=prefix_cache,
            requeue_preempted=requeue_preempted, codec=codec,
            ttft_deadline=ttft_deadline, deadline=deadline,
            max_queue=max_queue, overload=overload, trace_out=trace_out,
            metrics=metrics, metrics_port=metrics_port,
            metrics_out=metrics_out, metrics_jsonl=metrics_jsonl,
            observatory=observatory, audit_out=audit_out,
            chaos=chaos, snapshot_dir=snapshot_dir, tier_args=tier_args)
    if paged_reference:
        from repro_torch.serving.reference import ReferencePagedKVEngine
        eng = ReferencePagedKVEngine(cfg, params, page_size=PAGE,
                                     n_pool_pages=n_pool,
                                     prefill_chunk=prefill_chunk,
                                     codec=codec, device=dev)
        t0 = time.perf_counter()
        eng.add_requests(reqs)      # one prompt at a time
        for _ in range(gen):
            for b in range(batch):
                eng.decode_one(b)   # one sequence at a time
    else:
        eng = PagedKVEngine(cfg, params, page_size=PAGE, n_pool_pages=n_pool,
                            max_batch=batch, prefill_chunk=prefill_chunk,
                            codec=codec, device=dev)
        t0 = time.perf_counter()
        eng.add_requests(reqs)      # one chunked-batch prefill pass
        for _ in range(gen):
            eng.decode_batch()      # ends in a host sync of the tokens
    dt = time.perf_counter() - t0
    outs = [eng.seqs[b].tokens[prompt_len:] for b in range(batch)]
    return {"tokens": outs, "codec": eng.codec.name, "device": str(dev),
            "kv_compression_ratio": eng.compression_ratio(),
            "stats": eng.stats, "request_bytes": eng.request_bytes,
            "tok_per_s": batch * gen / dt}


def _build_tier(eng, cfg, *, host_mb, disk_dir, persist):
    """The host/disk tier behind the engine's prefix cache; restores a
    persisted warm cache when ``persist`` holds a checkpoint."""
    from repro_torch.checkpoint import store
    from repro_torch.serving.tier import TieredPageStore
    host_mb = host_mb if host_mb else 64.0
    if persist is not None and store.latest_step(persist) is not None:
        tier = TieredPageStore.restore(persist, cfg, eng.codec,
                                       host_mb=host_mb, disk_dir=disk_dir)
    else:
        tier = TieredPageStore.for_model(cfg, eng.page, eng.codec,
                                         host_mb=host_mb, disk_dir=disk_dir)
    eng.attach_tier(tier)
    return tier


def _serve_multi_turn(cfg, params, prompt: list[int], dev, *, turns: int,
                      gen: int, prefill_chunk, codec, tier_args) -> dict:
    """``--multi-turn N``: one conversation grows by the model's reply and
    8 fresh user tokens a turn, the device pool recycled between turns, so
    turn N's history promotes from the tier (or recomputes without it)."""
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.telemetry import Telemetry
    # the last turn's pages in every layer (a pool id holds one layer's
    # page), so the conversation never preempts at any depth
    last = len(prompt) + (turns - 1) * (gen + 8) + gen
    n_pool = 1 + cfg.n_layers * (-(-last // PAGE) + 1)
    eng = PagedKVEngine(cfg, params, page_size=PAGE, n_pool_pages=n_pool,
                        max_batch=1, prefill_chunk=prefill_chunk,
                        prefix_cache=PrefixCache.for_model(cfg, PAGE),
                        codec=codec, telemetry=Telemetry(),
                        cache_decode_pages=True, device=dev)
    tier = _build_tier(eng, cfg, **tier_args)
    convo = list(prompt)
    # throwaway primer turn, so turn 1's TTFT is not a first-call cost
    eng.add_requests({-1: convo[:eng.page]})
    eng.decode_one(-1)
    eng.release(-1)
    eng.recycle_device_pool()
    base = dict(tier.stats)
    report, total_toks, t_run = [], 0, time.perf_counter()
    for turn in range(1, turns + 1):
        t0 = time.perf_counter()
        cached = eng.add_requests({turn: convo})[turn]
        out_toks = [eng.decode_one(turn)]       # ends in a host sync
        ttft = time.perf_counter() - t0
        out_toks += [eng.decode_one(turn) for _ in range(gen - 1)]
        eng.release(turn)
        freed = eng.recycle_device_pool()
        d = {k: tier.stats[k] - base[k] for k in tier.stats}
        report.append({"turn": turn, "prompt_tokens": len(convo),
                       "ttft_s": round(ttft, 4), "cached_tokens": cached,
                       "recycled_pages": freed,
                       "demotions": d["demotions"],
                       "promotions": d["promotions"]})
        base = dict(tier.stats)
        total_toks += len(out_toks)
        # the next user message: the model's reply plus fresh user tokens
        extra = torch.randint(1, cfg.vocab, (8,), generator=torch.Generator()
                              .manual_seed(100 + turn)).tolist()
        convo = convo + out_toks + extra
    dt = time.perf_counter() - t_run
    eng.debug_validate()
    eng.sample_gauges()
    persist = tier_args["persist"]
    if persist is not None:
        tier.persist(persist)
    return {"turns": report, "codec": eng.codec.name, "device": str(dev),
            "tier": dict(tier.stats),
            "tier_logical_bytes": tier.logical_bytes(),
            "kv_compression_ratio": eng.compression_ratio(),
            "stats": eng.stats, "tok_per_s": total_toks / dt,
            "persisted": persist}


def _serve_scheduler(cfg, params, reqs: dict, dev, *, n_pool: int, gen: int,
                     prefill_chunk, token_budget, arrival_stagger,
                     prefix_cache, requeue_preempted, codec, ttft_deadline,
                     deadline, max_queue, overload, trace_out, metrics,
                     metrics_port, metrics_out, metrics_jsonl, observatory,
                     audit_out, chaos, snapshot_dir, tier_args) -> dict:
    """The ``--scheduler`` path: open-loop arrivals through
    :class:`ContinuousScheduler`, one shared Telemetry for engine and
    scheduler."""
    from repro_torch.core.camp import PressureLadder
    from repro_torch.serving import faults as F
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.serving.telemetry import (Telemetry,
                                               start_metrics_server,
                                               stop_metrics_server)
    tel = Telemetry(trace=trace_out is not None)
    obs = None
    if observatory or audit_out is not None:
        # reuse tracking, shadow policy/codec simulators and the decision
        # audit, all on the shared registry
        from repro_torch.serving.observatory import Observatory
        obs = Observatory(tel)
    cache = PrefixCache.for_model(cfg, PAGE) if prefix_cache else None
    injector = None
    if chaos is not None:
        injector = F.FaultInjector(F.FaultSpec(
            corrupt_page_every=7, corrupt_max=2,
            garble_decode_every=11, garble_max=2), seed=chaos)
    eng = PagedKVEngine(cfg, params, page_size=PAGE, n_pool_pages=n_pool,
                        max_batch=len(reqs), prefill_chunk=prefill_chunk,
                        prefix_cache=cache, codec=codec, faults=injector,
                        telemetry=tel, observatory=obs, device=dev)
    tier = None
    if any(v is not None for v in tier_args.values()):
        if cache is None:
            raise ValueError("--tier-host-mb/--tier-disk-dir/--persist-cache "
                             "need --prefix-cache (the tier backs the "
                             "prefix cache)")
        tier = _build_tier(eng, eng.cfg, **tier_args)
    sched = ContinuousScheduler(eng, token_budget=token_budget,
                                requeue_preempted=requeue_preempted,
                                max_queue=max_queue,
                                ladder=PressureLadder() if overload else None,
                                telemetry=tel)
    server = None
    if metrics_port is not None:
        server = start_metrics_server([tel.registry], metrics_port)
        print(f"[serve] serving /metrics on port {server.server_address[1]}")
    for p in (trace_out, metrics_out, metrics_jsonl, audit_out):
        if p is not None and os.path.dirname(p):
            os.makedirs(os.path.dirname(p), exist_ok=True)
    jsonl_f = open(metrics_jsonl, "w") if metrics_jsonl is not None else None
    arrivals = {b: b * arrival_stagger for b in reqs}
    pending = dict(arrivals)
    snap_step = None
    t0 = tel.clock.now()
    try:
        while pending or not sched.idle:
            if sched.iteration % 16 == 0:
                eng.sample_gauges()       # keep exported gauges fresh
                if jsonl_f is not None:
                    jsonl_f.write(tel.registry.to_jsonl_line(
                        iteration=sched.iteration) + "\n")
            for rid, at in list(pending.items()):
                if at <= sched.iteration:
                    sched.submit(rid, reqs[rid], max_new_tokens=gen,
                                 ttft_deadline=ttft_deadline,
                                 deadline=deadline)
                    del pending[rid]
            if snapshot_dir is not None and snap_step is None \
                    and not pending and (sched._running or sched._prefill):
                # mid-stream, requests in flight: the restore below must
                # finish them with the same tokens
                from repro_torch.serving.snapshot import save_snapshot
                snap_step = sched.iteration
                save_snapshot(snapshot_dir, eng, sched, step=snap_step)
            sched.step()
        dt = tel.clock.now() - t0
        eng.sample_gauges()
        if jsonl_f is not None:
            jsonl_f.write(tel.registry.to_jsonl_line(
                iteration=sched.iteration, final=True) + "\n")
    finally:
        # a clean exit or a crash mid-run: release the file and the port
        if jsonl_f is not None:
            jsonl_f.close()
        if server is not None:
            stop_metrics_server(server)
    if metrics_out is not None:
        with open(metrics_out, "w") as f:
            f.write(tel.registry.to_prometheus())
    if trace_out is not None:
        tel.tracer.write_chrome_trace(trace_out)
    fin = sched.finished()
    outs = [fin[b].out_tokens for b in reqs]

    def req_ratio(b):
        raw, comp = eng.request_bytes.get(b, (0, 0))
        return round(raw / comp, 3) if comp else None

    # first_token_iter stays None for a request that retires before its
    # first token (rejected, deadline, preempted past the requeue limit)
    report = {b: {"ttft_iters": (fin[b].first_token_iter - arrivals[b]
                                 if fin[b].first_token_iter is not None
                                 else None),
                  "latency_iters": fin[b].finished_iter - arrivals[b],
                  "cached_tokens": fin[b].pf_start,
                  "compression_ratio": req_ratio(b),
                  "reason": str(fin[b].finish_reason)}
              for b in reqs}
    out = {"tokens": outs, "codec": eng.codec.name, "device": str(dev),
           "kv_compression_ratio": eng.compression_ratio(),
           "stats": eng.stats, "sched_stats": sched.stats,
           "per_request": report, "iterations": sched.iteration,
           "wall_s": dt, "tok_per_s": sum(len(o) for o in outs) / dt}
    if injector is not None:
        out["faults"] = dict(injector.stats, log=injector.log)
    if cache is not None:
        out["prefix_cache"] = dict(cache.stats,
                                   hit_rate=round(cache.hit_rate(), 3))
    if tier is not None:
        out["tier"] = dict(tier.stats)
        if tier_args["persist"] is not None:
            tier.persist(tier_args["persist"])
            out["persisted"] = tier_args["persist"]
    if metrics or metrics_out is not None or trace_out is not None:
        out["metrics_summary"] = _metrics_summary(tel, eng, sched)
    if obs is not None:
        out["observatory"] = obs.summary()
        out["reuse_table"] = obs.reuse_table()
        if audit_out is not None:
            obs.audit.to_jsonl(audit_out)
    if snap_step is not None:
        from repro_torch.serving.snapshot import restore_snapshot
        eng2, sched2 = restore_snapshot(snapshot_dir, cfg, params,
                                        step=snap_step, device=dev)
        fin2 = sched2.run()
        match = all(fin2[b].out_tokens == fin[b].out_tokens
                    and str(fin2[b].finish_reason) == str(fin[b].finish_reason)
                    for b in fin2)
        eng2.debug_validate()
        out["snapshot"] = {"step": snap_step, "restored_match": match,
                           "restored_requests": len(fin2)}
    return out


def _metrics_summary(tel, eng, sched) -> dict:
    """End-of-run summary (--metrics): per-codec ratio, TTFT, inter-token
    and latency percentiles, ladder transitions, read from the shared
    registry's histograms."""
    reg = tel.registry
    per_codec = {}
    for labels, pages in reg.series("engine_pages_by_codec_total"):
        name = labels["codec"]
        ratios = [m for lb, m in reg.series("engine_page_compression_ratio")
                  if lb["codec"] == name]
        per_codec[name] = {
            "pages": pages.value,
            "ratio_p50": (round(ratios[0].quantile(0.5), 3) if ratios
                          else None)}

    def pct(name):
        hs = [m for _, m in reg.series(name)]
        if not hs or hs[0].count == 0:
            return None
        h = hs[0]
        return {"p50": round(h.quantile(0.5), 4),
                "p95": round(h.quantile(0.95), 4),
                "p99": round(h.quantile(0.99), 4), "n": h.count}

    return {"ttft_s": pct("serve_ttft_seconds"),
            "intertoken_s": pct("serve_intertoken_seconds"),
            "latency_s": pct("serve_request_latency_seconds"),
            "dispatch_s": pct("sched_dispatch_seconds"),
            "per_codec": per_codec,
            "ladder_transitions": sched.stats["ladder_transitions"],
            "pool_used_pages": eng.pool_used_pages()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the model to its reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--paged", action="store_true",
                    help="the paged compressed-KV engine, blocking admission")
    ap.add_argument("--paged-reference", action="store_true",
                    help="the host-looped reference engine (the oracle; "
                         "A/B baseline)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill step width in tokens "
                         "(page-aligned; default 2x page size)")
    ap.add_argument("--codec", default=None, choices=codecs.available(),
                    help="page codec (default: REPRO_CODEC, else bdi)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--scheduler", action="store_true",
                    help="continuous-batching token-budget loop")
    ap.add_argument("--token-budget", type=int, default=64,
                    help="per-iteration token budget (scheduler mode)")
    ap.add_argument("--arrival-stagger", type=int, default=2,
                    help="iterations between request arrivals "
                         "(scheduler mode)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="SIP prefix cache: share prompt-prefix KV pages "
                         "across requests (scheduler mode)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="every request shares its first N prompt tokens")
    ap.add_argument("--requeue-preempted", action="store_true",
                    help="CAMP-preempted requests re-enter the queue with "
                         "recompute-from-prompt instead of retiring")
    ap.add_argument("--ttft-deadline", type=int, default=None,
                    help="per-request TTFT deadline in iterations")
    ap.add_argument("--deadline", type=int, default=None,
                    help="per-request total deadline in iterations")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded waiting queue: submissions past this "
                         "depth finish 'rejected'")
    ap.add_argument("--overload", action="store_true",
                    help="arm the pool-pressure degradation ladder (shed "
                         "cache inserts -> shrink prefill share -> reject)")
    ap.add_argument("--trace-out", default=None,
                    help="write the Chrome/Perfetto trace_event timeline")
    ap.add_argument("--metrics", action="store_true",
                    help="print an end-of-run metrics summary")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text on 127.0.0.1:N/metrics "
                         "during the run (0 = ephemeral)")
    ap.add_argument("--metrics-out", default=None,
                    help="write a final Prometheus text snapshot here")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append JSON-lines registry snapshots here every "
                         "16 iterations")
    ap.add_argument("--observatory", action="store_true",
                    help="attach the memory-hierarchy observatory: reuse "
                         "tables, shadow policy/codec simulators, decision "
                         "audit (scheduler mode)")
    ap.add_argument("--audit-out", default=None,
                    help="write the decision audit log as JSONL here "
                         "(scheduler mode; implies --observatory)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="inject a deterministic fault schedule (scheduler "
                         "mode)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="snapshot the engine mid-stream, restore it after "
                         "the run and check it finishes identically")
    ap.add_argument("--tier-host-mb", type=float, default=None,
                    help="host-RAM tier behind the prefix cache (MB)")
    ap.add_argument("--tier-disk-dir", default=None,
                    help="spill the tier's host victims to an mmap arena "
                         "here")
    ap.add_argument("--persist-cache", default=None,
                    help="restore the tier from / persist it to this "
                         "checkpoint directory")
    ap.add_argument("--multi-turn", type=int, default=0, metavar="N",
                    help="one conversation of N turns, the device pool "
                         "recycled between turns, history from the tier")
    args = ap.parse_args()
    sched_flags = (args.chaos is not None or args.snapshot_dir
                   or args.prefix_cache or args.shared_prefix
                   or args.requeue_preempted or args.overload
                   or args.trace_out or args.metrics
                   or args.metrics_port is not None or args.metrics_out
                   or args.metrics_jsonl or args.max_queue is not None
                   or args.observatory or args.audit_out is not None
                   or args.deadline is not None
                   or args.ttft_deadline is not None)
    if sched_flags and not args.scheduler:
        ap.error("these flags belong to scheduler mode: add --scheduler")
    tier_flags = (args.tier_host_mb is not None or args.tier_disk_dir
                  or args.persist_cache)
    if tier_flags and not (args.multi_turn or args.prefix_cache):
        ap.error("the tier flags need --multi-turn or --scheduler "
                 "--prefix-cache (the tier backs the prefix cache)")
    out = generate(args.arch, smoke=args.smoke, batch=args.batch,
                   prompt_len=args.prompt_len, gen=args.gen,
                   paged=args.paged, paged_reference=args.paged_reference,
                   prefill_chunk=args.prefill_chunk,
                   scheduler=args.scheduler, token_budget=args.token_budget,
                   arrival_stagger=args.arrival_stagger,
                   prefix_cache=args.prefix_cache,
                   shared_prefix=args.shared_prefix,
                   requeue_preempted=args.requeue_preempted,
                   codec=args.codec, ttft_deadline=args.ttft_deadline,
                   deadline=args.deadline, max_queue=args.max_queue,
                   overload=args.overload, trace_out=args.trace_out,
                   metrics=args.metrics, metrics_port=args.metrics_port,
                   metrics_out=args.metrics_out,
                   metrics_jsonl=args.metrics_jsonl,
                   observatory=args.observatory, audit_out=args.audit_out,
                   chaos=args.chaos,
                   snapshot_dir=args.snapshot_dir,
                   tier_host_mb=args.tier_host_mb,
                   tier_disk_dir=args.tier_disk_dir,
                   persist_cache=args.persist_cache,
                   multi_turn=args.multi_turn, device=args.device)
    if "turns" in out:
        for t in out["turns"]:
            print(f"[serve] turn {t['turn']}: {t['prompt_tokens']} prompt "
                  f"tokens, {t['cached_tokens']} cached, ttft "
                  f"{t['ttft_s']} s, {t['demotions']} demotions, "
                  f"{t['promotions']} promotions")
        print(f"[serve] tier: {out['tier']}; {out['tok_per_s']:.1f} tok/s "
              f"on {out['device']} (codec {out['codec']})")
        return
    n_tok = sum(len(t) for t in out["tokens"])
    if "codec" not in out:                  # dense decode
        steps = out["decode_s"]
        print(f"[serve] {n_tok} tokens at {out['tok_per_s']:.1f} tok/s on "
              f"{out['device']} (dense decode): prefill "
              f"{out['prefill_s'] * 1e3:.1f} ms, decode "
              f"{sum(steps) / max(len(steps), 1) * 1e3:.2f} ms a step, "
              f"cache {out['cache_bytes']} bytes")
        return
    print(f"[serve] {n_tok} tokens at {out['tok_per_s']:.1f} tok/s on "
          f"{out['device']} (codec {out['codec']})")
    print(f"[serve] codec {out['codec']}: aggregate compression "
          f"{out['kv_compression_ratio']:.2f}x (raw/compressed "
          f"device-reported bytes); stats: {out['stats']}")
    if "sched_stats" in out:
        print(f"[serve] scheduler: {out['sched_stats']}")
        for rid, r in out["per_request"].items():
            ratio = r["compression_ratio"]
            print(f"[serve]   req {rid}: ttft {r['ttft_iters']} iters, "
                  f"latency {r['latency_iters']} iters, "
                  f"{r['cached_tokens']} cached, {out['codec']} ratio "
                  f"{'n/a' if ratio is None else f'{ratio:.2f}x'} "
                  f"({r['reason']})")
    if "metrics_summary" in out:
        ms = out["metrics_summary"]
        print("[serve] metrics summary:")
        for k in ("ttft_s", "intertoken_s", "latency_s", "dispatch_s"):
            v = ms[k]
            if v is not None:
                print(f"[serve]   {k:<13} p50 {v['p50']}  p95 {v['p95']}  "
                      f"p99 {v['p99']}  (n={v['n']})")
        for name, pc in ms["per_codec"].items():
            print(f"[serve]   codec {name}: {pc['pages']} pages, "
                  f"page-ratio p50 {pc['ratio_p50']}")
        print(f"[serve]   ladder transitions {ms['ladder_transitions']}, "
              f"pool used {ms['pool_used_pages']} pages")
    if "observatory" in out:
        ob = out["observatory"]
        print(f"[serve] observatory: shadow hit rates "
              f"{ob['shadow_hit_rates']}")
        print(f"[serve]   live pages {ob['live_pages']}, reuse ticks "
              f"{ob['reuse_ticks']}, audit decisions "
              f"{ob['audit_decisions']}")
        if ob["codec_wouldbe_bytes"]:
            print(f"[serve]   single-codec what-if bytes: "
                  f"{ob['codec_wouldbe_bytes']}")
        print("[serve] size-bin x reuse-distance:")
        for ln in out["reuse_table"].splitlines():
            print(f"[serve]   {ln}")
    for key in ("prefix_cache", "tier", "faults", "snapshot"):
        if key in out:
            print(f"[serve] {key.replace('_', ' ')}: {out[key]}")


if __name__ == "__main__":
    main()
