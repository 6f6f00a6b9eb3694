"""Serving CLI: batched greedy generation through the paged compressed-KV
engine (port of the ``--paged`` and ``--scheduler`` paths of
``repro/launch/serve.py``).

``--paged`` admits every prompt through ``PagedKVEngine.add_requests``
(one chunked-batch prefill pass; ``--prefill-chunk`` sets the step
width) and decodes through ``decode_batch`` (one step per token for the
whole batch).  ``--scheduler`` drives the token-budget
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

Weights are random, made from a seed on the device; prompts are random
token ids from a second seed.  The pool is sized so the requests never
preempt.  The JAX CLI's fault injection, snapshot, tier, multi-turn and
observatory flags are refused (not ported yet).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --paged \\
      [--smoke] [--batch 4 --prompt-len 16 --gen 16] [--device cuda|cpu] \\
      [--codec bdi|zero|raw|gbdi|fpc|adaptive] \\
      [--scheduler [--prefix-cache --shared-prefix N] [--token-budget 64]]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import codecs
from repro_torch.configs.registry import get_arch
from repro_torch.kernels._device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import PagedKVEngine

PAGE = 8

# the JAX CLI's flags whose subsystems the port does not have yet
_NOT_PORTED = {
    "--chaos": "fault injection (ROADMAP Queue 1 item 4)",
    "--snapshot-dir": "snapshot/restore (ROADMAP Queue 1 item 4)",
    "--tier-host-mb": "the host/disk tier (ROADMAP Queue 1 item 5)",
    "--tier-disk-dir": "the host/disk tier (ROADMAP Queue 1 item 5)",
    "--persist-cache": "the host/disk tier (ROADMAP Queue 1 item 5)",
    "--multi-turn": "the host/disk tier (ROADMAP Queue 1 item 5)",
    "--observatory": "the observatory (ROADMAP Queue 1 item 6)",
    "--audit-out": "the observatory (ROADMAP Queue 1 item 6)",
}


def generate(arch: str, *, smoke: bool = True, batch: int = 4,
             prompt_len: int = 16, gen: int = 16, paged: bool = True,
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
             device: str | torch.device | None = None) -> dict:
    if not (paged or scheduler):
        raise ValueError("only the --paged and --scheduler paths are ported")
    if shared_prefix > prompt_len:
        raise ValueError(f"--shared-prefix {shared_prefix} exceeds "
                         f"--prompt-len {prompt_len}")
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompts = torch.randint(1, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    # shared system prompt: every request reuses request 0's first
    # ``shared_prefix`` tokens
    prompts[:, :shared_prefix] = prompts[0, :shared_prefix]
    reqs = {b: prompts[b].tolist() for b in range(batch)}
    pages_per_seq = -(-(prompt_len + gen) // PAGE)
    n_pool = 1 + cfg.n_layers * batch * pages_per_seq
    if scheduler:
        return _serve_scheduler(
            cfg, params, reqs, dev, n_pool=n_pool, gen=gen,
            prefill_chunk=prefill_chunk, token_budget=token_budget,
            arrival_stagger=arrival_stagger, prefix_cache=prefix_cache,
            requeue_preempted=requeue_preempted, codec=codec,
            ttft_deadline=ttft_deadline, deadline=deadline,
            max_queue=max_queue, overload=overload, trace_out=trace_out,
            metrics=metrics, metrics_port=metrics_port,
            metrics_out=metrics_out, metrics_jsonl=metrics_jsonl)
    eng = PagedKVEngine(cfg, params, page_size=PAGE, n_pool_pages=n_pool,
                        max_batch=batch, prefill_chunk=prefill_chunk,
                        codec=codec, device=dev)
    t0 = time.perf_counter()
    eng.add_requests(reqs)          # one chunked-batch prefill pass
    for _ in range(gen):
        eng.decode_batch()          # ends in a host sync of the tokens
    dt = time.perf_counter() - t0
    outs = [eng.seqs[b].tokens[prompt_len:] for b in range(batch)]
    return {"tokens": outs, "codec": eng.codec.name, "device": str(dev),
            "kv_compression_ratio": eng.compression_ratio(),
            "stats": eng.stats, "request_bytes": eng.request_bytes,
            "tok_per_s": batch * gen / dt}


def _serve_scheduler(cfg, params, reqs: dict, dev, *, n_pool: int, gen: int,
                     prefill_chunk, token_budget, arrival_stagger,
                     prefix_cache, requeue_preempted, codec, ttft_deadline,
                     deadline, max_queue, overload, trace_out, metrics,
                     metrics_port, metrics_out, metrics_jsonl) -> dict:
    """The ``--scheduler`` path: open-loop arrivals through
    :class:`ContinuousScheduler`, one shared Telemetry for engine and
    scheduler."""
    from repro_torch.core.camp import PressureLadder
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.serving.telemetry import (Telemetry,
                                               start_metrics_server,
                                               stop_metrics_server)
    tel = Telemetry(trace=trace_out is not None)
    cache = PrefixCache.for_model(cfg, PAGE) if prefix_cache else None
    eng = PagedKVEngine(cfg, params, page_size=PAGE, n_pool_pages=n_pool,
                        max_batch=len(reqs), prefill_chunk=prefill_chunk,
                        prefix_cache=cache, codec=codec, telemetry=tel,
                        device=dev)
    sched = ContinuousScheduler(eng, token_budget=token_budget,
                                requeue_preempted=requeue_preempted,
                                max_queue=max_queue,
                                ladder=PressureLadder() if overload else None,
                                telemetry=tel)
    server = None
    if metrics_port is not None:
        server = start_metrics_server([tel.registry], metrics_port)
        print(f"[serve] serving /metrics on port {server.server_address[1]}")
    for p in (trace_out, metrics_out, metrics_jsonl):
        if p is not None and os.path.dirname(p):
            os.makedirs(os.path.dirname(p), exist_ok=True)
    jsonl_f = open(metrics_jsonl, "w") if metrics_jsonl is not None else None
    arrivals = {b: b * arrival_stagger for b in reqs}
    pending = dict(arrivals)
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
    if cache is not None:
        out["prefix_cache"] = dict(cache.stats,
                                   hit_rate=round(cache.hit_rate(), 3))
    if metrics or metrics_out is not None or trace_out is not None:
        out["metrics_summary"] = _metrics_summary(tel, eng, sched)
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
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args()
    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not ported: it needs {what}")
    if not (args.paged or args.scheduler):
        ap.error("pass --paged or --scheduler (the ported paths)")
    sched_flags = (args.prefix_cache or args.shared_prefix
                   or args.requeue_preempted or args.overload
                   or args.trace_out or args.metrics
                   or args.metrics_port is not None or args.metrics_out
                   or args.metrics_jsonl or args.max_queue is not None
                   or args.deadline is not None
                   or args.ttft_deadline is not None)
    if sched_flags and not args.scheduler:
        ap.error("these flags belong to scheduler mode: add --scheduler")
    out = generate(args.arch, smoke=args.smoke, batch=args.batch,
                   prompt_len=args.prompt_len, gen=args.gen,
                   paged=args.paged, prefill_chunk=args.prefill_chunk,
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
                   metrics_jsonl=args.metrics_jsonl, device=args.device)
    n_tok = sum(len(t) for t in out["tokens"])
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
    if "prefix_cache" in out:
        print(f"[serve] prefix cache: {out['prefix_cache']}")


if __name__ == "__main__":
    main()
