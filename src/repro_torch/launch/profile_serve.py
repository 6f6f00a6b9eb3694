"""Where the time goes: profile the serve workload on the card.

Builds yi-6b at full width with random weights from a seed, under one
page codec, on one of ``chip_smoke.py``'s serve workloads (``long``:
phases 4 and 4b, 8 prompts of 300-512 tokens; ``short``: phase 4c, 8
prompts of 100-200 tokens), page 16, the pool sized so nothing is
preempted; warms up on a small engine, then records with
``torch.profiler`` (1) the whole chunked prefill of the 8 prompts and
(2) a window of decode steps.  For each it prints one JSON line: host
wall time, device busy time (the sum of kernel times), the device's
idle share, and device time by kernel name, largest first.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--steps 8] \
      [--codec bdi|zero|raw|gbdi|fpc|adaptive] [--workload long|short]
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import codecs
from repro_torch.configs.registry import get_arch
from repro_torch.kernels._device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import PagedKVEngine


# name: (shortest prompt, longest prompt, seed), as in chip_smoke.py
WORKLOADS = {"long": (300, 512, 1), "short": (100, 200, 5)}


def _prompts(vocab: int, lo: int, hi: int,
             seed: int) -> dict[int, list[int]]:
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(lo, hi + 1, (8,), generator=g).tolist()
    return {i: torch.randint(1, vocab, (n,), generator=g).tolist()
            for i, n in enumerate(lens)}


def _summary(prof, wall_s: float, top: int) -> dict:
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0] + us,
                              kernels.get(e.key, (0.0, 0))[1] + e.count)
    busy_s = sum(us for us, _ in kernels.values()) / 1e6
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_s * 1e3,
            "device_idle_share": 1.0 - busy_s / wall_s,
            "kernels": [{"name": k[:90], "ms": us / 1e3, "calls": n}
                        for k, (us, n) in ranked[:top]]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8,
                    help="decode steps in the recorded window")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--codec", default="bdi", choices=codecs.available())
    ap.add_argument("--workload", default="long", choices=sorted(WORKLOADS))
    args = ap.parse_args()
    dev = resolve_device("cuda")
    cfg = get_arch("yi-6b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompts = _prompts(cfg.vocab, *WORKLOADS[args.workload])
    warm = PagedKVEngine(cfg, params, page_size=16, n_pool_pages=257,
                         max_batch=8, codec=args.codec, device=dev)
    warm.add_requests({0: prompts[0][:40], 1: prompts[1][:20]})
    for _ in range(17):
        warm.decode_batch()
    del warm
    steps = 4 + args.steps
    n_pool = 1 + cfg.n_layers * sum(-(-(len(p) + steps) // 16)
                                    for p in prompts.values())
    eng = PagedKVEngine(cfg, params, page_size=16, n_pool_pages=n_pool,
                        max_batch=8, codec=args.codec, device=dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.add_requests(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(json.dumps({"codec": args.codec, "workload": args.workload,
                      "phase": "prefill", "tokens": sum(map(len,
                      prompts.values())), **_summary(prof, wall, args.top)}))
    for _ in range(4):
        eng.decode_batch()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.decode_batch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(json.dumps({"codec": args.codec, "workload": args.workload,
                      "phase": "decode", "steps": args.steps,
                      **_summary(prof, wall, args.top)}))


if __name__ == "__main__":
    main()
