"""Serve a small model with batched requests through the LCP-paged
compressed-KV engine with CAMP pool management (port of
``examples/serve_paged.py``).

All requests advance together through the batched decode step
(``decode_batch``): one step a token for the whole batch, with attention
reading the BDI-compressed page pool in place (the CUDA kernel on the
card, its plain version on the CPU).  Weights are random, made from a
seed on the device.  Runs on the card unless asked for the CPU; raises
without CUDA.

Run: PYTHONPATH=src python -m repro_torch.launch.serve_paged [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels._device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.serving.engine import PagedKVEngine


def main(device: str | torch.device | None = None, steps: int = 24) -> dict:
    """Serve six prompts for ``steps`` decode steps on ``device``
    (default ``cuda``); returns what it prints."""
    dev = resolve_device(device)
    cfg = get_arch("yi-6b").reduced(n_layers=2, d_model=64)
    params = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 dev)
    eng = PagedKVEngine(cfg, params, page_size=8, n_pool_pages=96,
                        max_batch=8, device=dev)

    prompts = {i: [1 + (i * 7 + j) % (cfg.vocab - 1) for j in range(12)]
               for i in range(6)}
    for sid, p in prompts.items():
        eng.add_request(sid, p)
    print(f"prefilled {len(prompts)} requests; "
          f"pool pages used: {eng.pool_used_pages()}")

    t0 = time.perf_counter()
    for _ in range(steps):                   # continuous batching rounds
        eng.decode_batch()                   # all live seqs, one step
    dt = time.perf_counter() - t0
    for sid in list(prompts)[:3]:
        print(f"seq {sid}: ...{eng.seqs[sid].tokens[-6:]}")
    fused = dev.type == "cuda" and eng.codec.has_fused_kernels
    print(f"decode: {len(prompts) * steps / dt:.1f} tok/s "
          f"({'CUDA kernel' if fused else 'plain'} attention on {dev})")
    print(f"KV compression ratio: {eng.compression_ratio():.2f}x  "
          f"stats: {eng.stats}")
    return {"tokens": {sid: eng.seqs[sid].tokens for sid in prompts},
            "tok_per_s": len(prompts) * steps / dt,
            "kv_compression_ratio": eng.compression_ratio(),
            "stats": eng.stats}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    main(ap.parse_args().device)
