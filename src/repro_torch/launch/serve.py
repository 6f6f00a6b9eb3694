"""Serving CLI: batched greedy generation through the paged
compressed-KV engine (port of the ``--paged`` path of
``repro/launch/serve.py``).

Admission goes through ``PagedKVEngine.add_requests`` (one chunked-batch
prefill pass for all prompts; ``--prefill-chunk`` sets the step width)
and decode through ``decode_batch`` (one step per token for the whole
batch), under any registered page codec (``--codec``; default
``REPRO_CODEC`` or bdi).  Weights are random, made from a seed on the
device; prompts are random token ids from a second seed.  The pool is
sized so the requests never preempt.  The other modes of the JAX CLI
(scheduler, prefix cache, faults, tier, telemetry) are not ported yet.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --paged \
      [--smoke] [--batch 4 --prompt-len 16 --gen 16] [--device cuda|cpu] \
      [--codec bdi|zero|raw|gbdi|fpc|adaptive]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import codecs
from repro_torch.configs.registry import get_arch
from repro_torch.kernels._device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import PagedKVEngine

PAGE = 8


def generate(arch: str, *, smoke: bool = True, batch: int = 4,
             prompt_len: int = 16, gen: int = 16, paged: bool = True,
             prefill_chunk: int | None = None,
             codec: str | None = None,
             device: str | torch.device | None = None) -> dict:
    if not paged:
        raise ValueError("only the --paged serving path is ported")
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompts = torch.randint(1, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    reqs = {b: prompts[b].tolist() for b in range(batch)}
    pages_per_seq = -(-(prompt_len + gen) // PAGE)
    eng = PagedKVEngine(cfg, params, page_size=PAGE,
                        n_pool_pages=1 + cfg.n_layers * batch * pages_per_seq,
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the model to its reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--paged", action="store_true",
                    help="the paged compressed-KV engine (the ported mode)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill step width in tokens "
                         "(page-aligned; default 2x page size)")
    ap.add_argument("--codec", default=None, choices=codecs.available(),
                    help="page codec (default: REPRO_CODEC, else bdi)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args()
    if not args.paged:
        ap.error("only --paged is ported; pass --paged")
    out = generate(args.arch, smoke=args.smoke, batch=args.batch,
                   prompt_len=args.prompt_len, gen=args.gen,
                   prefill_chunk=args.prefill_chunk, codec=args.codec,
                   device=args.device)
    print(f"[serve] {args.batch}x{args.gen} tokens at "
          f"{out['tok_per_s']:.1f} tok/s on {out['device']} "
          f"(codec {out['codec']})")
    print(f"[serve] codec {out['codec']}: aggregate compression "
          f"{out['kv_compression_ratio']:.2f}x (raw/compressed "
          f"device-reported bytes); stats: {out['stats']}")


if __name__ == "__main__":
    main()
