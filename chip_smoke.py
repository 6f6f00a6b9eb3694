#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one NVIDIA Hopper card and fails loudly:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one
     process per source, all started together);
  2. ``bdi_compress_kv``: kernel vs plain PyTorch version on the card at
     the main path's publish shape plus edge rows — bit-exact;
  3. ``paged_attention_tail``: kernel vs plain version at yi-6b decode
     shapes, scrambled page table, ragged and zero lengths — within an
     f32 tolerance; ``F.scaled_dot_product_attention`` over K/V
     dequantised beforehand is timed as a yardstick only;
  4. serve yi-6b at full width (random bf16 weights from a seed) through
     ``PagedKVEngine.add_requests`` / ``decode_batch``: 8 ragged prompts
     of 300-512 tokens, 64 decode steps; both kernels must have launched;
  5. cross-device parity at small depth: the same prompts through the
     engine on ``cuda`` (kernels) and ``cpu`` (plain versions) — greedy
     tokens equal up to reported bf16 ties, ``stats`` exactly equal.

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Exits non-zero, with
no result line, when CUDA is missing or any phase fails.

Usage: ``python3 chip_smoke.py`` from the repository root (one card).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
F32_FLOPS = 67e12                   # H100 SXM f32 outside the tensor cores
ATTN_ATOL = 1e-4                    # kernel vs plain, f32 attention
ATTN_RTOL = 1e-4


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``.  The calls queue up behind a
    sleeping kernel, so the events bracket back-to-back device work and
    not the host's launch rate: a 30 us kernel launched from Python
    would otherwise time the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)          # ~0.1 s at H100 clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: the row codec
# ---------------------------------------------------------------------------

def edge_rows(d: int, dev):
    """Rows that stress the codec's rounding and exponent edges."""
    import torch
    rows = torch.zeros((10, d), dtype=torch.float32)
    rows[1] = 3.25                                 # constant: maxres 0
    rows[2, 1] = 100.0                             # scale 1, .5 quotients
    rows[2, 2:10] = torch.tensor([2.5, -3.5, 0.5, -0.5, 126.5, -126.5,
                                  1.5, -2.5])
    rows[3, 1:] = 1e-40                            # subnormal maxres/ratio
    rows[3, 2] = -3e-39
    rows[4, 1] = 1.4e-45                           # ratio 0: scale 2^-127
    rows[5, 1::2] = 1e38                           # huge maxres, finite
    rows[5, 2::2] = -1e38
    rows[6, 1] = 127.0                             # ratio exactly 1
    rows[7, 1] = 127.0 * 2.0 ** -20                # ratio exactly 2^-20
    rows[8] = torch.linspace(-5e5, 5e5, d)
    rows[9, 0] = -7.0                              # base far from the rest
    rows[9, 1:] = torch.linspace(0.0, 0.001, d - 1)
    return rows.to(dev)


def phase_compress(dev, cfg, page: int) -> dict:
    import torch
    from repro_torch.kernels.bdi_compress import (bdi_compress_kv,
                                                  bdi_compress_kv_ref)
    d = cfg.head_dim
    # the main path's biggest publish: one prefill chunk of 8 rows x 2
    # pages, every layer, every kv head
    n_main = cfg.n_layers * 16 * cfg.n_kv_heads * page
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((n_main, d), generator=g, device=dev) * 2.0
    x = torch.cat([x, edge_rows(d, dev)]).contiguous()
    got = bdi_compress_kv(x)
    want = bdi_compress_kv_ref(x)
    torch.cuda.synchronize()
    for name, a, b in zip(("deltas", "base", "scale"), got, want):
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"bdi_compress_kv {name} differ from the "
                                 f"plain version at {bad}")
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    xm = x[:n_main].contiguous()
    ms = cuda_time_ms(lambda: bdi_compress_kv(xm))
    plain_ms = cuda_time_ms(lambda: bdi_compress_kv_ref(xm))
    n = xm.shape[0]
    bms, by = bound(n * d * 4 + n * d + 8 * n, 6.0 * n * d)
    log(f"bdi_compress_kv: {n} rows x {d} + {x.shape[0] - n} edge rows "
        f"bit-exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by})")
    return {"name": "bdi_compress_kv", "route": "cuda",
            "source": "src/repro_torch/csrc/bdi_compress_kv.cu",
            "replaces": "src/repro/kernels/bdi_compress.py:116",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


# ---------------------------------------------------------------------------
# phase 3: decode attention
# ---------------------------------------------------------------------------

def phase_attention(dev, cfg, page: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        paged_attention_tail, paged_attention_tail_ref)
    from repro_torch.kernels.ref import compress_kv_pages, dequant_pages
    b, kvh, d = 8, cfg.n_kv_heads, cfg.head_dim
    g_, pmax, n_pages = cfg.n_heads // kvh, 64, 600
    gen = torch.Generator(device=dev).manual_seed(3)
    k = torch.randn((n_pages, kvh, page, d), generator=gen, device=dev)
    v = torch.randn((n_pages, kvh, page, d), generator=gen, device=dev)
    pages = compress_kv_pages(k, v)
    q = torch.randn((b, kvh, g_, d), generator=gen, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    pt = perm[:b * pmax].view(b, pmax).to(torch.int32).contiguous()
    lengths = torch.tensor([1024, 0, 517, 1000, 16, 33, 700, 1023],
                           dtype=torch.int32, device=dev)
    tail_len = torch.tensor([1, 16, 7, 3, 16, 1, 9, 12], dtype=torch.int32,
                            device=dev)
    tk = torch.randn((b, kvh, page, d), generator=gen, device=dev)
    tv = torch.randn((b, kvh, page, d), generator=gen, device=dev)
    args = (q, pages, pt, lengths, tk, tv, tail_len)
    got = paged_attention_tail(*args)
    want = paged_attention_tail_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=ATTN_ATOL, rtol=ATTN_RTOL):
        raise AssertionError(f"paged_attention_tail differs from the plain "
                             f"version: max abs err {err}")
    ms = cuda_time_ms(lambda: paged_attention_tail(*args))
    plain_ms = cuda_time_ms(lambda: paged_attention_tail_ref(*args))
    # library yardstick: SDPA over K/V dequantised and gathered beforehand
    kd = dequant_pages(pages.kd, pages.kb, pages.ks)[pt.long()]
    vd = dequant_pages(pages.vd, pages.vb, pages.vs)[pt.long()]
    kg = torch.cat([kd.movedim(2, 1).reshape(b, kvh, pmax * page, d), tk], 2)
    vg = torch.cat([vd.movedim(2, 1).reshape(b, kvh, pmax * page, d), tv], 2)
    pos = torch.arange(pmax * page + page, device=dev)
    mask = torch.where(pos[None, :] < pmax * page,
                       pos[None, :] < lengths[:, None],
                       pos[None, :] - pmax * page < tail_len[:, None])
    mask = mask[:, None, None, :]
    lib_out = F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)
    lib_err = float((lib_out - want).abs().max())
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask))
    keys = int(lengths.sum() + tail_len.sum())
    nbytes = (q.numel() * 4 * 2 + int(lengths.sum()) * kvh * (2 * d + 16)
              + int(tail_len.sum()) * kvh * 2 * d * 4
              + 4 * int(((lengths + page - 1) // page).sum()) + 8 * b)
    bms, by = bound(nbytes, 4.0 * g_ * d * kvh * keys)
    log(f"paged_attention_tail: B={b} KVH={kvh} G={g_} D={d} page={page} "
        f"PMAX={pmax}; max abs err {err:.3e} (tol {ATTN_ATOL} + "
        f"{ATTN_RTOL}*|ref|); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms (err {lib_err:.3e}), bound {bms:.4f} ms "
        f"({by})")
    return {"name": "paged_attention_tail", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention_tail.cu",
            "replaces": "src/repro/kernels/paged_attention.py:211",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 4: serve yi-6b at full width
# ---------------------------------------------------------------------------

def ragged_prompts(n: int, lo: int, hi: int, vocab: int, seed: int):
    import torch
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
    return {i: torch.randint(1, vocab, (ln,), generator=g).tolist()
            for i, ln in enumerate(lens)}


def phase_serve(dev, cfg, page: int) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedKVEngine
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"yi-6b params: {n_params / 1e9:.3f} B on {dev} in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = ragged_prompts(8, 300, 512, cfg.vocab, seed=1)
    # warm-up on a small engine (cuBLAS heuristics, allocator), not timed
    warm = PagedKVEngine(cfg, params, page_size=page, n_pool_pages=257,
                         max_batch=8, device=dev)
    warm.add_requests({0: prompts[0][:40], 1: prompts[1][:20]})
    for _ in range(17):
        warm.decode_batch()
    del warm
    torch.cuda.empty_cache()

    eng = PagedKVEngine(cfg, params, page_size=page, n_pool_pages=10240,
                        max_batch=8, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.add_requests(prompts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches_prefill = dict(ops.LAUNCHES)
    gen = 64
    t0 = time.perf_counter()
    for _ in range(gen):
        eng.decode_batch()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    # the output is right by the engine's own accounting
    want_pages = cfg.n_layers * sum((len(p) - 1 + gen) // page
                                    for p in prompts.values())
    st = eng.stats
    if st["preemptions"] or st["pages_compressed"] != want_pages:
        raise AssertionError(f"unexpected stats {st} (want "
                             f"{want_pages} pages, no preemption)")
    for sid, p in prompts.items():
        out = eng.seqs[sid].tokens[len(p):]
        if len(out) != gen or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"sid {sid}: bad output {out[:8]}...")
    logits = eng.last_logits.float()
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits at full width")
    n_prompt = sum(len(p) for p in prompts.values())
    res = {"prompt_tokens": n_prompt, "prompt_lens":
           [len(p) for p in prompts.values()], "decode_steps": gen,
           "prefill_s": t_prefill, "prefill_tok_s": n_prompt / t_prefill,
           "decode_s": t_decode, "decode_tok_s": 8 * gen / t_decode,
           "decode_ms_per_step": 1e3 * t_decode / gen,
           "kv_compression_ratio": eng.compression_ratio(), "stats": st,
           "launches": launches, "launches_prefill": launches_prefill,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    log(f"serve: {json.dumps(res)}")
    del eng
    torch.cuda.empty_cache()
    return res


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# phase 5: cross-device parity at small depth
# ---------------------------------------------------------------------------

def phase_parity(dev, cfg, page: int, lo: int, hi: int, steps: int) -> dict:
    import torch
    from repro_torch.models.params import to_device
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.parity import GreedyParity, engine_logits
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = ragged_prompts(8, lo, hi, cfg.vocab, seed=4)
    n_pool = 1 + cfg.n_layers * sum(-(-(len(p) + steps) // page)
                                    for p in prompts.values())
    engs = {d: PagedKVEngine(cfg, to_device(params, torch.device(d)),
                             page_size=page, n_pool_pages=n_pool,
                             max_batch=8, device=d)
            for d in (dev, torch.device("cpu"))}
    gpu, cpu = engs[dev], engs[torch.device("cpu")]
    for e in engs.values():
        e.add_requests(prompts)
    if gpu.stats != cpu.stats:
        raise AssertionError(f"prefill stats differ: {gpu.stats} vs "
                             f"{cpu.stats}")
    parity = GreedyParity()
    for step in range(steps):
        want, got = cpu.decode_batch(), gpu.decode_batch()
        parity.check(step, want, got, engine_logits(gpu),
                     engine_logits(cpu))
    if gpu.stats != cpu.stats or gpu._pmax != cpu._pmax:
        raise AssertionError(f"stats differ: {gpu.stats} vs {cpu.stats}")
    if not torch.equal(gpu._page_table().cpu(), cpu._page_table()):
        raise AssertionError("page tables differ across devices")
    res = {"config": cfg.name, "d_model": cfg.d_model, "steps": steps,
           "tokens_equal": parity.compared,
           "ties": [vars(t) for t in parity.ties]}
    log(f"parity {cfg.name} d_model={cfg.d_model}: {json.dumps(res)}")
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels._device import resolve_device

    dev = resolve_device("cuda")
    card = smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    path, build_log = _build.build()
    _build.load()
    log(f"built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  {line.strip()}")

    cfg = get_arch("yi-6b")
    page = 16
    kernels = [phase_compress(dev, cfg, page), phase_attention(dev, cfg, page)]
    serve = phase_serve(dev, cfg, page)
    for k in kernels:
        k["launches"] = serve["launches"][k["name"]]
    phase_parity(dev, cfg.reduced(n_layers=2), page, 20, 140, 24)
    wide = cfg.reduced(n_layers=2, d_model=cfg.d_model, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                       vocab=cfg.vocab)
    phase_parity(dev, wide, page, 20, 140, 24)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys}
                                  for kk in kernels]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
