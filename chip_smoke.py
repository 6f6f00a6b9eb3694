#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one NVIDIA Hopper card and fails loudly:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one
     process per source, all started together);
  2. ``bdi_compress_kv``: kernel vs plain PyTorch version on the card at
     the main path's publish shape plus edge rows — bit-exact;
  2b. ``gbdi_compress_kv``: kernel vs plain version at 512 pages x 64
     rows x 128 plus edge pages — every output bit-equal; then at a
     decode-size publish (yi-6b: 32 layers x 8 pages) and at gemma3-27b's
     page (256 rows x 168, one prefill chunk of its 62 layers), and the
     generic instance at 2b's shape (input 4 bytes off a 16-byte
     boundary), each bit-equal and timed;
  2c. ``gbdi_decompress_kv``: kernel vs plain version on 2b's encodings
     — bit-equal;
  2d. ``bdi_compress`` (the two-base tile codec): kernel vs plain
     version on one yi-6b layer's MLP up-projection, [4096 x 11008] f32
     in 128-wide tiles (352,256 tiles), plus sparse-cluster and edge
     tiles, and rows of 256 and 512 — every output bit-equal; the generic
     instance (one warp a tile, IEEE division) timed at the same shape;
  2e. ``bdi_decompress`` on 2d's encodings — bit-equal;
  3. ``paged_attention_tail``: kernel vs plain version at yi-6b decode
     shapes, scrambled page table, ragged and zero lengths — within an
     f32 tolerance; ``F.scaled_dot_product_attention`` over K/V
     dequantised beforehand is timed as a yardstick only;
  3b. ``paged_attention`` (no tail), called through ``ops`` at phase 3's
     shapes — within the same tolerance, NaN rows (length 0) equal;
  3c. ``paged_attention_tail`` at long context (PMAX 256, up to 4096
     tokens) against its plain version, timed over a rotation of pools
     that together exceed the L2, so that each call reads cold pages;
  3d. ``paged_attention_tail`` at gemma3-27b's head (KVH 16, G 2, D 168:
     the generic-D instance) with pages of 16 and of 32 rows, phase 3's
     lengths, against its plain version, timed beside SDPA;
  4. serve yi-6b at full width (random bf16 weights from a seed) through
     ``PagedKVEngine.add_requests`` / ``decode_batch`` under ``bdi``: 8
     ragged prompts of 300-512 tokens, 64 decode steps; the row codec and
     the attention kernel must have launched;
  4b. the same workload under ``gbdi``: both GBDI kernels launched, the
     attention kernel not (decode gathers and decompresses);
  4c. ``adaptive``: 8 prompts of 100-200 tokens, 32 decode steps, the
     pool sized from the requests; the row codec and both GBDI kernels
     launched; prints the member mix of the published pages;
  5. cross-device parity at small depth: the same prompts through the
     engine on ``cuda`` (kernels) and ``cpu`` (plain versions) — greedy
     tokens equal up to reported bf16 ties, host state exactly equal;
  5b. the same under ``zero``, ``raw``, ``fpc``, ``gbdi`` and ``adaptive``
     (gbdi and adaptive also at full width, 2 layers); byte counts of
     fpc and adaptive, which read exact bits, within 8 per page (stats)
     and 64 per request;
  5c. ``gemma3-27b`` at full width and 2 layers under ``bdi`` (D 168,
     G 2: the attention kernel's generic instance), cuda vs cpu greedy
     parity, with shorter prompts and fewer steps than phase 5 (its CPU
     engine reads 7.4 GB of bf16 weights a step);
  6. the tile path end to end: ``ops.roundtrip_tensor`` over every
     parameter leaf of full-width yi-6b (phase 4's weights, stacked
     leaves a layer at a time), |x - x_hat| <= scale/2 per tile, the
     tile-class mix, compression ratio, GB/s and peak memory; then the
     quickstart twin (``repro_torch.launch.quickstart``) on the card;
     both tile kernels must have launched.

Prints each phase's wall time, a ``{"kernels": [...]}`` JSON line, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result line, when CUDA is missing or any phase
fails.

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


def ptxas_report(build_log: str) -> list[str]:
    """One line per kernel instance from nvcc's ``-Xptxas -v`` output:
    its name with template arguments, registers, spills and shared
    memory."""
    import re
    out, name, spill = [], "?", ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            sym, name = m.group(1), m.group(1)
            # the <length><name> piece that names the kernel
            hits = [(d.end(), d.end() + int(sym[k:d.end()]))
                    for d in re.finditer(r"\d+", sym)
                    for k in range(d.start(), d.end())]
            for a, b in hits:
                if sym[a:b].endswith("_kernel"):
                    name = sym[a:b]
                    args = re.match(r"I((?:Li\d+E)+)E", sym[b:])
                    if args:
                        name += "<" + ",".join(
                            re.findall(r"Li(\d+)E", args.group(1))) + ">"
                    break
            spill = ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f", spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {m.group(1)} registers{spill}"
                       + (f", {smem.group(1)} B static smem" if smem else ""))
    return out


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


def bits(t):
    """Bit pattern of a tensor for equality (a NaN compares too)."""
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def max_abs_err(got, want) -> float:
    """Largest |got - want| over finite differences (the codecs are held
    bit-equal first; inf - inf and NaN - NaN count as 0)."""
    return max(float((a.float() - b.float()).nan_to_num(0.0, 0.0, 0.0)
                     .abs().max()) for a, b in zip(got, want))


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
# phases 2b, 2c: the GBDI page codec
# ---------------------------------------------------------------------------

def phase_gbdi(dev, cfg, page: int) -> list[dict]:
    import torch
    from repro_torch.kernels import gbdi_codec as G
    d, rows = cfg.head_dim, cfg.n_kv_heads * page
    # the main path's largest publish: one prefill chunk of 8 rows x 2
    # pages, every layer (512 pages); decode gathers as many (8 x 64)
    pages = cfg.n_layers * 16
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((pages * rows, d), generator=g, device=dev) * 2.0
    edge = G.edge_pages(rows, d)
    x = torch.cat([x] + [p.to(dev) for p in edge.values()]).contiguous()
    got = G.gbdi_compress_kv(x, rows)
    want = G.gbdi_compress_kv_ref(x, rows)
    torch.cuda.synchronize()
    for name, a, b in zip(("deltas", "bases", "bid", "scale", "width"),
                          got, want):
        if not torch.equal(bits(a), bits(b)):
            bad = (bits(a) != bits(b)).nonzero()[:5].tolist()
            raise AssertionError(f"gbdi_compress_kv {name} differ from the "
                                 f"plain version at {bad}")
    err_c = max_abs_err(got, want)
    out = G.gbdi_decompress_kv(*got[:4], rows)
    out_ref = G.gbdi_decompress_kv_ref(*got[:4], rows)
    torch.cuda.synchronize()
    if not torch.equal(bits(out), bits(out_ref)):
        bad = (bits(out) != bits(out_ref)).nonzero()[:5].tolist()
        raise AssertionError(f"gbdi_decompress_kv differs from the plain "
                             f"version at {bad}")
    err_d = max_abs_err([out], [out_ref])
    n = pages * rows
    xm = x[:n].contiguous()
    enc = [got[0][:n], got[1][:pages], got[2][:n], got[3][:n]]
    ms_c = cuda_time_ms(lambda: G.gbdi_compress_kv(xm, rows))
    plain_c = cuda_time_ms(lambda: G.gbdi_compress_kv_ref(xm, rows))
    ms_d = cuda_time_ms(lambda: G.gbdi_decompress_kv(*enc, rows))
    plain_d = cuda_time_ms(lambda: G.gbdi_decompress_kv_ref(*enc, rows))
    # compress: read x once; write deltas, 6 bytes of row metadata and 16
    # of bases a page; ~8 operations an element (2 sub, abs, max, div,
    # round, 2 clamp).  decompress: the reverse bytes, a mul and an add.
    b_c, by_c = bound(n * d * 4 + n * d + 6 * n + 16 * pages, 8.0 * n * d)
    b_d, by_d = bound(n * d + 5 * n + 16 * pages + n * d * 4, 2.0 * n * d)
    log(f"gbdi_compress_kv: {pages} pages x {rows} rows x {d} + "
        f"{len(edge)} edge pages ({', '.join(edge)}) bit-equal; kernel "
        f"{ms_c:.4f} ms, plain {plain_c:.4f} ms, bound {b_c:.5f} ms ({by_c})")
    log(f"gbdi_decompress_kv: the same encodings bit-equal; kernel "
        f"{ms_d:.4f} ms, plain {plain_d:.4f} ms, bound {b_d:.5f} ms ({by_d})")
    # generic instance at the same shape: the same rows 4 bytes off a
    # 16-byte boundary (the launcher then takes the generic body)
    shifted = torch.empty(n * d + 1, device=dev)[1:].view(n, d)
    shifted.copy_(xm)
    if not all(torch.equal(bits(a), bits(b)) for a, b in
               zip(G.gbdi_compress_kv(shifted, rows),
                   G.gbdi_compress_kv(xm, rows))):
        raise AssertionError("gbdi_compress_kv: generic and staged "
                             "instances differ")
    ms_gen = cuda_time_ms(lambda: G.gbdi_compress_kv(shifted, rows))
    log(f"gbdi_compress_kv generic instance (one warp a row, x from global "
        f"memory) at the same shape: {ms_gen:.5f} ms, bit-equal to the "
        f"staged one")
    del shifted
    gbdi_shapes(dev)
    common = {"route": "cuda", "library_ms": None}
    return [dict(common, name="gbdi_compress_kv",
                 source="src/repro_torch/csrc/gbdi_compress_kv.cu",
                 replaces="src/repro/kernels/gbdi_codec.py:177",
                 max_abs_err=err_c, ms=ms_c, plain_ms=plain_c, bound_ms=b_c,
                 bound_by=by_c),
            dict(common, name="gbdi_decompress_kv",
                 source="src/repro_torch/csrc/gbdi_decompress_kv.cu",
                 replaces="src/repro/kernels/gbdi_codec.py:215",
                 max_abs_err=err_d, ms=ms_d, plain_ms=plain_d, bound_ms=b_d,
                 bound_by=by_d)]


def gbdi_shapes(dev) -> None:
    """2b at a decode-size publish (yi-6b: 32 layers x 8 pages of 4 x 16
    rows x 128) and at gemma3-27b's page (16 x 16 rows x 168, one prefill
    chunk of its 62 layers), each with the edge pages: bit-equal, and the
    kernel timed against its byte bound."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import gbdi_codec as G
    for arch, pages_per_layer in (("yi-6b", 8), ("gemma3-27b", 16)):
        cfg = get_arch(arch)
        d, rows = cfg.head_dim, cfg.n_kv_heads * 16
        pages = cfg.n_layers * pages_per_layer
        g = torch.Generator(device=dev).manual_seed(pages)
        xm = torch.randn((pages * rows, d), generator=g, device=dev) * 2.0
        edge = G.edge_pages(rows, d)
        x = torch.cat([xm] + [p.to(dev) for p in edge.values()])
        for name, a, b in zip(("deltas", "bases", "bid", "scale", "width"),
                              G.gbdi_compress_kv(x, rows),
                              G.gbdi_compress_kv_ref(x, rows)):
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"gbdi_compress_kv ({arch}) {name} "
                                     "differ from the plain version")
        n = pages * rows
        ms = cuda_time_ms(lambda: G.gbdi_compress_kv(xm, rows))
        bms, by = bound(n * d * 4 + n * d + 6 * n + 16 * pages, 8.0 * n * d)
        log(f"gbdi_compress_kv at {arch}: {pages} pages x {rows} rows x {d} "
            f"+ {len(edge)} edge pages bit-equal; kernel {ms:.5f} ms, bound "
            f"{bms:.5f} ms ({by}), kernel/bound {ms / bms:.2f}")
        del x, xm


# ---------------------------------------------------------------------------
# phase 3: decode attention
# ---------------------------------------------------------------------------

ATTN_B, ATTN_PMAX, ATTN_POOL = 8, 64, 600
ATTN_LENGTHS = [1024, 0, 517, 1000, 16, 33, 700, 1023]


def attn_inputs(dev, cfg, page: int, seed: int):
    """yi-6b decode shapes: B 8, PMAX 64, a scrambled page table into a
    pool of 600 BDI pages, ragged lengths with a 0."""
    import torch
    from repro_torch.kernels.ref import compress_kv_pages
    b, kvh, d = ATTN_B, cfg.n_kv_heads, cfg.head_dim
    g_, pmax, n_pages = cfg.n_heads // kvh, ATTN_PMAX, ATTN_POOL
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn((n_pages, kvh, page, d), generator=gen, device=dev)
    v = torch.randn((n_pages, kvh, page, d), generator=gen, device=dev)
    pages = compress_kv_pages(k, v)
    q = torch.randn((b, kvh, g_, d), generator=gen, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    pt = perm[:b * pmax].view(b, pmax).to(torch.int32).contiguous()
    lengths = torch.tensor(ATTN_LENGTHS, dtype=torch.int32, device=dev)
    return gen, q, pages, pt, lengths


def gathered_kv(pages, pt):
    """K/V dequantised and gathered through the table, [B, KVH, T, D]:
    what ``scaled_dot_product_attention`` is handed as a yardstick."""
    from repro_torch.kernels.ref import dequant_pages
    b, pmax = pt.shape
    _, kvh, page, d = pages.kd.shape
    kd = dequant_pages(pages.kd, pages.kb, pages.ks)[pt.long()]
    vd = dequant_pages(pages.vd, pages.vb, pages.vs)[pt.long()]
    return (kd.movedim(2, 1).reshape(b, kvh, pmax * page, d),
            vd.movedim(2, 1).reshape(b, kvh, pmax * page, d))


def phase_attention(dev, cfg, page: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        paged_attention_tail, paged_attention_tail_ref)
    gen, q, pages, pt, lengths = attn_inputs(dev, cfg, page, 3)
    b, kvh, g_, d = q.shape
    pmax = pt.shape[1]
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
    kg, vg = gathered_kv(pages, pt)
    kg, vg = torch.cat([kg, tk], 2), torch.cat([vg, tv], 2)
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


def phase_attention_pages(dev, cfg, page: int) -> dict:
    """3b: decode attention over pages only, driven through ``ops``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    _, q, pages, pt, lengths = attn_inputs(dev, cfg, page, 6)
    b, kvh, g_, d = q.shape
    args = (q, pages, pt, lengths)
    ops.reset_launches()
    got = ops.paged_attention(*args)
    launches = ops.LAUNCHES["paged_attention"]
    want = paged_attention_ref(*args)
    torch.cuda.synchronize()
    empty = lengths == 0
    if not (torch.allclose(got, want, atol=ATTN_ATOL, rtol=ATTN_RTOL,
                           equal_nan=True) and got[empty].isnan().all()
            and not got[~empty].isnan().any()):
        raise AssertionError("paged_attention differs from the plain "
                             "version (or NaN rows differ)")
    err = float((got - want)[~empty].abs().max())
    ms = cuda_time_ms(lambda: paged_attention(*args))
    plain_ms = cuda_time_ms(lambda: paged_attention_ref(*args))
    kg, vg = gathered_kv(pages, pt)
    pos = torch.arange(kg.shape[2], device=dev)
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
    lib_out = F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)
    lib_err = float((lib_out - want)[~empty].abs().max())
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask))
    keys = int(lengths.sum())
    nbytes = (q.numel() * 4 * 2 + keys * kvh * (2 * d + 16)
              + 4 * int(((lengths + page - 1) // page).sum()) + 4 * b)
    bms, by = bound(nbytes, 4.0 * g_ * d * kvh * keys)
    log(f"paged_attention: B={b} KVH={kvh} G={g_} D={d} page={page} "
        f"PMAX={pt.shape[1]}, lengths {ATTN_LENGTHS}; max abs err {err:.3e} "
        f"(tol {ATTN_ATOL} + {ATTN_RTOL}*|ref|), NaN rows equal; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
        f"(err {lib_err:.3e}), bound {bms:.4f} ms ({by}); {launches} "
        f"launch through ops")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention_tail.cu",
            "replaces": "src/repro/kernels/paged_attention.py:153",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms}


LONG_PMAX, LONG_POOL, LONG_SETS = 256, 2049, 4
LONG_LENGTHS = [4096, 4000, 3500, 4095, 2048, 3333, 4081, 17]


def phase_attention_long(dev, cfg, page: int) -> dict:
    """3c: ``paged_attention_tail`` at long context (B 8, PMAX 256, up to
    4096 tokens, a tail as in phase 3), timed over a rotation of
    LONG_SETS independent pools and tables (2049 pages, ~36 MB each), so
    that each call finds its pages cold in the 50 MB L2, as a serving
    step does across its layers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        paged_attention_tail, paged_attention_tail_ref)
    from repro_torch.kernels.ref import compress_kv_pages
    b, kvh, d = ATTN_B, cfg.n_kv_heads, cfg.head_dim
    g_, pmax = cfg.n_heads // kvh, LONG_PMAX
    gen = torch.Generator(device=dev).manual_seed(7)
    lengths = torch.tensor(LONG_LENGTHS, dtype=torch.int32, device=dev)
    tail_len = torch.tensor([1, 16, 7, 3, 16, 1, 9, 12], dtype=torch.int32,
                            device=dev)
    q = torch.randn((b, kvh, g_, d), generator=gen, device=dev)
    tk = torch.randn((b, kvh, page, d), generator=gen, device=dev)
    tv = torch.randn((b, kvh, page, d), generator=gen, device=dev)
    pos = torch.arange(pmax * page + page, device=dev)
    mask = torch.where(pos[None, :] < pmax * page,
                       pos[None, :] < lengths[:, None],
                       pos[None, :] - pmax * page < tail_len[:, None])
    mask = mask[:, None, None, :]
    sets, gathered, err, lib_err = [], [], 0.0, 0.0
    for _ in range(LONG_SETS):
        k = torch.randn((LONG_POOL, kvh, page, d), generator=gen, device=dev)
        v = torch.randn((LONG_POOL, kvh, page, d), generator=gen, device=dev)
        pages = compress_kv_pages(k, v)
        del k, v
        perm = torch.randperm(LONG_POOL - 1, generator=gen, device=dev) + 1
        pt = perm[:b * pmax].view(b, pmax).to(torch.int32).contiguous()
        args = (q, pages, pt, lengths, tk, tv, tail_len)
        got = paged_attention_tail(*args)
        want = paged_attention_tail_ref(*args)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, atol=ATTN_ATOL, rtol=ATTN_RTOL):
            raise AssertionError(
                f"paged_attention_tail at long context differs from the "
                f"plain version: max abs err {(got - want).abs().max()}")
        err = max(err, float((got - want).abs().max()))
        kg, vg = gathered_kv(pages, pt)
        kg, vg = torch.cat([kg, tk], 2), torch.cat([vg, tv], 2)
        lib_out = F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)
        lib_err = max(lib_err, float((lib_out - want).abs().max()))
        sets.append(args)
        gathered.append((kg, vg))
    pool_mb = sum(t.numel() * t.element_size() for t in sets[0][1]) / 1e6

    def rotate(fn, inputs):
        it = iter(range(1 << 30))
        return lambda: fn(*inputs[next(it) % LONG_SETS])

    ms = cuda_time_ms(rotate(paged_attention_tail, sets))
    plain_ms = cuda_time_ms(rotate(paged_attention_tail_ref, sets))
    library_ms = cuda_time_ms(rotate(
        lambda kg, vg: F.scaled_dot_product_attention(q, kg, vg,
                                                      attn_mask=mask),
        gathered))
    keys = int(lengths.sum() + tail_len.sum())
    nbytes = (q.numel() * 4 * 2 + int(lengths.sum()) * kvh * (2 * d + 16)
              + int(tail_len.sum()) * kvh * 2 * d * 4
              + 4 * int(((lengths + page - 1) // page).sum()) + 8 * b)
    bms, by = bound(nbytes, 4.0 * g_ * d * kvh * keys)
    log(f"paged_attention_tail long context: B={b} KVH={kvh} G={g_} D={d} "
        f"page={page} PMAX={pmax}, lengths {LONG_LENGTHS}, tail as phase 3; "
        f"timed over a rotation of {LONG_SETS} pools and tables of "
        f"{LONG_POOL} pages ({pool_mb:.1f} MB each, cold in the 50 MB L2); "
        f"max abs err {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa {library_ms:.4f} ms (err {lib_err:.3e}), bound "
        f"{bms:.4f} ms ({by}, {nbytes / 1e6:.2f} MB); kernel/bound "
        f"{ms / bms:.2f}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phases 2d, 2e: the tile codec
# ---------------------------------------------------------------------------

def cluster_tiles(n: int, t: int, gen, dev):
    """The sparse-cluster kind: half the elements near 50, half near 0."""
    import torch
    big = 50.0 + torch.randn((n, t), generator=gen, device=dev)
    x = torch.where(torch.rand((n, t), generator=gen, device=dev) < 0.5,
                    big, torch.randn((n, t), generator=gen, device=dev)
                    * 1e-2)
    x[:, 0] = big[:, 0]
    return x


def phase_tile_codec(dev, cfg) -> list[dict]:
    import torch
    from repro_torch.kernels.bdi_compress import (bdi_compress,
                                                  bdi_compress_ref,
                                                  edge_tiles)
    from repro_torch.kernels.bdi_decompress import (bdi_decompress,
                                                    bdi_decompress_ref)
    gen = torch.Generator(device=dev).manual_seed(7)
    # one layer's MLP up-projection in 128-wide tiles: the size of a
    # gradient bucket or a moment leaf of that layer
    n = cfg.d_model * cfg.d_ff // 128
    xm = torch.randn((n, 128), generator=gen, device=dev) * 0.02
    checked = 0
    for t, rows in ((128, n), (256, 4096), (512, 4096)):
        edge = torch.cat(list(edge_tiles(t).values())).to(dev)
        base = xm if t == 128 else torch.randn((rows, t), generator=gen,
                                               device=dev) * 3.0
        x = torch.cat([base, cluster_tiles(4096, t, gen, dev), edge])
        got = bdi_compress(x.contiguous())
        want = bdi_compress_ref(x)
        torch.cuda.synchronize()
        for name, a, b in zip(got._fields, got, want):
            if not torch.equal(bits(a), bits(b)):
                bad = (bits(a) != bits(b)).nonzero()[:5].tolist()
                raise AssertionError(f"bdi_compress (T={t}) {name} differs "
                                     f"from the plain version at {bad}")
        out, out_ref = bdi_decompress(got), bdi_decompress_ref(got)
        torch.cuda.synchronize()
        if not torch.equal(bits(out), bits(out_ref)):
            bad = (bits(out) != bits(out_ref)).nonzero()[:5].tolist()
            raise AssertionError(f"bdi_decompress (T={t}) differs from the "
                                 f"plain version at {bad}")
        if t == 128:
            err_c, err_d = max_abs_err(got, want), max_abs_err([out],
                                                               [out_ref])
        checked += x.shape[0]
    enc = bdi_compress(xm)
    ms_c = cuda_time_ms(lambda: bdi_compress(xm))
    # the generic instance (one warp a tile) at the same shape: the tiles 4
    # bytes off a 16-byte boundary, which the 128 instance does not take
    shifted = torch.empty(xm.numel() + 1, device=dev)[1:].view(xm.shape)
    shifted.copy_(xm)
    if not all(torch.equal(bits(a), bits(b))
               for a, b in zip(bdi_compress(shifted), enc)):
        raise AssertionError("bdi_compress: generic and 128 instances "
                             "differ")
    ms_gen = cuda_time_ms(lambda: bdi_compress(shifted))
    del shifted
    plain_c = cuda_time_ms(lambda: bdi_compress_ref(xm))
    ms_d = cuda_time_ms(lambda: bdi_decompress(enc))
    plain_d = cuda_time_ms(lambda: bdi_decompress_ref(enc))
    t = xm.shape[1]
    # compress: read x once; write deltas, the mask and 12 bytes a tile;
    # ~12 operations an element (sub, 2 abs, compare, select, 2 max, div,
    # round, 2 clamp, pack).  decompress: the reverse bytes; 2 mul, add.
    b_c, by_c = bound(n * t * 4 + n * t + n * t // 8 + 12 * n, 12.0 * n * t)
    b_d, by_d = bound(n * t + n * t // 8 + 8 * n + n * t * 4, 3.0 * n * t)
    log(f"bdi_compress: {n} tiles x {t} (one yi-6b MLP up-projection, "
        f"{n * t * 4 / 1e6:.0f} MB) + 4096 sparse-cluster + edge tiles, and "
        f"rows of 256 and 512 ({checked} tiles) bit-equal; kernel "
        f"{ms_c:.4f} ms, plain {plain_c:.4f} ms, bound {b_c:.4f} ms ({by_c})"
        f"; {ms_c * 1e3:.1f} us a call, {ms_c * 1e6 / (n * t):.4f} ns an "
        f"element; generic instance (one warp a tile) {ms_gen:.4f} ms")
    log(f"bdi_decompress: the same encodings bit-equal; kernel {ms_d:.4f} "
        f"ms, plain {plain_d:.4f} ms, bound {b_d:.4f} ms ({by_d}); "
        f"{ms_d * 1e3:.1f} us a call, {ms_d * 1e6 / (n * t):.4f} ns an "
        f"element")
    common = {"route": "cuda", "library_ms": None}
    return [dict(common, name="bdi_compress",
                 source="src/repro_torch/csrc/bdi_compress_tile.cu",
                 replaces="src/repro/kernels/bdi_compress.py:151",
                 max_abs_err=err_c, ms=ms_c, plain_ms=plain_c, bound_ms=b_c,
                 bound_by=by_c),
            dict(common, name="bdi_decompress",
                 source="src/repro_torch/csrc/bdi_decompress_tile.cu",
                 replaces="src/repro/kernels/bdi_decompress.py:55",
                 max_abs_err=err_d, ms=ms_d, plain_ms=plain_d, bound_ms=b_d,
                 bound_by=by_d)]


# ---------------------------------------------------------------------------
# phase 6: the tile path end to end
# ---------------------------------------------------------------------------

def param_slices(params: dict):
    """Every parameter leaf; stacked block leaves one layer at a time."""
    for key, sub in params.items():
        for leaf in _leaves(sub) if isinstance(sub, dict) else [sub]:
            if key == "blocks":
                yield from leaf.unbind(0)
            else:
                yield leaf


def phase_tile_path(dev, params: dict) -> dict:
    import torch
    from repro_torch.core import bdi_value as bv
    from repro_torch.kernels import ops
    from repro_torch.launch import quickstart
    slices = list(param_slices(params))
    nbytes = sum(x.numel() * x.element_size() for x in slices)
    ops.roundtrip_tensor(slices[0])                  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    for x in slices:
        ops.roundtrip_tensor(x)
    torch.cuda.synchronize()
    t_rt = time.perf_counter() - t0
    mix = torch.zeros(3, dtype=torch.int64, device=dev)
    size = torch.zeros((), dtype=torch.int64, device=dev)
    n_tiles = 0
    for x in slices:
        tiles, n = bv.fold_to_tiles(x)
        p = ops.compress(tiles)
        out = ops.decompress(p)
        if not bool(((tiles.float() - out).abs() <= 0.5 * p.scale).all()):
            raise AssertionError(f"a tile of a {tuple(x.shape)} leaf is off "
                                 "by more than scale/2")
        xhat = ops.roundtrip_tensor(x)
        if not torch.equal(xhat, bv.unfold_from_tiles(out, n, x.shape)
                           .to(x.dtype)):
            raise AssertionError("roundtrip_tensor differs from compress + "
                                 "decompress")
        mix += torch.bincount(p.enc[:, 0].long(), minlength=3)[:3]
        size += bv.tile_size_bytes(p.enc[:, 0], tiles.shape[1], 2).sum()
        n_tiles += tiles.shape[0]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    qs = quickstart.main(dev)
    launches = {k: ops.LAUNCHES[k] for k in ("bdi_compress",
                                             "bdi_decompress")}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the tile "
                                 f"path: {dict(ops.LAUNCHES)}")
    mix = mix.tolist()
    res = {"leaves": len(slices), "params": sum(x.numel() for x in slices),
           "tiles": n_tiles, "param_bytes": nbytes,
           "roundtrip_s": t_rt, "roundtrip_gb_s": nbytes / t_rt / 1e9,
           "tile_mix": {"zero": mix[0], "rep": mix[1], "d8": mix[2]},
           "compression_ratio_bf16": n_tiles * 128 * 2 / int(size),
           "peak_mem_gb": peak, "launches": launches,
           "quickstart": {k: v for k, v in qs.items() if k != "ec"}}
    log(f"tile path: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phases 4, 4b, 4c: serve yi-6b at full width
# ---------------------------------------------------------------------------

def ragged_prompts(n: int, lo: int, hi: int, vocab: int, seed: int):
    import torch
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
    return {i: torch.randint(1, vocab, (ln,), generator=g).tolist()
            for i, ln in enumerate(lens)}


def pool_for(cfg, prompts: dict, steps: int, page: int) -> int:
    """Pool pages so the requests never preempt (+1: id 0 is padding)."""
    return 1 + cfg.n_layers * sum(-(-(len(p) + steps) // page)
                                  for p in prompts.values())


def phase_serve(dev, cfg, params, page: int, *, codec: str, prompts: dict,
                gen: int, n_pool: int, need: tuple[str, ...],
                forbid: tuple[str, ...] = ()) -> dict:
    """Serve ``prompts`` for ``gen`` decode steps under ``codec``; the
    kernels in ``need`` must have launched in this run, those in
    ``forbid`` not."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import PagedKVEngine
    # warm-up on a small engine (cuBLAS heuristics, allocator), not timed
    warm = PagedKVEngine(cfg, params, page_size=page, n_pool_pages=257,
                         max_batch=8, codec=codec, device=dev)
    warm.add_requests({0: prompts[0][:40], 1: prompts[1][:20]})
    for _ in range(17):
        warm.decode_batch()
    del warm
    torch.cuda.empty_cache()

    eng = PagedKVEngine(cfg, params, page_size=page, n_pool_pages=n_pool,
                        max_batch=8, codec=codec, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.add_requests(prompts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches_prefill = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    for _ in range(gen):
        eng.decode_batch()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for name in need:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched serving "
                                 f"{codec}: {launches}")
    for name in forbid:
        if launches[name]:
            raise AssertionError(f"kernel {name} launched serving {codec}: "
                                 f"{launches}")
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
        raise AssertionError(f"non-finite logits at full width ({codec})")
    names = getattr(eng.codec, "member_names", (eng.codec.name,))
    pids = [p for s in eng.seqs.values() for lp in s.pages for p in lp]
    tags = eng.page_codec_id[pids].tolist()
    n_prompt = sum(len(p) for p in prompts.values())
    res = {"codec": codec, "prompt_tokens": n_prompt, "prompt_lens":
           [len(p) for p in prompts.values()], "decode_steps": gen,
           "n_pool_pages": n_pool,
           "prefill_s": t_prefill, "prefill_tok_s": n_prompt / t_prefill,
           "decode_s": t_decode, "decode_tok_s": 8 * gen / t_decode,
           "decode_ms_per_step": 1e3 * t_decode / gen,
           "kv_compression_ratio": eng.compression_ratio(), "stats": st,
           "page_codec_mix": {names[t]: tags.count(t)
                              for t in sorted(set(tags))},
           "launches": launches, "launches_prefill": launches_prefill,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    log(f"serve {codec}: {json.dumps(res)}")
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
# phases 5, 5b: cross-device parity at small depth
# ---------------------------------------------------------------------------

def _host_state(eng) -> dict:
    return {"stats": dict(eng.stats), "pmax": eng._pmax,
            "page_table": eng._page_table().cpu().tolist(),
            "free": list(eng.free), "codec_ids": eng.page_codec_id.tolist(),
            "request_bytes": {k: list(v)
                              for k, v in sorted(eng.request_bytes.items())}}


def _assert_same_host_state(gpu, cpu) -> None:
    """Exactly equal, but for byte counts of a codec whose sizes read
    exact bits: 8 bytes a page (stats) and 64 a request."""
    a, b = _host_state(gpu), _host_state(cpu)
    if not gpu.codec.ulp_stable_sizes:
        ab, bb = a["stats"].pop("bytes_compressed"), \
            b["stats"].pop("bytes_compressed")
        if abs(ab - bb) > 8 * max(a["stats"]["pages_compressed"], 1):
            raise AssertionError(f"bytes_compressed {ab} vs {bb}")
        ra, rb = a.pop("request_bytes"), b.pop("request_bytes")
        if ra.keys() != rb.keys() or any(
                ra[k][0] != rb[k][0] or abs(ra[k][1] - rb[k][1]) > 64
                for k in ra):
            raise AssertionError(f"request_bytes {ra} vs {rb}")
    for key in a:
        if a[key] != b[key]:
            raise AssertionError(f"{gpu.codec.name}: {key} differs across "
                                 f"devices: {a[key]} vs {b[key]}")


def phase_parity(dev, cfg, page: int, lo: int, hi: int, steps: int,
                 codec: str = "bdi", init_on: str = "cpu") -> dict:
    """Greedy parity of the engine on ``dev`` and on the CPU; the weights
    come from a seeded generator on ``init_on`` (the card for a model whose
    CPU init would take long)."""
    import torch
    from repro_torch.models.params import to_device
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.parity import GreedyParity, engine_logits
    params = init_params(cfg, torch.Generator(device=init_on).manual_seed(0),
                         init_on)
    prompts = ragged_prompts(8, lo, hi, cfg.vocab, seed=4)
    n_pool = pool_for(cfg, prompts, steps, page)
    gpu, cpu = (PagedKVEngine(cfg, to_device(params, torch.device(d)),
                              page_size=page, n_pool_pages=n_pool,
                              max_batch=8, codec=codec, device=d)
                for d in (dev, "cpu"))
    for e in (gpu, cpu):
        e.add_requests(prompts)
    _assert_same_host_state(gpu, cpu)
    parity = GreedyParity()
    for step in range(steps):
        want, got = cpu.decode_batch(), gpu.decode_batch()
        parity.check(step, want, got, engine_logits(gpu),
                     engine_logits(cpu))
    _assert_same_host_state(gpu, cpu)
    res = {"codec": codec, "config": cfg.name, "d_model": cfg.d_model,
           "steps": steps, "tokens_equal": parity.compared,
           "bytes_compressed": [gpu.stats["bytes_compressed"],
                                cpu.stats["bytes_compressed"]],
           "ties": [vars(t) for t in parity.ties]}
    log(f"parity {codec} {cfg.name} d_model={cfg.d_model}: "
        f"{json.dumps(res)}")
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
    for line in ptxas_report(build_log):
        log(f"  {line}")

    from repro_torch.models.transformer import init_params
    from repro_torch.serving._tree import tree_leaves
    cfg = get_arch("yi-6b")
    page = 16

    def phase_done(name: str) -> None:
        nonlocal t0
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    phase_done("1 build")
    kernels = [phase_compress(dev, cfg, page)]
    phase_done("2 bdi_compress_kv")
    kernels += phase_gbdi(dev, cfg, page)
    phase_done("2b/2c gbdi_compress_kv, gbdi_decompress_kv")
    kernels += phase_tile_codec(dev, cfg)
    phase_done("2d/2e bdi_compress, bdi_decompress")
    kernels.append(phase_attention(dev, cfg, page))
    phase_done("3 paged_attention_tail")
    kernels.append(phase_attention_pages(dev, cfg, page))
    phase_done("3b paged_attention")
    phase_attention_long(dev, cfg, page)
    phase_done("3c paged_attention_tail at long context")
    for gpage in (16, 32):
        phase_attention(dev, get_arch("gemma3-27b"), gpage)
    phase_done("3d paged_attention_tail at gemma3-27b's D 168, pages 16 "
               "and 32")

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    log(f"yi-6b params: {sum(t.numel() for t in _leaves(params)) / 1e9:.3f}"
        f" B on {dev}")
    from repro_torch import codecs
    per_pid = {name: sum(t.numel() * t.element_size() for t in tree_leaves(
        codecs.get(name).init_pools(1, 1, cfg.n_kv_heads, page,
                                    cfg.head_dim, "cpu")))
               for name in codecs.available()}
    log(f"pool bytes per (layer, pid) at yi-6b widths: {json.dumps(per_pid)}")
    long = ragged_prompts(8, 300, 512, cfg.vocab, seed=1)
    bdi = phase_serve(dev, cfg, params, page, codec="bdi", prompts=long,
                      gen=64, n_pool=10240,
                      need=("bdi_compress_kv", "paged_attention_tail"))
    phase_done("4 serve bdi")
    gbdi = phase_serve(dev, cfg, params, page, codec="gbdi", prompts=long,
                       gen=64, n_pool=10240,
                       need=("gbdi_compress_kv", "gbdi_decompress_kv"),
                       forbid=("paged_attention_tail",))
    phase_done("4b serve gbdi")
    short = ragged_prompts(8, 100, 200, cfg.vocab, seed=5)
    phase_serve(dev, cfg, params, page, codec="adaptive", prompts=short,
                gen=32, n_pool=pool_for(cfg, short, 32, page),
                need=("bdi_compress_kv", "gbdi_compress_kv",
                      "gbdi_decompress_kv"),
                forbid=("paged_attention_tail",))
    phase_done("4c serve adaptive")
    tile = phase_tile_path(dev, params)
    phase_done("6 tile path (every yi-6b leaf, quickstart)")
    del params
    torch.cuda.empty_cache()
    # launches of the path that ran each kernel (3b set its own)
    path = {"bdi_compress_kv": bdi, "paged_attention_tail": bdi,
            "gbdi_compress_kv": gbdi, "gbdi_decompress_kv": gbdi,
            "bdi_compress": tile, "bdi_decompress": tile}
    for k in kernels:
        if k["name"] in path:
            k["launches"] = path[k["name"]]["launches"][k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on its path")

    tiny = cfg.reduced(n_layers=2)
    wide = cfg.reduced(n_layers=2, d_model=cfg.d_model, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                       vocab=cfg.vocab)
    phase_parity(dev, tiny, page, 20, 140, 24)
    phase_parity(dev, wide, page, 20, 140, 24)
    phase_done("5 parity bdi")
    for codec in ("zero", "raw", "fpc", "gbdi", "adaptive"):
        phase_parity(dev, tiny, page, 20, 140, 24, codec)
    for codec in ("gbdi", "adaptive"):
        phase_parity(dev, wide, page, 20, 140, 24, codec)
    phase_done("5b parity zero/raw/fpc/gbdi/adaptive")
    gemma = get_arch("gemma3-27b")
    gemma_wide = gemma.reduced(n_layers=2, d_model=5376, n_heads=32,
                               n_kv_heads=16, d_ff=21504, vocab=262144)
    log("5c: gemma3-27b at full width, 2 layers: 8 prompts of 16-48 tokens "
        "and 8 decode steps (phase 5: 20-140 and 24), weights made on the "
        "card, so that the CPU engine stays within the time limit")
    phase_parity(dev, gemma_wide, page, 16, 48, 8, init_on=dev.type)
    phase_done("5c parity bdi gemma3-27b")

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
