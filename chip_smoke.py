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
     (gbdi and adaptive also at full width, 2 layers, 12 decode steps);
     byte counts of fpc and adaptive, which read exact bits, within 8 per
     page (stats) and 64 per request;
  5c. ``gemma3-27b`` at full width and 2 layers under ``bdi`` (D 168,
     G 2: the attention kernel's generic instance), cuda vs cpu greedy
     parity, with shorter prompts and fewer steps than phase 5 (its CPU
     engine reads 7.4 GB of bf16 weights a step);
  6. the tile path end to end: ``ops.roundtrip_tensor`` over every
     parameter leaf of full-width yi-6b (phase 4's weights, stacked
     leaves a layer at a time), |x - x_hat| <= scale/2 per tile, the
     tile-class mix, compression ratio, GB/s and peak memory; then the
     quickstart twin (``repro_torch.launch.quickstart``) on the card;
     both tile kernels must have launched;
  7. continuous batching with the SIP prefix cache: yi-6b at full width
     (phase 4's weights) under ``bdi``, page 16, chunk 32, batch 8,
     token budget 256, through ``ContinuousScheduler`` with a
     ``PrefixCache``: 16 requests share a 384-token system prompt and add
     32-128 tokens of their own (seed 7), 32 new tokens each; wave 1 (8
     requests) arrives every 2 iterations, wave 2 once every wave-1
     request has finished its prefill, and is admitted as wave 1
     retires.  Every wave-2 request must start from >= 384 cached tokens,
     the cache's hit rate be > 0, the row codec and the attention kernel
     have launched, no request be preempted; prints ms an iteration,
     tok/s, TTFT in iterations, the prefill tokens hits skipped and the
     KV ratio;
  7b. the same 16 requests without the prefix cache: every request's
     tokens equal phase 7's up to reported one-bf16-ULP ties, at most
     four;
  7c. cross-device parity through the scheduler at depth 2
     (``phase_parity(scheduler=True)``): prompts sharing a prefix on a
     pool small enough that SIP evicts retained entries; finish reasons,
     first-token and finish iterations, scheduler and engine stats and
     the cache's state (eviction order, hit rate) equal after every
     iteration, tokens equal up to ties; under ``bdi`` and ``gbdi``;
  8. multi-turn from the host tier: one conversation through a
     prefix-cached engine that caches decode pages, with a 64 MB
     ``TieredPageStore`` (yi-6b full width, phase 4's weights, bdi, page
     16, chunk 32): a 1024-token opening prompt (seed 11), 3 turns of 32
     new tokens plus 8 fresh user tokens, ``recycle_device_pool()``
     between turns, so turns 2-3 promote their history from host RAM;
     then again with 8 MB of host RAM and a disk arena, so records spill
     and promote from disk.  Per turn: TTFT (synchronised), cached
     tokens (equal to the count rehearsed on the CPU), demotions,
     promotions, spills, bytes to and from the host; tokens equal a
     tierless run fed the same prompts up to reported ties;
  8b. phase 7's warm workload snapshotted (``save_snapshot`` with the
     scheduler) at the first iteration with every request submitted,
     decodes in flight and no cohort, finished, restored into a fresh
     engine and scheduler on the card and finished again: exactly equal
     tokens; raw and stored bytes, save and restore seconds;
  8c. phase 7's warm workload under a fault schedule (page corruption,
     garbage tokens, a free-list hold): every request ends eos/length,
     a corruption is detected and a request restarted, the injector's
     log printed, tokens equal phase 7's up to reported ties;
  8d. at depth 2 under bdi and gbdi: a scheduler snapshot written on the
     card restores on the CPU and both finish with equal tokens and host
     state; a tier persisted on the card restores on the CPU with the
     same bytes, records and checksums, and promotes the same pages.
     Every phase 8 run ends with ``debug_validate``.
  9. the observatory: phase 7's warm workload (bdi, phase 7's pool)
     without and with an ``Observatory`` in turns (off, on, on, off):
     every run's tokens, engine stats and scheduler stats exactly phase
     7's (a pure observer); ms an iteration of each beside phase 7's
     and the host ms spent inside the observatory's hooks, the joint
     size-bin x reuse-distance table, shadow hit rates per policy and
     audit counts; then the same workload under
     ``adaptive`` on a pool of 104 page boundaries (3329 ids, 29.9 GB at
     281 KB a layer and id), tight enough that SIP evicts retained
     entries (each audited) and loose enough that nothing is preempted:
     every published page's five member sizes recorded, the registry and
     audit log exported (Prometheus text,
     metrics JSONL, audit JSONL) and rendered by
     ``repro_torch.launch.observe``;
  9b. the oracle on the card: yi-6b at full width, 2 layers, 4 requests
     on a shared two-page prefix, 16 new tokens each, through the batched
     scheduler and through ``make_reference_scheduler`` over
     ``ReferencePagedKVEngine(device="cuda")`` (pools on the host), under
     bdi and gbdi: tokens equal up to reported ties; stats, tracks and the
     allocation-order-free host state equal every iteration; ms a token of
     each;
  9c. at depth 2 under adaptive: an engine with an observatory
     snapshotted on the card restores on the CPU with the observatory's
     state and registry series exactly equal;
  10. training: ``launch.train.train("yi-6b", smoke=False, steps=8,
     seq_len=128, batch=8, moment_dtype="bdi8")`` at full width (random
     init from a seed, the synthetic stream): every loss finite, both
     tile kernels launched by the optimizer's moment stores and loads;
     ms a step (forward+backward, optimizer), tokens/s, model TFLOP/s
     (6N and 8N a token), the mask layout conversion of the whole state
     at a checkpoint (export and import, round trip checked),
     peak memory, ``opt_state_bytes`` of the four moment dtypes at full
     depth (``adamw_init`` over meta tensors), and the share of elements
     whose stored v is 0 while m is not (bdi8 rounds v to 0 below half a
     tile step; such an element moves by lr * m / eps, so the reference
     algorithm's loss can jump); then the same 8 steps under bf16
     moments, whose last loss must be below the first;
  10b. full width at 2 layers, 8 steps under f32, bf16, bdi8 and q8 from
     the same params and batches: loss trajectories, the bdi8 - f32 gap,
     ms a step, peak memory; the tile kernels launch under bdi8 only;
  10c. card vs CPU at the reduced config and at d_model 256 under f32
     and bdi8: the first loss (rtol 1e-4) and 10 steps' losses (f32 rtol
     2e-3; bdi8 1e-2 reduced, 3e-2 at d_model 256), then one step on the
     card from the CPU run's step-9 state against the CPU's step 10 (params
     within one bf16 ULP for 99% of each leaf, each loaded moment leaf
     within a relative error of 2e-2, as ``tests/test_torch_train.py``);
     restart continuity on the card (f32, rtol 1e-5, and whether two runs
     give the same bits); one moment leaf
     of 10b's bdi8 state through both tile kernels and their plain
     versions, bit-equal;
  10d. the training twins on the card: ``launch.train_lm`` (yi-100m, 50
     steps, bdi8, a checkpoint every 50, loss drop > 0.5) and
     ``launch.compressed_checkpointing`` (resume at step 30 from the
     trained state);
  11. dense decode, the path of ``launch.serve.generate(paged=False)``:
     yi-6b at full width, batch 8, 512-token prompts, 64 new tokens
     (prefill ms, decode ms a step, tok/s, the bf16 cache's bytes, peak
     memory); the same prefill's K/V in the BDI-quantised cache, 16
     steps of ``decode_step_quant`` fed the dense run's tokens (its bytes,
     ms a step, share of equal tokens); the same prompts through
     ``PagedKVEngine`` under bdi (first tokens equal up to reported ties,
     the share of equal tokens printed: int8 KV is lossy);
  11b. full width, 2 layers, card vs CPU: dense greedy tokens equal up to
     ties; ``decode_step_quant`` fed the same tokens: logits within 4 bf16
     ULPs of the largest, a (token, head) row whose base and scale agree
     has deltas at most one step apart (those on a rounding boundary,
     counted), every dequantised value within two steps;
  11c. gemma3-27b at full width, 6 layers (5 local rings of 1024 slots,
     then 1 global): batch 2, a 1100-token prompt (the rings wrap), 16
     decode steps fed the sequence; each step's logits against
     ``forward``'s at the same position: argmax equal up to ties, the
     worst gap printed and within ``tests/test_models.py``'s 2e-2;
  11d. deepseek-v2-lite-16b at full width, 27 layers (MLA + 64 experts,
     capacity factor 1.25): batch 4, 256-token prompts, 32 new tokens;
     a second run counts the (token, choice) pairs the capacity drops
     and must give the same tokens; then at 2 layers, dropless, card vs
     CPU: tokens equal up to ties, and every expert choice the card made
     equal to the CPU's on the same router input but for reported
     near-ties;
  11e. arctic-480b at full width, 1 layer (128 experts, dense residual
     FFN): batch 2, 64-token prompts, 8 new tokens, finite logits, the
     same tokens twice;
  11f. deepseek-v2-lite-16b at full width, 4 layers, trained 4 steps of 4
     x 128 tokens under bf16 moments: finite losses, the last below the
     first; ms a step and peak memory;
  12. xlstm-350m at full width and depth (24 layers, sLSTM at 7, 15,
     23) through ``generate(smoke=False)``: batch 8, 256-token prompts
     (prefill is one decode step a token), 64 new tokens (prefill ms,
     decode ms a step, tok/s, cache bytes, peak memory); one decode step
     and one sLSTM time scan (4 x 128) profiled: kernels and copies run,
     device ms;
  12b. hymba-1.5b at full width and depth (32 layers, global 0, 15, 31):
     batch 2, 1100-token prompts (the 1024-slot rings wrap), 16 new
     tokens; prefill and 16 decode steps fed a sequence against
     ``forward`` (argmax equal up to ties, each row's gap recorded); one
     decode step and layer 0's Mamba time scan, sequential and chunked,
     profiled;
  12c. seamless-m4t-large-v2 at full width and depth (24 + 24 layers):
     batch 4, 256 frames and 256 prompt tokens, 32 new tokens; a second
     run gives the same tokens, finite logits; one decode step profiled;
  12d. each of the three at full width, 2 layers (seamless 2 + 2), card
     vs CPU on the same params, prompts and frames: greedy tokens equal
     up to reported ties, prefill logits within 4 bf16 ULPs of the
     largest;
  12e. ``train()`` at full width, 4 steps of 4 x 128 under bf16 moments:
     xlstm-350m at full depth, hymba at 4 layers, seamless at 4 + 4;
     finite, falling losses, ms a step, peak memory.
     Phases 12-12e assert that none of the seven kernels launched.
  13. the distributed layer's main path, compressed DP training: yi-6b
     at full width and depth on a one-rank NCCL mesh
     (``launch.mesh.make_host_mesh(1, 1)``; on one card the all-gather
     and all-reduce are copies), ``compress_comm.make_dp_train_step``
     with bdi8 moments, 4 steps of 8 x 128 from phase 10's stream and
     init: the EC plan (``plan_compression``) from step 1's gradients
     (seconds, leaves and bytes it ships compressed), then the 4 steps
     compressed (every leaf, as ``benchmarks/bench_collectives.py``) and
     raw (``compress=False``) from the same init and batches: both loss
     trajectories and the last gap, wire bytes a step raw against
     compressed, ms a step split into forward+backward, all-reduce and
     update, peak memory, the residual's norm relative to the
     gradient's; both tile kernels must launch inside the all-reduce
     (counted apart from the optimizer's), every loss be finite;
  13b. full width, 1 layer: ``tree_all_reduce`` of one set of gradients
     and residuals on the card (NCCL, the tile kernels) and on the CPU
     (gloo, the plain versions): means and residuals bit-equal; one
     compressed DP step (the EC plan, f32 moments) from one state on
     both: params within one bf16 ULP for >= 99% of each leaf;
  13c. deepseek-v2-lite-16b at full width, 4 layers, through
     ``dense_generate`` under ``use_mesh(make_host_mesh(1, 1))`` (MoE's
     expert-parallel path) and without a mesh: tokens and logits
     bit-equal;
  13d. phase 13b's model saved with ``store.save`` and restored with
     ``launch.elastic.restore_elastic`` onto a one-rank mesh on the card:
     every leaf a DTensor on the mesh, bit-equal; ``reshard_plan`` of
     yi-6b at full width, (16, 16) -> (2, 2): leaves flagged, the
     largest growth;
  14. the dry run (``repro_torch.launch.dryrun``) against the card: one
     yi-6b train step at full width and depth (bf16 moments, 8 x 128 in
     2 microbatches, bf16 accumulation: with f32 the allocator's
     fragmentation left it out of memory at 67.8 GiB allocated of 79.2)
     traced on ``meta`` at mesh (1, 1),
     then built and run on the card under ``FlopCounterMode``, and once
     more plain: FLOPs equal, argument bytes within the allocator's 512
     bytes a tensor, the predicted peak (arguments + temp) not under
     either measured peak by more than 10%; both gaps logged;
  14b. the dry run's CLI in three processes, started after phase 1 (they
     need no card): xlstm-350m long_500k, yi-6b train_4k, and the same
     with ``--multi-pod``; each exits 0 with 256 (512) devices and
     positive traced FLOPs; its row is logged.
     No kernel launches in phases 14-14b.

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
TRAIN_LM_STEPS = 50                 # phase 10d (the twin's default is 200)
WIDE_5B_STEPS = 12                  # phase 5b at full width (5: 24)
ALLOC_ROUND = 512                   # the caching allocator's block unit
DRYRUN_CELLS = (("xlstm-350m", "long_500k", False),
                ("yi-6b", "train_4k", False), ("yi-6b", "train_4k", True))
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
                 codec: str = "bdi", init_on: str = "cpu",
                 scheduler: bool = False) -> dict:
    """Greedy parity of the engine on ``dev`` and on the CPU; the weights
    come from a seeded generator on ``init_on`` (the card for a model whose
    CPU init would take long).  ``scheduler=True`` drives both engines
    through ``ContinuousScheduler`` with a prefix cache instead
    (:func:`parity_scheduler`)."""
    import torch
    from repro_torch.models.params import to_device
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.parity import GreedyParity, engine_logits
    params = init_params(cfg, torch.Generator(device=init_on).manual_seed(0),
                         init_on)
    if scheduler:
        return parity_scheduler(dev, cfg, params, page, lo, hi, steps, codec)
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


# ---------------------------------------------------------------------------
# phases 7, 7b, 7c: continuous batching with the SIP prefix cache
# ---------------------------------------------------------------------------

def shared_prefix_requests(n: int, prefix: int, lo: int, hi: int,
                           vocab: int, seed: int) -> dict:
    """``n`` prompts: one ``prefix``-token system prompt, then lo..hi
    tokens of each request's own."""
    import torch
    g = torch.Generator().manual_seed(seed)
    sysp = torch.randint(1, vocab, (prefix,), generator=g).tolist()
    own = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
    return {r: sysp + torch.randint(1, vocab, (k,), generator=g).tolist()
            for r, k in enumerate(own)}


def drive_waves(scheds: list, reqs: dict, gen: int, on_step=None,
                stagger: int = 2, max_iters: int = 4000) -> None:
    """Drive schedulers in lockstep: the first half of ``reqs`` arrives
    every ``stagger`` iterations, the second half at once when every
    first-half request has finished its prefill (or retired before it),
    to be admitted as the first half retires.  ``on_step(events)`` sees
    each iteration's events."""
    n1 = len(reqs) // 2
    arrivals = {r: stagger * r for r in range(n1)}
    wave2 = False
    lead = scheds[0]
    while arrivals or not wave2 or not lead.idle:
        if lead.iteration >= max_iters:
            raise AssertionError(f"not drained after {max_iters} iterations")
        due = [r for r, at in arrivals.items() if at <= lead.iteration]
        if not wave2 and not arrivals and all(
                lead.tracks[r].prefill_done_iter is not None
                or lead.tracks[r].state == "finished" for r in range(n1)):
            due, wave2 = list(range(n1, len(reqs))), True
        for r in due:
            arrivals.pop(r, None)
            for sc in scheds:
                sc.submit(r, reqs[r], max_new_tokens=gen)
        events = [sc.step() for sc in scheds]
        if on_step is not None:
            on_step(events)


def capture_logits(eng) -> list:
    """Keep every engine step's logits rows by request and output
    position: ``rows[(rid, k)]`` is the row that chose request ``rid``'s
    k-th token (for tie reports)."""
    rows, pos = {}, {}
    inner = eng.mixed_step

    def mixed_step(*a, **kw):
        out, completed = inner(*a, **kw)
        if out:
            lg = eng.last_logits.clone()
            for rid in out:
                k = pos.get(rid, 0)
                rows[(rid, k)] = lg[eng.seqs[rid].slot]
                pos[rid] = k + 1
        return out, completed

    eng.mixed_step = mixed_step
    return rows


def compare_requests(want: dict, got: dict, want_rows: dict,
                     got_rows: dict):
    """Per-request greedy parity of two runs whose schedules differ:
    position k of every request is one parity step."""
    from repro_torch.serving.parity import GreedyParity
    parity = GreedyParity()
    for k in range(max(len(t) for t in want.values())):
        w = {r: t[k] for r, t in want.items() if k < len(t)}
        g = {r: got[r][k] for r in w}
        parity.check(k, w, g, lambda r: got_rows[(r, k)],
                     lambda r: want_rows[(r, k)])
    return parity


SCHED_PREFIX, SCHED_OWN, SCHED_GEN, SCHED_N = 384, (32, 128), 32, 16
# warm and cold prefill run GEMMs of other row counts and offsets on the
# card, so a one-bf16-ULP tie may flip a token; more than a handful of
# them over 512 tokens would point at a fault, not at ties
SCHED_MAX_TIES = 4


def phase_scheduler(dev, cfg, params, page: int) -> tuple:
    """7 and 7b: the scheduler with and without the prefix cache at full
    width under bdi (see the module docstring).  Returns phase 7's result,
    tokens and logits rows (phase 8c's reference)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.serving.telemetry import Telemetry
    reqs = shared_prefix_requests(SCHED_N, SCHED_PREFIX, *SCHED_OWN,
                                  cfg.vocab, seed=7)
    # every request's pages as if none were shared: neither run evicts
    # or preempts (the cold one holds the prefix once a request)
    n_pool = pool_for(cfg, reqs, SCHED_GEN, page)
    runs = {}
    for name, cached in (("7 warm", True), ("7b cold", False)):
        tel = Telemetry()
        cache = PrefixCache.for_model(cfg, page) if cached else None
        eng = PagedKVEngine(cfg, params, page_size=page, n_pool_pages=n_pool,
                            max_batch=8, prefill_chunk=32, prefix_cache=cache,
                            codec="bdi", telemetry=tel, device=dev)
        sched = ContinuousScheduler(eng, token_budget=256, telemetry=tel)
        rows = capture_logits(eng)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        drive_waves([sched], reqs, SCHED_GEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        fin = sched.finished()
        st, est = sched.stats, eng.stats
        toks = {r: fin[r].out_tokens for r in reqs}
        reasons = [str(t.finish_reason) for t in fin.values()]
        if set(reasons) != {"length"} or est["preemptions"] or any(
                len(t) != SCHED_GEN or not all(0 <= x < cfg.vocab for x in t)
                for t in toks.values()):
            raise AssertionError(f"phase {name}: finish reasons {reasons}, "
                                 f"stats {est}")
        if not torch.isfinite(eng.last_logits.float()).all():
            raise AssertionError(f"phase {name}: non-finite logits")
        for k in ("bdi_compress_kv", "paged_attention_tail"):
            if launches[k] <= 0:
                raise AssertionError(f"phase {name}: kernel {k} never "
                                     f"launched: {launches}")
        ttft = sched._h_ttft_it
        res = {"card": smi(), "requests": SCHED_N,
               "prompt_lens": [len(p) for p in reqs.values()],
               "n_pool_pages": n_pool, "iterations": sched.iteration,
               "wall_s": wall, "ms_per_iteration": 1e3 * wall /
               sched.iteration,
               "tok_s": st["decode_tokens"] / wall,
               "ttft_iters_p50": ttft.quantile(0.5),
               "ttft_iters_p99": ttft.quantile(0.99),
               "ttft_iters": [fin[r].first_token_iter - fin[r].submitted_iter
                              for r in reqs],
               "cached_tokens": [fin[r].pf_start for r in reqs],
               "prefill_tokens": st["prefill_tokens"],
               "prefix_cached_tokens": st["prefix_cached_tokens"],
               "mixed_iterations": st["mixed_iterations"],
               "kv_compression_ratio": eng.compression_ratio(),
               "engine_stats": est, "sched_stats": dict(st),
               "launches": launches}
        if cached:
            wave2 = res["cached_tokens"][SCHED_N // 2:]
            if min(wave2) < SCHED_PREFIX or cache.hit_rate() <= 0:
                raise AssertionError(f"phase 7: wave 2 cached {wave2}, hit "
                                     f"rate {cache.hit_rate()}")
            res["hit_rate"] = cache.hit_rate()
            res["cache_stats"] = dict(cache.stats)
        log(f"phase {name}: {json.dumps(res)}")
        runs[name] = (res, toks, rows)
        del eng, sched, cache
        torch.cuda.empty_cache()
    (warm, wtoks, wrows), (cold, ctoks, crows) = runs["7 warm"], \
        runs["7b cold"]
    parity = compare_requests(ctoks, wtoks, crows, wrows)
    log(f"phase 7b: warm vs cold tokens, {parity.compared} equal, "
        f"{len(parity.ties)} one-bf16-ULP ties: "
        f"{json.dumps([vars(t) for t in parity.ties])}")
    if len(parity.ties) > SCHED_MAX_TIES:
        raise AssertionError(f"phase 7b: {len(parity.ties)} ties, more than "
                             f"{SCHED_MAX_TIES}")
    warm["ties_vs_cold"] = len(parity.ties)
    return warm, wtoks, wrows


def parity_scheduler(dev, cfg, params, page: int, lo: int, hi: int,
                     steps: int, codec: str) -> dict:
    """7c: the scheduler over a prefix-cached engine on ``dev`` and on the
    CPU in lockstep: 8 requests sharing a 3-page prefix, 4 slots, a pool
    that holds the live sequences but not every retained entry, so SIP
    evicts; host state, scheduler stats, tracks and cache state equal
    after every iteration, tokens up to ties."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.params import to_device
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.parity import GreedyParity
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.scheduler import ContinuousScheduler
    reqs = shared_prefix_requests(8, 3 * page, lo, hi, cfg.vocab, seed=4)
    # 16 pages a layer: at page 16, prompts of 64-108 tokens and 24 steps,
    # four live requests fit, but not with every retained entry beside
    # them, so SIP evicts (and CAMP preempts once: yi-6b at 2 layers)
    n_pool = 1 + cfg.n_layers * 16
    scheds, rows = [], []
    for d in (dev, "cpu"):
        eng = PagedKVEngine(cfg, to_device(params, torch.device(d)),
                            page_size=page, n_pool_pages=n_pool, max_batch=4,
                            prefix_cache=PrefixCache.for_model(cfg, page),
                            codec=codec, device=d)
        rows.append(capture_logits(eng))
        scheds.append(ContinuousScheduler(eng, token_budget=64))
    parity = GreedyParity()
    ops.reset_launches()

    def state(sc):
        fin = {r: [str(t.finish_reason), t.first_token_iter,
                   t.finished_iter, t.pf_start]
               for r, t in sc.finished().items()}
        return dict(_host_state(sc.engine), sched=sc.stats, tracks=fin,
                    cache=sc.engine.prefix_cache.state(),
                    hit_rate=sc.engine.prefix_cache.hit_rate())

    def on_step(events):
        gpu_ev, cpu_ev = events
        it = gpu_ev["iteration"]
        k = {r: len(scheds[1].tracks[r].out_tokens) - 1
             for r in cpu_ev["decoded"]}
        parity.check(it, cpu_ev["decoded"], gpu_ev["decoded"],
                     lambda r: rows[0][(r, k[r])],
                     lambda r: rows[1][(r, k[r])])
        if parity.ties:
            return                    # the runs may part after a tie
        a, b = state(scheds[0]), state(scheds[1])
        for key in a:
            if a[key] != b[key]:
                raise AssertionError(f"7c {codec}: {key} differs across "
                                     f"devices after iteration {it}: "
                                     f"{a[key]} vs {b[key]}")

    drive_waves(scheds, reqs, steps, on_step)
    est = scheds[0].engine.stats
    cache = scheds[0].engine.prefix_cache
    if est["prefix_pages_evicted"] <= 0 or cache.hit_rate() <= 0:
        raise AssertionError(f"7c {codec}: no SIP eviction or no hit: {est}")
    need = {"bdi": ("bdi_compress_kv", "paged_attention_tail"),
            "gbdi": ("gbdi_compress_kv", "gbdi_decompress_kv")}[codec]
    if not all(ops.LAUNCHES[k] > 0 for k in need):
        raise AssertionError(f"7c {codec}: kernels {need} not all launched: "
                             f"{dict(ops.LAUNCHES)}")
    res = {"codec": codec, "config": cfg.name, "n_pool_pages": n_pool,
           "iterations": scheds[0].iteration,
           "tokens_equal": parity.compared,
           "ties": [vars(t) for t in parity.ties],
           "engine_stats": est, "cache_stats": dict(cache.stats),
           "hit_rate": cache.hit_rate(), "launches": dict(ops.LAUNCHES)}
    log(f"parity scheduler {codec} {cfg.name}: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phases 8, 8b, 8c, 8d: the host/disk tier, snapshot/restore, faults
# ---------------------------------------------------------------------------

TURN_PROMPT, TURN_GEN, TURN_USER, TURNS = 1024, 32, 8, 3


def rows_by_position(eng, sched) -> dict:
    """Keep each decode step's logits rows by request and position in its
    final output, ``rows[(rid, k)]`` (a restarted request's later attempt
    overwrites its earlier one; positions count from the original prompt,
    so a requeue that absorbs tokens keeps them)."""
    rows = {}
    inner = eng.mixed_step

    def mixed_step(*a, **kw):
        out, completed = inner(*a, **kw)
        if out:
            lg = eng.last_logits.clone()
            for rid in out:
                k = len(eng.seqs[rid].tokens) \
                    - len(sched.tracks[rid].orig_prompt) - 1
                rows[(rid, k)] = lg[eng.seqs[rid].slot]
        return out, completed

    eng.mixed_step = mixed_step
    return rows


def need_launched(name: str, need: tuple[str, ...]) -> None:
    from repro_torch.kernels import ops
    missing = [k for k in need if ops.LAUNCHES[k] <= 0]
    if missing:
        raise AssertionError(f"phase {name}: kernels {missing} never "
                             f"launched: {dict(ops.LAUNCHES)}")


def conversation(dev, cfg, params, page: int, *, tier_kw: dict | None,
                 convos: list | None = None,
                 need: tuple[str, ...] = ("bdi_compress_kv",
                                          "paged_attention_tail")) -> dict:
    """One conversation of TURNS turns at batch 1 under bdi, the device
    pool recycled between turns: turn 1 is a TURN_PROMPT-token prompt
    (seed 11), each later turn the last one's prompt, its TURN_GEN
    tokens and TURN_USER fresh ones.  With ``tier_kw`` the engine has a
    prefix cache, caches decode pages and a TieredPageStore built from
    ``tier_kw``, so later turns promote their history; without it every
    turn prefills cold.  ``convos`` feeds the prompts of another run
    (so a tie cannot fork the history)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.tier import TieredPageStore
    eng = PagedKVEngine(cfg, params, page_size=page, n_pool_pages=
                        1 + cfg.n_layers * 96, max_batch=1,
                        prefill_chunk=32, codec="bdi",
                        prefix_cache=(PrefixCache.for_model(cfg, page)
                                      if tier_kw else None),
                        cache_decode_pages=bool(tier_kw), device=dev)
    tier = None
    demotes = []                             # seconds of each demotion
    if tier_kw:
        tier = TieredPageStore.for_model(cfg, page, eng.codec, **tier_kw)
        eng.attach_tier(tier)
        inner = eng._demote_pages

        def demote_pages(*a, **kw):  # a gather, one copy to the host, pack
            t0 = time.perf_counter()
            inner(*a, **kw)
            demotes.append(time.perf_counter() - t0)

        eng._demote_pages = demote_pages
    rows = capture_logits(eng)
    g = torch.Generator().manual_seed(11)
    convo = torch.randint(1, cfg.vocab, (TURN_PROMPT,), generator=g).tolist()
    ops.reset_launches()
    turns, outs, prompts = [], {}, []
    for t in range(1, TURNS + 1):
        if convos is not None:
            convo = convos[t - 1]
        prompts.append(list(convo))
        base = dict(tier.stats) if tier else {}
        from_disk = (sum(r.level == "disk" for r in tier.lookup(convo))
                     if tier and tier.disk is not None else 0)
        n_dem = len(demotes)
        promote_s = eng._h_promote.sum if tier else 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        cached = eng.add_requests({t: convo})[t]
        out = [eng.decode_one(t)]                  # ends in a host sync
        ttft = time.perf_counter() - t0
        out += [eng.decode_one(t) for _ in range(TURN_GEN - 1)]
        eng.release(t)
        eng.recycle_device_pool()
        eng.debug_validate()
        outs[t] = out
        d = {k: tier.stats[k] - base[k] for k in tier.stats} if tier else {}
        turns.append({"turn": t, "prompt_tokens": len(convo),
                      "ttft_ms": 1e3 * ttft, "cached_tokens": cached,
                      "demotions": d.get("demotions", 0),
                      "promotions": d.get("promotions", 0),
                      "spills": d.get("spills", 0),
                      "promoted_from_disk_records": from_disk,
                      "promote_ms": 1e3 * ((eng._h_promote.sum if tier
                                            else 0.0) - promote_s),
                      "demote_ms": 1e3 * sum(demotes[n_dem:]),
                      "d2h_bytes": (len(demotes) - n_dem)
                      * (tier.slot_bytes if tier else 0),
                      "h2d_bytes": d.get("promotions", 0)
                      * (tier.slot_bytes if tier else 0)})
        extra = torch.randint(1, cfg.vocab, (TURN_USER,), generator=torch
                              .Generator().manual_seed(100 + t)).tolist()
        convo = convo + out + extra
    need_launched("8", need)
    return {"turns": turns, "outs": outs, "rows": rows, "prompts": prompts,
            "tier": None if tier is None else dict(tier.stats),
            "tier_logical_bytes": None if tier is None
            else tier.logical_bytes(),
            "slot_bytes": None if tier is None else tier.slot_bytes,
            "launches": dict(ops.LAUNCHES)}


def expected_cached(prompts: list, page: int) -> list:
    """Cached tokens each turn takes from the tier: turn 1 none, a later
    turn every full page of the last turn's prompt and its first
    TURN_GEN - 1 tokens (their K/V was computed; the last token's was
    not)."""
    return [0] + [(len(p) + TURN_GEN - 1) // page * page
                  for p in prompts[:-1]]


# the disk variant's arenas in tier slots: 15 host slots are 7.97 MB at
# yi-6b's full width under bdi (8 MB holds 15), 240 disk slots 127.5 MB
DISK_RUN_SLOTS = (15, 240)


def phase_multi_turn(dev, cfg, params, page: int, need=("bdi_compress_kv",
                     "paged_attention_tail")) -> dict:
    """8: multi-turn from host RAM (64 MB), then from 15 slots of host RAM
    (7.97 MB) spilling to a disk arena, each against a run without a tier
    fed the same prompts; tokens equal up to reported ties."""
    import tempfile
    from repro_torch import codecs
    from repro_torch.serving._tree import tree_leaves
    slot_mb = cfg.n_layers * sum(
        t.numel() * t.element_size() for t in tree_leaves(
            codecs.get("bdi").init_pools(1, 1, cfg.n_kv_heads, page,
                                         cfg.head_dim, "cpu"))) / 2**20
    res = {}
    with tempfile.TemporaryDirectory() as disk:
        for name, kw in (("host 64 MB", {"host_mb": 64}),
                         ("host 15 slots + disk", {
                             "host_mb": DISK_RUN_SLOTS[0] * slot_mb,
                             "disk_dir": disk,
                             "disk_mb": DISK_RUN_SLOTS[1] * slot_mb})):
            tiered = conversation(dev, cfg, params, page, tier_kw=kw,
                                  need=need)
            cold = conversation(dev, cfg, params, page, tier_kw=None,
                                convos=tiered["prompts"], need=need)
            parity = compare_requests(cold["outs"], tiered["outs"],
                                      cold["rows"], tiered["rows"])
            got = [t["cached_tokens"] for t in tiered["turns"]]
            want = expected_cached(tiered["prompts"], page)
            if got != want:
                raise AssertionError(f"phase 8 {name}: cached {got}, "
                                     f"rehearsed {want}")
            if tiered["tier"]["corrupt"] or not all(
                    t["promotions"] for t in tiered["turns"][1:]):
                raise AssertionError(f"phase 8 {name}: {tiered['turns']}")
            if "disk" in name and not (
                    tiered["tier"]["spills"] > 0 and any(
                        t["promoted_from_disk_records"]
                        for t in tiered["turns"])):
                raise AssertionError(f"phase 8 {name}: nothing promoted "
                                     f"from disk: {tiered['turns']}")
            if len(parity.ties) > SCHED_MAX_TIES:
                raise AssertionError(f"phase 8 {name}: {len(parity.ties)} "
                                     "ties")
            r = {"card": smi(), "turns": tiered["turns"],
                 "tierless_ttft_ms": [t["ttft_ms"] for t in cold["turns"]],
                 "tier": tiered["tier"],
                 "tier_logical_bytes": tiered["tier_logical_bytes"],
                 "slot_bytes": tiered["slot_bytes"],
                 "tokens_equal": parity.compared,
                 "ties": [vars(t) for t in parity.ties],
                 "launches": tiered["launches"]}
            log(f"phase 8 {name}: {json.dumps(r)}")
            res[name] = r
    return res


# page boundaries of 8b's pool: phase 7's workload peaks near 104 live
# ones (the 24 shared, ~10 of each of 8 requests); SIP evicts retained
# entries beyond that
SNAP_POOL_BLOCKS = 128


def phase_snapshot(dev, cfg, params, page: int) -> dict:
    """8b: phase 7's warm workload, snapshotted at the first iteration
    with every request submitted, decodes in flight and no cohort;
    finished, then restored into a fresh engine and scheduler on the same
    device and finished again: the same tokens exactly.

    A pool id holds a page of one layer but is allocated in all L (the
    JAX layout, ``[L, P, ...]``), so the pools are L times the pages in
    use: at full width even this workload's pool is 2.3 GB, which the
    host's BDI stream codec (tens of MB/s) would take minutes to
    compress.  So the pool is sized to the workload (SNAP_POOL_BLOCKS
    page boundaries, not phase 7's every-request-unshared sizing) and the
    snapshot is stored uncompressed; the compressed path is held by the
    CPU tests and by 8d."""
    import tempfile
    import torch
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.serving.snapshot import restore_snapshot, save_snapshot
    from repro_torch.serving.telemetry import Telemetry
    reqs = shared_prefix_requests(SCHED_N, SCHED_PREFIX, *SCHED_OWN,
                                  cfg.vocab, seed=7)
    tel = Telemetry()
    eng = PagedKVEngine(cfg, params, page_size=page,
                        n_pool_pages=1 + cfg.n_layers * SNAP_POOL_BLOCKS,
                        max_batch=8, prefill_chunk=32, codec="bdi",
                        prefix_cache=PrefixCache.for_model(cfg, page),
                        telemetry=tel, device=dev)
    sched = ContinuousScheduler(eng, token_budget=256, telemetry=tel)
    snap = {}
    with tempfile.TemporaryDirectory() as d:
        def on_step(events):
            if not snap and len(sched.tracks) == SCHED_N \
                    and eng._cohort is None and sched._running:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                man = save_snapshot(d, eng, sched, step=sched.iteration,
                                    compress=False)
                snap.update(iteration=sched.iteration,
                            save_s=time.perf_counter() - t0,
                            raw_bytes=man["raw_bytes"],
                            stored_bytes=man["stored_bytes"],
                            files=len(man["entries"]),
                            running=len(sched._running),
                            waiting=len(sched.waiting))

        drive_waves([sched], reqs, SCHED_GEN, on_step)
        if not snap:
            raise AssertionError("phase 8b: no iteration to snapshot at")
        eng.debug_validate()
        fin = sched.finished()
        t0 = time.perf_counter()
        eng2, sched2 = restore_snapshot(d, cfg, params, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        snap["restore_s"] = time.perf_counter() - t0
        fin2 = sched2.run()
        eng2.debug_validate()
    a = {r: (str(t.finish_reason), t.out_tokens) for r, t in fin.items()}
    b = {r: (str(t.finish_reason), t.out_tokens) for r, t in fin2.items()}
    if a != b or eng.stats != eng2.stats or eng.stats["preemptions"]:
        raise AssertionError(f"phase 8b: the restored run differs or "
                             f"preempted: {eng.stats} vs {eng2.stats}")
    snap.update(card=smi(), requests=len(fin2), equal_tokens=sum(
        len(t) for _, t in b.values()), iterations=sched2.iteration,
        engine_stats=eng.stats)
    log(f"phase 8b: {json.dumps(snap)}")
    return snap


CHAOS = dict(corrupt_page_every=7, corrupt_max=2, garble_decode_every=11,
             garble_max=2, holds=((10, 64, 6),))


def phase_chaos(dev, cfg, params, page: int, clean: dict, clean_rows: dict,
                need=("bdi_compress_kv", "paged_attention_tail")) -> dict:
    """8c: phase 7's warm workload under a fault schedule: every request
    ends eos/length, a corruption is detected and a request restarted,
    and the tokens equal phase 7's up to reported ties."""
    from repro_torch.kernels import ops
    from repro_torch.serving import faults as F
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.serving.telemetry import Telemetry
    reqs = shared_prefix_requests(SCHED_N, SCHED_PREFIX, *SCHED_OWN,
                                  cfg.vocab, seed=7)
    inj = F.FaultInjector(F.FaultSpec(**CHAOS), seed=0)
    tel = Telemetry()
    eng = PagedKVEngine(cfg, params, page_size=page,
                        n_pool_pages=pool_for(cfg, reqs, SCHED_GEN, page),
                        max_batch=8, prefill_chunk=32, codec="bdi",
                        prefix_cache=PrefixCache.for_model(cfg, page),
                        faults=inj, telemetry=tel, device=dev)
    sched = ContinuousScheduler(eng, token_budget=256, telemetry=tel)
    rows = rows_by_position(eng, sched)
    ops.reset_launches()
    t0 = time.perf_counter()
    drive_waves([sched], reqs, SCHED_GEN)
    wall = time.perf_counter() - t0
    inj.release_holds(eng)
    eng.debug_validate()
    fin = sched.finished()
    toks = {r: fin[r].out_tokens for r in reqs}
    reasons = {str(t.finish_reason) for t in fin.values()}
    st, est = sched.stats, eng.stats
    if not reasons <= {"eos", "length"}:
        raise AssertionError(f"phase 8c: finish reasons {reasons}")
    if inj.stats["corruptions"] < 1 or est["integrity_failures"] < 1 \
            or st["corrupt_retries"] < 1:
        raise AssertionError(f"phase 8c: no corruption detected and "
                             f"restarted: {inj.stats}, {est}, {st}")
    parity = compare_requests(clean, toks, clean_rows, rows)
    if len(parity.ties) > SCHED_MAX_TIES:
        raise AssertionError(f"phase 8c: {len(parity.ties)} ties")
    need_launched("8c", need)
    res = {"card": smi(), "log": inj.log, "injected": dict(inj.stats),
           "integrity_failures": est["integrity_failures"],
           "corrupt_events": st["corrupt_events"],
           "corrupt_retries": st["corrupt_retries"],
           "iterations": sched.iteration, "wall_s": wall,
           "cache_stats": dict(eng.prefix_cache.stats),
           "tokens_equal": parity.compared,
           "ties": [vars(t) for t in parity.ties]}
    log(f"phase 8c: {json.dumps(res)}")
    return res


def parity_snapshot_tier(dev, cfg, page: int, codec: str) -> dict:
    """8d at depth 2: a scheduler snapshot written on the card restores on
    the CPU, and both finish with equal tokens (up to reported ties) and,
    with no tie, equal host and cache state; a tier persisted on the card
    restores on the CPU with the same slot bytes, records and checksums,
    and the CPU engine promotes the card's page bytes out of it."""
    import tempfile
    import torch
    from repro_torch.models.params import to_device
    from repro_torch.models.transformer import init_params
    from repro_torch.serving._tree import tree_leaves
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.parity import GreedyParity
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.serving.snapshot import restore_snapshot, save_snapshot
    from repro_torch.serving.tier import TieredPageStore
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    reqs = shared_prefix_requests(8, 3 * page, 16, 60, cfg.vocab, seed=4)

    def engine(d, **kw):
        return PagedKVEngine(cfg, to_device(params, torch.device(d)),
                             page_size=page, n_pool_pages=1 + cfg.n_layers
                             * 64, max_batch=4, codec=codec, device=d,
                             prefix_cache=PrefixCache.for_model(cfg, page),
                             **kw)

    gpu = engine(dev)
    sched = ContinuousScheduler(gpu, token_budget=64)
    rows = rows_by_position(gpu, sched)
    res = {"codec": codec}
    with tempfile.TemporaryDirectory() as d:
        def on_step(events):
            if "snapshot_iteration" not in res and len(sched.tracks) == 8 \
                    and sched._running:
                save_snapshot(d, gpu, sched, step=sched.iteration)
                res["snapshot_iteration"] = sched.iteration

        drive_waves([sched], reqs, 24, on_step)
        cpu, sched_cpu = restore_snapshot(d, cfg, params, device="cpu")
    cpu_rows = rows_by_position(cpu, sched_cpu)
    sched_cpu.run()
    gpu.debug_validate()
    cpu.debug_validate()
    parity = GreedyParity()
    want = {r: t.out_tokens for r, t in sched.finished().items()}
    got = {r: t.out_tokens for r, t in sched_cpu.finished().items()}
    for k in range(max(len(t) for t in want.values())):
        w = {r: t[k] for r, t in want.items() if k < len(t)}
        parity.check(k, w, {r: got[r][k] for r in w},
                     lambda r: cpu_rows.get((r, k), rows[(r, k)]),
                     lambda r: rows[(r, k)])
    if not parity.ties:
        a = dict(_host_state(gpu), sched=sched.stats,
                 cache=gpu.prefix_cache.state())
        b = dict(_host_state(cpu), sched=sched_cpu.stats,
                 cache=cpu.prefix_cache.state())
        for key in a:
            if a[key] != b[key]:
                raise AssertionError(f"8d {codec}: {key} differs after the "
                                     f"card-to-cpu restore")
    res.update(tokens_equal=parity.compared,
               ties=[vars(t) for t in parity.ties])

    def chain_bytes(eng, chain):
        pools = [lf.cpu() for lf in tree_leaves(eng.pools)]
        return [b"".join(lf[li, eng.prefix_cache.entries[e].pages[li]]
                         .contiguous().view(torch.uint8).numpy().tobytes()
                         for lf in pools for li in range(cfg.n_layers))
                for e in chain]

    tiered = engine(dev)
    tiered.attach_tier(TieredPageStore.for_model(cfg, page, tiered.codec,
                                                 host_mb=4))
    prompt = reqs[0]
    tiered.add_requests({0: prompt})
    before = chain_bytes(tiered, tiered.seqs[0].chain)
    tiered.release(0)
    tiered.recycle_device_pool()
    with tempfile.TemporaryDirectory() as d:
        tiered.tier.persist(d)
        cpu_tier = TieredPageStore.restore(d, cfg, tiered.codec, host_mb=4)
    same = (cpu_tier.tier_arrays()["tier_data"].tobytes()
            == tiered.tier.tier_arrays()["tier_data"].tobytes()
            and cpu_tier.meta_state()["records"]
            == tiered.tier.meta_state()["records"])
    cpu2 = engine("cpu")
    cpu2.attach_tier(cpu_tier)
    cached = cpu2.add_requests({1: prompt})[1]
    promoted = chain_bytes(cpu2, cpu2.seqs[1].chain)
    cpu2.debug_validate()
    if not same or cached != len(before) * page or promoted != before:
        raise AssertionError(f"8d {codec}: the card's tier restored on the "
                             f"cpu differs (bytes and records equal: "
                             f"{same}, cached {cached})")
    res.update(tier_records=cpu_tier.record_count(), tier_cached=cached)
    log(f"8d {codec}: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phases 9, 9b, 9c: the observatory, the oracle on the card, and an
# observatory snapshot from the card
# ---------------------------------------------------------------------------

def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def release(dev) -> None:
    """Free what the last phase left: objects in reference cycles (an
    engine and its scheduler) hold card memory until the collector runs,
    so collect, return the cached blocks, and log what stays allocated."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  allocated after release: "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")


def obs_series(reg) -> dict:
    """The observatory's registry series (JSON-normalised)."""
    return json.loads(json.dumps(
        {k: v for k, v in reg.snapshot().items()
         if k.startswith(("obs_", "shadow_", "audit_"))}))


def time_hooks(obs) -> dict:
    """Wrap the observatory's engine hooks and its audit log's ``record``
    with host-clock accumulators; returns ``{hook: seconds spent}``, the
    observatory's whole cost to the serving loop (it does no device
    work)."""
    spent: dict[str, float] = {}

    def wrap(owner, name):
        inner = getattr(owner, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out

        setattr(owner, name, timed)

    for name in ("on_publish", "on_admit", "on_cache_insert", "on_dedup",
                 "on_release", "on_retire", "sample_gauges"):
        wrap(obs, name)
    wrap(obs.audit, "record")
    return spent


def observed_run(dev, cfg, params, page: int, reqs: dict, *, codec: str,
                 n_pool: int, observe: bool = True,
                 jsonl: list | None = None) -> dict:
    """Phase 7's warm workload (two waves through the scheduler and the
    prefix cache) under ``codec``, with an Observatory attached when
    ``observe``; with ``jsonl`` the registry is sampled into it every 16
    iterations (the serve CLI's ``--metrics-jsonl`` cadence)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.observatory import Observatory
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.serving.telemetry import Telemetry
    tel = Telemetry()
    obs = Observatory(tel) if observe else None
    eng = PagedKVEngine(cfg, params, page_size=page, n_pool_pages=n_pool,
                        max_batch=8, prefill_chunk=32, codec=codec,
                        prefix_cache=PrefixCache.for_model(cfg, page),
                        telemetry=tel, observatory=obs, device=dev)
    sched = ContinuousScheduler(eng, token_budget=256, telemetry=tel)
    hooks = time_hooks(obs) if observe else {}

    def on_step(events):
        if jsonl is not None and sched.iteration % 16 == 0:
            eng.sample_gauges()
            jsonl.append(tel.registry.to_jsonl_line(
                iteration=sched.iteration))

    sync(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    drive_waves([sched], reqs, SCHED_GEN, on_step)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    eng.debug_validate()
    eng.sample_gauges()
    if jsonl is not None:
        jsonl.append(tel.registry.to_jsonl_line(iteration=sched.iteration,
                                                final=True))
    fin = sched.finished()
    if not torch.isfinite(eng.last_logits.float()).all():
        raise AssertionError(f"phase 9 {codec}: non-finite logits")
    return {"eng": eng, "sched": sched, "obs": obs, "wall": wall,
            "launches": launches, "hook_ms": {k: 1e3 * v
                                              for k, v in hooks.items()},
            "tokens": {r: fin[r].out_tokens for r in reqs},
            "reasons": sorted({str(t.finish_reason) for t in fin.values()})}


# page boundaries of phase 9's adaptive pool: phase 7's workload then
# evicts 10 retained prefix entries (a CPU rehearsal at 2 layers; the
# decisions depend on token counts only) and preempts nothing
OBS_POOL_BLOCKS = 104


def phase_observatory(dev, cfg, params, page: int, warm: dict,
                      warm_toks: dict) -> dict:
    """9: phase 7's workload under bdi without and with an Observatory, in
    turns (off, on, on, off): every run gives the tokens, engine stats and
    scheduler stats of phase 7's (the observatory is a pure observer);
    ms an iteration of each beside phase 7's; the joint size-bin x
    reuse-distance table, shadow hit rates and audit counts.  Then under
    adaptive on a pool sized to the workload: every member's would-be
    bytes recorded for every published page; the registry and the audit
    log exported (Prometheus text, metrics JSONL, audit JSONL) and
    rendered by ``repro_torch.launch.observe``."""
    import tempfile
    import torch
    from repro_torch.codecs.adaptive import MEMBER_NAMES
    from repro_torch.launch import observe
    reqs = shared_prefix_requests(SCHED_N, SCHED_PREFIX, *SCHED_OWN,
                                  cfg.vocab, seed=7)
    res, launches, ms, hook_ms = {}, {}, {"off": [], "on": []}, []
    for attach in (False, True, True, False):
        bdi = observed_run(dev, cfg, params, page, reqs, codec="bdi",
                           n_pool=warm["n_pool_pages"], observe=attach)
        eng, sched, obs = bdi["eng"], bdi["sched"], bdi["obs"]
        need_launched("9 bdi", ("bdi_compress_kv", "paged_attention_tail"))
        same = {"tokens": bdi["tokens"] == warm_toks,
                "engine_stats": eng.stats == warm["engine_stats"],
                "sched_stats": sched.stats == warm["sched_stats"]}
        if not all(same.values()):
            raise AssertionError(f"phase 9: a run with observatory "
                                 f"{attach} differs from phase 7: {same}")
        ms["on" if attach else "off"].append(1e3 * bdi["wall"] /
                                             sched.iteration)
        if attach:
            hook_ms.append(bdi["hook_ms"])
        if attach and "bdi" not in res:
            summ = obs.summary()
            rates = summ["shadow_hit_rates"]
            if not obs.reuse.joint_counts() or min(rates.values()) <= 0:
                raise AssertionError(f"phase 9: no reuse recorded: {summ}")
            res["bdi"] = {"card": smi(), "iterations": sched.iteration,
                          "same_as_phase7": same, "summary": summ,
                          "reuse_table": obs.reuse_table(),
                          "launches": bdi["launches"]}
            for ln in obs.reuse_table().splitlines():
                log(f"  {ln}")
            for k, v in bdi["launches"].items():
                launches[k] = launches.get(k, 0) + v
        del eng, sched, obs, bdi
        torch.cuda.empty_cache()
    res["bdi"].update(ms_per_iteration_on=ms["on"],
                      ms_per_iteration_off=ms["off"],
                      phase7_ms_per_iteration=warm["ms_per_iteration"],
                      hook_ms=hook_ms, hook_ms_per_iteration=[
                          sum(h.values()) / res["bdi"]["iterations"]
                          for h in hook_ms])
    log(f"phase 9 bdi: {json.dumps(res['bdi'])}")

    jsonl: list[str] = []
    ad = observed_run(dev, cfg, params, page, reqs, codec="adaptive",
                      n_pool=1 + cfg.n_layers * OBS_POOL_BLOCKS,
                      jsonl=jsonl)
    eng, sched, obs = ad["eng"], ad["sched"], ad["obs"]
    need_launched("9 adaptive", ("bdi_compress_kv", "gbdi_compress_kv",
                                 "gbdi_decompress_kv"))
    est, cache = eng.stats, eng.prefix_cache
    published = est["pages_compressed"] + cfg.n_layers * \
        cache.stats["deduped"]
    wb = obs.codec_shadow.bytes
    if (set(wb) != set(MEMBER_NAMES) or min(wb.values()) <= 0
            or obs.codec_shadow.pages != published
            or ad["reasons"] != ["length"] or est["preemptions"]
            or not obs.audit.counts().get("sip_evict")):
        raise AssertionError(f"phase 9 adaptive: would-be bytes {wb} over "
                             f"{obs.codec_shadow.pages} pages, {published} "
                             f"published; {ad['reasons']}, {est}")
    with tempfile.TemporaryDirectory() as d:
        paths = {k: Path(d) / f"obs.{k}" for k in ("prom", "jsonl",
                                                  "audit")}
        paths["prom"].write_text(eng.telemetry.registry.to_prometheus())
        paths["jsonl"].write_text("".join(ln + "\n" for ln in jsonl))
        n_audit = obs.audit.to_jsonl(paths["audit"])
        audit = [json.loads(ln) for ln in
                 paths["audit"].read_text().splitlines()]
        snap, records = observe.load_jsonl(str(paths["jsonl"]))
        report = observe.render_report(snap, jsonl_records=records,
                                       audit_records=audit)
        from_prom = observe.render_report(observe.parse_prometheus(
            paths["prom"].read_text()), audit_records=audit)
        sizes = {k: p.stat().st_size for k, p in paths.items()}
    if "size_bin" not in report or "size_bin" not in from_prom:
        raise AssertionError(f"phase 9: the report lacks the joint table:\n"
                             f"{report}")
    res["adaptive"] = {"card": smi(), "iterations": sched.iteration,
                       "ms_per_iteration": 1e3 * ad["wall"] /
                       sched.iteration,
                       "n_pool_pages": eng.n_pool_pages,
                       "pages_published": published,
                       "wouldbe_bytes": dict(wb),
                       "kv_compression_ratio": eng.compression_ratio(),
                       "summary": obs.summary(), "audit_records": n_audit,
                       "hook_ms": ad["hook_ms"],
                       "hook_ms_per_iteration": sum(ad["hook_ms"].values())
                       / sched.iteration,
                       "export_bytes": sizes, "launches": ad["launches"]}
    log(f"phase 9 adaptive: {json.dumps(res['adaptive'])}")
    for ln in report.splitlines():
        log(f"  observe| {ln}")
    for k, v in ad["launches"].items():
        launches[k] = launches.get(k, 0) + v
    res["launches"] = launches
    del eng, sched, obs, ad
    torch.cuda.empty_cache()
    return res


def shape_state(eng) -> dict:
    """Host state that does not depend on which pool ids were handed out
    (the batched engine reserves a step's pages at once, the oracle one at
    a time): stats, pool use and pressure, each sequence's page counts,
    tail, flags and chain, request bytes, the cache trie without pool
    ids."""
    cache = eng.prefix_cache
    cs = None
    if cache is not None:
        cs = cache.state()
        for e in cs["entries"]:
            del e["pages"]
    return json.loads(json.dumps({
        "stats": dict(eng.stats), "used": eng.pool_used_pages(),
        "pressure": eng.pool_pressure(),
        "seqs": {sid: [[len(lp) for lp in s.pages], s.tail_len, s.preempted,
                       list(s.chain)] for sid, s in sorted(eng.seqs.items())},
        "request_bytes": {k: list(v)
                          for k, v in sorted(eng.request_bytes.items())},
        "cache": cs}))


def oracle_run(sched, reqs: dict, gen: int) -> dict:
    """Drive one scheduler over ``reqs`` (arriving every 2 iterations),
    synced and timed, keeping each iteration's decoded tokens and shape
    state and each token's logits row by request and position."""
    from repro_torch.kernels import ops
    eng = sched.engine
    rows, pos = {}, {}
    if hasattr(eng, "mixed_step"):
        rows = capture_logits(eng)
    else:
        inner = eng.decode_one

        def decode_one(sid):
            tok = inner(sid)
            k = pos.get(sid, 0)
            rows[(sid, k)] = eng.last_logits[sid].clone()
            pos[sid] = k + 1
            return tok

        eng.decode_one = decode_one
    dev = eng.device
    iters, first = [], {}
    sync(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    pending = {r: 2 * r for r in reqs}
    while pending or not sched.idle:
        for r in [r for r, at in pending.items() if at <= sched.iteration]:
            sched.submit(r, reqs[r], max_new_tokens=gen)
            del pending[r]
        ev = sched.step()
        for r in ev["decoded"]:
            k = len(sched.tracks[r].out_tokens) - 1
            first.setdefault((r, k), ev["iteration"])
        iters.append(shape_state(eng))
    sync(dev)
    wall = time.perf_counter() - t0
    eng.debug_validate()
    fin = sched.finished()
    return {"wall": wall, "launches": dict(ops.LAUNCHES), "rows": rows,
            "states": iters, "iteration_of": first,
            "tokens": {r: fin[r].out_tokens for r in reqs},
            "tracks": {r: [str(t.finish_reason), t.first_token_iter,
                           t.finished_iter, t.pf_start]
                       for r, t in sorted(fin.items())},
            "sched_stats": dict(sched.stats),
            "engine_stats": dict(eng.stats)}


ORACLE_GEN = 16


def phase_oracle(dev, cfg, page: int) -> dict:
    """9b: yi-6b at full width and depth 2, 4 requests sharing a two-page
    prefix, through the batched scheduler and through
    ``make_reference_scheduler`` over ``ReferencePagedKVEngine`` on the
    card (pools on the host, math and codec kernels on the card), under
    bdi and gbdi: tokens equal up to reported ties; scheduler and engine
    stats, tracks and the allocation-order-free host state equal after
    every iteration (up to the first tie)."""
    import torch
    from repro_torch.models.transformer import init_params
    from repro_torch.serving._tree import tree_leaves
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.reference import ReferencePagedKVEngine
    from repro_torch.serving.scheduler import (ContinuousScheduler,
                                               make_reference_scheduler)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    reqs = shared_prefix_requests(4, 2 * page, 24, 72, cfg.vocab, seed=9)
    n_pool = pool_for(cfg, reqs, ORACLE_GEN, page)
    res, launches = {}, {}
    need = {"bdi": (("bdi_compress_kv", "paged_attention_tail"),
                    ("bdi_compress_kv",)),
            "gbdi": (("gbdi_compress_kv", "gbdi_decompress_kv"),
                     ("gbdi_compress_kv", "gbdi_decompress_kv"))}
    for codec in ("bdi", "gbdi"):
        be = PagedKVEngine(cfg, params, page_size=page, n_pool_pages=n_pool,
                           max_batch=4, prefill_chunk=32, codec=codec,
                           prefix_cache=PrefixCache.for_model(cfg, page),
                           device=dev)
        batched = oracle_run(ContinuousScheduler(be, token_budget=64),
                             reqs, ORACLE_GEN)
        need_launched(f"9b {codec} batched", need[codec][0])
        re_ = ReferencePagedKVEngine(
            cfg, params, page_size=page, n_pool_pages=n_pool,
            prefill_chunk=32, codec=codec,
            prefix_cache=PrefixCache.for_model(cfg, page), device=dev)
        oracle = oracle_run(make_reference_scheduler(
            re_, token_budget=64, max_batch=4, prefill_chunk=32), reqs,
            ORACLE_GEN)
        need_launched(f"9b {codec} oracle", need[codec][1])
        if oracle["launches"]["paged_attention_tail"] or {
                lf.device.type for lf in tree_leaves(re_.pools)} != {"cpu"}:
            raise AssertionError(f"9b {codec}: the oracle's pools left the "
                                 f"host or it ran the attention kernel")
        parity = compare_requests(oracle["tokens"], batched["tokens"],
                                  oracle["rows"], batched["rows"])
        upto = min((batched["iteration_of"][(t.sid, t.step)]
                    for t in parity.ties), default=len(batched["states"]))
        same = batched["states"][:upto] == oracle["states"][:upto]
        if not parity.ties:
            same = same and all(batched[k] == oracle[k] for k in (
                "states", "tracks", "sched_stats", "engine_stats"))
        if not same:
            raise AssertionError(f"9b {codec}: the oracle's host state, "
                                 f"stats or tracks differ")
        n_tok = batched["sched_stats"]["decode_tokens"]
        res[codec] = {"card": smi(), "config": cfg.name, "d_model":
                      cfg.d_model, "n_layers": cfg.n_layers,
                      "prompt_lens": [len(p) for p in reqs.values()],
                      "iterations": len(batched["states"]),
                      "decode_tokens": n_tok,
                      "tokens_equal": parity.compared,
                      "ties": [vars(t) for t in parity.ties],
                      "batched_ms_per_token": 1e3 * batched["wall"] / n_tok,
                      "oracle_ms_per_token": 1e3 * oracle["wall"] / n_tok,
                      "engine_stats": batched["engine_stats"],
                      "launches_batched": batched["launches"],
                      "launches_oracle": oracle["launches"]}
        log(f"phase 9b {codec}: {json.dumps(res[codec])}")
        for run in (batched, oracle):
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
        del be, re_, batched, oracle
        torch.cuda.empty_cache()
    res["launches"] = launches
    return res


def phase_obs_snapshot(dev, cfg, page: int) -> dict:
    """9c at depth 2 under adaptive: an engine with an Observatory,
    snapshotted on the card mid-stream, restores on the CPU with the
    observatory's state and registry series exactly equal; the restored
    run finishes and validates."""
    import tempfile
    import torch
    from repro_torch.models.params import to_device
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.observatory import Observatory
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.serving.snapshot import restore_snapshot, save_snapshot
    from repro_torch.serving.telemetry import Telemetry
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    reqs = shared_prefix_requests(8, 3 * page, 16, 60, cfg.vocab, seed=4)
    tel = Telemetry()
    obs = Observatory(tel)
    eng = PagedKVEngine(cfg, to_device(params, dev), page_size=page,
                        n_pool_pages=1 + cfg.n_layers * 64, max_batch=4,
                        codec="adaptive", telemetry=tel, observatory=obs,
                        prefix_cache=PrefixCache.for_model(cfg, page),
                        device=dev)
    sched = ContinuousScheduler(eng, token_budget=64, telemetry=tel)
    saved = {}
    with tempfile.TemporaryDirectory() as d:
        def on_step(events):
            if not saved and len(sched.tracks) == 8 and sched._running:
                save_snapshot(d, eng, sched, step=sched.iteration)
                saved.update(iteration=sched.iteration,
                             state=json.loads(json.dumps(obs.state())),
                             series=obs_series(tel.registry))

        drive_waves([sched], reqs, 24, on_step)
        cpu, sched_cpu = restore_snapshot(d, cfg, params, device="cpu")
    got = {"state": json.loads(json.dumps(cpu.obs.state())),
           "series": obs_series(cpu.telemetry.registry)}
    if not saved or got["state"] != saved["state"] \
            or got["series"] != saved["series"]:
        raise AssertionError("9c: the observatory restored on the cpu "
                             "differs from the card's")
    sched_cpu.run()
    cpu.debug_validate()
    eng.debug_validate()
    s = saved["state"]
    res = {"card": smi(), "iteration": saved["iteration"],
           "reuse_ticks": s["reuse"]["tick"],
           "live_pages": len(s["reuse"]["live"]),
           "audit_records": len(s["audit"]["records"]),
           "codec_shadow_pages": s["codec_shadow"]["pages"],
           "restored_finished": len(sched_cpu.finished())}
    log(f"phase 9c: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phases 10-10d: training with BDI-compressed AdamW moments
# ---------------------------------------------------------------------------

def _finite_losses(name: str, losses: list) -> None:
    import math
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: a loss is not finite: {losses}")


def _step_split(out: dict) -> dict:
    """Mean host ms of the forward+backward and of the update over every
    step but the first (which builds the kernels' first calls and the
    allocator's pools), and the first step's ms."""
    fb = [a * 1e3 for a, _ in out["step_s"]]
    opt = [b * 1e3 for _, b in out["step_s"]]
    rest = slice(1, None) if len(fb) > 1 else slice(None)
    mean = lambda xs: sum(xs) / len(xs)              # noqa: E731
    return {"fwd_bwd_ms": mean(fb[rest]), "opt_ms": mean(opt[rest]),
            "step_ms": mean(fb[rest]) + mean(opt[rest]),
            "first_step_ms": fb[0] + opt[0]}


def opt_bytes_by_dtype(params: dict) -> dict:
    """``opt_state_bytes`` of each moment dtype for ``params``' shapes,
    from ``adamw_init`` over meta tensors (nothing allocated)."""
    from repro_torch.models.params import tree_map
    from repro_torch.optim import AdamWConfig, adamw_init, opt_state_bytes
    meta = tree_map(lambda t: t.to("meta"), params)
    return {md: opt_state_bytes(adamw_init(meta, AdamWConfig(
        moment_dtype=md)), AdamWConfig(moment_dtype=md))
        for md in ("f32", "bf16", "bdi8", "q8")}


def lost_second_moments(state: dict, params: dict) -> dict:
    """Elements whose stored v loads as 0 while their stored m does not:
    the next step moves each by lr * m / eps unless its gradient is large
    enough to refill v (``_load`` of each row group; launches the tile
    decompressor, so call it after reading the launch counts)."""
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.optim import adamw
    out, total = {}, 0
    for (name, p), m_s, v_s in zip(leaf_paths(params),
                                   adamw._store_leaves(state["m"]),
                                   adamw._store_leaves(state["v"])):
        n = 0
        for r0, r1 in adamw._groups(p):
            shape = adamw._rows(p, r0, r1).shape
            m = adamw._load(adamw._rows(m_s, r0, r1), shape)
            v = adamw._load(adamw._rows(v_s, r0, r1), shape)
            n += int(((v == 0) & (m != 0)).sum())
        out[name] = n / p.numel()
        total += n
    return {"fraction": total / sum(p.numel() for _, p in leaf_paths(params)),
            "by_leaf": out}


def phase_train(dev, cfg) -> dict:
    """Phase 10: yi-6b at full width, 8 steps under bdi8, then under bf16
    moments from the same init and batches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw
    seq, batch, steps = 128, 8, 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    out = train(cfg.name, smoke=False, steps=steps, seq_len=seq,
                batch=batch, moment_dtype="bdi8", log_every=1, device="cuda")
    sync(dev)
    launches = {k: ops.LAUNCHES[k] for k in ("bdi_compress",
                                             "bdi_decompress")}
    peak = torch.cuda.max_memory_allocated(dev)
    _finite_losses("phase 10", out["losses"])
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"phase 10: {name} never launched on the "
                                 f"training path: {dict(ops.LAUNCHES)}")
    params = out["params"]
    n_params = sum(t.numel() for t in _leaves(params))
    split = _step_split(out)
    tokens = seq * batch
    # the mask layout conversion: the live state keeps the tile kernels'
    # bit planes, so it runs only where a state leaves or enters the port
    # (a checkpoint); timed once each way on the whole state
    sync(dev)
    t = time.perf_counter()
    exported = adamw.export_state(out["opt_state"])
    sync(dev)
    ms_export = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    back = adamw.import_state(exported)
    sync(dev)
    ms_import = (time.perf_counter() - t) * 1e3
    if not all(torch.equal(x, y) for x, y in zip(
            _leaves(back), _leaves(out["opt_state"]))):
        raise AssertionError("phase 10: export_state/import_state do not "
                             "round-trip the state")
    tiles = sum(s["maskp"].numel() // 16
                for s in adamw._store_leaves(out["opt_state"]["m"])
                if isinstance(s, dict))
    del exported, back
    state_bytes = opt_bytes_by_dtype(params)
    lost = lost_second_moments(out["opt_state"], params)
    res = {"card": smi(), "params": n_params, "losses": out["losses"],
           **split, "tokens_per_s": tokens / split["step_ms"] * 1e3,
           "model_tflop_s_6n": 6 * n_params * tokens / split["step_ms"]
           / 1e9,
           "model_tflop_s_8n": 8 * n_params * tokens / split["step_ms"]
           / 1e9,
           "peak_mem_gb": peak / 1e9, "launches": launches,
           "moment_tiles_per_step": 2 * tiles,
           "mask_conversion_ms_at_checkpoint": {"export": ms_export,
                                                "import": ms_import},
           "opt_state_bytes": state_bytes,
           "opt_state_bytes_actual": sum(
               t.numel() * t.element_size() for k in ("m", "v")
               for t in _leaves(out["opt_state"][k])),
           "v_lost_m_kept_after_last_step": lost}
    if res["opt_state_bytes_actual"] != state_bytes["bdi8"]:
        raise AssertionError("phase 10: the bdi8 state's bytes differ from "
                             "opt_state_bytes of adamw_init")
    del out, params
    torch.cuda.empty_cache()
    # the same run with bf16 moments (f32's 48.5 GB of moments would leave
    # too little of the card): the path itself must lower the loss
    torch.cuda.reset_peak_memory_stats(dev)
    ref = train(cfg.name, smoke=False, steps=steps, seq_len=seq,
                batch=batch, moment_dtype="bf16", log_every=1, device="cuda")
    sync(dev)
    _finite_losses("phase 10 (bf16 moments)", ref["losses"])
    if not ref["losses"][-1] < ref["losses"][0]:
        raise AssertionError(f"phase 10: under bf16 moments the loss did "
                             f"not fall: {ref['losses']}")
    res["bf16_moments"] = {"losses": ref["losses"], **_step_split(ref),
                           "peak_mem_gb": torch.cuda.max_memory_allocated(
                               dev) / 1e9}
    log(f"phase 10: {json.dumps(res)}")
    del ref
    torch.cuda.empty_cache()
    return res


def register(cfg, name: str):
    """``cfg`` under ``name`` in the port's registry (``train`` takes a
    name), as the training twins do."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = dataclasses.replace(cfg, name=name)
    registry.ARCHS[name] = cfg
    return cfg


def phase_train_dtypes(dev, cfg) -> tuple[dict, dict]:
    """Phase 10b: full width, 2 layers, 8 steps under each moment dtype
    from the same params and batches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    two = register(cfg.reduced(n_layers=2, d_model=cfg.d_model,
                               n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                               vocab=cfg.vocab), "yi-6b-2l")
    res, kept = {"card": smi()}, None
    for md in ("f32", "bf16", "bdi8", "q8"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        out = train(two.name, smoke=False, steps=8, seq_len=128, batch=8,
                    moment_dtype=md, log_every=100, device="cuda")
        sync(dev)
        _finite_losses(f"phase 10b {md}", out["losses"])
        n = {k: ops.LAUNCHES[k] for k in ("bdi_compress", "bdi_decompress")}
        if (md == "bdi8") != all(v > 0 for v in n.values()) or \
                (md != "bdi8" and any(n.values())):
            raise AssertionError(f"phase 10b {md}: tile kernel launches "
                                 f"{n}")
        res[md] = {"losses": out["losses"], **_step_split(out),
                   "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                   "launches": n}
        if md == "bdi8":
            kept = out["opt_state"]
        del out
    gap = [b - a for a, b in zip(res["f32"]["losses"],
                                 res["bdi8"]["losses"])]
    res["bdi8_minus_f32"] = {"per_step": gap,
                             "max_abs": max(abs(g) for g in gap)}
    log(f"phase 10b: {json.dumps(res)}")
    return res, kept


def load_train_ckpt(ckpt: str, arch_cfg, md: str, step: int):
    """Params and live optimizer state of a training checkpoint, on the
    CPU."""
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import export_state, import_state
    params = init_params(arch_cfg, torch.Generator().manual_seed(0), "cpu")
    state = export_state(adamw_init(params, AdamWConfig(moment_dtype=md)))
    (params, state), _ = store.restore(ckpt, (params, state), step=step)
    return params, import_state(state)


def one_step_gap(start, got, want) -> dict:
    """``got`` against ``want``, both one step after ``start``: the least
    share of a param leaf's elements within one bf16 ULP, and the largest
    relative Frobenius error of a loaded moment leaf (m or v)."""
    import torch
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.optim import adamw
    (p0, s0), (pg, sg), (pw, sw) = start, got, want
    if not int(sg["step"]) == int(sw["step"]) == int(s0["step"]) + 1:
        raise AssertionError("one_step_gap: steps differ")
    share = 1.0
    for (_, a), (_, b) in zip(leaf_paths(pg), leaf_paths(pw)):
        a, b = a.float(), b.float()
        mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        share = min(share, float(((a - b).abs() <= ulp).float().mean()))
    err = 0.0
    for key in ("m", "v"):
        for (_, p), x, y in zip(leaf_paths(p0),
                                adamw._store_leaves(sg[key]),
                                adamw._store_leaves(sw[key])):
            if type(x) is not type(y):
                raise AssertionError(f"one_step_gap: {key} stores differ")
            a, b = adamw._load(x, p.shape), adamw._load(y, p.shape)
            err = max(err, float((a - b).norm() / b.norm()))
    return {"param_share_within_1ulp": share, "moment_rel_err": err}


def phase_train_parity(dev, cfg, state: dict) -> dict:
    """Phase 10c: card vs CPU at the reduced config and a wider one, under
    f32 and bdi8: the first loss (rtol 1e-4) and 10 steps' losses of runs
    resuming one CPU-made step-0 checkpoint, then one step from one state
    (the card resumes the CPU run's step 9) against the CPU's step 10,
    within ``tests/test_torch_train.py``'s one-step bounds; restart
    continuity on the card; a real moment leaf of 10b through the tile
    kernels and their plain versions."""
    import shutil
    import tempfile

    import torch
    from repro_torch.kernels import bdi_compress, bdi_decompress, ref
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw
    from repro_torch.checkpoint import store
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    wider = register(cfg.reduced(n_layers=2, d_model=256, n_heads=8,
                                 n_kv_heads=2, d_ff=512, vocab=4096),
                     "yi-6b-w256")
    # losses over 10 steps: near-checks, each a few times the largest
    # card-vs-CPU gap of the first runs (PR 20: 1.5e-4 / 3.2e-3 reduced,
    # 1.4e-4 / 1.31e-2 wider); the one-step state bounds are what a fault
    # in the moments or the update fails (tests/test_torch_train.py)
    tol = {"yi-6b": {"f32": 2e-3, "bdi8": 1e-2},
           wider.name: {"f32": 2e-3, "bdi8": 3e-2}}
    one_step = {"param_share_within_1ulp": 0.99, "moment_rel_err": 2e-2}
    res = {"card": smi(), "rtol": tol, "one_step_bounds": one_step}
    for arch, smoke in (("yi-6b", True), (wider.name, False)):
        a = get_arch(arch).reduced() if smoke else get_arch(arch)
        for md in ("f32", "bdi8"):
            # both devices resume one step-0 checkpoint of a CPU init: a
            # generator on the card draws other numbers than on the CPU
            params = init_params(a, torch.Generator().manual_seed(0), "cpu")
            runs = {}
            kw = dict(smoke=smoke, steps=10, seq_len=64, batch=4,
                      ckpt_every=9, moment_dtype=md, log_every=100)
            with tempfile.TemporaryDirectory() as tmp:
                store.save(f"{tmp}/init", 0, (params, adamw.export_state(
                    adamw_init(params, AdamWConfig(moment_dtype=md)))),
                    extra={"next_step": 0, "data_seed": 0, "loss": None})
                for d in ("cuda", "cpu"):
                    shutil.copytree(f"{tmp}/init", f"{tmp}/{d}")
                    runs[d] = train(arch, ckpt_dir=f"{tmp}/{d}", device=d,
                                    **kw)["losses"]
                shutil.copytree(f"{tmp}/cpu", f"{tmp}/one", ignore=(
                    lambda d, names: [n for n in names if n.startswith(
                        "step_") and n != f"step_{9:010d}"]))
                train(arch, ckpt_dir=f"{tmp}/one", device="cuda", **kw)
                gap = one_step_gap(
                    load_train_ckpt(f"{tmp}/cpu", a, md, 9),
                    load_train_ckpt(f"{tmp}/one", a, md, 10),
                    load_train_ckpt(f"{tmp}/cpu", a, md, 10))
            rel = max(abs(x - y) / abs(y) for x, y in zip(runs["cuda"],
                                                          runs["cpu"]))
            first = abs(runs["cuda"][0] - runs["cpu"][0]) / runs["cpu"][0]
            res[f"{arch}/{md}"] = {"max_rel": rel, "first_rel": first,
                                   "one_step": gap, **runs}
            if first > 1e-4 or rel > tol[arch][md] or \
                    gap["param_share_within_1ulp"] < one_step[
                        "param_share_within_1ulp"] or \
                    gap["moment_rel_err"] > one_step["moment_rel_err"]:
                raise AssertionError(f"phase 10c: {arch} {md} card vs cpu: "
                                     f"{res[f'{arch}/{md}']}")
    # restart continuity on the card (f32 moments, as test_system)
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(smoke=True, seq_len=32, batch=4, log_every=100,
                  device="cuda")
        train("yi-6b", steps=20, ckpt_dir=f"{tmp}/a", ckpt_every=10, **kw)
        resumed = train("yi-6b", steps=30, ckpt_dir=f"{tmp}/a",
                        ckpt_every=10, **kw)
        whole = [train("yi-6b", steps=30, ckpt_dir=f"{tmp}/{d}",
                       ckpt_every=30, **kw)["losses"] for d in "bc"]
    res["restart"] = {
        "resumed_final": resumed["final_loss"], "whole_final": whole[0][-1],
        "rel": abs(resumed["final_loss"] - whole[0][-1]) / whole[0][-1],
        "two_whole_runs_bit_equal": whole[0] == whole[1]}
    if resumed["steps_run"] != 10 or res["restart"]["rel"] > 1e-5:
        raise AssertionError(f"phase 10c: restart continuity {res}")
    # one real moment leaf of 10b (layer 0's MLP gate-projection m) through
    # the tile kernels and their plain versions
    st = state["m"]["blocks"]["ffn"]["gate"]["w"]
    tiles = adamw._load({k: v[0] for k, v in st.items()},
                        st["deltas"][0].shape[:-2]
                        + (st["deltas"].shape[-2] * 128,)).reshape(-1, 128)
    got, want = bdi_compress.bdi_compress(tiles), ref.compress_ref(tiles)
    out, out_ref = bdi_decompress.bdi_decompress(got), ref.decompress_ref(got)
    sync(dev)
    for name, a, b in list(zip(got._fields, got, want)) + [("out", out,
                                                            out_ref)]:
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"phase 10c: a 10b moment leaf: {name} "
                                 "differs between kernel and plain version")
    res["moment_leaf_tiles"] = tiles.shape[0]
    log(f"phase 10c: {json.dumps(res)}")
    return res


def phase_train_twins(dev) -> dict:
    """Phase 10d: the training twins on the card."""
    from repro_torch.launch import compressed_checkpointing, train_lm
    t0 = time.perf_counter()
    lm = train_lm.main(steps=TRAIN_LM_STEPS, device="cuda")
    t_lm = time.perf_counter() - t0
    _finite_losses("train_lm", lm["losses"])
    cc = compressed_checkpointing.main(device="cuda")
    res = {"card": smi(), "train_lm": {
        "first": lm["first_loss"], "final": lm["final_loss"],
        "drop": lm["first_loss"] - lm["final_loss"], "s": t_lm,
        **_step_split(lm)},
        "compressed_checkpointing": {
            "first_run_final": cc["first"]["final_loss"],
            "resumed_first": cc["resumed"]["losses"][0],
            "resumed_final": cc["resumed"]["final_loss"],
            "compression_ratio": cc["compression_ratio"]}}
    log(f"phase 10d: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phases 11-11f: dense decode, the quantised cache, gemma3's rings, MoE and
# MLA serving, MoE training
# ---------------------------------------------------------------------------

def at_depth(cfg, n_layers: int, **kw):
    """``cfg`` at full width with ``n_layers`` layers (and ``kw``)."""
    import dataclasses
    return dataclasses.replace(cfg, n_layers=n_layers, **kw)


def model_on(dev, cfg) -> dict:
    """Random params of ``cfg`` (any family) from a seeded generator on
    ``dev``."""
    import torch
    from repro_torch.models.api import get_model
    params = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 dev)
    sync(dev)
    return params


def n_params(params: dict) -> int:
    return sum(t.numel() for t in _leaves(params))


def timed_generate(dev, arch: str, batch: int, prompt_len: int,
                   gen: int) -> dict:
    """``launch.serve.generate(arch, paged=False)`` at full width (its
    params from seed 0 on the card, its prompts from seed 1), after a
    short warm-up call (cuBLAS heuristics, allocator); with the peak
    memory of the timed call (its init included)."""
    import torch
    from repro_torch.launch import serve
    serve.generate(arch, smoke=False, batch=batch, prompt_len=16, gen=3,
                   device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out = serve.generate(arch, smoke=False, batch=batch,
                         prompt_len=prompt_len, gen=gen, device=dev)
    steps = out["decode_s"]
    out.update(decode_ms_per_step=1e3 * sum(steps) / len(steps),
               decode_tok_s=batch * len(steps) / sum(steps),
               prefill_ms=out["prefill_s"] * 1e3,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    torch.cuda.empty_cache()
    return out


def generate_inputs(dev, cfg, batch: int, prompt_len: int):
    """The params and prompts ``launch.serve.generate`` makes."""
    import torch
    prompts = torch.randint(1, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    return model_on(dev, cfg), prompts


def check_tokens(name: str, tokens, vocab: int, shape) -> None:
    import numpy as np
    if np.shape(tokens) != tuple(shape) or not all(
            0 <= t < vocab for row in tokens for t in row):
        raise AssertionError(f"{name}: bad tokens {np.shape(tokens)}")


def quantise_cache(cfg, dense, max_len: int):
    """The quantised cache holding ``dense``'s K/V (every layer global),
    each (token, head) row through ``_quant_vec``."""
    from repro_torch.models import transformer as T
    b = dense.full_k.shape[1]
    q = T.init_quant_cache(cfg, b, max_len, device=dense.full_k.device)
    for (dd, bb, ss), src in (((q.kd, q.kb, q.ks), dense.full_k),
                              ((q.vd, q.vb, q.vs), dense.full_v)):
        for li in range(cfg.n_layers):
            dd[li], bb[li], ss[li] = T._quant_vec(src[li])
    return q


def phase_dense_decode(dev, cfg) -> dict:
    """Phase 11: yi-6b at full width, ``generate(paged=False)``'s loop at
    batch 8 (512-token prompts, 64 new tokens); the quantised cache from
    the same prefill, 16 steps; the same prompts through the paged engine
    under bdi."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.parity import GreedyParity, engine_logits
    batch, plen, gen, page = 8, 512, 64, 16
    out = timed_generate(dev, cfg.name, batch, plen, gen)
    check_tokens("phase 11", out["tokens"], cfg.vocab, (batch, gen))
    params, prompts = generate_inputs(dev, cfg, batch, plen)
    res = {"card": smi(), "params": n_params(params), "batch": batch,
           "prompt_len": plen, "gen": gen,
           **{k: out[k] for k in ("prefill_ms", "decode_ms_per_step",
                                  "decode_tok_s", "tok_per_s",
                                  "cache_bytes", "peak_mem_gb")}}
    # the quantised cache: the prefill's K/V quantised, then 16 steps of
    # decode_step_quant from the same tokens as the dense run
    max_len = plen + gen
    logits, dense = T.prefill(cfg, params, {"tokens": prompts.to(dev)},
                              max_len)
    quant = quantise_cache(cfg, dense, max_len)
    res["quant_cache_bytes"] = T.cache_bytes(quant)
    toks = torch.tensor([r[0] for r in out["tokens"]], device=dev)
    qsteps, same = [], 0
    for j in range(16):
        sync(dev)
        t0 = time.perf_counter()
        ql, quant = T.decode_step_quant(cfg, params, quant, toks, plen + j)
        nxt = torch.argmax(ql, -1).tolist()
        qsteps.append(time.perf_counter() - t0)
        want = [r[j + 1] for r in out["tokens"]]
        same += sum(a == b for a, b in zip(nxt, want))
        toks = torch.tensor(want, device=dev)      # teacher-forced
    res["quant_decode_ms_per_step"] = 1e3 * sum(qsteps[1:]) / 15
    res["quant_tokens_equal_dense_share"] = same / (16 * batch)
    del quant, dense
    # the paged engine under bdi on the same prompts
    reqs = {b: prompts[b].tolist() for b in range(batch)}
    eng = PagedKVEngine(cfg, params, page_size=page,
                        n_pool_pages=pool_for(cfg, reqs, gen, page),
                        max_batch=batch, codec="bdi", device=dev)
    ops.reset_launches()
    eng.add_requests(reqs)
    first = eng.decode_batch()
    parity = GreedyParity()
    parity.check(0, {b: out["tokens"][b][0] for b in range(batch)}, first,
                 engine_logits(eng), lambda sid: logits[sid])
    for _ in range(gen - 1):
        eng.decode_batch()
    need_launched("11 paged", ("bdi_compress_kv",
                                     "paged_attention_tail"))
    paged = [eng.seqs[b].tokens[plen:] for b in range(batch)]
    res["paged_bdi"] = {
        "first_tokens_equal": parity.compared,
        "first_token_ties": [vars(t) for t in parity.ties],
        "tokens_equal_share": sum(a == b for r, q in zip(out["tokens"], paged)
                                  for a, b in zip(r, q)) / (batch * gen)}
    log(f"phase 11: {json.dumps(res)}")
    del eng, params, logits
    torch.cuda.empty_cache()
    return res


def logit_gap_ulps(got, want) -> float:
    """max |got - want| in bf16 ULPs of the largest |want|."""
    from repro_torch.serving.parity import bf16_ulp
    want = want.float().cpu()
    return float((got.float().cpu() - want).abs().max()
                 / bf16_ulp(float(want.abs().max())))


QUANT_LOGIT_ULPS = 4        # decode_step_quant logits, card vs cpu


def quant_gap(a, b) -> dict:
    """Two devices' quantised caches of the same tokens.  A row (token,
    head) whose base and scale agree quantises the same grid, so its
    deltas may differ only by one step, at a rounding boundary; a row
    whose K/V differ by an ULP at element 0 (the base) or whose largest
    residual crossed a power of two (the scale) quantises another grid.
    Every dequantised value stays within two steps of the other's."""
    import torch
    out = {}
    for d, bs, sc in (("kd", "kb", "ks"), ("vd", "vb", "vs")):
        da, db = getattr(a, d).cpu().int(), getattr(b, d).int()
        ba, bb = getattr(a, bs).cpu(), getattr(b, bs)
        sa, sb = getattr(a, sc).cpu(), getattr(b, sc)
        same = (ba == bb) & (sa == sb)
        step = (torch.maximum(sa, sb))[..., None]
        deq = ((da * sa[..., None] + ba[..., None])
               - (db * sb[..., None] + bb[..., None])).abs() / step
        off = (da != db) & same[..., None]
        out[d] = {"rows": same.numel(), "rows_other_grid": int((~same).sum()),
                  "deltas_on_a_boundary": int(off.sum()),
                  "max_delta_gap_same_grid": int(((da - db).abs()
                                                  * same[..., None]).max()),
                  "max_dequant_gap_steps": float(deq.max())}
    return out


def phase_decode_parity(dev, cfg) -> dict:
    """Phase 11b: full width, 2 layers, cuda vs cpu: dense greedy tokens
    equal up to ties; ``decode_step_quant`` over the same tokens: int8
    deltas equal but for values on a rounding boundary (:func:`quant_gap`),
    logits within QUANT_LOGIT_ULPS bf16 ULPs of the largest."""
    import torch
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import transformer as T
    from repro_torch.models.params import to_device
    from repro_torch.serving.parity import GreedyParity
    wide = cfg.reduced(n_layers=2, d_model=cfg.d_model, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                       vocab=cfg.vocab)
    gpu = model_on(dev, wide)
    cpu = to_device(gpu, torch.device("cpu"))
    prompts = torch.randint(1, wide.vocab, (4, 48),
                            generator=torch.Generator().manual_seed(22))
    gen = 16
    g = dense_generate(wide, gpu, prompts, gen, keep_logits=True)
    c = dense_generate(wide, cpu, prompts, gen, keep_logits=True)
    parity = GreedyParity()
    for j in range(gen):
        parity.check(j, {b: r[j] for b, r in enumerate(c["tokens"])},
                     {b: r[j] for b, r in enumerate(g["tokens"])},
                     lambda sid, j=j: g["logits"][j, sid],
                     lambda sid, j=j: c["logits"][j, sid])
    res = {"card": smi(), "dense_tokens_equal": parity.compared,
           "dense_ties": [vars(t) for t in parity.ties]}
    # the quantised cache, both devices fed the prompts' tokens
    n = 32
    qc = {d: T.init_quant_cache(wide, 4, n, device=d) for d in (dev, "cpu")}
    worst = 0.0
    for t in range(n):
        tok = prompts[:, t]
        lg, qc[dev] = T.decode_step_quant(wide, gpu, qc[dev], tok.to(dev), t)
        lc, qc["cpu"] = T.decode_step_quant(wide, cpu, qc["cpu"], tok, t)
        worst = max(worst, logit_gap_ulps(lg, lc))
    gap = quant_gap(qc[dev], qc["cpu"])
    res["quant"] = {"steps": n, "logit_gap_ulps": worst, "cache": gap}
    log(f"phase 11b: {json.dumps(res)}")
    if worst > QUANT_LOGIT_ULPS:
        raise AssertionError(f"phase 11b: quantised-cache logits {worst} "
                             f"bf16 ULPs apart across devices")
    for key, v in gap.items():
        if v["max_delta_gap_same_grid"] > 1 or v["max_dequant_gap_steps"] > 2:
            raise AssertionError(f"phase 11b: {key} differs across devices "
                                 f"beyond a rounding boundary: {v}")
    del gpu, cpu, qc
    torch.cuda.empty_cache()
    return res


def phase_gemma_rings(dev) -> dict:
    """Phase 11c: gemma3-27b at full width, 6 layers (5 local with window
    1024, then 1 global): a 1100-token prompt (the rings wrap), 16 decode
    steps fed the sequence's next tokens; each step's logits against
    forward's at the same position."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving.parity import GreedyParity
    cfg = at_depth(get_arch("gemma3-27b"), 6)
    params = model_on(dev, cfg)
    plen, steps = 1100, 16
    seq = torch.randint(1, cfg.vocab, (2, plen + steps),
                        generator=torch.Generator().manual_seed(23)).to(dev)
    sync(dev)
    t0 = time.perf_counter()
    logits, cache = T.prefill(cfg, params, {"tokens": seq[:, :plen]},
                              plen + steps)
    sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    rows, step_s = [logits.float()], []
    for j in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = T.decode_step(cfg, params, cache, seq[:, plen + j],
                                      plen + j)
        sync(dev)
        step_s.append(time.perf_counter() - t0)
        rows.append(logits.float())
    with torch.no_grad():
        h = T._hidden(cfg, params, {"tokens": seq}, remat=False)
        want = L.lm_logits(params["lm_head"],
                           h[:, plen - 1:plen + steps]).float()
    got = torch.stack(rows, dim=1)
    parity = GreedyParity()
    for j in range(steps + 1):
        parity.check(j, dict(enumerate(want[:, j].argmax(-1).tolist())),
                     dict(enumerate(got[:, j].argmax(-1).tolist())),
                     lambda sid, j=j: got[sid, j],
                     lambda sid, j=j: want[sid, j])
    gap = (got - want).abs()
    res = {"card": smi(), "params": n_params(params),
           "ring_slots": cache.ring_k.shape[2],
           "global_len": cache.full_k.shape[2], "prefill_ms": prefill_ms,
           "decode_ms_per_step": 1e3 * sum(step_s[1:]) / (steps - 1),
           "argmax_equal": parity.compared,
           "ties": [vars(t) for t in parity.ties],
           "worst_gap": float(gap.max()),
           "worst_gap_ulps": logit_gap_ulps(got, want)}
    log(f"phase 11c: {json.dumps(res)}")
    # the prefill/decode-vs-forward bound of tests/test_models.py
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-2, atol=2e-2)
    del params, cache, h
    torch.cuda.empty_cache()
    return res


class RouteLog:
    """Wraps ``models/moe``'s ``_moe_local`` (counting the (token, choice)
    pairs that the capacity drops, on the device: no sync per layer) or
    ``_route`` (keeping every call's router input and choices)."""

    def __init__(self, keep_routes: bool = False):
        from repro_torch.models import moe as M
        self.M, self.keep = M, keep_routes
        self.saved = (M._moe_local, M._route)
        self.dropped = {"prefill": 0, "decode": 0}     # device tensors
        self.routes = []

    def __enter__(self):
        M, (moe_local, route) = self.M, self.saved

        def counted(p, x2d, top_k, n_experts, e_off, e_loc, capacity):
            import torch
            _, idx = route(p["router"], x2d, top_k, n_experts)
            over = (torch.bincount(idx.reshape(-1), minlength=n_experts)
                    - capacity).clamp(min=0).sum()
            key = "prefill" if x2d.shape[0] > 8 else "decode"
            self.dropped[key] = self.dropped[key] + over
            return moe_local(p, x2d, top_k, n_experts, e_off, e_loc,
                             capacity)

        def logged(router, x2d, top_k, n_experts):
            out = route(router, x2d, top_k, n_experts)
            self.routes.append((x2d.cpu(), out[1].cpu()))
            return out

        if self.keep:
            M._route = logged
        else:
            M._moe_local = counted
        return self

    def __exit__(self, *exc):
        self.M._moe_local, self.M._route = self.saved


ROUTE_NEAR_TIE_ULPS = 4     # competing probabilities, f32 ULPs


def route_flips(cfg, cpu_params, routes) -> tuple[int, list[dict]]:
    """The card's expert choices of each ``_route`` call against the
    CPU's on the same router input (layer ``call % n_layers``): equal,
    but where the two competing probabilities lie within
    ROUTE_NEAR_TIE_ULPS f32 ULPs (softmax and the f32 product differ in
    the last bits across devices), each such flip reported.  Returns
    (choices compared, flips)."""
    import numpy as np
    from repro_torch.models import moe as M
    router = cpu_params["blocks"]["ffn"]["router"]
    flips, n = [], 0
    for call, (x2d, got) in enumerate(routes):
        li = call % cfg.n_layers
        rp = {k: v[li] for k, v in router.items()}
        _, want = M._route(rp, x2d, cfg.top_k, cfg.n_experts)
        probs = M._probs(rp, x2d)
        n += want.numel()
        for tok, k in (want != got).nonzero().tolist():
            a = float(probs[tok, want[tok, k]])
            b = float(probs[tok, got[tok, k]])
            ulps = abs(a - b) / float(np.spacing(np.float32(max(a, b))))
            flips.append({"call": call, "token": tok, "choice": k,
                          "ulps": ulps})
            if ulps > ROUTE_NEAR_TIE_ULPS:
                raise AssertionError(f"expert choice differs beyond a "
                                     f"near-tie: {flips[-1]}")
    return n, flips


def phase_deepseek(dev) -> dict:
    """Phase 11d: deepseek-v2-lite-16b at full width, 27 layers (MLA + 64
    experts, capacity factor 1.25): batch 4, 256-token prompts, 32 new
    tokens; a second run counts the capacity's drops (and must give the
    same tokens); then at 2 layers, dropless, cuda vs cpu."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models.params import to_device
    from repro_torch.serving.parity import GreedyParity
    cfg = get_arch("deepseek-v2-lite-16b")
    out = timed_generate(dev, cfg.name, 4, 256, 32)
    check_tokens("phase 11d", out["tokens"], cfg.vocab, (4, 32))
    params, prompts = generate_inputs(dev, cfg, 4, 256)
    with RouteLog() as counts:
        again = dense_generate(cfg, params, prompts, 32)
    if again["tokens"] != out["tokens"]:
        raise AssertionError("phase 11d: two runs gave other tokens")
    res = {"card": smi(), "params": n_params(params),
           "capacity_factor": cfg.capacity_factor,
           **{k: out[k] for k in ("prefill_ms", "decode_ms_per_step",
                                  "decode_tok_s", "tok_per_s",
                                  "cache_bytes", "peak_mem_gb")},
           "dropped_choices": {k: int(v) for k, v in counts.dropped.items()},
           "choices": {"prefill": 27 * 4 * 256 * cfg.top_k,
                       "decode": 27 * 31 * 4 * cfg.top_k}}
    del params, out, again
    torch.cuda.empty_cache()
    two = at_depth(cfg, 2, capacity_factor=cfg.n_experts / cfg.top_k)
    gpu = model_on(dev, two)
    cpu = to_device(gpu, torch.device("cpu"))
    small = prompts[:, :32]
    with RouteLog(keep_routes=True) as rg:
        g = dense_generate(two, gpu, small, 12, keep_logits=True)
    c = dense_generate(two, cpu, small, 12, keep_logits=True)
    parity = GreedyParity()
    for j in range(12):
        parity.check(j, {b: r[j] for b, r in enumerate(c["tokens"])},
                     {b: r[j] for b, r in enumerate(g["tokens"])},
                     lambda sid, j=j: g["logits"][j, sid],
                     lambda sid, j=j: c["logits"][j, sid])
    choices, flips = route_flips(two, cpu, rg.routes)
    res["two_layers_cuda_vs_cpu"] = {
        "tokens_equal": parity.compared,
        "ties": [vars(t) for t in parity.ties],
        "expert_choices_compared": choices, "near_tie_flips": flips}
    log(f"phase 11d: {json.dumps(res)}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return res


def phase_arctic(dev) -> dict:
    """Phase 11e: arctic-480b at full width, 1 layer (128 experts, top-2,
    dense residual FFN): batch 2, 64-token prompts, 8 new tokens."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import dense_generate
    cfg = register(at_depth(get_arch("arctic-480b"), 1), "arctic-480b-1l")
    out = timed_generate(dev, cfg.name, 2, 64, 8)
    check_tokens("phase 11e", out["tokens"], cfg.vocab, (2, 8))
    params, prompts = generate_inputs(dev, cfg, 2, 64)
    again = dense_generate(cfg, params, prompts, 8, keep_logits=True)
    if again["tokens"] != out["tokens"]:
        raise AssertionError("phase 11e: two runs gave other tokens")
    if not torch.isfinite(again["logits"]).all():
        raise AssertionError("phase 11e: non-finite logits")
    res = {"card": smi(), "params": n_params(params),
           **{k: out[k] for k in ("prefill_ms", "decode_ms_per_step",
                                  "decode_tok_s", "tok_per_s",
                                  "peak_mem_gb")}}
    log(f"phase 11e: {json.dumps(res)}")
    del params
    torch.cuda.empty_cache()
    return res


def phase_train_moe(dev) -> dict:
    """Phase 11f: deepseek-v2-lite-16b at full width, 4 layers, trained 4
    steps of 4 x 128 tokens with bf16 moments."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import train
    cfg = register(at_depth(get_arch("deepseek-v2-lite-16b"), 4),
                   "deepseek-v2-lite-16b-4l")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out = train(cfg.name, smoke=False, steps=4, seq_len=128, batch=4,
                moment_dtype="bf16", log_every=1, device=dev)
    sync(dev)
    _finite_losses("phase 11f", out["losses"])
    if not out["losses"][-1] < out["losses"][0]:
        raise AssertionError(f"phase 11f: the loss did not fall: "
                             f"{out['losses']}")
    res = {"card": smi(), "params": n_params(out["params"]),
           "losses": out["losses"], **_step_split(out),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    log(f"phase 11f: {json.dumps(res)}")
    del out
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 12-12e: the recurrent and encoder-decoder families (xlstm-350m,
# hymba-1.5b, seamless-m4t-large-v2): dense decode through generate, card
# vs cpu, training.  No kernel of the seven lies on their path.
# ---------------------------------------------------------------------------

FAMILY_LOGIT_ULPS = 4       # card vs cpu prefill logits, 2 layers


def no_kernel_launched(name: str) -> None:
    """The phase ran none of the seven kernels (their counts stayed 0)."""
    from repro_torch.kernels import ops
    ran = {k: v for k, v in ops.LAUNCHES.items() if v}
    if ran:
        raise AssertionError(f"phase {name}: launched {ran}, none expected")


def frames(cfg, batch: int, n: int):
    """The encoder frames ``launch.serve.generate`` draws (f32, seed 2)."""
    import torch
    return torch.randn((batch, n, cfg.d_model),
                       generator=torch.Generator().manual_seed(2)) * 0.02


def device_ops(dev, fn) -> dict:
    """``fn()`` once under ``torch.profiler``: the kernels and copies it
    ran on the card, their summed device ms, and the host ms of the
    profiled call (synced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    n, busy = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += e.count
            busy += e.self_device_time_total
    return {"device_ops": n, "device_busy_ms": busy / 1e3,
            "profiled_wall_ms": wall * 1e3}


def host_ms(dev, fn, reps: int = 3) -> float:
    """Mean host ms of ``fn()`` (synced), after one unrecorded call."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def generate_numbers(out: dict) -> dict:
    return {k: out[k] for k in ("prefill_ms", "decode_ms_per_step",
                                "decode_tok_s", "tok_per_s", "cache_bytes",
                                "peak_mem_gb")}


def phase_xlstm(dev) -> dict:
    """Phase 12: xlstm-350m at full width and depth through
    ``generate(arch, smoke=False)``: batch 8, 256-token prompts (the
    prefill is 256 decode steps), 64 new tokens; one decode step and one
    sLSTM time scan (block 7, 4 x 128, the training shape) profiled."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import ssm as S
    from repro_torch.models import xlstm as X
    from repro_torch.models.params import layer
    cfg = get_arch("xlstm-350m")
    ops.reset_launches()
    out = timed_generate(dev, cfg.name, 8, 256, 64)
    check_tokens("phase 12", out["tokens"], cfg.vocab, (8, 64))
    params = model_on(dev, cfg)
    slstm = [int(i) for i in X.layer_is_slstm(cfg).nonzero()[0]]
    res = {"card": smi(), "params": n_params(params), "slstm_blocks": slstm,
           **generate_numbers(out)}
    cache = X.init_cache(cfg, 8, 320, device=dev)
    tok = torch.ones(8, dtype=torch.int64, device=dev)
    X.decode_step(cfg, params, cache, tok, 0)
    step = device_ops(dev, lambda: X.decode_step(cfg, params, cache, tok, 1))
    res["decode_step"] = step
    res["prefill_device_ops"] = 256 * step["device_ops"]
    bp = layer(params["blocks"], slstm[0])["slstm"]
    x = (torch.randn((4, 128, cfg.d_model), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3))
         ).to(torch.bfloat16)
    with torch.no_grad():
        res["slstm_scan"] = {
            "shape": [4, 128, cfg.d_model],
            "ms": host_ms(dev, lambda: S.slstm_forward(bp, x, cfg.n_heads)),
            **device_ops(dev, lambda: S.slstm_forward(bp, x, cfg.n_heads))}
    no_kernel_launched("12")
    log(f"phase 12: {json.dumps(res)}")
    del params, cache
    torch.cuda.empty_cache()
    return res


def phase_hymba(dev) -> dict:
    """Phase 12b: hymba-1.5b at full width and depth through
    ``generate(arch, smoke=False)``: batch 2, 1100-token prompts (the
    1024-slot rings of the 29 windowed layers wrap), 16 new tokens; then
    prefill and 16 decode steps fed a sequence, each step's logits
    against ``forward``'s at the same position (argmax equal up to
    reported ties; each row's gap in bf16 ULPs of its largest logit,
    recorded); one decode step, and one layer's Mamba time scan on the
    prompt, sequential (the default) and chunked, timed and profiled."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import hybrid as Hy
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models.params import layer
    from repro_torch.serving.parity import GreedyParity
    cfg = get_arch("hymba-1.5b")
    plen, steps = 1100, 16
    ops.reset_launches()
    out = timed_generate(dev, cfg.name, 2, plen, steps)
    check_tokens("phase 12b", out["tokens"], cfg.vocab, (2, steps))
    params = model_on(dev, cfg)
    is_g, _, (n_g, n_l) = Hy.cache_slots(cfg)
    res = {"card": smi(), "params": n_params(params),
           "global_layers": [int(i) for i in np.nonzero(is_g)[0]],
           "windowed_layers": n_l, **generate_numbers(out)}
    seq = torch.randint(1, cfg.vocab, (2, plen + steps),
                        generator=torch.Generator().manual_seed(24)).to(dev)
    logits, cache = Hy.prefill(cfg, params, {"tokens": seq[:, :plen]},
                               plen + steps)
    rows = [logits.float()]
    for j in range(steps):
        logits, cache = Hy.decode_step(cfg, params, cache, seq[:, plen + j],
                                       plen + j)
        rows.append(logits.float())
    res["ring_slots"] = cache.ring_k.shape[2]
    del cache
    with torch.no_grad():
        h = Hy._hidden(cfg, params, {"tokens": seq}, remat=False)
        want = L.lm_logits(params["lm_head"],
                           h[:, plen - 1:plen + steps]).float()
    del h
    got = torch.stack(rows, dim=1)
    parity = GreedyParity()
    for j in range(steps + 1):
        parity.check(j, dict(enumerate(want[:, j].argmax(-1).tolist())),
                     dict(enumerate(got[:, j].argmax(-1).tolist())),
                     lambda sid, j=j: got[sid, j],
                     lambda sid, j=j: want[sid, j])
    # row 0 is prefill: forward's math on 1100 of the 1116 positions, so
    # its gap is what other GEMM shapes alone move at this depth
    res.update(argmax_equal=parity.compared,
               ties=[vars(t) for t in parity.ties],
               largest_logit=float(want.abs().max()),
               worst_gap=float((got - want).abs().max()),
               row_gap_ulps=[logit_gap_ulps(got[:, j], want[:, j])
                             for j in range(steps + 1)])
    # layer 0's Mamba branch on the prompt's normed embeddings
    bp = layer(params["blocks"], 0)
    with torch.no_grad():
        x = L.rmsnorm(bp["ln1"], L.embed(params["embed"], seq[:, :plen]),
                      cfg.norm_eps)
        scan = {"shape": list(x.shape)}
        seq_out = S.mamba_forward(bp["mamba"], x, cfg.ssm_state)
        scan["sequential_ms"] = host_ms(dev, lambda: S.mamba_forward(
            bp["mamba"], x, cfg.ssm_state))
        scan["sequential"] = device_ops(dev, lambda: S.mamba_forward(
            bp["mamba"], x, cfg.ssm_state))
        S.CHUNKED_SCAN = True
        try:
            chk_out = S.mamba_forward(bp["mamba"], x, cfg.ssm_state)
            scan["chunked_ms"] = host_ms(dev, lambda: S.mamba_forward(
                bp["mamba"], x, cfg.ssm_state))
            scan["chunked"] = device_ops(dev, lambda: S.mamba_forward(
                bp["mamba"], x, cfg.ssm_state))
        finally:
            S.CHUNKED_SCAN = False
        scan["chunked_vs_sequential_ulps"] = logit_gap_ulps(chk_out,
                                                            seq_out)
    res["mamba_scan"] = scan
    cache = Hy.init_cache(cfg, 2, plen + steps, device=dev)
    Hy.decode_step(cfg, params, cache, seq[:, 0], 0)
    res["decode_step"] = device_ops(dev, lambda: Hy.decode_step(
        cfg, params, cache, seq[:, 1], 1))
    del cache
    no_kernel_launched("12b")
    log(f"phase 12b: {json.dumps(res)}")
    del params
    torch.cuda.empty_cache()
    return res


def phase_seamless(dev) -> dict:
    """Phase 12c: seamless-m4t-large-v2 at full width and depth (24 + 24
    layers) through ``generate(arch, smoke=False)``: batch 4, 256 frames
    and 256 prompt tokens, 32 new tokens; a second run gives the same
    tokens."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models.api import get_model
    cfg = get_arch("seamless-m4t-large-v2")
    ops.reset_launches()
    out = timed_generate(dev, cfg.name, 4, 256, 32)
    check_tokens("phase 12c", out["tokens"], cfg.vocab, (4, 32))
    params = model_on(dev, cfg)
    prompts = torch.randint(1, cfg.vocab, (4, 256),
                            generator=torch.Generator().manual_seed(1))
    again = dense_generate(cfg, params, prompts, 32,
                           enc_embeds=frames(cfg, 4, 256), keep_logits=True)
    if again["tokens"] != out["tokens"]:
        raise AssertionError("phase 12c: two runs gave other tokens")
    if not torch.isfinite(again["logits"]).all():
        raise AssertionError("phase 12c: non-finite logits")
    res = {"card": smi(), "params": n_params(params),
           **generate_numbers(out)}
    m = get_model(cfg)
    _, cache = m.prefill(params, {"tokens": prompts[:, :8].to(dev),
                                  "enc_embeds": frames(cfg, 4, 256).to(dev)},
                         16)
    tok = prompts[:, 8].to(dev)
    res["decode_step"] = device_ops(dev, lambda: m.decode_step(
        params, cache, tok, 8))
    del cache
    no_kernel_launched("12c")
    log(f"phase 12c: {json.dumps(res)}")
    del params
    torch.cuda.empty_cache()
    return res


def phase_family_parity(dev) -> dict:
    """Phase 12d: each family at full width and 2 layers (seamless 2 + 2),
    the same params and prompts on the card and the CPU: greedy tokens
    equal up to reported one-bf16-ULP ties, prefill logits within
    FAMILY_LOGIT_ULPS of the largest.  xlstm puts its sLSTM block at
    layer 1 (``slstm_every`` 2); hymba keeps one global layer and one of
    window 1024 (``n_full_attn`` 1), whose ring wraps in a 1030-token
    prompt."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models.params import to_device
    from repro_torch.serving.parity import GreedyParity
    cases = {"xlstm-350m": ({"slstm_every": 2}, 4, 32, 8),
             "hymba-1.5b": ({"n_full_attn": 1}, 2, 1030, 8),
             "seamless-m4t-large-v2": ({"enc_layers": 2}, 4, 64, 8)}
    ops.reset_launches()
    res = {"card": smi()}
    for name, (kw, b, plen, gen) in cases.items():
        cfg = at_depth(get_arch(name), 2, **kw)
        gpu = model_on(dev, cfg)
        cpu = to_device(gpu, torch.device("cpu"))
        prompts = torch.randint(1, cfg.vocab, (b, plen),
                                generator=torch.Generator().manual_seed(25))
        enc = frames(cfg, b, plen) if cfg.is_encdec else None
        g = dense_generate(cfg, gpu, prompts, gen, enc_embeds=enc,
                           keep_logits=True)
        c = dense_generate(cfg, cpu, prompts, gen, enc_embeds=enc,
                           keep_logits=True)
        parity = GreedyParity()
        for j in range(gen):
            parity.check(j, {i: r[j] for i, r in enumerate(c["tokens"])},
                         {i: r[j] for i, r in enumerate(g["tokens"])},
                         lambda sid, j=j: g["logits"][j, sid],
                         lambda sid, j=j: c["logits"][j, sid])
        gap = logit_gap_ulps(g["logits"][0], c["logits"][0])
        res[name] = {"batch": b, "prompt_len": plen, "gen": gen,
                     "tokens_equal": parity.compared,
                     "ties": [vars(t) for t in parity.ties],
                     "prefill_logit_gap_ulps": gap,
                     "cpu_s": c["prefill_s"] + sum(c["decode_s"])}
        if gap > FAMILY_LOGIT_ULPS:
            raise AssertionError(f"phase 12d {name}: prefill logits {gap} "
                                 f"bf16 ULPs apart across devices")
        del gpu, cpu
        torch.cuda.empty_cache()
    no_kernel_launched("12d")
    log(f"phase 12d: {json.dumps(res)}")
    return res


def phase_train_families(dev) -> dict:
    """Phase 12e: ``train()`` at full width, 4 steps of 4 x 128 tokens
    with bf16 moments: xlstm-350m at full depth, hymba-1.5b at 4 layers,
    seamless-m4t-large-v2 at 4 + 4; losses finite and falling, ms a step,
    peak memory."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    cases = {"xlstm-350m": get_arch("xlstm-350m"),
             "hymba-1.5b-4l": at_depth(get_arch("hymba-1.5b"), 4),
             "seamless-m4t-large-v2-4l": at_depth(
                 get_arch("seamless-m4t-large-v2"), 4, enc_layers=4)}
    ops.reset_launches()
    res = {"card": smi()}
    for name, cfg in cases.items():
        register(cfg, name)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        out = train(name, smoke=False, steps=4, seq_len=128, batch=4,
                    moment_dtype="bf16", log_every=1, device=dev)
        sync(dev)
        _finite_losses(f"phase 12e {name}", out["losses"])
        if not out["losses"][-1] < out["losses"][0]:
            raise AssertionError(f"phase 12e {name}: the loss did not fall: "
                                 f"{out['losses']}")
        res[name] = {"params": n_params(out["params"]),
                     "losses": out["losses"], **_step_split(out),
                     "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                     / 1e9}
        del out
    no_kernel_launched("12e")
    log(f"phase 12e: {json.dumps(res)}")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 13-13d: the distributed layer (compressed DP training, card vs
# cpu, MoE's expert-parallel path, elastic restore) on a one-rank mesh
# ---------------------------------------------------------------------------

DP_SEQ, DP_BATCH, DP_STEPS = 128, 8, 4


def dp_batches(dev, cfg, seq: int, batch: int, n: int) -> list:
    """The first ``n`` batches of phase 10's stream (``launch.train``'s:
    seed 0), on ``dev``."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, DataIterator
    it = DataIterator(cfg, ShapeConfig("train", seq, batch, "train"),
                      DataConfig(seed=0))
    return [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
            for _ in range(n)]


def grads_of(model, params: dict, batch: dict) -> dict:
    """The loss's gradients over every leaf (``make_dp_train_step``'s)."""
    import torch
    from repro_torch.models import params as P
    leaves = [t.requires_grad_() for t in P.leaves(params)]
    grads = torch.autograd.grad(model.loss(params, batch), leaves,
                                allow_unused=True, materialize_grads=True)
    for t in leaves:
        t.requires_grad_(False)
    return P.unflatten(params, grads)


def plan_numbers(plan: dict, params: dict) -> dict:
    """Leaves and f32 wire bytes the EC plan ships compressed."""
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import compress_comm as cc
    shapes = {p: tuple(t.shape) for p, t in leaf_paths(params)}
    raw = {p: cc.wire_bytes(s, False) for p, s in shapes.items()}
    on = [p for p, v in plan.items() if v]
    return {"leaves": len(plan), "leaves_compressed": len(on),
            "raw_bytes_compressed": sum(raw[p] for p in on),
            "raw_bytes_all": sum(raw.values()),
            "wire_bytes_a_step_under_plan": sum(
                cc.wire_bytes(shapes[p], True) if plan[p] else raw[p]
                for p in shapes),
            "compressed": sorted(on)}


def dp_run(dev, cfg, batches: list, *, compress: bool, moment_dtype: str,
           plan=None) -> dict:
    """``make_dp_train_step`` over ``batches`` on a one-rank mesh from the
    seed-0 init (``launch.train``'s), AdamW (lr 3e-4) with
    ``moment_dtype`` moments: losses, each step's ms split, the residual's
    norm relative to the reduced gradient's, the tile kernels' launches
    inside the all-reduce, peak memory."""
    import torch
    from repro_torch.distributed import compress_comm as cc
    from repro_torch.launch.mesh import BACKEND, destroy_mesh, make_host_mesh
    from repro_torch.models.api import get_model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    model = get_model(cfg)
    ocfg = AdamWConfig(moment_dtype=moment_dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(params, ocfg)
    res = cc.init_residuals(params, 1) if compress else None
    mesh = make_host_mesh(1, 1, device=dev)
    out = {"losses": [], "fwd_bwd_ms": [], "allreduce_ms": [], "opt_ms": [],
           "residual_rel_norm": [],
           "allreduce_launches": {"bdi_compress": 0, "bdi_decompress": 0}}
    try:
        if torch.distributed.get_backend() != BACKEND[dev.type]:
            raise AssertionError(f"phase 13: a {dev.type} mesh on "
                                 f"{torch.distributed.get_backend()}")
        step = cc.make_dp_train_step(
            model.loss, lambda p, g, s: adamw_update(p, g, s, ocfg), mesh,
            plan=plan, compress=compress)
        for b in batches:
            params, opt, res, m = step(params, opt, res, b)
            out["losses"].append(m["loss"])
            for k in ("fwd_bwd", "allreduce", "opt"):
                out[f"{k}_ms"].append(m[f"{k}_s"] * 1e3)
            for k, v in m["allreduce_launches"].items():
                out["allreduce_launches"][k] += v
            if compress:
                rn = torch.linalg.vector_norm(torch.stack([
                    torch.linalg.vector_norm(r) for r in _leaves(res)]))
                out["residual_rel_norm"].append(float(rn) / m["grad_norm"])
        sync(dev)
    finally:
        destroy_mesh()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    rest = slice(1, None)
    for k in ("fwd_bwd", "allreduce", "opt"):
        xs = out[f"{k}_ms"][rest]
        out[f"{k}_ms_mean"] = sum(xs) / len(xs)
    out["step_ms_mean"] = sum(out[f"{k}_ms_mean"] for k in
                              ("fwd_bwd", "allreduce", "opt"))
    del params, opt, res
    torch.cuda.empty_cache()
    return out


def phase_dp_train(dev, cfg) -> dict:
    """Phase 13: yi-6b at full width and depth, compressed DP training on
    a one-rank NCCL mesh with bdi8 moments, 4 steps of 8 x 128 from phase
    10's stream and init; the EC plan from step 1's gradients; the same 4
    steps with ``compress=False``."""
    import torch
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import compress_comm as cc
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_model
    batches = dp_batches(dev, cfg, DP_SEQ, DP_BATCH, DP_STEPS)
    ops.reset_launches()
    # the EC plan from step 1's gradients (the init's, on batch 1)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    grads = grads_of(model, params, batches[0])
    sync(dev)
    t0 = time.perf_counter()
    plan = cc.plan_compression(grads)
    plan_s = time.perf_counter() - t0
    shapes = [tuple(t.shape) for _, t in leaf_paths(params)]
    plan_info = {"seconds": plan_s, **plan_numbers(plan, params)}
    del params, grads
    torch.cuda.empty_cache()
    comp = dp_run(dev, cfg, batches, compress=True, moment_dtype="bdi8")
    exact = dp_run(dev, cfg, batches, compress=False, moment_dtype="bdi8")
    sync(dev)
    launches = {k: ops.LAUNCHES[k] for k in ("bdi_compress",
                                             "bdi_decompress")}
    for name, run in (("compressed", comp), ("exact", exact)):
        _finite_losses(f"phase 13 {name}", run["losses"])
    for k, n in comp["allreduce_launches"].items():
        if n <= 0:
            raise AssertionError(f"phase 13: {k} never launched inside the "
                                 f"all-reduce: {comp['allreduce_launches']}")
    if any(exact["allreduce_launches"].values()):
        raise AssertionError("phase 13: the raw all-reduce launched a tile "
                             f"kernel: {exact['allreduce_launches']}")
    wire = {"raw_f32": sum(cc.wire_bytes(s, False) for s in shapes),
            "bdi8": sum(cc.wire_bytes(s, True) for s in shapes)}
    wire["reduction"] = wire["raw_f32"] / wire["bdi8"]
    groups = sum(len(cc._groups(torch.empty(s, device="meta")))
                 for s in shapes)
    res = {"card": smi(), "params": sum(
        int(torch.Size(s).numel()) for s in shapes),
        "steps": DP_STEPS, "tokens_a_step": DP_SEQ * DP_BATCH,
        "plan": {k: v for k, v in plan_info.items() if k != "compressed"},
        "plan_compressed_leaves": plan_info["compressed"],
        "wire_bytes_a_step": wire, "allreduce_groups_a_step": groups,
        "exact_final": exact["losses"][-1],
        "bdi8_final": comp["losses"][-1],
        "final_gap": abs(exact["losses"][-1] - comp["losses"][-1]),
        "compressed": comp, "exact": exact, "launches": launches}
    log(f"phase 13: {json.dumps(res)}")
    return res


def phase_dp_parity(dev, cfg) -> dict:
    """Phase 13b: full width, 1 layer: ``tree_all_reduce`` of one set of
    gradients and residuals on the card (NCCL, the tile kernels) and on
    the CPU (gloo, the plain versions), means and residuals bit-equal;
    then one compressed DP step from one state on both, params within one
    bf16 ULP for at least 99% of each leaf."""
    import torch
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import compress_comm as cc
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.api import get_model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    one = at_depth(cfg, 1)
    model = get_model(one)
    gpu = model_on(dev, one)
    cpu_dev = torch.device("cpu")
    cpu = P.tree_map(lambda t: t.to(cpu_dev, copy=True), gpu)
    batch = dp_batches(dev, one, 64, 2, 1)[0]
    grads = grads_of(model, gpu, batch)
    t0 = time.perf_counter()
    plan = cc.plan_compression(grads)
    plan_s = time.perf_counter() - t0
    out, secs = {}, {}
    for side, d in (("card", dev), ("cpu", cpu_dev)):
        g = P.tree_map(lambda t: t.to(d, copy=True), grads)
        r = P.tree_map(lambda t: t.to(torch.float32) * 2.0 ** -9, g)
        mesh = make_host_mesh(1, 1, device=d)
        try:
            ops.reset_launches()
            sync(dev)
            t0 = time.perf_counter()
            cc.tree_all_reduce(g, r, mesh.get_group("data"), None)
            sync(dev)
            secs[side] = time.perf_counter() - t0
            n = (ops.LAUNCHES["bdi_compress"], ops.LAUNCHES["bdi_decompress"])
            if (d.type == "cuda") != (min(n) > 0):
                raise AssertionError(f"phase 13b: tile launches {n} on {d}")
        finally:
            destroy_mesh()
        out[side] = (P.to_device(g, cpu_dev), P.to_device(r, cpu_dev))
    differ = [p for (p, a), (_, b) in zip(
        leaf_paths(out["card"]), leaf_paths(out["cpu"]))
        if not torch.equal(bits(a.float()), bits(b.float()))]
    if differ:
        raise AssertionError(f"phase 13b: tree_all_reduce differs, card vs "
                             f"cpu, at {differ[:6]}")
    del out, grads
    torch.cuda.empty_cache()
    # one compressed DP step from one state (f32 moments, the EC plan)
    ocfg = AdamWConfig()
    after = {}
    for side, d, params in (("card", dev, gpu), ("cpu", cpu_dev, cpu)):
        mesh = make_host_mesh(1, 1, device=d)
        try:
            step = cc.make_dp_train_step(
                model.loss, lambda p, g, s: adamw_update(p, g, s, ocfg),
                mesh, plan=plan)
            p, _, _, m = step(params, adamw_init(params, ocfg),
                              cc.init_residuals(params, 1),
                              {k: v.to(d) for k, v in batch.items()})
            after[side] = (P.to_device(p, cpu_dev), m["loss"])
        finally:
            destroy_mesh()
    share = 1.0
    for (_, a), (_, b) in zip(leaf_paths(after["card"][0]),
                              leaf_paths(after["cpu"][0])):
        a, b = a.float(), b.float()
        mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        share = min(share, float(((a - b).abs() <= ulp).float().mean()))
    res = {"card": smi(), "params": n_params(gpu),
           "plan": {"seconds": plan_s, **{k: v for k, v in plan_numbers(
               plan, gpu).items() if k != "compressed"}},
           "tree_all_reduce_bit_equal_leaves": len(leaf_paths(gpu)),
           "tree_all_reduce_s": secs,
           "step_loss": {k: v[1] for k, v in after.items()},
           "step_param_share_within_1ulp": share}
    if share < 0.99:
        raise AssertionError(f"phase 13b: one DP step, card vs cpu: {res}")
    log(f"phase 13b: {json.dumps(res)}")
    del gpu, cpu, after
    torch.cuda.empty_cache()
    return res


def phase_moe_mesh(dev) -> dict:
    """Phase 13c: deepseek-v2-lite-16b at full width, 4 layers, through
    ``dense_generate`` under ``use_mesh(make_host_mesh(1, 1))`` (the
    expert-parallel path) and without a mesh: tokens and logits
    bit-equal."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
    from repro_torch.launch.serve import dense_generate
    cfg = at_depth(get_arch("deepseek-v2-lite-16b"), 4)
    params, prompts = generate_inputs(dev, cfg, 4, 64)
    dense_generate(cfg, params, prompts[:, :8], 2)          # warm-up
    plain = dense_generate(cfg, params, prompts, 8, keep_logits=True)
    mesh = make_host_mesh(1, 1, device=dev)
    try:
        with use_mesh(mesh):
            ep = dense_generate(cfg, params, prompts, 8, keep_logits=True)
    finally:
        destroy_mesh()
    if ep["tokens"] != plain["tokens"] or not torch.equal(
            bits(ep["logits"]), bits(plain["logits"])):
        raise AssertionError("phase 13c: the expert-parallel path differs "
                             "from the plain one at m = 1")
    check_tokens("phase 13c", ep["tokens"], cfg.vocab, (4, 8))
    res = {"card": smi(), "params": n_params(params),
           "tokens_equal": True, "logits_bit_equal": True,
           **{f"{k}_ms": {"plain": f(plain), "mesh": f(ep)} for k, f in (
               ("prefill", lambda o: o["prefill_s"] * 1e3),
               ("decode_step", lambda o: 1e3 * sum(o["decode_s"])
                / len(o["decode_s"])))}}
    log(f"phase 13c: {json.dumps(res)}")
    del params
    torch.cuda.empty_cache()
    return res


def phase_elastic(dev, cfg) -> dict:
    """Phase 13d: phase 13b's 2-layer model saved with ``store.save`` and
    restored with ``restore_elastic`` onto a one-rank mesh on the card,
    every leaf bit-equal and on the mesh; ``reshard_plan`` of yi-6b at
    full width, (16, 16) -> (2, 2)."""
    import tempfile

    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import store
    from repro_torch.launch.elastic import (abstract_mesh, reshard_plan,
                                            restore_elastic)
    from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
    from repro_torch.models.api import get_model
    two = at_depth(cfg, 2)
    params = model_on(dev, two)
    meta = get_model(two).init(torch.Generator(), "meta")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        man = store.save(tmp, 1, params, compress=False)
        save_s = time.perf_counter() - t0
        mesh = make_host_mesh(1, 1, device=dev)
        try:
            t0 = time.perf_counter()
            out, _ = restore_elastic(tmp, meta, mesh)
            sync(dev)
            restore_s = time.perf_counter() - t0
            for (p, a), (_, b) in zip(store.leaf_paths(out),
                                      store.leaf_paths(params)):
                if not (isinstance(a, DTensor) and a.device_mesh is mesh
                        and a.to_local().device == b.device and torch.equal(
                            a.to_local().view(torch.uint8),
                            b.view(torch.uint8))):
                    raise AssertionError(f"phase 13d: {p} not restored "
                                         "bit-equal onto the mesh")
        finally:
            destroy_mesh()
    full = get_model(cfg).init(torch.Generator(), "meta")
    plan = reshard_plan(full, abstract_mesh((16, 16), ("data", "model")),
                        abstract_mesh((2, 2), ("data", "model")))
    top = max(plan.items(), key=lambda kv: kv[1]["replicated_growth"])
    res = {"card": smi(), "leaves": len(store.leaf_paths(params)),
           "bytes": man["raw_bytes"], "save_s": save_s,
           "restore_s": restore_s, "reshard_plan_16x16_to_2x2": {
               "flagged": sorted(plan), "largest_growth": top}}
    if not plan:
        raise AssertionError("phase 13d: shrinking the mesh flagged nothing")
    log(f"phase 13d: {json.dumps(res)}")
    del params, out
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 14, 14b: the dry run against the card
# ---------------------------------------------------------------------------

def phase_dryrun(dev) -> dict:
    """Phase 14: the dry run's prediction for one yi-6b train step at full
    width and depth (bf16 moments, 8 x 128 in 2 microbatches, bf16
    accumulation, mesh (1, 1)), traced on meta, against the same step
    built and run on the card under ``FlopCounterMode``: FLOPs equal,
    argument bytes within the allocator's rounding, the predicted peak
    (arguments + temp) not under the measured one by more than 10%."""
    import math

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.elastic import abstract_mesh
    from repro_torch.models import frontends
    from repro_torch.models.api import get_model
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_arch("yi-6b")
    shape = ShapeConfig("train_128", 128, 8, "train")
    ocfg, n_micro = AdamWConfig(moment_dtype="bf16"), 2
    pred = dryrun.trace(cfg, shape, abstract_mesh((1, 1), ("data", "model")),
                        ocfg, n_micro, torch.bfloat16)
    release(dev)
    base = torch.cuda.memory_allocated(dev)
    model = get_model(cfg)
    params = model_on(dev, cfg)
    opt = adamw_init(params, ocfg)
    batch = frontends.make_batch(cfg, shape,
                                 torch.Generator(device=dev).manual_seed(1),
                                 dev)
    sync(dev)
    args = torch.cuda.memory_allocated(dev) - base
    n_args = sum(1 for _ in _leaves(params)) + sum(1 for _ in _leaves(opt)) \
        + len(batch)
    step = dryrun.build_train_step(model, ocfg, n_micro, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        params, opt, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])
    step_s = time.perf_counter() - t0
    peak_fc = torch.cuda.max_memory_allocated(dev) - base
    # the same step again, plain: the program a trainer runs
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, opt, metrics = step(params, opt, batch)
    loss2 = float(metrics["loss"])
    plain_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    predicted_peak = pred["argument_size_in_bytes"] \
        + pred["temp_size_in_bytes"]
    res = {"card": smi(), "cell": "yi-6b, 8 x 128, 2 microbatches, bf16 "
           "moments, bf16 accumulation, mesh 1x1",
           "trace_s": pred["trace_s"],
           "flops": {"predicted": pred["traced_flops"],
                     "measured": fc.get_total_flops()},
           "argument_bytes": {"predicted": pred["argument_size_in_bytes"],
                              "measured": args, "tensors": n_args},
           "peak_bytes": {"predicted": predicted_peak,
                          "measured_plain": peak,
                          "measured_under_flop_counter": peak_fc,
                          "gap_plain": (predicted_peak - peak) / peak,
                          "gap_flop_counter": (predicted_peak - peak_fc)
                          / peak_fc},
           "temp_bytes_predicted": pred["temp_size_in_bytes"],
           "losses": [loss, loss2],
           "step_s": {"under_flop_counter": step_s, "plain": plain_s}}
    log(f"phase 14: {json.dumps(res)}")
    if res["flops"]["predicted"] != res["flops"]["measured"]:
        raise AssertionError(f"phase 14: FLOPs differ: {res['flops']}")
    if not 0 <= args - pred["argument_size_in_bytes"] <= ALLOC_ROUND * n_args:
        raise AssertionError(f"phase 14: argument bytes: "
                             f"{res['argument_bytes']}")
    if predicted_peak < 0.9 * max(peak, peak_fc):
        raise AssertionError(f"phase 14: the predicted peak is under the "
                             f"measured one by more than 10%: "
                             f"{res['peak_bytes']}")
    if not all(map(math.isfinite, (loss, loss2))):
        raise AssertionError(f"phase 14: losses {loss}, {loss2}")
    del params, opt, batch, metrics
    return res


def start_dryrun_cli() -> list:
    """Phase 14b's processes, started after the build (they need no card
    and run beside the other phases): ``python -m
    repro_torch.launch.dryrun`` on ``DRYRUN_CELLS``."""
    import os
    import tempfile
    work = Path(tempfile.mkdtemp(prefix="dryrun_cli_"))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        out = work / f"{arch}_{shape}_{int(multi_pod)}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out)]
        procs.append((cmd + ["--multi-pod"] * multi_pod, out, subprocess.Popen(
            cmd + ["--multi-pod"] * multi_pod, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, cwd=SRC.parent)))
    return procs


def phase_dryrun_cli(procs: list) -> list:
    """Phase 14b: the three rows of ``start_dryrun_cli``: each process
    exits 0, its row has 256 (512 with ``--multi-pod``) devices and
    positive traced FLOPs, and yi-6b's train_4k rank on two pods traces
    half the FLOPs of one pod's (half the rows)."""
    rows = []
    try:
        for cmd, out, proc in procs:
            text, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"phase 14b: {' '.join(cmd[2:])} exited "
                                     f"{proc.returncode}: {text[-2000:]}")
            rows.append(json.loads(out.read_text()))
    finally:
        for _, _, proc in procs:
            proc.kill()
            proc.wait()
    for (_, _, multi_pod), row in zip(DRYRUN_CELLS, rows):
        log("phase 14b: " + json.dumps(
            {k: v for k, v in row.items() if k not in ("not_measured",)}
            | {"collectives": {k: v for k, v in row["collectives"].items()
                               if k != "leaves"}}))
        if row["n_devices"] != (512 if multi_pod else 256) \
                or row["traced_flops"] <= 0:
            raise AssertionError(f"phase 14b: row {row['arch']} "
                                 f"{row['shape']}: {row['n_devices']} "
                                 f"devices, {row['traced_flops']} FLOPs")
    if 2 * rows[2]["traced_flops"] != rows[1]["traced_flops"]:
        raise AssertionError("phase 14b: yi-6b train_4k on two pods is not "
                             "half a pod's FLOPs a rank")
    return rows


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
        release(dev)
        t0 = time.perf_counter()

    phase_done("1 build")
    cli = start_dryrun_cli()
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
    warm, clean, clean_rows = phase_scheduler(dev, cfg, params, page)
    phase_done("7/7b scheduler + prefix cache, warm and cold")
    phase_multi_turn(dev, cfg, params, page)
    phase_done("8 multi-turn from the host tier, then host + disk")
    phase_snapshot(dev, cfg, params, page)
    phase_done("8b snapshot/restore mid-stream")
    phase_chaos(dev, cfg, params, page, clean, clean_rows)
    del clean_rows
    phase_done("8c chaos")
    observed = phase_observatory(dev, cfg, params, page, warm, clean)
    del clean
    phase_done("9 observatory, bdi (pure observer) and adaptive")
    del params
    release(dev)

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
        phase_parity(dev, wide, page, 20, 140, WIDE_5B_STEPS, codec)
    phase_done("5b parity zero/raw/fpc/gbdi/adaptive")
    gemma = get_arch("gemma3-27b")
    gemma_wide = gemma.reduced(n_layers=2, d_model=5376, n_heads=32,
                               n_kv_heads=16, d_ff=21504, vocab=262144)
    log("5c: gemma3-27b at full width, 2 layers: 8 prompts of 16-48 tokens "
        "and 8 decode steps (phase 5: 20-140 and 24), weights made on the "
        "card, so that the CPU engine stays within the time limit")
    phase_parity(dev, gemma_wide, page, 16, 48, 8, init_on=dev.type)
    phase_done("5c parity bdi gemma3-27b")
    for codec in ("bdi", "gbdi"):
        phase_parity(dev, tiny, page, 16, 60, 24, codec, scheduler=True)
    phase_done("7c scheduler parity bdi/gbdi")
    for codec in ("bdi", "gbdi"):
        parity_snapshot_tier(dev, tiny, page, codec)
    phase_done("8d snapshot and tier, card to cpu, bdi/gbdi")
    oracle = phase_oracle(dev, wide, page)
    phase_done("9b the oracle on the card, bdi/gbdi")
    phase_obs_snapshot(dev, tiny, page)
    phase_done("9c observatory snapshot, card to cpu")
    trained = phase_train(dev, cfg)
    phase_done("10 train yi-6b at full width, bdi8 moments")
    _, moments = phase_train_dtypes(dev, cfg)
    phase_done("10b moment dtypes at full width, 2 layers")
    phase_train_parity(dev, cfg, moments)
    del moments
    phase_done("10c training card vs cpu, restart, a moment leaf")
    phase_train_twins(dev)
    phase_done("10d the training twins")
    phase_dense_decode(dev, cfg)
    phase_done("11 yi-6b dense decode at full width, quantised cache, "
               "paged bdi")
    phase_decode_parity(dev, cfg)
    phase_done("11b dense and quantised decode, card vs cpu, 2 layers")
    phase_gemma_rings(dev)
    phase_done("11c gemma3-27b rings at full width, 6 layers")
    phase_deepseek(dev)
    phase_done("11d deepseek-v2-lite-16b at full width, then card vs cpu")
    phase_arctic(dev)
    phase_done("11e arctic-480b at full width, 1 layer")
    phase_train_moe(dev)
    phase_done("11f train deepseek-v2-lite-16b at full width, 4 layers")
    phase_xlstm(dev)
    phase_done("12 xlstm-350m at full width and depth")
    phase_hymba(dev)
    phase_done("12b hymba-1.5b at full width and depth, rings wrapping")
    phase_seamless(dev)
    phase_done("12c seamless-m4t-large-v2 at full width and depth")
    phase_family_parity(dev)
    phase_done("12d the three families, card vs cpu, 2 layers")
    phase_train_families(dev)
    phase_done("12e train the three families at full width")
    dp = phase_dp_train(dev, cfg)
    phase_done("13 compressed DP training of yi-6b at full width")
    phase_dp_parity(dev, cfg)
    phase_done("13b tree_all_reduce and one DP step, card vs cpu, 1 layer")
    phase_moe_mesh(dev)
    phase_done("13c deepseek-v2-lite-16b's expert-parallel path at m = 1")
    phase_elastic(dev, cfg)
    phase_done("13d elastic restore onto a one-rank mesh, reshard_plan")
    phase_dryrun(dev)
    phase_done("14 the dry run's prediction against a yi-6b step on the card")
    phase_dryrun_cli(cli)
    phase_done("14b the dry run's CLI (started after phase 1, beside the "
               "others)")

    # launches of the paths that ran each kernel (3b set its own): the
    # serve run of phase 4 or 4b, the tile path and the training runs of
    # phases 10 and 13 (the compressed all-reduce), and for the serving
    # kernels phases 9 and 9b, each counted from 0 over its own run
    path = {"bdi_compress_kv": bdi, "paged_attention_tail": bdi,
            "gbdi_compress_kv": gbdi, "gbdi_decompress_kv": gbdi,
            "bdi_compress": tile, "bdi_decompress": tile}
    for k in kernels:
        name = k["name"]
        if name in path:
            k["launches"] = path[name]["launches"][name]
        if name in ("bdi_compress", "bdi_decompress"):
            k["launches"] += trained["launches"][name] + dp["launches"][name]
        if name in ("bdi_compress_kv", "paged_attention_tail",
                    "gbdi_compress_kv", "gbdi_decompress_kv"):
            k["launches"] += (observed["launches"][name]
                              + oracle["launches"][name])
        if k["launches"] <= 0:
            raise AssertionError(f"{name}: no launch on its path")

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
