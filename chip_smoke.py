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
     at full width, ``DP_LAYERS`` = 8 of its 32 layers (full depth until
     PR 27; the EC plan's host percentile over every gradient value was
     ~60 s of it) on a one-rank NCCL mesh
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
  14b. the dry run's CLI in four processes, started after phase 1 (they
     need no card): xlstm-350m long_500k, yi-6b train_4k, the same with
     ``--multi-pod``, and arctic-480b train_4k; each row is a rank at
     coordinate 0 of the production mesh, exits 0 with 256 (512) devices,
     positive traced FLOPs and the rank's collectives by axis, and is
     logged; the two-pod yi-6b rank runs exactly half the one-pod rank's
     FLOPs (half its rows) and the same model-axis collectives; arctic's
     straddling q8 moments move by all-to-all.
     No kernel launches in phases 14-14b.
  15. tensor-parallel serving: internvl2-76b's language model at full
     width (d_model 8192, 64 heads, 8 KV heads, d_ff 28672, vocab
     128256), 4 of its 80 layers (8 before phase 20), on a ``(1, 2)``
     mesh of two rank processes on the one card over gloo (NCCL refuses
     two ranks on one device: two more processes try it first and must
     fail).  Each rank
     draws the whole model from seed 15 on the card a layer at a time
     and keeps its shards (``init_params(local=sharding.Local(mesh))``),
     then serves 4 prompts of 128 tokens and 16 greedy tokens through
     ``launch.serve.dense_generate`` after a short warm-up; the backend,
     prefill ms, ms a step, collectives and bytes a step (``tp.COUNTS``)
     and peak memory per rank are printed, labelled as gloo through the
     host on one card, not a TP speed.  After the ranks exit, the same
     weights whole in this process: the ranks' tokens and logits equal
     each other's; against the whole model, every logits row within 2
     bf16 ULPs of its array's largest |value| (``tests/test_torch_tensor_
     parallel.py``'s bound) while its sequence's tokens agree, tokens
     equal up to reported one-ULP ties.  No kernel launches.
  16. tensor-parallel training: phase 15's model (no frontend embeds)
     on two gloo rank processes of the one card, each drawing its shards
     as phase 15's do and taking 3 steps of ``launch.train.make_train_
     step`` on 4 x 128 tokens of phase 10's stream (the same batch on
     both ranks) under bdi8 moments (lr 3e-4, clip 1.0): the model
     axis's collectives forward and backward through ``distributed/
     tp.py`` (the vocab-parallel loss, the column-parallel input
     gradients, the clip norm's sum), the moments stored and loaded by
     tile kernels 4 and 5 on each rank's shards.  Printed a rank,
     labelled gloo through the host on one card, not a TP speed: ms a
     step split into forward+backward and update, collectives and bytes
     a step (``tp.COUNTS``), tile launches, peak memory.  Each rank must
     launch both tile kernels and no other, the ranks' losses and norms
     be equal and the norms and their moments bit-equal after every
     step.  After the ranks exit, the same weights and batches train
     whole in this process: the first loss within rtol 1e-4, the 3
     within 1e-2 (phase 10c's bdi8 bound); after step 1, on every 16th
     row of each rank's shard of every leaf (block leaves at their first
     and last layer), the params before the step bit-equal, the loaded
     moments within relative error 2e-2, the params >= 98% within one
     bf16 ULP and every element within 2 lr + 1 ULP (a first step from
     zero moments, ``_one_step_gap``).  The kernel launches of both
     ranks go into the ``kernels`` line.
  17. DP x TP: phase 16's model at ``DPT_LAYERS`` = 2 layers (training 8
     would need ~78 GB for the four ranks, and a decode step gathers
     every FSDP block through the host, ~13 s at 8 layers; 4 until phase
     19 came: the rule table makes the same leaves FSDP blocks at 2 as
     at 4) on a ``(2, 2)`` mesh of four gloo rank processes of the one
     card, laid out as JAX's dry run lays out a production cell (params
     by the rule table with ``fsdp=True`` at its real 64 MiB: each rank
     draws the model a layer at a time and keeps its FSDP blocks,
     ``sharding.Local(fsdp=True, layers=)``; batches by ``batch_specs``,
     each rank its rows).  It serves 4 prompts of 128 tokens (2 a data
     group) and ``DPT_GEN`` = 2 greedy tokens (16 until phase 18 came, 8
     until phase 19: a decode step gathers every FSDP block through the
     host, ~6.3 s, most of it the embedding and the head), then trains
     from the same params for ``DPT_STEPS`` = 2 steps (3 until phase 19)
     of 4 x 128 under bdi8 moments (ZeRO-1: each rank keeps its blocks'
     moments, stored and loaded by kernels 4 and 5).  Before the
     ranks start, ``dpt_predict`` computes from the shapes each leaf's
     spec, a rank's param and moment bytes, the collectives of a serving
     step and a train step by axis and the tile launches; each rank must
     match them exactly.  Printed a rank, labelled gloo through the host
     on one card, not a DP or TP speed: the placement, bytes, peaks,
     prefill ms, ms a step, forward+backward and update ms, collectives
     and bytes a step by axis, tile launches.  The four ranks' tokens,
     logits, losses, norms and replicated leaves must be equal, and the
     params whole over data bit-equal across the data ranks.  After the
     ranks exit, the same weights whole in this process: served tokens
     and logits as phase 15's bounds; training as phase 16's (first loss
     rtol 1e-4, 2 losses 1e-2, after step 1 on every 16th row of each
     rank's blocks: the params before the step bit-equal, moments within
     2e-2, params >= 98% within one bf16 ULP, all within 2 lr + 1 ULP).
     Kernels 4 and 5 are held against their plain versions on those rows
     of every moment store of each rank (launches not counted).  Each
     train step of each rank is held against the dry run's trace of that
     rank (``step_traces``, run on ``meta`` in a process started after
     phase 1): its collectives by axis equal, the bytes it holds within
     512 a tensor, the traced peak not under the measured one by more
     than 10%, and the first step's FLOPs (under ``FlopCounterMode``)
     equal.  Then the four processes, as a ``(2, 1, 2)`` mesh (a pod axis
     beside the data and model axes), take one bdi8 step of yi-6b
     reduced to d_model 384 with 3 heads of 128 (FSDP at 16 KiB), whose
     wo, down and embedding tiles straddle the data blocks (each rank
     keeps the moments of another dim's block, moved there by an
     all-to-all): the step held against its trace as above, kernels 4
     and 5 against their plain versions on every tile.  The four ranks'
     launches, the straddling step's included, go into the ``kernels``
     line.
  18. The model axis where the KV heads do not divide it: yi-6b at full
     width (32 heads, 4 KV heads, d_ff 11008, vocab 64000, seed 0) on a
     ``(1, 8)`` mesh of eight gloo rank processes of the one card, the
     smallest model axis on which its KV heads stay whole (wk, wv on
     every rank, each rank's 4 query heads reading their KV head) and
     the decode cache is sharded over T (``cache_specs``: 18 of 144 rows
     a rank).  Each rank draws the model a layer at a time and keeps its
     shards, serves 4 prompts of 128 tokens and 16 greedy tokens at
     ``REP_LAYERS`` = 4 layers (8 until phase 19; decode: the query
     heads gathered, the T blocks' softmax combined by a MAX and a SUM
     all-reduce, the new token's K/V written on the rank that holds its
     row), then trains 3
     steps of 4 x 128 at ``REP_TRAIN_LAYERS`` = 4 under bdi8, where
     gate, up (86 tiles) and lm_head (500) straddle the shards: every
     rank keeps their whole moments, updated from the gradient gathered
     over the model axis, through kernels 4 and 5.  ``rep_predict``
     computes from the shapes a rank's bytes (params, cache, moments),
     the straddling leaves, the collectives of a prefill, a decode step
     and a train step, the row writes a step by rank and the tile
     launches; each rank must match them.  The eight ranks' tokens,
     logits, losses, norms, wk, wv and straddling moments must be equal;
     against the same weights whole in this process, phase 17's bounds.
     Kernels 4 and 5 are held against their plain versions on sampled
     rows of every moment store of each rank, the whole straddling ones
     included; each train step is held against the dry run's trace of
     its rank as in phase 17.  Then each rank takes one more step with
     the sequence-parallel residual stream (``axes.set_sp(True)``: a
     layer's input and output the rank's block of S/8 positions, the
     row-parallel outputs reduce-scattered, ``sp_step``) from clones of
     its first step's params, state and batch: its loss within 1e-4 of
     that step's, its state after it within phase 17's bounds of that
     step's, its collectives, held bytes, FLOPs and peak against the dry
     run's ``--sp`` trace of its rank, its tile launches the first
     step's (``sp_checks``).  The eight ranks' launches go into the
     ``kernels`` line.
  19. The model axis for the MoE and MLA decoders: four gloo rank
     processes of the one card on a ``(1, 4)`` mesh run, in turn,
     deepseek-v2-lite-16b at full width (d_model 2048, 16 MLA heads,
     latent 512, 64 experts top-6 and 2 shared, vocab 102400, seed 0):
     each rank draws the model a layer at a time and keeps its shards,
     its 16 experts a layer among them (``sharding.Local``), serves 4
     prompts of 128 tokens and 16 greedy tokens at ``MOE_LAYERS`` = 4 (8
     before phase 20)
     (each rank its 4 heads, the latent cache split over its last dim
     and gathered at use, its experts' outputs summed over the axis),
     then trains 3 steps of 4 x 128 from phase 10's stream at
     ``MOE_TRAIN_LAYERS`` = 4 under bdi8 (the experts' moment tiles on
     the rank's experts, the shared experts' gate and up straddling the
     shards, through kernels 4 and 5); then arctic-480b at full width
     (d_model 7168, 56/8 heads, 128 experts top-2, a dense residual FFN,
     vocab 32000) at ``ARC_LAYERS`` = 1, 2 prompts of 64 tokens and 8
     greedy tokens, each rank holding 32 experts (~7.0 GB of params,
     against ~28 GB whole).  ``moe_predict`` computes from the shapes a
     rank's bytes (params, caches, moments), the straddling leaves, the
     collectives and their bytes of a prefill, a decode step and a train
     step by axis, and the tile launches; each rank must match them.
     The four ranks' tokens, logits, losses, norms and expert choices
     must be equal; against the same weights whole in this process,
     phase 18's bounds, the whole model's first train step routed as
     the ranks routed (``RouteReplay``: at a random init bf16-level
     differences in the router's input flip near-tied expert choices,
     and each flip moves an expert's gradient; the whole model's router
     must choose exactly the ranks' experts on the ranks' inputs, its
     own inputs lie within 2 bf16 ULPs of the ranks' and at most 3% of
     its own choices differ from theirs).
     Kernels 4 and 5 are held against their plain versions on sampled
     rows of every moment store of each rank.  Then deepseek takes phase
     18's sequence-parallel step (its expert choices those of its first
     step: the gathered sequence routed whole), and arctic-480b, after
     serving, its loss and gradients without and with the sequence-
     parallel stream on one batch of 4 x 128 and no update (its moments
     would not fit four ranks on one card; ``sp_grads``, each gradient
     sampled and freed as it lands): the losses within 1e-4, every
     gradient's sampled rows, the expert stacks' among them, within 1e-2
     relative, the expert choices equal.  The four ranks' launches go into the
     ``kernels`` line.
  20. The model axis for the recurrent and encoder-decoder families:
     four gloo rank processes of the one card on a ``(1, 4)`` mesh run,
     in turn, hymba-1.5b, xlstm-350m and seamless-m4t-large-v2 at their
     published widths (seed 0), at cut depths (``FAM_CELLS``).  Each
     rank draws the whole model on the card and keeps its blocks
     (``sharding.local_params``), serves a few prompts through
     ``dense_generate`` (hymba's of 1040 tokens, so that its rings of
     1024 slots wrap, each rank holding 256 of them; its 25 heads and 5
     KV heads whole on every rank, its full-attention cache over T;
     Mamba on the rank's 800 channels, its state over n; xLSTM's 4 heads
     one a rank; seamless's vocab of 256206, which 4 does not divide,
     whole on every rank) and takes ``FAM_STEPS`` bdi8 train steps,
     kernels 4 and 5 on the rank's moment tiles.  ``fam_predict``
     computes from the shapes (meta tensors on an abstract ``(1, 4)``
     mesh) a rank's bytes (params, cache, moments), the collectives and
     their bytes of a prefill, a decode step and a train step by axis,
     and the tile launches a step; each rank must match them.  The four
     ranks' tokens, logits, losses and norms must be equal; against the
     same weights whole in this process, greedy tokens equal up to
     one-ULP ties with logits within ``TP_ULPS`` bf16 ULPs (xlstm:
     within twice what reassociating the whole model's mLSTM sums as the
     ranks add them moves its logits, ``Reassociated``, and tokens up to
     near ties within that bound), the first loss within 1e-4 (xlstm:
     or twice what so reassociating moves it) and the others within
     1e-2.  Kernels 4 and 5 are
     held against their plain versions on sampled rows of every moment
     store of each rank.  hymba and xlstm (``FAM_SP``: seamless never
     splits its stream, as in JAX) each take ``FAM_STEPS`` of phase 18's
     sequence-parallel steps from the first step's start, on its
     batches, each held as there against the dry run's ``--sp`` trace of
     each rank's step of 2 x 128: the first loss within 1e-4 of the first
     step's, the second, after the update, within 1e-2 of the second
     step's, as phase 20 holds its own steps; the state after the first
     within twice what reassociating the whole model's sums as the ranks
     add them moves the whole model's first step (``Reassociated``: the
     share of a leaf off by more than one ULP, the moments' relative
     error), or phase 17's bounds where those are wider.  The four
     ranks' launches go into the ``kernels`` line.

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
                ("yi-6b", "train_4k", False), ("yi-6b", "train_4k", True),
                ("arctic-480b", "train_4k", False))
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
DP_LAYERS = 8                   # phase 13's depth, of yi-6b's 32


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
    """Phase 13: yi-6b at full width and ``cfg``'s depth (``DP_LAYERS``),
    compressed DP training on a one-rank NCCL mesh with bdi8 moments, 4
    steps of 8 x 128 from phase 10's stream and init; the EC plan from
    step 1's gradients; the same 4 steps with ``compress=False``."""
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
    """Phase 14b: the rows of ``start_dryrun_cli``, each a rank at
    coordinate 0 of the production mesh: each process exits 0, its row
    has 256 (512 with ``--multi-pod``) devices, positive traced FLOPs,
    the mesh's collectives by axis and no ``collectives.tensor_parallel_
    fsdp`` under ``not_measured``; yi-6b's train_4k rank on two pods runs
    the one-pod rank's program at half its rows (8 of 256 for 16): its
    FLOPs are exactly half (every product's rows halve, the weights'
    blocks are the same) and its model axis issues the same collectives;
    arctic-480b's q8 moments of ``wo`` straddle the data blocks (56 tiles
    over 16), which the rank moves by all-to-all."""
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
            {k: v for k, v in row.items() if k not in ("not_measured",
                                                       "dp_compressed")}))
        if row["n_devices"] != (512 if multi_pod else 256) \
                or row["traced_flops"] <= 0 \
                or set(row["rank"]["coordinate"].values()) != {0} \
                or "by_axis" not in row["collectives"] \
                or "collectives.tensor_parallel_fsdp" in row["not_measured"]:
            raise AssertionError(f"phase 14b: row {row['arch']} "
                                 f"{row['shape']}: {row['n_devices']} "
                                 f"devices, {row['traced_flops']} FLOPs, "
                                 f"rank {row['rank']}")
    one, two = rows[1], rows[2]
    model = lambda r: {k: r["collectives"]["by_axis"]["model"][k]  # noqa
                       for k in ("all_reduce", "all_gather", "all_to_all")}
    if 2 * two["traced_flops"] != one["traced_flops"] \
            or model(one) != model(two):
        raise AssertionError(f"phase 14b: yi-6b train_4k on two pods: "
                             f"{two['traced_flops']} FLOPs and model-axis "
                             f"collectives {model(two)} against one pod's "
                             f"{one['traced_flops']} and {model(one)}")
    if rows[3]["collectives"]["by_axis"]["data"]["all_to_all"] <= 0:
        raise AssertionError("phase 14b: arctic-480b's straddling moments "
                             "moved nothing")
    return rows


# ---------------------------------------------------------------------------
# phase 15: tensor-parallel serving, two ranks on one card
# ---------------------------------------------------------------------------

TP_RANKS = 2
TP_LAYERS = 4                   # of internvl2-76b's 80 (8 before phase 20)
TP_BATCH, TP_PROMPT, TP_GEN = 4, 128, 16
TP_SEED = 15
TP_ULPS = 2


def tp_cfg():
    from repro_torch.configs.registry import get_arch
    cfg = get_arch("internvl2-76b")
    return at_depth(cfg, TP_LAYERS)


def tp_prompts(vocab: int):
    import torch
    return torch.randint(1, vocab, (TP_BATCH, TP_PROMPT),
                         generator=torch.Generator().manual_seed(TP_SEED + 1))


def nccl_rank(rank: int, work: str) -> None:
    """A rank that asks NCCL for a two-rank group on this card; writes
    what happened."""
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(Path(work) / "nccl_rendezvous"), TP_RANKS), rank=rank,
            world_size=TP_RANKS, device_id=dev)
        dist.all_reduce(torch.ones(1, device=dev))
        torch.cuda.synchronize()
        said = "ok"
    except Exception as e:          # the refusal is the expected outcome
        said = f"{type(e).__name__}: {e}"
    (Path(work) / f"nccl_{rank}.txt").write_text(said)


def tp_rank(rank: int, work: str) -> None:
    """One rank of phase 15: its shards of the model, then warm-up and
    timed ``dense_generate``; writes ``tp_<rank>.json`` and ``.pt``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.kernels._device import resolve_device
    from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models.transformer import init_params
    dev = resolve_device("cuda")
    torch.cuda.set_device(dev)
    cfg = tp_cfg()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(work) / "rendezvous"), TP_RANKS), rank=rank,
        world_size=TP_RANKS)
    try:
        mesh = make_host_mesh(1, TP_RANKS)
        with use_mesh(mesh):
            t0 = time.perf_counter()
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(TP_SEED), dev,
                local=SH.Local(mesh))
            sync(dev)
            init_s = time.perf_counter() - t0
            prompts = tp_prompts(cfg.vocab)
            dense_generate(cfg, params, prompts[:, :16], 3)     # warm-up
            torch.cuda.reset_peak_memory_stats(dev)
            out = dense_generate(cfg, params, prompts, TP_GEN,
                                 keep_logits=True)
            peak = torch.cuda.max_memory_allocated(dev)
        ran = {k: v for k, v in ops.LAUNCHES.items() if v}
        res = {"rank": rank, "backend": dist.get_backend(),
               "param_bytes": sum(t.numel() * t.element_size()
                                  for t in _leaves(params)),
               "init_s": init_s, "prefill_ms": out["prefill_s"] * 1e3,
               "ms_a_step": [s * 1e3 for s in out["decode_s"]],
               "collectives": out["collectives"],
               "cache_bytes": out["cache_bytes"], "peak_bytes": peak,
               "kernel_launches": ran}
        torch.save({"tokens": out["tokens"], "logits": out["logits"]},
                   Path(work) / f"tp_{rank}.pt")
        (Path(work) / f"tp_{rank}.json").write_text(json.dumps(res))
    finally:
        destroy_mesh()


def _spawn(call: str, log_path: Path):
    import os
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
        stdout=open(log_path, "w"), stderr=subprocess.STDOUT, env=env,
        cwd=Path(__file__).resolve().parent)


def _wait_all(procs: list, what: str, timeout: float) -> None:
    try:
        for p, log_path in procs:
            if p.wait(timeout=timeout) != 0:
                time.sleep(5)         # the others' errors reach their logs
                tails = "".join(
                    f"\n--- {lp.name}, exit {q.poll()}: "
                    f"{lp.read_text()[-1500:]}" for q, lp in procs
                    if q.poll() not in (None, 0))
                raise AssertionError(f"{what} exited {p.returncode}"
                                     f": {tails}")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _served_parity(name: str, tokens, logits, whole: dict, ulps: float,
                   batch: int = TP_BATCH) -> tuple:
    """``tokens``/``logits`` of a sharded run against the whole model's
    (``dense_generate`` with ``keep_logits``): every live row's logits
    within ``ulps`` bf16 ULPs of its array's largest |value| while its
    sequence's tokens agree, tokens equal up to reported one-ULP ties.
    Returns (the parity record, the worst gap in ULPs)."""
    from repro_torch.serving.parity import GreedyParity, bf16_ulp
    par, worst = GreedyParity(), 0.0
    gen = logits.shape[0]
    for j in range(gen):
        live = [b for b in range(batch) if b not in par.stopped]
        if live:
            a, w = logits[j, live], whole["logits"][j, live]
            gap = float((a - w).abs().max()) / bf16_ulp(
                float(w.abs().max()))
            worst = max(worst, gap)
            if gap > ulps:
                raise AssertionError(f"{name}: step {j} logits {gap:.2f} "
                                     f"ULPs from the whole model's")
        par.check(j, {b: whole["tokens"][b][j] for b in range(batch)},
                  {b: tokens[b][j] for b in range(batch)},
                  lambda sid, j=j: logits[j, sid],
                  lambda sid, j=j: whole["logits"][j, sid])
    return par, worst


def phase_tensor_parallel(dev) -> dict:
    """Phase 15 (see the module docstring)."""
    import tempfile

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models.transformer import init_params
    work = Path(tempfile.mkdtemp(prefix="tp15_"))
    nccl = [(_spawn(f"nccl_rank({r}, {str(work)!r})", work / f"nccl_{r}.log"),
             work / f"nccl_{r}.log") for r in range(TP_RANKS)]
    _wait_all(nccl, "phase 15: an NCCL probe rank", 300)
    said = [(work / f"nccl_{r}.txt").read_text() for r in range(TP_RANKS)]
    log(f"phase 15: NCCL with {TP_RANKS} ranks on one card: {said[0]}")
    if any(s == "ok" for s in said):
        raise AssertionError("phase 15: NCCL took two ranks on one card")
    t0 = time.perf_counter()
    ranks = [(_spawn(f"tp_rank({r}, {str(work)!r})", work / f"tp_{r}.log"),
              work / f"tp_{r}.log") for r in range(TP_RANKS)]
    _wait_all(ranks, "phase 15: a TP rank", 900)
    ranks_s = time.perf_counter() - t0
    res = [json.loads((work / f"tp_{r}.json").read_text())
           for r in range(TP_RANKS)]
    got = [torch.load(work / f"tp_{r}.pt") for r in range(TP_RANKS)]
    for r, rr in enumerate(res):
        step = rr["ms_a_step"]
        log(f"phase 15 rank {r} (gloo through the host on one card, not a "
            f"TP speed): " + json.dumps(
                rr | {"ms_a_step": {"median": sorted(step)[len(step) // 2],
                                    "min": min(step), "max": max(step)}}))
        if rr["backend"] != "gloo" or rr["kernel_launches"]:
            raise AssertionError(f"phase 15: rank {r}: {rr}")
    for g in got[1:]:
        if g["tokens"] != got[0]["tokens"] or not torch.equal(
                g["logits"], got[0]["logits"]):
            raise AssertionError("phase 15: the ranks disagree")
    # the same weights, whole, in this process
    cfg = tp_cfg()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(TP_SEED),
                         dev)
    prompts = tp_prompts(cfg.vocab)
    dense_generate(cfg, params, prompts[:, :16], 3)             # warm-up
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    whole = dense_generate(cfg, params, prompts, TP_GEN, keep_logits=True)
    no_kernel_launched("15")
    del params
    par, worst = _served_parity("phase 15", got[0]["tokens"],
                                got[0]["logits"], whole, TP_ULPS)
    step = [s * 1e3 for s in whole["decode_s"]]
    out = {"card": smi(), "cell": f"internvl2-76b full width, "
           f"{TP_LAYERS} layers, {TP_BATCH} x {TP_PROMPT} + {TP_GEN}, "
           f"(1, {TP_RANKS}) over gloo on one card",
           "ranks_wall_s": ranks_s, "tokens_equal": par.compared,
           "ties": [t.__dict__ for t in par.ties],
           "worst_logit_gap_ulps": worst,
           "whole": {"prefill_ms": whole["prefill_s"] * 1e3,
                     "ms_a_step_median": sorted(step)[len(step) // 2],
                     "cache_bytes": whole["cache_bytes"]}}
    log(f"phase 15: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 16: training under tensor parallelism, two ranks on one card
# ---------------------------------------------------------------------------

TPT_STEPS = 3
TPT_BATCH, TPT_SEQ = 4, 128
TPT_MOMENTS = "bdi8"
TPT_FIRST_RTOL = 1e-4           # the first loss, one state on both sides
TPT_LOSS_RTOL = 1e-2            # phase 10c's bdi8 trajectory bound
TPT_ULP_SHARE = 0.98            # params within 1 ULP after step 1 (see
TPT_MOMENT_RTOL = 2e-2          # _one_step_gap); moments: test_torch_train
TPT_ROW_STRIDE = 16             # rows of each shard compared after step 1


def tpt_cfg(n_layers: int = TP_LAYERS):
    """Phase 15's model at ``n_layers`` layers, without frontend
    embeddings (the CPU tests train with them): phase 16's at 8, phase
    17's at ``DPT_LAYERS``."""
    return at_depth(tp_cfg(), n_layers, n_frontend_embeds=0)


def tpt_ocfg():
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=3e-4, grad_clip=1.0, moment_dtype=TPT_MOMENTS)


def tpt_batches(cfg, dev, steps: int = TPT_STEPS, rows: int = TPT_BATCH,
                seq: int = TPT_SEQ) -> list:
    """``steps`` batches of ``rows`` x ``seq`` of phase 10's stream
    (``train()``'s: seed 0), every rank the same."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, DataIterator
    it = DataIterator(cfg, ShapeConfig("train", seq, rows, "train"),
                      DataConfig(seed=0))
    return [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()
             if k != "embeds"} for _ in range(steps)]


def _is_norm(path: str) -> bool:
    return "norm" in path or "['ln" in path


def _sample(t, path: str, n_layers: int):
    """Rows of a shard (a param leaf, or a moment store's tensors, whose
    leading dims are the param's) compared after step 1: block leaves at
    their first and last layer, every ``TPT_ROW_STRIDE``-th row of the
    next dim; the embedding and the head every ``TPT_ROW_STRIDE``-th row;
    the norms whole.  The whole state of a rank is ~20 GB, which would
    have to cross the host between the processes."""
    if _is_norm(path):
        return t
    if path.startswith("['blocks']"):      # the stride a view, then a copy
        return t[:, ::TPT_ROW_STRIDE][[0, n_layers - 1]]
    return t[::TPT_ROW_STRIDE]


def tpt_state(params: dict, state: dict | None, n_layers: int,
              coord: dict | None = None, owners: list | None = None,
              shape: tuple = (1, TP_RANKS), wide: list | None = None
              ) -> dict:
    """``_sample`` of every param leaf and of its two moments (loaded to
    f32; none with ``state`` None), on the host.  ``coord``: cut the
    whole tree to the blocks of the rank at those coordinates of a
    ``shape`` mesh first (the reference run): a param by its spec
    (``fsdp=True``), a moment store's parts by the
    param's spec on their leading dims (the last param dim is the tile
    count, cut in whole tiles), narrowed along ``owners`` (a ZeRO-1
    leaf's owner dim, by leaf) where the param is whole over data; a
    moment whose tiles straddle the model shards (``wide``, by leaf)
    whole over model."""
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim import adamw
    from repro_torch.launch.elastic import abstract_mesh
    mesh = abstract_mesh(shape, ("data", "model"))
    sizes = dict(zip(("data", "model"), shape))

    def cut(t, spec, owner=None):
        if coord is None:
            return t
        for d, s in enumerate(spec):
            if s is not None:
                b = t.shape[d] // sizes[s]
                t = t.narrow(d, coord[s] * b, b)
        if owner is not None and "data" not in spec:
            b = t.shape[owner] // sizes["data"]
            t = t.narrow(owner, coord["data"] * b, b)
        return t
    stores = {k: adamw._store_leaves(state[k]) for k in ("m", "v")
              } if state is not None else {}
    out = {}
    for i, (path, p) in enumerate(leaf_paths(params)):
        spec = tuple(SH._spec_for(path, tuple(p.shape), mesh,
                                  p.element_size(), True))
        pc = _sample(cut(p.detach(), spec), path, n_layers)
        out[f"param{path}"] = pc.to("cpu", copy=True)
        owner = None if owners is None or owners[i] < 0 else owners[i]
        mspec = spec[:-1] + (None,) if wide and wide[i] else spec
        for k, leaves in stores.items():
            s = leaves[i]
            if isinstance(s, dict):
                s = {n: _sample(cut(x, mspec, owner), f"{path}['{n}']",
                                n_layers) for n, x in s.items()}
                shape = s["deltas"].shape[:-2] + (
                    s["deltas"].shape[-2] * 128,)
            else:
                s = _sample(cut(s, spec, owner), path, n_layers)
                shape = s.shape
            out[f"{k}{path}"] = adamw._load(s, shape).to("cpu", copy=True)
    return out


def tpt_norms(params: dict, state: dict) -> dict:
    """The replicated leaves (the norms) and their moments, on the host."""
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.optim.adamw import _store_leaves
    out = {}
    for (path, p), m_s, v_s in zip(leaf_paths(params),
                                   _store_leaves(state["m"]),
                                   _store_leaves(state["v"])):
        if _is_norm(path):
            for k, t in (("param", p), ("m", m_s), ("v", v_s)):
                parts = t.items() if isinstance(t, dict) else [("", t)]
                for n, x in parts:
                    out[f"{k}{path}{n}"] = x.detach().to("cpu", copy=True)
    return out


def tp_train_rank(rank: int, work: str) -> None:
    """One rank of phase 16: its shards of the model (phase 15's init),
    ``TPT_STEPS`` steps of ``launch.train.make_train_step`` under bdi8
    moments; writes ``tpt_<rank>.json`` and ``tpt_<rank>.pt``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.kernels._device import resolve_device
    from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init, opt_state_bytes
    dev = resolve_device("cuda")
    torch.cuda.set_device(dev)
    cfg, ocfg = tpt_cfg(), tpt_ocfg()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(work) / "rendezvous_train"), TP_RANKS), rank=rank,
        world_size=TP_RANKS)
    try:
        mesh = make_host_mesh(1, TP_RANKS)
        with use_mesh(mesh):
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(TP_SEED), dev,
                local=SH.Local(mesh))
            state = adamw_init(params, ocfg)
            batches = tpt_batches(cfg, dev)
            step = make_train_step(get_model(cfg), ocfg)
            start = tpt_state(params, None, cfg.n_layers)
            sync(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launches()
            mets, norms, sample = [], [], None
            for i, batch in enumerate(batches):
                params, state, met = step(params, state, batch)
                mets.append(met)
                norms.append(tpt_norms(params, state))
                if i == 0:
                    launches = dict(ops.LAUNCHES)
                    sample = tpt_state(params, state, cfg.n_layers)
                    ops.LAUNCHES.update(launches)   # the sample's loads
            peak = torch.cuda.max_memory_allocated(dev)
        res = {"rank": rank, "backend": dist.get_backend(),
               "param_bytes": sum(t.numel() * t.element_size()
                                  for t in _leaves(params)),
               "opt_state_bytes": opt_state_bytes(state, ocfg),
               "losses": [m["loss"] for m in mets],
               "grad_norms": [m["grad_norm"] for m in mets],
               "fwd_bwd_ms": [m["fwd_bwd_s"] * 1e3 for m in mets],
               "opt_ms": [m["opt_s"] * 1e3 for m in mets],
               "collectives": [m["collectives"] for m in mets],
               "peak_bytes": peak,
               "kernel_launches": {k: v for k, v in ops.LAUNCHES.items()
                                   if v}}
        torch.save({"start": start, "sample": sample, "norms": norms},
                   Path(work) / f"tpt_{rank}.pt")
        (Path(work) / f"tpt_{rank}.json").write_text(json.dumps(res))
    finally:
        destroy_mesh()


def _one_step_gap(got: dict, want: dict, start: dict) -> dict:
    """The sampled state after step 1 against the whole model's.  From
    zero moments AdamW moves an element by lr g / (|g| + eps) + lr wd p
    (about lr sign(g)), so two runs whose gradients differ land at most 2
    lr + 1 ULP apart, and exactly where a gradient is near 0 or near eps
    next to its difference.  By param leaf: the share within one bf16 ULP
    (test_torch_train's bound is 99% of a leaf, from states at steps 5 and
    9; here 98%: the TP run's gradients differ from the whole model's by
    1-2% relative at every layer, where its loss agrees to 1e-5, and the
    first step turns that into 1.2-1.8% of the down projection's elements
    off by more than an ULP on the card), the share the two steps moved
    apart from ``start`` (the params before the step, the same on both
    sides) and the largest gap less 1 ULP, over lr; by moment leaf the
    relative Frobenius error (block leaves also at their first and last
    layer)."""
    import torch
    lr = tpt_ocfg().lr
    by_leaf = {}
    for k, a in got.items():
        b = want[k]
        if a.shape != b.shape:
            raise AssertionError(f"{k}: {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)}")
        a, b = a.float(), b.float()
        if k.startswith("param"):
            path = k[len("param"):]
            mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            gap = (a - b).abs()
            p0 = start[k].float()
            apart = torch.sign(a - p0) != torch.sign(b - p0)
            by_leaf.setdefault(path, {}).update(
                within_1_ulp=float((gap <= ulp).float().mean()),
                moved_apart=float(apart.float().mean()),
                max_gap_over_lr=float(((gap - ulp) / lr).max()))
        else:
            err = lambda x, y: float((x - y).norm()          # noqa: E731
                                     / y.norm().clamp(min=1e-30))
            leaf = by_leaf.setdefault(k[1:], {})
            leaf[f"{k[0]}_err"] = err(a, b)
            if k[1:].startswith("['blocks']"):    # layer 0, the last layer
                leaf[f"{k[0]}_err_by_layer"] = [err(a[0], b[0]),
                                                err(a[1], b[1])]
    worst = {"within_1_ulp": min(by_leaf, key=lambda p: by_leaf[p].get(
        "within_1_ulp", 1.0))}
    for n in ("max_gap_over_lr", "m_err", "v_err"):
        worst[n] = max(by_leaf, key=lambda p: by_leaf[p].get(n, 0.0))
    return {"worst": {n: [p, by_leaf[p][n]] for n, p in worst.items()},
            "by_leaf": by_leaf}


def phase_tp_train(dev) -> dict:
    """Phase 16 (see the module docstring)."""
    import math
    import tempfile

    import torch
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    work = Path(tempfile.mkdtemp(prefix="tp16_"))
    t0 = time.perf_counter()
    ranks = [(_spawn(f"tp_train_rank({r}, {str(work)!r})",
                     work / f"tpt_{r}.log"), work / f"tpt_{r}.log")
             for r in range(TP_RANKS)]
    _wait_all(ranks, "phase 16: a TP training rank", 600)
    ranks_s = time.perf_counter() - t0
    res = [json.loads((work / f"tpt_{r}.json").read_text())
           for r in range(TP_RANKS)]
    got = [torch.load(work / f"tpt_{r}.pt") for r in range(TP_RANKS)]
    for r, rr in enumerate(res):
        log(f"phase 16 rank {r} (gloo through the host on one card, not a "
            f"TP speed): {json.dumps(rr)}")
        ran = rr["kernel_launches"]
        if rr["backend"] != "gloo" or set(ran) != {"bdi_compress",
                                                   "bdi_decompress"}:
            raise AssertionError(f"phase 16: rank {r}: backend "
                                 f"{rr['backend']}, launches {ran}")
        if not all(math.isfinite(x) for x in rr["losses"]):
            raise AssertionError(f"phase 16: rank {r}: {rr['losses']}")
    if res[1]["losses"] != res[0]["losses"] or \
            res[1]["grad_norms"] != res[0]["grad_norms"]:
        raise AssertionError("phase 16: the ranks' losses or norms differ")
    for i in range(TPT_STEPS):
        for k, a in got[0]["norms"][i].items():
            if not torch.equal(a, got[1]["norms"][i][k]):
                raise AssertionError(f"phase 16: step {i}: {k} differs "
                                     f"between the ranks")
    # the same weights and batches, whole, in this process
    cfg, ocfg = tpt_cfg(), tpt_ocfg()
    t1 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(TP_SEED),
                         dev)
    state = adamw_init(params, ocfg)
    step = make_train_step(get_model(cfg), ocfg)
    start = [tpt_state(params, None, cfg.n_layers, {"data": 0, "model": r})
             for r in range(TP_RANKS)]
    for r in range(TP_RANKS):
        for k, t in start[r].items():
            if not torch.equal(t, got[r]["start"][k]):
                raise AssertionError(f"phase 16: rank {r}'s {k} is not "
                                     f"its block of the whole model's")
    batches = tpt_batches(cfg, dev)
    whole, want = [], None
    for i, batch in enumerate(batches):
        params, state, met = step(params, state, batch)
        whole.append(met)
        if i == 0:
            want = [tpt_state(params, state, cfg.n_layers,
                              {"data": 0, "model": r})
                    for r in range(TP_RANKS)]
    whole_s = time.perf_counter() - t1
    del params, state
    release(dev)
    gaps = [_one_step_gap(got[r]["sample"], want[r], start[r])
            for r in range(TP_RANKS)]
    losses = [m["loss"] for m in whole]
    tp_losses = res[0]["losses"]
    if abs(tp_losses[0] - losses[0]) > TPT_FIRST_RTOL * abs(losses[0]) or \
            any(abs(a - b) > TPT_LOSS_RTOL * abs(b)
                for a, b in zip(tp_losses, losses)):
        raise AssertionError(f"phase 16: losses {tp_losses} against the "
                             f"whole model's {losses}")
    for r, g in enumerate(gaps):
        log(f"phase 16: rank {r} after step 1 against the whole model: "
            f"{json.dumps(g)}")
    for r, g in enumerate(gaps):
        w = {n: v for n, (_, v) in g["worst"].items()}
        if (w["within_1_ulp"] < TPT_ULP_SHARE
                or w["max_gap_over_lr"] > 2.0
                or max(w["m_err"], w["v_err"]) > TPT_MOMENT_RTOL):
            raise AssertionError(f"phase 16: rank {r} after step 1: "
                                 f"{g['worst']}")
    rest = slice(1, None)
    mean = lambda xs: sum(xs) / len(xs)              # noqa: E731
    out = {"card": smi(), "cell": f"internvl2-76b full width, "
           f"{TP_LAYERS} layers, {TPT_STEPS} steps of {TPT_BATCH} x "
           f"{TPT_SEQ}, {TPT_MOMENTS} moments, (1, {TP_RANKS}) over gloo "
           f"on one card",
           "ranks_wall_s": ranks_s, "whole_wall_s": whole_s,
           "losses_tp": tp_losses, "losses_whole": losses,
           "grad_norms_tp": res[0]["grad_norms"],
           "grad_norms_whole": [m["grad_norm"] for m in whole],
           "after_step_1": [g["worst"] for g in gaps],
           "tp_ms_a_step": {f"rank{r}": {
               "fwd_bwd": mean(rr["fwd_bwd_ms"][rest]),
               "opt": mean(rr["opt_ms"][rest]),
               "first_step": rr["fwd_bwd_ms"][0] + rr["opt_ms"][0]}
               for r, rr in enumerate(res)},
           "whole_ms_a_step": {
               "fwd_bwd": mean([m["fwd_bwd_s"] * 1e3 for m in whole[rest]]),
               "opt": mean([m["opt_s"] * 1e3 for m in whole[rest]])},
           "collectives_a_step": res[0]["collectives"][-1],
           "tile_launches": {f"rank{r}": rr["kernel_launches"]
                             for r, rr in enumerate(res)},
           "peak_gb_a_rank": [rr["peak_bytes"] / 1e9 for rr in res],
           "launches": {k: sum(rr["kernel_launches"].get(k, 0)
                               for rr in res)
                        for k in ("bdi_compress", "bdi_decompress")}}
    log(f"phase 16: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 17: DP x TP (FSDP blocks, ZeRO-1 moments), four ranks on one card
# ---------------------------------------------------------------------------

STEP_KEYS = ("all_reduce", "all_gather", "all_to_all", "reduce_scatter",
             "backward", "bytes")
STEP_PEAK_SHARE = 0.9                # as phase 14 holds the predicted peak
STRADDLE_SHAPE = (2, 1, 2)           # (pod, data, model)
STRADDLE_KW = {"n_layers": 2, "d_model": 384, "n_heads": 3,
               "n_kv_heads": 1, "d_ff": 256, "vocab": 256}
STRADDLE_THRESHOLD = 16 << 10        # FSDP over the pod axis at these widths


def step_traces(cfg, ocfg, shape: tuple, names: tuple, sp: bool = False,
                rows: int = TPT_BATCH, seq: int = TPT_SEQ) -> list:
    """``launch/dryrun.trace`` of one train step of ``cfg`` on the
    phases' batch (``tpt_batches``: ``rows`` x ``seq``, no frontend
    embeds) at every coordinate of the ``shape`` mesh, on meta, in rank
    order, with the sequence-parallel residual stream where ``sp``: each
    rank's collectives by axis (``STEP_KEYS``), FLOPs, the bytes it holds
    (params, moments, its rows) and the peak (those and the trace's temp
    bytes)."""
    import itertools

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.elastic import abstract_mesh
    cell = ShapeConfig("train_chip", seq, rows, "train")
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in tpt_batches(cfg, "cpu", 1, rows, seq)[0].items()}
    out = []
    for idx in itertools.product(*(range(n) for n in shape)):
        row = dryrun.trace(cfg, cell, abstract_mesh(
            shape, names, dict(zip(names, idx))), ocfg, 1, torch.float32,
            batch=batch, sp=sp)
        held = sum(row["rank"]["held_bytes"].values())
        out.append({"collectives": {
            a: [c[k] for k in STEP_KEYS]
            for a, c in row["collectives"]["by_axis"].items()},
            "flops": row["traced_flops"], "held_bytes": held,
            "peak_bytes": held + row["temp_size_in_bytes"],
            "trace_s": row["trace_s"]})
    return out


def write_step_traces(out: str) -> None:
    """Entry of the process ``start_step_traces`` starts: phase 17's and
    18's traces of each rank's train step (``step_traces``; the straddling
    step's too) and the traces of the sequence-parallel steps of phases
    18-20 (``"<phase> sp"``, phase 20's by family) into ``out`` (JSON)."""
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    names = ("data", "model")
    rows = {"17": step_traces(tpt_cfg(DPT_LAYERS), tpt_ocfg(), DPT_SHAPE,
                              names),
            "17 straddling": straddle_traces(),
            "18": step_traces(rep_cfg(REP_TRAIN_LAYERS), tpt_ocfg(),
                              REP_SHAPE, names),
            "18 sp": step_traces(rep_cfg(REP_TRAIN_LAYERS), tpt_ocfg(),
                                 REP_SHAPE, names, sp=True),
            "19 sp": step_traces(moe_cfg(MOE_DS, MOE_TRAIN_LAYERS),
                                 tpt_ocfg(), MOE_SHAPE, names, sp=True)}
    for arch in FAM_SP:
        rows[f"20 sp {arch}"] = step_traces(fam_cfg(arch), tpt_ocfg(),
                                            FAM_SHAPE, names, sp=True,
                                            rows=FAM_TRAIN[0],
                                            seq=FAM_TRAIN[1])
    rows["trace_s"] = time.perf_counter() - t0
    Path(out).write_text(json.dumps(rows))


def start_step_traces() -> dict:
    """Starts ``write_step_traces`` after the build, beside the other
    phases (it needs no card: tens of seconds on the host's CPU)."""
    import tempfile
    work = Path(tempfile.mkdtemp(prefix="step_traces_"))
    out = work / "traces.json"
    return {"proc": _spawn(f"write_step_traces({str(out)!r})",
                           work / "traces.log"),
            "out": out, "log": work / "traces.log"}


def step_traces_of(started: dict, key: str) -> list:
    """The traces ``start_step_traces`` wrote, for phase ``key``."""
    if "rows" not in started:
        _wait_all([(started["proc"], started["log"])],
                  "the dry run's traces of phases 17-20", 600)
        started["rows"] = json.loads(started["out"].read_text())
        log(f"the dry run's traces of phases 17-20 took "
            f"{started['rows']['trace_s']:.1f} s on meta, beside the "
            f"other phases")
    return started["rows"][key]


def _bmm_flops(a_shape, b_shape, *rest, out_shape=None, **kw) -> int:
    """``FlopCounterMode``'s ``bmm`` count for every overload: its own
    formula takes the ``out_dtype`` of ``bmm.dtype`` (the MoE experts'
    f32-accumulated products on the card) for its ``out_shape`` and
    raises."""
    from torch.utils.flop_counter import bmm_flop
    return bmm_flop(a_shape, b_shape)


def measured_step(step, params, state, batch, dev, flops: bool):
    """One train step on a rank, measured as the dry run predicts it:
    the bytes the step takes (params, moments, this rank's rows), the
    peak (those and what the step allocates above what was allocated
    before it) and, with ``flops``, its FLOPs under ``FlopCounterMode``.
    Returns ``(params, state, metrics, measures)``."""
    import contextlib

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tp
    from repro_torch.distributed.axes import current_mesh
    nbytes = lambda tree: sum(t.numel() * t.element_size()    # noqa: E731
                              for t in _leaves(tree))
    rows = batch if tp.data_size() == 1 else \
        SH.local_batch(batch, current_mesh())
    held = nbytes(params) + nbytes(state) + nbytes(rows)
    del rows
    sync(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fc = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.bmm: _bmm_flops}) if flops else \
        contextlib.nullcontext()
    with fc:
        params, state, met = step(params, state, batch)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - before + held
    return params, state, met, {
        "held_bytes": held, "peak_bytes": peak, "tensors": sum(
            1 for _ in _leaves(params)) + sum(1 for _ in _leaves(state))
        + len(batch), "flops": fc.get_total_flops() if flops else None}


def check_step_traces(phase: str, r: int, rr: dict, pred: dict) -> dict:
    """Rank ``r``'s measured train steps (``rr["steps"]``, each with its
    collectives) against the dry run's trace of that rank: collectives
    equal, held bytes within ``ALLOC_ROUND`` a tensor, the predicted peak
    not under the measured one by more than 10%, FLOPs equal where
    measured.  Returns the comparison for the log."""
    worst = 0.0
    for i, (m, c) in enumerate(zip(rr["steps"], rr["collectives"])):
        got = {a: [c[a][k] for k in STEP_KEYS] for a in c}
        if got != pred["collectives"]:
            raise AssertionError(f"phase {phase}: rank {r}: train step {i}'s "
                                 f"collectives {got}, traced "
                                 f"{pred['collectives']}")
        if abs(m["held_bytes"] - pred["held_bytes"]) > \
                ALLOC_ROUND * m["tensors"]:
            raise AssertionError(f"phase {phase}: rank {r}: step {i} holds "
                                 f"{m['held_bytes']} bytes, traced "
                                 f"{pred['held_bytes']}")
        if pred["peak_bytes"] < STEP_PEAK_SHARE * m["peak_bytes"]:
            raise AssertionError(f"phase {phase}: rank {r}: step {i}'s peak "
                                 f"{m['peak_bytes']} bytes, traced "
                                 f"{pred['peak_bytes']}")
        if m["flops"] is not None and m["flops"] != pred["flops"]:
            raise AssertionError(f"phase {phase}: rank {r}: step {i} ran "
                                 f"{m['flops']} FLOPs, traced "
                                 f"{pred['flops']}")
        worst = max(worst, m["peak_bytes"] / pred["peak_bytes"])
    return {"held_bytes": pred["held_bytes"],
            "peak_bytes": {"traced": pred["peak_bytes"],
                           "measured": [m["peak_bytes"]
                                        for m in rr["steps"]]},
            "flops": {"traced": pred["flops"],
                      "measured": [m["flops"] for m in rr["steps"]]},
            "measured_over_traced_peak": worst}


def sp_step(step, params, state, batches: list, dev, n_layers: int) -> tuple:
    """Train steps of a rank with the sequence-parallel residual stream
    (``axes.set_sp(True)`` for the steps, off after them), one a batch of
    ``batches`` (those of the steps without it, from their first), from
    ``params`` and ``state`` (clones of the first step's start), each
    measured as :func:`measured_step`, the first with its FLOPs (as the
    steps without it count theirs): returns ``(record,
    the tpt_state sample after the first step)``, the record's ``steps``
    and ``collectives`` as :func:`check_step_traces` reads them, and the
    tile launches of the steps alone (``ops.LAUNCHES`` as it was, after
    the sample's loads too)."""
    from repro_torch.distributed import axes as AX
    from repro_torch.kernels import ops
    saved = dict(ops.LAUNCHES)
    ops.reset_launches()
    mets, meas, sample = [], [], None
    AX.set_sp(True)
    try:
        for batch in batches:
            params, state, met, m = measured_step(step, params, state, batch,
                                                  dev, flops=sample is None)
            mets.append(met)
            meas.append(m)
            if sample is None:
                launches = dict(ops.LAUNCHES)
                sample = tpt_state(params, state, n_layers)
                ops.LAUNCHES.update(launches)
    finally:
        AX.set_sp(False)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    ops.LAUNCHES.update(saved)
    return {
        "losses": [x["loss"] for x in mets],
        "grad_norms": [x["grad_norm"] for x in mets],
        "fwd_bwd_ms": [x["fwd_bwd_s"] * 1e3 for x in mets],
        "opt_ms": [x["opt_s"] * 1e3 for x in mets],
        "steps": meas, "collectives": [x["collectives"] for x in mets],
        "kernel_launches": launches}, sample


SP_PEAK_FLOOR = 0.85                 # measured / traced peak, at least
SP_STATE_BOUNDS = {"within_1_ulp": TPT_ULP_SHARE, "max_gap_over_lr": 2.0,
                   "moment_err": TPT_MOMENT_RTOL}      # phase 17's


def sp_checks(phase: str, r: int, rr: dict, sp: dict, trace: dict,
              kept: dict, launches: dict,
              bounds: dict = SP_STATE_BOUNDS) -> dict:
    """A rank's sequence-parallel steps (``sp``, :func:`sp_step`) against
    its steps without it (``rr``'s losses, ``kept``'s samples of the state
    before and after the first): the first loss within
    ``TPT_FIRST_RTOL``, a later one (after an update) within
    ``TPT_LOSS_RTOL``; the state after the first step within ``bounds``
    of the other's (``_one_step_gap``'s worst leaf: the share within one
    bf16 ULP at least, the largest gap over lr and the moments' relative
    error at most; phase 17's unless the phase derives its own); each
    step's collectives, held bytes, FLOPs and peak against its ``--sp``
    trace (:func:`check_step_traces`: the traced peak at least 90% of the
    measured; here besides the measured at least ``SP_PEAK_FLOOR`` of
    the traced), a reduce-scatter among them; the
    tile launches ``launches`` a step, the steps' without it.  Returns the
    comparison for the log."""
    for i, (a, b) in enumerate(zip(sp["losses"], rr["losses"])):
        if abs(a - b) > (TPT_LOSS_RTOL if i else TPT_FIRST_RTOL) * abs(b):
            raise AssertionError(f"phase {phase}: rank {r}: the sp step "
                                 f"{i}'s loss {a}, without sp {b}")
    gap = _one_step_gap(kept["sp_sample"], kept["sample"], kept["start"])
    w = {n: v for n, (_, v) in gap["worst"].items()}
    if w["within_1_ulp"] < bounds["within_1_ulp"] \
            or w["max_gap_over_lr"] > bounds["max_gap_over_lr"] \
            or max(w["m_err"], w["v_err"]) > bounds["moment_err"]:
        raise AssertionError(f"phase {phase}: rank {r}: the sp step's state "
                             f"against the step without sp: "
                             f"{gap['worst']}, bounds {bounds}")
    low = [m["peak_bytes"] / trace["peak_bytes"] for m in sp["steps"]]
    if min(low) < SP_PEAK_FLOOR:
        raise AssertionError(f"phase {phase}: rank {r}: the sp steps' peaks "
                             f"are {low} of the traced")
    if not all(c["model"]["reduce_scatter"] for c in sp["collectives"]):
        raise AssertionError(f"phase {phase}: rank {r}: an sp step "
                             f"reduce-scattered nothing")
    n = len(sp["steps"])
    if sp["kernel_launches"] != {k: n * v for k, v in launches.items()}:
        raise AssertionError(f"phase {phase}: rank {r}: {n} sp steps "
                             f"launched {sp['kernel_launches']}, a step "
                             f"without sp {launches}")
    return {"losses": [sp["losses"], rr["losses"][:n]],
            "state_gap": gap["worst"], "state_bounds": bounds,
            "against_trace": check_step_traces(f"{phase} sp", r, sp, trace),
            "collectives": sp["collectives"][0],
            "launches": sp["kernel_launches"],
            "fwd_bwd_ms": sp["fwd_bwd_ms"]}


DPT_SHAPE = (2, 2)                   # (data, model)
DPT_RANKS = DPT_SHAPE[0] * DPT_SHAPE[1]
DPT_LAYERS = 2                       # the rule table's blocks as at 4
DPT_GEN = 2                          # greedy tokens (~6.3 s a decode step)
DPT_STEPS = 2                        # train steps (~22 s each)


def _dpt_mesh():
    from repro_torch.launch.elastic import abstract_mesh
    return abstract_mesh(DPT_SHAPE, ("data", "model"))


def _dpt_coord(rank: int) -> dict:
    return {"data": rank // DPT_SHAPE[1], "model": rank % DPT_SHAPE[1]}


def dpt_predict(cfg) -> dict:
    """What a rank holds and issues, from the shapes alone (meta tensors,
    the rule table at its real threshold on an abstract ``(2, 2)`` mesh):
    each leaf's spec, bytes of params a rank and of its bdi8 moments,
    collectives a serving step and a train step by axis (``tp.COUNTS``:
    all_reduce, all_gather, backward), tile launches a train step.  The
    counts follow ``distributed/tp.py``: over ``data`` an all-gather of
    each FSDP block at its use (a layer's and the head's again in their
    recompute), a backward all-reduce of each leaf's gradient (9 a layer,
    the embedding, the final norm, the head), the loss's sum, the clip
    norm's sum, a ZeRO-1 gather a leaf whose moment alone is split; over
    ``model`` PR 26's count (phase 16)."""
    import torch
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tp
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw as AW
    mesh = _dpt_mesh()
    d = DPT_SHAPE[0]
    ocfg = tpt_ocfg()
    with use_mesh(mesh):
        whole = init_params(cfg, torch.Generator(), "meta")
        local = SH.local_params(whole, mesh, coord=_dpt_coord(0), fsdp=True)
        fsdp = {path: dim is not None
                for path, _, dim in tp.placement(whole, local)}
        lay = AW.plan(local, whole, ocfg)
    n = cfg.n_layers
    layer = sum(f for p, f in fsdp.items() if p.startswith("['blocks']"))
    emb, head = fsdp["['embed']['w']"], fsdp["['lm_head']['w']"]
    zero1 = sum(x.owner is not None and x.data is None for x in lay)
    blocks = []
    for (_, t), x in zip(leaf_paths(local), lay):
        shape = list(t.shape)
        if x.owner is not None and x.data is None:
            shape[x.owner] //= d
        blocks.append(torch.empty(shape, dtype=t.dtype, device="meta"))
    stores = [AW._zero_store(b, ocfg.moment_dtype) for b in blocks]
    moments = 2 * sum(x.numel() * x.element_size() for z in stores
                      for x in (z.values() if isinstance(z, dict) else [z]))
    groups = sum(len(AW._groups(b)) for b in blocks
                 if AW._tiled(tuple(b.shape), ocfg.moment_dtype))
    backward = 5 * n + 1
    return {"specs": {p: str(SH._spec_for(p, tuple(t.shape), mesh,
                                          t.element_size(), True))
                      for p, t in leaf_paths(whole)},
            "param_bytes": sum(t.numel() * t.element_size()
                               for _, t in leaf_paths(local)),
            "moment_bytes": moments, "zero1_leaves": zero1,
            "serve_collectives_a_step": {
                "model": [2 * n + 1, 1, 0],
                "data": [0, layer * n + emb + head + 1, 0]},
            "train_collectives_a_step": {
                "model": [(1 + 2 * n + 2) + (n + 2) + backward + 1, 0,
                          backward],
                "data": [(9 * n + 3) + 1 + any(fsdp.values()),
                         emb + 2 * layer * n + 2 * head + zero1,
                         9 * n + 3]},
            "tile_launches_a_step": 4 * groups}


def dpt_tiles_vs_plain(params: dict, state: dict, n_layers: int,
                       phase: str = "17", sample: bool = True) -> int:
    """Kernels 4 and 5 against their plain versions on the sampled rows
    of every bdi8 moment store of this rank (``_sample``; every tile
    without ``sample``): decompress, then compress what it gave;
    bit-equal or raise.  Returns the tiles held; the launches made here
    are not the main path's (the caller restores ``ops.LAUNCHES``)."""
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.kernels import bdi_compress, bdi_decompress, ref
    from repro_torch.optim import adamw
    n = 0
    for k in ("m", "v"):
        for (path, _), s in zip(leaf_paths(params),
                                adamw._store_leaves(state[k])):
            if not isinstance(s, dict) or "maskp" not in s:
                continue
            x = {name: (_sample(t, path, n_layers) if sample else t)
                 .contiguous() for name, t in s.items()}
            p = ref.PackedTiles(x["deltas"].reshape(-1, 128),
                                x["base"].reshape(-1, 1),
                                x["scale"].reshape(-1, 1),
                                x["maskp"].reshape(-1, 16), None)
            tiles = bdi_decompress.bdi_decompress(p)
            pairs = [("decompress", tiles, ref.decompress_ref(p))]
            got, want = bdi_compress.bdi_compress(tiles), \
                ref.compress_ref(tiles)
            pairs += [(f"compress {f}", a, b)
                      for f, a, b in zip(got._fields, got, want)]
            for name, a, b in pairs:
                if not torch_equal_bits(a, b):
                    raise AssertionError(f"phase {phase}: {k}{path}: "
                                         f"{name} differs from the plain "
                                         f"version")
            n += p.deltas.shape[0]
    return n


def torch_equal_bits(a, b) -> bool:
    import torch
    if a is None or b is None:
        return a is b
    return bool(torch.equal(bits(a), bits(b)))


def dp_tp_rank(rank: int, work: str) -> None:
    """One rank of phase 17 on the ``(2, 2)`` mesh: its FSDP blocks of
    ``tpt_cfg(DPT_LAYERS)``'s model (drawn a layer at a time), serving
    its rows of the prompts, then ``DPT_STEPS`` train steps from the same
    params under bdi8 moments (ZeRO-1 blocks); writes ``dpt_<rank>.json``
    and ``.pt``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tp
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.kernels._device import resolve_device
    from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
    from repro_torch.launch.serve import dense_generate
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import init_params, whole_shapes
    from repro_torch.optim import adamw, adamw_init, opt_state_bytes
    dev = resolve_device("cuda")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(work) / "rendezvous_dptp"), DPT_RANKS), rank=rank,
        world_size=DPT_RANKS)
    res = {"rank": rank, "backend": dist.get_backend()}
    try:
        mesh = make_host_mesh(*DPT_SHAPE)
        with use_mesh(mesh):
            cfg, ocfg = tpt_cfg(DPT_LAYERS), tpt_ocfg()
            t0 = time.perf_counter()
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(TP_SEED), dev,
                local=SH.Local(mesh, fsdp=True, layers=cfg.n_layers))
            sync(dev)
            whole = whole_shapes(cfg)
            res.update(init_s=time.perf_counter() - t0, placement=[
                [path, list(p.shape), dim] for (path, _, dim), (_, p) in zip(
                    tp.placement(whole, params), leaf_paths(params))],
                param_bytes=sum(t.numel() * t.element_size()
                                for t in _leaves(params)))
            # no warm-up: a step is seconds of weight gathers through the
            # host, which a warm-up would only repeat
            torch.cuda.reset_peak_memory_stats(dev)
            out = dense_generate(cfg, params, tp_prompts(cfg.vocab),
                                 DPT_GEN, keep_logits=True)
            res.update(serve_peak_bytes=torch.cuda.max_memory_allocated(dev),
                       prefill_ms=out["prefill_s"] * 1e3,
                       ms_a_step=[s * 1e3 for s in out["decode_s"]],
                       serve_collectives=out["collectives"],
                       cache_bytes=out["cache_bytes"])
            served = {"tokens": out["tokens"], "logits": out["logits"]}
            del out
            state = adamw_init(params, ocfg, whole=whole)
            owners = [-1 if x.owner is None else x.owner
                      for x in adamw.plan(params, whole, ocfg)]
            batches = tpt_batches(cfg, dev, DPT_STEPS)
            step = make_train_step(get_model(cfg), ocfg)
            start = tpt_state(params, None, cfg.n_layers)
            sync(dev)
            torch.cuda.empty_cache()
            ops.reset_launches()
            mets, norms, sample, held, steps, peak = [], [], None, 0, [], 0
            for i, batch in enumerate(batches):
                params, state, met, meas = measured_step(
                    step, params, state, batch, dev, flops=i == 0)
                peak = max(peak, torch.cuda.max_memory_allocated(dev))
                mets.append(met)
                steps.append(meas)
                norms.append(tpt_norms(params, state))
                if i == 0:
                    launches = dict(ops.LAUNCHES)
                    sample = tpt_state(params, state, cfg.n_layers)
                    held = dpt_tiles_vs_plain(params, state, cfg.n_layers)
                    ops.LAUNCHES.update(launches)   # the sample's, plain's
        res.update(
            steps=steps,
            opt_state_bytes=opt_state_bytes(state, ocfg), owners=owners,
            losses=[m["loss"] for m in mets],
            grad_norms=[m["grad_norm"] for m in mets],
            fwd_bwd_ms=[m["fwd_bwd_s"] * 1e3 for m in mets],
            opt_ms=[m["opt_s"] * 1e3 for m in mets],
            collectives=[m["collectives"] for m in mets],
            train_peak_bytes=peak, tiles_held_vs_plain=held,
            kernel_launches={k: v for k, v in ops.LAUNCHES.items() if v})
        del params, state, batches
        torch.cuda.empty_cache()
        res["straddle"] = straddle_step(dev)
        torch.save({"served": served, "start": start, "sample": sample,
                    "norms": norms}, Path(work) / f"dpt_{rank}.pt")
        (Path(work) / f"dpt_{rank}.json").write_text(json.dumps(res))
    finally:
        destroy_mesh()


def straddle_cfg():
    from repro_torch.configs.registry import get_arch
    return get_arch("yi-6b").reduced(**STRADDLE_KW)


def straddle_step(dev) -> dict:
    """Phase 17's ranks after their work: their world as a ``(2, 1, 2)``
    mesh (a pod axis), one bdi8 step of ``straddle_cfg`` with FSDP at
    ``STRADDLE_THRESHOLD`` (test-size widths, so that the blocks lie over
    the pod axis), whose wo, down and embedding tiles straddle the data
    blocks (each rank keeps the moments of another dim's block,
    ``optim/adamw.plan``); kernels 4 and 5 then held against their plain
    versions on every tile of those stores."""
    import torch
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import init_params, whole_shapes
    from repro_torch.optim import adamw, adamw_init
    cfg, ocfg = straddle_cfg(), tpt_ocfg()
    prev = SH.FSDP_THRESHOLD_BYTES
    SH.FSDP_THRESHOLD_BYTES = STRADDLE_THRESHOLD
    try:
        mesh = make_host_mesh(*STRADDLE_SHAPE[1:], pod=STRADDLE_SHAPE[0])
        with use_mesh(mesh):
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(TP_SEED), dev,
                local=SH.Local(mesh, fsdp=True, layers=cfg.n_layers))
            whole = whole_shapes(cfg)
            lay = adamw.plan(params, whole, ocfg)
            state = adamw_init(params, ocfg, whole=whole)
            ops.reset_launches()
            params, state, met, meas = measured_step(
                make_train_step(get_model(cfg), ocfg), params, state,
                tpt_batches(cfg, dev, 1)[0], dev, flops=True)
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            held = dpt_tiles_vs_plain(params, state, cfg.n_layers, "17",
                                      sample=False)
            ops.LAUNCHES.update(launches)
        return {"straddling": [p for (p, _), x in zip(leaf_paths(params), lay)
                               if x.data is not None and x.owner != x.data],
                "loss": met["loss"], "collectives": [met["collectives"]],
                "steps": [meas], "kernel_launches": launches,
                "tiles_held_vs_plain": held}
    finally:
        SH.FSDP_THRESHOLD_BYTES = prev


def straddle_traces() -> list:
    """``step_traces`` of ``straddle_step``'s cell at its threshold."""
    from repro_torch.distributed import sharding as SH
    prev = SH.FSDP_THRESHOLD_BYTES
    SH.FSDP_THRESHOLD_BYTES = STRADDLE_THRESHOLD
    try:
        return step_traces(straddle_cfg(), tpt_ocfg(), STRADDLE_SHAPE,
                           ("pod", "data", "model"))
    finally:
        SH.FSDP_THRESHOLD_BYTES = prev


def phase_dp_tp(dev, started: dict) -> dict:
    """Phase 17 (see the module docstring); ``started``: the dry run's
    traces (``start_step_traces``)."""
    import math
    import tempfile

    import torch
    from repro_torch.launch.serve import dense_generate
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    cfg, ocfg = tpt_cfg(DPT_LAYERS), tpt_ocfg()
    pred = dpt_predict(cfg)
    log(f"phase 17 prediction (shapes, rule table at 64 MiB, (2, 2)): "
        f"{json.dumps(pred)}")
    traces = step_traces_of(started, "17")
    straddle = step_traces_of(started, "17 straddling")
    log(f"phase 17: the dry run's trace of each rank's train step: "
        f"{json.dumps(traces)}; of the straddling step on "
        f"{STRADDLE_SHAPE}: {json.dumps(straddle)}")
    work = Path(tempfile.mkdtemp(prefix="dptp17_"))
    t0 = time.perf_counter()
    ranks = [(_spawn(f"dp_tp_rank({r}, {str(work)!r})",
                     work / f"dpt_{r}.log"), work / f"dpt_{r}.log")
             for r in range(DPT_RANKS)]
    _wait_all(ranks, "phase 17: a DP x TP rank", 900)
    ranks_s = time.perf_counter() - t0
    res = [json.loads((work / f"dpt_{r}.json").read_text())
           for r in range(DPT_RANKS)]
    got = [torch.load(work / f"dpt_{r}.pt") for r in range(DPT_RANKS)]
    for r, rr in enumerate(res):
        step = rr["ms_a_step"]
        log(f"phase 17 rank {r} (gloo through the host on one card, not a "
            f"DP or TP speed): " + json.dumps(
                rr | {"ms_a_step": {"median": sorted(step)[len(step) // 2],
                                    "min": min(step), "max": max(step)}}))
        ran = rr["kernel_launches"]
        if rr["backend"] != "gloo" or set(ran) != {"bdi_compress",
                                                   "bdi_decompress"}:
            raise AssertionError(f"phase 17: rank {r}: backend "
                                 f"{rr['backend']}, launches {ran}")
        if not all(math.isfinite(x) for x in rr["losses"]):
            raise AssertionError(f"phase 17: rank {r}: {rr['losses']}")
        want = pred["tile_launches_a_step"] * DPT_STEPS // 2
        if ran != {"bdi_compress": want, "bdi_decompress": want}:
            raise AssertionError(f"phase 17: rank {r}: launches {ran}, "
                                 f"predicted {want} each")
        for key, meas in (("serve_collectives_a_step", [
                rr["serve_collectives"]["prefill"],
                rr["serve_collectives"]["per_step"]]),
                ("train_collectives_a_step", rr["collectives"])):
            for c in meas:
                for axis, counts in pred[key].items():
                    if [c[axis][k] for k in ("all_reduce", "all_gather",
                                             "backward")] != counts:
                        raise AssertionError(
                            f"phase 17: rank {r}: {key} over {axis} "
                            f"{c[axis]}, predicted {counts}")
        for key, pkey in (("param_bytes", "param_bytes"),
                          ("opt_state_bytes", "moment_bytes")):
            if rr[key] != pred[pkey]:
                raise AssertionError(f"phase 17: rank {r}: {key} {rr[key]}"
                                     f", predicted {pred[pkey]}")
        rr["against_trace"] = check_step_traces("17", r, rr, traces[r])
        st = rr["straddle"]
        st["against_trace"] = check_step_traces("17 (straddling step)", r,
                                                st, straddle[r])
        if not math.isfinite(st["loss"]) or len(st["straddling"]) < 3 \
                or st["tiles_held_vs_plain"] <= 0 or set(
                    st["kernel_launches"]) != {"bdi_compress",
                                               "bdi_decompress"}:
            raise AssertionError(f"phase 17: rank {r}'s straddling step: "
                                 f"{json.dumps(st)}")
        log(f"phase 17 rank {r} against its trace: "
            f"{json.dumps(rr['against_trace'])}; straddling step: "
            f"{json.dumps(st)}")
    for r in range(1, DPT_RANKS):
        if res[r]["losses"] != res[0]["losses"] or \
                res[r]["grad_norms"] != res[0]["grad_norms"]:
            raise AssertionError("phase 17: the ranks' losses or norms "
                                 "differ")
        if got[r]["served"]["tokens"] != got[0]["served"]["tokens"] or \
                not torch.equal(got[r]["served"]["logits"],
                                got[0]["served"]["logits"]):
            raise AssertionError("phase 17: the ranks' serving differs")
        for i in range(DPT_STEPS):
            for k, a in got[0]["norms"][i].items():
                if not torch.equal(a, got[r]["norms"][i][k]):
                    raise AssertionError(f"phase 17: step {i}: {k} differs "
                                         f"between ranks 0 and {r}")
    # the blocks whole over data, the same on the two data ranks
    fsdp = {path for path, _, dim in res[0]["placement"] if dim is not None}
    for j in range(DPT_SHAPE[1]):
        a, b = got[j]["sample"], got[DPT_SHAPE[1] + j]["sample"]
        for k in a:
            if k.startswith("param") and k[len("param"):] not in fsdp:
                if not torch.equal(bits(a[k]), bits(b[k])):
                    raise AssertionError(f"phase 17: {k} differs between "
                                         f"the data ranks of model {j}")
    # the same weights, prompts and batches, whole, in this process:
    # serving, then training from the same params
    t1 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(TP_SEED),
                         dev)
    prompts = tp_prompts(cfg.vocab)
    dense_generate(cfg, params, prompts[:, :16], 3)             # warm-up
    whole = dense_generate(cfg, params, prompts, DPT_GEN, keep_logits=True)
    par, worst = _served_parity("phase 17", got[0]["served"]["tokens"],
                                got[0]["served"]["logits"], whole, TP_ULPS)
    state = adamw_init(params, ocfg)
    step = make_train_step(get_model(cfg), ocfg)
    owners = res[0]["owners"]
    start = [tpt_state(params, None, cfg.n_layers, _dpt_coord(r),
                       shape=DPT_SHAPE) for r in range(DPT_RANKS)]
    for r in range(DPT_RANKS):
        for k, t in start[r].items():
            if not torch.equal(t, got[r]["start"][k]):
                raise AssertionError(f"phase 17: rank {r}'s {k} is not "
                                     f"its block of the whole model's")
    mets, want = [], None
    for i, batch in enumerate(tpt_batches(cfg, dev, DPT_STEPS)):
        params, state, met = step(params, state, batch)
        mets.append(met)
        if i == 0:
            want = [tpt_state(params, state, cfg.n_layers, _dpt_coord(r),
                              owners, DPT_SHAPE) for r in range(DPT_RANKS)]
    whole_s = time.perf_counter() - t1
    del params, state
    release(dev)
    gaps = [_one_step_gap(got[r]["sample"], want[r], start[r])
            for r in range(DPT_RANKS)]
    losses = [m["loss"] for m in mets]
    ours = res[0]["losses"]
    if abs(ours[0] - losses[0]) > TPT_FIRST_RTOL * abs(losses[0]) or \
            any(abs(a - b) > TPT_LOSS_RTOL * abs(b)
                for a, b in zip(ours, losses)):
        raise AssertionError(f"phase 17: losses {ours} against the whole "
                             f"model's {losses}")
    for r, g in enumerate(gaps):
        log(f"phase 17: rank {r} after step 1 against the whole model: "
            f"{json.dumps(g['worst'])}")
        w = {n: v for n, (_, v) in g["worst"].items()}
        if (w["within_1_ulp"] < TPT_ULP_SHARE
                or w["max_gap_over_lr"] > 2.0
                or max(w["m_err"], w["v_err"]) > TPT_MOMENT_RTOL):
            raise AssertionError(f"phase 17: rank {r} after step 1: "
                                 f"{g['worst']}")
    rest = slice(1, None)
    mean = lambda xs: sum(xs) / len(xs)              # noqa: E731
    out = {"card": smi(), "cell": f"internvl2-76b full width, "
           f"{cfg.n_layers} layers, (2, 2) over gloo on one card, FSDP and "
           f"ZeRO-1 at 64 MiB: serving {TP_BATCH} x {TP_PROMPT} + {DPT_GEN}, "
           f"then {DPT_STEPS} train steps of {TPT_BATCH} x {TPT_SEQ} under "
           f"{ocfg.moment_dtype} moments",
           "ranks_wall_s": ranks_s, "whole_wall_s": whole_s,
           "tokens_equal": par.compared,
           "ties": [t.__dict__ for t in par.ties],
           "worst_logit_gap_ulps": worst,
           "losses": ours, "losses_whole": losses,
           "grad_norms": res[0]["grad_norms"],
           "grad_norms_whole": [m["grad_norm"] for m in mets],
           "after_step_1": [g["worst"] for g in gaps],
           "ms_a_step": {f"rank{r}": {
               "prefill": rr["prefill_ms"],
               "decode_median": sorted(rr["ms_a_step"])[
                   len(rr["ms_a_step"]) // 2],
               "fwd_bwd": mean(rr["fwd_bwd_ms"][rest]),
               "opt": mean(rr["opt_ms"][rest]),
               "first_step": rr["fwd_bwd_ms"][0] + rr["opt_ms"][0]}
               for r, rr in enumerate(res)},
           "whole_ms_a_step": {
               "prefill": whole["prefill_s"] * 1e3,
               "decode_median": sorted(whole["decode_s"])[
                   len(whole["decode_s"]) // 2] * 1e3,
               "fwd_bwd": mean([m["fwd_bwd_s"] * 1e3 for m in mets[rest]]),
               "opt": mean([m["opt_s"] * 1e3 for m in mets[rest]])},
           "collectives_a_step": {"serve": res[0]["serve_collectives"][
               "per_step"], "train": res[0]["collectives"][-1]},
           "peak_gb_a_rank": {"serve": [rr["serve_peak_bytes"] / 1e9
                                        for rr in res],
                              "train": [rr["train_peak_bytes"] / 1e9
                                        for rr in res]},
           "tiles_held_vs_plain": [rr["tiles_held_vs_plain"] for rr in res],
           "against_trace": [rr["against_trace"] for rr in res],
           "straddling_step": {
               "cell": f"yi-6b at {STRADDLE_KW}, {STRADDLE_SHAPE} (pod, "
                       f"data, model), FSDP at {STRADDLE_THRESHOLD} B, "
                       f"{ocfg.moment_dtype}",
               "straddling": res[0]["straddle"]["straddling"],
               "losses": [rr["straddle"]["loss"] for rr in res],
               "tiles_held_vs_plain": [rr["straddle"]["tiles_held_vs_plain"]
                                       for rr in res],
               "against_trace": [rr["straddle"]["against_trace"]
                                 for rr in res]},
           "launches": {k: sum(rr["kernel_launches"].get(k, 0)
                               + rr["straddle"]["kernel_launches"].get(k, 0)
                               for rr in res)
                        for k in ("bdi_compress", "bdi_decompress")}}
    log(f"phase 17: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 18: the model axis where yi-6b's KV heads do not divide it (K/V
# replicated, the cache over T, bdi8 tiles across shards), eight ranks
# ---------------------------------------------------------------------------

REP_SHAPE = (1, 8)                   # (data, model)
REP_RANKS = REP_SHAPE[0] * REP_SHAPE[1]
REP_LAYERS, REP_TRAIN_LAYERS = 4, 4  # serving (8 until phase 19), training
REP_SEED = 0


def rep_cfg(n_layers: int):
    from repro_torch.configs.registry import get_arch
    return at_depth(get_arch("yi-6b"), n_layers)


def rep_predict() -> dict:
    """What a rank of phase 18 holds and issues, from the shapes alone
    (meta tensors on an abstract ``(1, 8)`` mesh): bytes of a rank's
    params (serving and training depth), of its dense cache, of its bdi8
    moments; the leaves whose moment tiles straddle the shards; the
    collectives of a prefill, of a decode step and of a train step over
    the model axis (``tp.COUNTS``: all_reduce, all_gather, backward,
    writes); tile launches a train step.  The counts follow
    ``distributed/tp.py`` with query heads split (32 over 8) and K/V
    whole (4 KV heads): a decode step gathers the query heads and
    combines the T blocks (MAX, then one SUM) a layer beside wo's and
    the MLP's sums, the embedding's sum and the logits' gather; the rank
    holding row t writes each layer's K and V; a train step issues PR
    26's count plus wk's and wv's weight-gradient sums a layer, and one
    gather a straddling leaf's gradient; a moment group (``adamw._
    groups`` of the whole-over-model moment) is two decompresses and two
    compresses."""
    import torch
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tp
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.launch.elastic import abstract_mesh
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.optim import adamw as AW
    from repro_torch.optim import adamw_init, opt_state_bytes
    mesh = abstract_mesh(REP_SHAPE, ("data", "model"))
    ocfg = tpt_ocfg()
    nbytes = lambda tree: sum(t.numel() * t.element_size()   # noqa: E731
                              for t in _leaves(tree))
    out = {}
    with use_mesh(mesh):
        for key, n in (("serve", REP_LAYERS), ("train", REP_TRAIN_LAYERS)):
            whole = init_params(rep_cfg(n), torch.Generator(), "meta")
            local = SH.local_params(whole, mesh, coord={"data": 0,
                                                        "model": 0})
            out[f"param_bytes_{key}"] = nbytes(local)
        cache = init_cache(rep_cfg(REP_LAYERS), TP_BATCH, TP_PROMPT + TP_GEN,
                           device="meta")
        out["cache_bytes"] = sum(t.numel() * t.element_size() for t in cache)
        out["cache_block"] = list(cache.full_k.shape)
        wide = tp.check_moments(local, ocfg.moment_dtype)
        state = adamw_init(local, ocfg)
        out["moment_bytes"] = opt_state_bytes(state, ocfg)
        shapes = [AW._wide(p.shape, w)
                  for (_, p), w in zip(leaf_paths(local), wide)]
    out["straddling"] = [p for (p, _), w in zip(leaf_paths(local), wide)
                         if w]
    groups = [len(AW._groups(torch.empty(sh, device="meta")))
              for sh in shapes if AW._tiled(sh, ocfg.moment_dtype)]
    wide_groups = sum(len(AW._groups(torch.empty(sh, device="meta")))
                      for sh, w in zip(shapes, wide) if w)
    n, m = REP_LAYERS, REP_SHAPE[1]
    nt = REP_TRAIN_LAYERS
    backward = 5 * nt + 1 + 2 * nt
    rows = (TP_PROMPT + TP_GEN) // m
    # the decode steps' positions TP_PROMPT .. TP_PROMPT + TP_GEN - 2
    writers = sorted({t // rows for t in range(TP_PROMPT,
                                               TP_PROMPT + TP_GEN - 1)})
    out.update({
        "prefill_model": [2 * n + 1, 1, 0, 0],
        "decode_step_model": [4 * n + 1, n + 1, 0],
        "decode_writes_a_step": {str(r): 2 * n * sum(
            t // rows == r for t in range(TP_PROMPT, TP_PROMPT + TP_GEN - 1))
            / (TP_GEN - 1) for r in writers},
        "train_step_model": [(1 + 2 * nt + 2) + (nt + 2) + backward + 1,
                             len(out["straddling"]), backward],
        "tile_launches_a_step": 4 * sum(groups),
        "tile_launches_a_step_straddling": 4 * wide_groups})
    return out


def rep_rank(rank: int, work: str) -> None:
    """One rank of phase 18 on the ``(1, 8)`` mesh: its shards of yi-6b
    at ``REP_LAYERS`` (drawn a layer at a time), serving, then
    ``TPT_STEPS`` train steps of the model at ``REP_TRAIN_LAYERS`` under
    bdi8; writes ``rep_<rank>.json`` and ``.pt``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tp
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.kernels._device import resolve_device
    from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
    from repro_torch.launch.serve import dense_generate
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw, adamw_init, opt_state_bytes
    dev = resolve_device("cuda")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(work) / "rendezvous_rep"), REP_RANKS), rank=rank,
        world_size=REP_RANKS)
    res = {"rank": rank, "backend": dist.get_backend()}
    try:
        mesh = make_host_mesh(*REP_SHAPE)
        with use_mesh(mesh):
            cfg, ocfg = rep_cfg(REP_LAYERS), tpt_ocfg()
            t0 = time.perf_counter()
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(REP_SEED), dev,
                local=SH.Local(mesh))
            sync(dev)
            res.update(init_s=time.perf_counter() - t0,
                       param_bytes_serve=sum(t.numel() * t.element_size()
                                             for t in _leaves(params)))
            prompts = tp_prompts(cfg.vocab)
            dense_generate(cfg, params, prompts[:, :13], 3)      # warm-up
            torch.cuda.reset_peak_memory_stats(dev)
            out = dense_generate(cfg, params, prompts, TP_GEN,
                                 keep_logits=True)
            res.update(serve_peak_bytes=torch.cuda.max_memory_allocated(dev),
                       prefill_ms=out["prefill_s"] * 1e3,
                       ms_a_step=[s * 1e3 for s in out["decode_s"]],
                       serve_collectives=out["collectives"],
                       cache_bytes=out["cache_bytes"])
            served = {"tokens": out["tokens"], "logits": out["logits"]}
            del out, params
            torch.cuda.empty_cache()
            cfg = rep_cfg(REP_TRAIN_LAYERS)
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(REP_SEED), dev,
                local=SH.Local(mesh))
            res["param_bytes_train"] = sum(t.numel() * t.element_size()
                                           for t in _leaves(params))
            wide = tp.check_moments(params, ocfg.moment_dtype)
            state = adamw_init(params, ocfg)
            batches = tpt_batches(cfg, dev)
            step = make_train_step(get_model(cfg), ocfg)
            start = tpt_state(params, None, cfg.n_layers)
            sp_start = (_tree_clone(params), _tree_clone(state))
            sync(dev)
            torch.cuda.empty_cache()
            ops.reset_launches()
            mets, norms, sample, held, steps, peak = [], [], None, 0, [], 0
            for i, batch in enumerate(batches):
                params, state, met, meas = measured_step(
                    step, params, state, batch, dev, flops=i == 0)
                peak = max(peak, torch.cuda.max_memory_allocated(dev))
                mets.append(met)
                steps.append(meas)
                norms.append(tpt_norms(params, state))
                if i == 0:
                    launches = dict(ops.LAUNCHES)
                    sample = tpt_state(params, state, cfg.n_layers)
                    held = dpt_tiles_vs_plain(params, state, cfg.n_layers,
                                              "18")
                    ops.LAUNCHES.update(launches)   # the sample's, plain's
            res["sp"], sp_sample = sp_step(step, *sp_start, batches[:1],
                                           dev, cfg.n_layers)
            del sp_start
        res.update(
            steps=steps,
            opt_state_bytes=opt_state_bytes(state, ocfg), wide=wide,
            moment_shapes={p: list(s["deltas"].shape) for (p, _), s, w in
                           zip(leaf_paths(params),
                               adamw._store_leaves(state["m"]), wide) if w},
            losses=[m["loss"] for m in mets],
            grad_norms=[m["grad_norm"] for m in mets],
            fwd_bwd_ms=[m["fwd_bwd_s"] * 1e3 for m in mets],
            opt_ms=[m["opt_s"] * 1e3 for m in mets],
            collectives=[m["collectives"] for m in mets],
            train_peak_bytes=peak, tiles_held_vs_plain=held,
            kernel_launches={k: v for k, v in ops.LAUNCHES.items() if v})
        torch.save({"served": served, "start": start, "sample": sample,
                    "sp_sample": sp_sample, "norms": norms},
                   Path(work) / f"rep_{rank}.pt")
        (Path(work) / f"rep_{rank}.json").write_text(json.dumps(res))
    finally:
        destroy_mesh()


def phase_replicated(dev, started: dict) -> dict:
    """Phase 18 (see the module docstring); ``started``: the dry run's
    traces (``start_step_traces``)."""
    import math
    import tempfile

    import torch
    from repro_torch.launch.serve import dense_generate
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    ocfg = tpt_ocfg()
    pred = rep_predict()
    log(f"phase 18 prediction (shapes, (1, 8)): {json.dumps(pred)}")
    traces = step_traces_of(started, "18")
    sp_traces = step_traces_of(started, "18 sp")
    log(f"phase 18: the dry run's trace of each rank's train step, without "
        f"and with sequence parallelism: {json.dumps(traces)} "
        f"{json.dumps(sp_traces)}")
    work = Path(tempfile.mkdtemp(prefix="rep18_"))
    t0 = time.perf_counter()
    ranks = [(_spawn(f"rep_rank({r}, {str(work)!r})",
                     work / f"rep_{r}.log"), work / f"rep_{r}.log")
             for r in range(REP_RANKS)]
    _wait_all(ranks, "phase 18: a rank", 600)
    ranks_s = time.perf_counter() - t0
    res = [json.loads((work / f"rep_{r}.json").read_text())
           for r in range(REP_RANKS)]
    got = [torch.load(work / f"rep_{r}.pt") for r in range(REP_RANKS)]
    want = pred["tile_launches_a_step"] * TPT_STEPS
    for r, rr in enumerate(res):
        step = rr["ms_a_step"]
        log(f"phase 18 rank {r} (gloo through the host on one card, not a "
            f"TP speed): " + json.dumps(
                rr | {"ms_a_step": {"median": sorted(step)[len(step) // 2],
                                    "min": min(step), "max": max(step)}}))
        ran = rr["kernel_launches"]
        if rr["backend"] != "gloo" or ran != {"bdi_compress": want // 2,
                                              "bdi_decompress": want // 2}:
            raise AssertionError(f"phase 18: rank {r}: backend "
                                 f"{rr['backend']}, launches {ran}, "
                                 f"predicted {want // 2} each")
        if not all(math.isfinite(x) for x in rr["losses"]):
            raise AssertionError(f"phase 18: rank {r}: {rr['losses']}")
        for key, pkey in (("param_bytes_serve", "param_bytes_serve"),
                          ("param_bytes_train", "param_bytes_train"),
                          ("cache_bytes", "cache_bytes"),
                          ("opt_state_bytes", "moment_bytes")):
            if rr[key] != pred[pkey]:
                raise AssertionError(f"phase 18: rank {r}: {key} {rr[key]}"
                                     f", predicted {pred[pkey]}")
        wide = [p for p in rr["moment_shapes"]]
        if wide != pred["straddling"]:
            raise AssertionError(f"phase 18: rank {r}: straddling {wide}, "
                                 f"predicted {pred['straddling']}")
        c = rr["serve_collectives"]
        model = lambda x, keys: [x["model"][k] for k in keys]  # noqa: E731
        checks = [
            ("prefill", model(c["prefill"], ("all_reduce", "all_gather",
                                             "backward", "writes")),
             pred["prefill_model"]),
            ("decode step", model(c["per_step"], ("all_reduce",
                                                  "all_gather",
                                                  "backward")),
             pred["decode_step_model"]),
            ("decode writes", c["per_step"]["model"]["writes"],
             pred["decode_writes_a_step"].get(str(r), 0.0))]
        checks += [(f"train step {i}", model(m, ("all_reduce", "all_gather",
                                                 "backward")),
                    pred["train_step_model"])
                   for i, m in enumerate(rr["collectives"])]
        checks += [(f"{name} over data", sum(x["data"].values()), 0)
                   for name, x in [("prefill", c["prefill"]),
                                   ("decode step", c["per_step"])]
                   + [(f"train step {i}", m)
                      for i, m in enumerate(rr["collectives"])]]
        for name, a, b in checks:
            if a != b:
                raise AssertionError(f"phase 18: rank {r}: {name} "
                                     f"collectives {a}, predicted {b}")
        rr["against_trace"] = check_step_traces("18", r, rr, traces[r])
        log(f"phase 18 rank {r} against its trace: "
            f"{json.dumps(rr['against_trace'])}")
        rr["sp_checks"] = sp_checks(
            "18", r, rr, rr["sp"], sp_traces[r], got[r],
            {k: pred["tile_launches_a_step"] // 2
             for k in ("bdi_compress", "bdi_decompress")})
        log(f"phase 18 rank {r}: the sequence-parallel step: "
            f"{json.dumps(rr['sp_checks'])}")
    for r in range(1, REP_RANKS):
        if res[r]["losses"] != res[0]["losses"] or \
                res[r]["grad_norms"] != res[0]["grad_norms"]:
            raise AssertionError("phase 18: the ranks' losses or norms "
                                 "differ")
        if got[r]["served"]["tokens"] != got[0]["served"]["tokens"] or \
                not torch.equal(got[r]["served"]["logits"],
                                got[0]["served"]["logits"]):
            raise AssertionError("phase 18: the ranks' serving differs")
        for i in range(TPT_STEPS):
            for k, a in got[0]["norms"][i].items():
                if not torch.equal(a, got[r]["norms"][i][k]):
                    raise AssertionError(f"phase 18: step {i}: {k} differs "
                                         f"between ranks 0 and {r}")
        # the whole-over-model leaves and moments (K/V's projections, the
        # straddling leaves' moments), the same bits on every rank
        for k, a in got[0]["sample"].items():
            b = got[r]["sample"][k]
            if ("['wk']" in k or "['wv']" in k or k[0] in "mv" and any(
                    k[1:] == p for p in pred["straddling"])) and \
                    not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"phase 18: {k} differs between "
                                     f"ranks 0 and {r}")
    # the same weights, prompts and batches, whole, in this process
    t1 = time.perf_counter()
    cfg = rep_cfg(REP_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        REP_SEED), dev)
    prompts = tp_prompts(cfg.vocab)
    dense_generate(cfg, params, prompts[:, :13], 3)             # warm-up
    whole = dense_generate(cfg, params, prompts, TP_GEN, keep_logits=True)
    par, worst = _served_parity("phase 18", got[0]["served"]["tokens"],
                                got[0]["served"]["logits"], whole, TP_ULPS)
    del params
    release(dev)
    cfg = rep_cfg(REP_TRAIN_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        REP_SEED), dev)
    state = adamw_init(params, ocfg)
    step = make_train_step(get_model(cfg), ocfg)
    wide = res[0]["wide"]
    start = [tpt_state(params, None, cfg.n_layers, {"data": 0, "model": r},
                       shape=REP_SHAPE) for r in range(REP_RANKS)]
    for r in range(REP_RANKS):
        for k, t in start[r].items():
            if not torch.equal(t, got[r]["start"][k]):
                raise AssertionError(f"phase 18: rank {r}'s {k} is not "
                                     f"its block of the whole model's")
    mets, want_s = [], None
    for i, batch in enumerate(tpt_batches(cfg, dev)):
        params, state, met = step(params, state, batch)
        mets.append(met)
        if i == 0:
            want_s = [tpt_state(params, state, cfg.n_layers,
                                {"data": 0, "model": r}, shape=REP_SHAPE,
                                wide=wide) for r in range(REP_RANKS)]
    whole_s = time.perf_counter() - t1
    del params, state
    release(dev)
    gaps = [_one_step_gap(got[r]["sample"], want_s[r], start[r])
            for r in range(REP_RANKS)]
    losses = [m["loss"] for m in mets]
    ours = res[0]["losses"]
    if abs(ours[0] - losses[0]) > TPT_FIRST_RTOL * abs(losses[0]) or \
            any(abs(a - b) > TPT_LOSS_RTOL * abs(b)
                for a, b in zip(ours, losses)):
        raise AssertionError(f"phase 18: losses {ours} against the whole "
                             f"model's {losses}")
    for r, g in enumerate(gaps):
        w = {n: v for n, (_, v) in g["worst"].items()}
        if (w["within_1_ulp"] < TPT_ULP_SHARE
                or w["max_gap_over_lr"] > 2.0
                or max(w["m_err"], w["v_err"]) > TPT_MOMENT_RTOL):
            raise AssertionError(f"phase 18: rank {r} after step 1: "
                                 f"{g['worst']}")
    rest = slice(1, None)
    mean = lambda xs: sum(xs) / len(xs)              # noqa: E731
    out = {"card": smi(), "cell": f"yi-6b full width, (1, 8) over gloo on "
           f"one card (32 heads split, 4 KV heads whole, the cache over T): "
           f"serving {TP_BATCH} x {TP_PROMPT} + {TP_GEN} at {REP_LAYERS} "
           f"layers, then {TPT_STEPS} train steps of {TPT_BATCH} x "
           f"{TPT_SEQ} at {REP_TRAIN_LAYERS} layers under "
           f"{ocfg.moment_dtype} moments",
           "ranks_wall_s": ranks_s, "whole_wall_s": whole_s,
           "tokens_equal": par.compared,
           "ties": [t.__dict__ for t in par.ties],
           "worst_logit_gap_ulps": worst,
           "losses": ours, "losses_whole": losses,
           "grad_norms": res[0]["grad_norms"],
           "grad_norms_whole": [m["grad_norm"] for m in mets],
           "after_step_1_worst_rank": min(
               (g["worst"] for g in gaps),
               key=lambda w: w["within_1_ulp"][1]),
           "moment_shapes": res[0]["moment_shapes"],
           "ms_a_step": {f"rank{r}": {
               "init_s": rr["init_s"], "prefill": rr["prefill_ms"],
               "decode_median": sorted(rr["ms_a_step"])[
                   len(rr["ms_a_step"]) // 2],
               "fwd_bwd": mean(rr["fwd_bwd_ms"][rest]),
               "opt": mean(rr["opt_ms"][rest]),
               "first_step": rr["fwd_bwd_ms"][0] + rr["opt_ms"][0]}
               for r, rr in enumerate(res)},
           "whole_ms_a_step": {
               "prefill": whole["prefill_s"] * 1e3,
               "decode_median": sorted(whole["decode_s"])[
                   len(whole["decode_s"]) // 2] * 1e3,
               "fwd_bwd": mean([m["fwd_bwd_s"] * 1e3 for m in mets[rest]]),
               "opt": mean([m["opt_s"] * 1e3 for m in mets[rest]])},
           "collectives_a_step": {
               "prefill": res[0]["serve_collectives"]["prefill"],
               "decode": res[0]["serve_collectives"]["per_step"],
               "train": res[0]["collectives"][-1]},
           "peak_gb_a_rank": {"serve": [rr["serve_peak_bytes"] / 1e9
                                        for rr in res],
                              "train": [rr["train_peak_bytes"] / 1e9
                                        for rr in res]},
           "tiles_held_vs_plain": [rr["tiles_held_vs_plain"] for rr in res],
           "against_trace": [rr["against_trace"] for rr in res],
           "sp_step": [rr["sp_checks"] for rr in res],
           "launches": {k: sum(rr["kernel_launches"].get(k, 0)
                               + rr["sp"]["kernel_launches"].get(k, 0)
                               for rr in res)
                        for k in ("bdi_compress", "bdi_decompress")},
           "launches_straddling": pred["tile_launches_a_step_straddling"]
           * TPT_STEPS * REP_RANKS}
    log(f"phase 18: {json.dumps(out)}")
    return out


MOE_SHAPE = (1, 4)                   # (data, model)
MOE_RANKS = MOE_SHAPE[0] * MOE_SHAPE[1]
MOE_DS, MOE_ARC = "deepseek-v2-lite-16b", "arctic-480b"
# deepseek serving (8 before phase 20) and training, of 27
MOE_LAYERS, MOE_TRAIN_LAYERS = 4, 4
MOE_GEN = 16
ARC_LAYERS, ARC_BATCH, ARC_PROMPT, ARC_GEN = 1, 2, 64, 8   # arctic, of 35
MOE_SEED = 0
MOE_ROUTE_ULPS = 2.0                 # the ranks' router inputs, bf16 ULPs
MOE_FLIP_SHARE = 0.03                # of step 1's expert choices


def moe_cfg(arch: str, n_layers: int):
    from repro_torch.configs.registry import get_arch
    return at_depth(get_arch(arch), n_layers)


def arc_prompts(vocab: int, batch: int = ARC_BATCH, n: int = ARC_PROMPT):
    import torch
    return torch.randint(1, vocab, (batch, n),
                         generator=torch.Generator().manual_seed(MOE_SEED + 2))


class RouteReplay:
    """Wraps ``models/moe``'s ``_route``.  With ``replay`` None it keeps
    the expert choices of each call and the router inputs of the first
    ``keep_inputs`` calls.  Else call i < len(replay) chooses the ranks'
    ``replay[i]`` (the gates of those experts from this model's own
    probabilities, normalised as ``_route`` does), after checking, where
    ``inputs`` are given, that this model's router on the ranks' input
    ``inputs[i]`` chooses exactly those; later calls route themselves.  At a random init the routing is
    near uniform: the ranks' router inputs differ from the whole model's
    by bf16 roundings, which flip near-tied choices, and an expert's
    gradient moves with each token it gains or loses.  So phase 19 trains
    the whole model's first step on the ranks' choices (those of its
    forward and of its recompute), and records how many of its own would
    have differed (``flips``) and how far its router inputs lie from the
    ranks' (``input_ulps``, bf16 ULPs of the input's largest |value|);
    :meth:`check` holds both to the rounding they come from."""

    def __init__(self, replay: list | None = None, inputs: list | None = None,
                 keep_inputs: int = 0):
        from repro_torch.models import moe as M
        self.M, self.saved = M, M._route
        self.replay, self.given, self.keep = replay, inputs, keep_inputs
        self.routes, self.inputs, self.flips = [], [], []
        self.choices, self.input_ulps = 0, 0.0

    def __enter__(self):
        import torch
        from repro_torch.serving.parity import bf16_ulp
        M, route = self.M, self.saved

        def logged(router, x2d, top_k, n_experts):
            out = route(router, x2d, top_k, n_experts)
            if len(self.routes) < self.keep:
                self.inputs.append(x2d.detach().to("cpu", copy=True))
            self.routes.append(out[1].cpu())
            return out

        def replayed(router, x2d, top_k, n_experts):
            call = len(self.routes)
            self.routes.append(None)
            if call >= len(self.replay):
                return route(router, x2d, top_k, n_experts)
            idx = self.replay[call].to(x2d.device)
            with torch.no_grad():
                if self.given is not None:
                    theirs = self.given[call].to(x2d.device)
                    if not torch.equal(
                            M._top_k(M._probs(router, theirs), top_k)[1],
                            idx):
                        raise AssertionError(
                            f"phase 19: route call {call}: the router on "
                            f"the ranks' input chooses otherwise than the "
                            f"ranks")
                    gap = (x2d.float() - theirs.float()).abs().max()
                    self.input_ulps = max(self.input_ulps, float(
                        gap) / bf16_ulp(float(theirs.float().abs().max())))
            probs = M._probs(router, x2d)
            own = M._top_k(probs, top_k)[1]
            self.choices += idx.numel()
            self.flips += (own != idx).sum(dim=-1).tolist()
            gates = torch.gather(probs, -1, idx)
            gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
            return gates.to(torch.float32), idx

        M._route = logged if self.replay is None else replayed
        return self

    def __exit__(self, *exc):
        self.M._route = self.saved

    def summary(self) -> dict:
        """:meth:`check`, then the replay's counts: route calls, choices
        replayed, choices and tokens its own router would have flipped,
        its router inputs' largest gap in bf16 ULPs."""
        self.check()
        return {"calls": len(self.routes), "choices": self.choices,
                "flipped": sum(self.flips),
                "tokens_flipped": sum(1 for n in self.flips if n),
                "input_ulps": self.input_ulps}

    def check(self) -> None:
        """Raise unless the replay hid rounding alone: every router input
        within ``MOE_ROUTE_ULPS`` of the ranks' and at most
        ``MOE_FLIP_SHARE`` of the choices flipped."""
        flipped = sum(self.flips)
        if self.input_ulps > MOE_ROUTE_ULPS or \
                flipped > MOE_FLIP_SHARE * self.choices:
            raise AssertionError(
                f"phase 19: the router inputs lie {self.input_ulps} bf16 "
                f"ULPs from the ranks' (at most {MOE_ROUTE_ULPS}) and "
                f"{flipped} of {self.choices} choices flipped (at most "
                f"{MOE_FLIP_SHARE:.0%})")


def _serve_prediction(cfg, b: int, s: int, gen: int, m: int) -> dict:
    """Model-axis collectives (``tp.COUNTS``: all_reduce, all_gather,
    backward, writes, bytes) of ``dense_generate``'s prefill and of a
    decode step (averaged over its gen - 1 steps), an MoE decoder whose
    heads and KV heads divide m: a layer sums attention's wo, the routed
    experts and the shared experts' or dense FFN's down projection (f32
    [tokens, D] each), MLA gathers its latent and rope key blocks (f32
    [B, t + 1, (r + dr) / m]) a decode step; the embedding's sum (f32)
    and the last position's logits gathered (bf16 [B, 1, V/m])."""
    n, d = cfg.n_layers, cfg.d_model
    mla = cfg.attn_kind == "mla"
    head = b * (cfg.vocab // m) * 2
    steps = gen - 1
    dec = (1 + 3 * n) * b * d * 4 * steps + head * steps
    if mla:
        w = (cfg.kv_lora_rank + cfg.qk_rope_dim) // m
        dec += n * sum(b * (t + 1) * w * 4 for t in range(s, s + steps))
    return {"prefill": [3 * n + 1, 1, 0, 0,
                        (1 + 3 * n) * b * s * d * 4 + head],
            "decode_step": [3 * n + 1, 1 + 2 * n * mla, 0, 0, dec / steps]}


def _train_prediction(cfg, b: int, s: int, m: int, sharded: int,
                      straddling_bytes: list) -> list:
    """Model-axis collectives of a train step of an MLA/MoE decoder with
    shared experts (deepseek), as ``distributed/tp.py`` issues them: the
    forward's embedding sum, wo's, the experts' and the shared down's
    sums a layer, the loss's MAX and SUM; the recompute's loss and each
    layer's wo and experts' sums; backward a layer the input gradients
    of wq, of wuk and wuv for the latent, the rope key's, the router's
    (``[D, E]``), the FFN input's and the shared gate's and up's, then
    the head's; the clip norm's one sum of the ``sharded`` leaves'
    squares; one gather a straddling leaf's bf16 gradient.  Returns
    [all_reduce, all_gather, backward, bytes]."""
    n, d, tok = cfg.n_layers, cfg.d_model, b * s
    r, dr, e = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.n_experts
    x = tok * d * 4
    backward = 8 * n + 1
    forward = x + 3 * n * x + 3 * tok * 4
    recompute = 3 * tok * 4 + 2 * n * x
    grads = n * (4 * x + 2 * tok * r * 4 + tok * dr * 4 + d * e * 4) + x
    return [(1 + 3 * n + 2) + (2 + 2 * n) + backward + 1,
            len(straddling_bytes), backward,
            forward + recompute + grads + sharded * 4
            + sum(straddling_bytes)]


def moe_predict() -> dict:
    """What a rank of phase 19 holds and issues, from the shapes alone
    (meta tensors on an abstract ``(1, 4)`` mesh): bytes of a rank's
    params (deepseek serving and training depth, arctic), of its decode
    caches, of its bdi8 moments; the leaves whose moment tiles straddle
    the shards; the collectives and their bytes of a prefill, a decode
    step and a train step over the model axis (:func:`_serve_prediction`,
    :func:`_train_prediction`) and none over data; tile launches a train
    step (a moment group is two decompresses and two compresses)."""
    import torch
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tp
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.launch.elastic import abstract_mesh
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.optim import adamw as AW
    from repro_torch.optim import adamw_init, opt_state_bytes
    ds_serve = moe_cfg(MOE_DS, MOE_LAYERS)
    ds_train = moe_cfg(MOE_DS, MOE_TRAIN_LAYERS)
    arc = moe_cfg(MOE_ARC, ARC_LAYERS)
    ds_batch = (TP_BATCH, TP_PROMPT, MOE_GEN)
    arc_batch = (ARC_BATCH, ARC_PROMPT, ARC_GEN)
    train_batch = (TPT_BATCH, TPT_SEQ)
    mesh = abstract_mesh(MOE_SHAPE, ("data", "model"))
    m = MOE_SHAPE[1]
    ocfg = tpt_ocfg()
    coord = {"data": 0, "model": 0}
    nbytes = lambda tree: sum(t.numel() * t.element_size()   # noqa: E731
                              for t in _leaves(tree))
    out = {}
    with use_mesh(mesh):
        for key, cfg in (("ds_serve", ds_serve), ("ds_train", ds_train),
                         ("arc", arc)):
            local = init_params(cfg, torch.Generator(), "meta",
                                local=SH.Local(mesh, coord))
            out[f"param_bytes_{key}"] = nbytes(local)
        for key, cfg, (b, s, g) in (("ds", ds_serve, ds_batch),
                                    ("arc", arc, arc_batch)):
            out[f"cache_bytes_{key}"] = sum(
                t.numel() * t.element_size()
                for t in init_cache(cfg, b, s + g, device="meta"))
            out[key] = _serve_prediction(cfg, b, s, g, m)
        whole = init_params(ds_train, torch.Generator(), "meta")
        wide = tp.check_moments(local_t := init_params(
            ds_train, torch.Generator(), "meta",
            local=SH.Local(mesh, coord)), ocfg.moment_dtype)
        out["moment_bytes"] = opt_state_bytes(adamw_init(local_t, ocfg),
                                              ocfg)
        sharded = sum(tp.sharded_leaves(whole, local_t))
        shapes = [AW._wide(p.shape, w)
                  for (_, p), w in zip(leaf_paths(local_t), wide)]
    leaves = leaf_paths(local_t)
    out["straddling"] = [p for (p, _), w in zip(leaves, wide) if w]
    out["train_step"] = _train_prediction(
        ds_train, *train_batch, m, sharded,
        [t.numel() * t.element_size() for (_, t), w in zip(leaves, wide)
         if w])
    groups = [len(AW._groups(torch.empty(sh, device="meta")))
              for sh in shapes if AW._tiled(sh, ocfg.moment_dtype)]
    out["tile_launches_a_step"] = 4 * sum(groups)
    out["tile_launches_a_step_straddling"] = 4 * sum(
        len(AW._groups(torch.empty(sh, device="meta")))
        for sh, w in zip(shapes, wide) if w)
    return out


def _moe_serve(cfg, params, prompts, gen: int, dev) -> tuple[dict, dict]:
    """A rank's warm-up and timed ``dense_generate``: (its numbers, its
    tokens and logits)."""
    import torch
    from repro_torch.launch.serve import dense_generate
    dense_generate(cfg, params, prompts[:, :13], 3)              # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    out = dense_generate(cfg, params, prompts, gen, keep_logits=True)
    return ({"serve_peak_bytes": torch.cuda.max_memory_allocated(dev),
             "prefill_ms": out["prefill_s"] * 1e3,
             "ms_a_step": [s * 1e3 for s in out["decode_s"]],
             "serve_collectives": out["collectives"],
             "cache_bytes": out["cache_bytes"]},
            {"tokens": out["tokens"], "logits": out["logits"]})


SP_GRAD_RTOL = 1e-2                  # tests/test_torch_tp_sp.py's


def sp_grads(model, params: dict, batch: dict, n_layers: int) -> dict:
    """The loss and the gradients of a rank's ``params`` on ``batch``
    without and then with the sequence-parallel residual stream, and no
    update (arctic-480b's moments at full width do not fit four ranks on
    one card): both losses, both runs' collectives, the expert choices
    equal or not, and by leaf the relative Frobenius distance of the sp
    run's gradient from the other's, on each gradient's ``_sample``.  Each
    gradient is sampled as it lands and freed at once (a hook after its
    accumulation): an expert stack's, formed in f32, takes 4.16 GiB a rank,
    and all of them at once ran four ranks out of memory."""
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import axes as AX
    from repro_torch.distributed import tp
    items = leaf_paths(params)
    out, kept, first, on, landed = {}, {}, None, False, []

    def hook(path):
        def sample(t):
            landed[-1].add(path)
            x = _sample(t.grad, path, n_layers).cpu().float()
            t.grad = None
            if on:
                y = kept[path]
                kept[path] = float((x - y).norm() / y.norm().clamp(min=1e-30))
            else:
                kept[path] = x
        return sample

    hooks = [t.requires_grad_().register_post_accumulate_grad_hook(hook(p))
             for p, t in items]
    try:
        for on in (False, True):
            AX.set_sp(on)
            c0 = tp.counts()
            landed.append(set())
            # the sp run replays the other's expert choices (RouteReplay)
            with RouteReplay(keep_inputs=1 << 30) if first is None else \
                    RouteReplay(first.routes, first.inputs) as routes:
                loss = model.loss(params, batch)
                loss.backward()
            first = first or routes
            out[f"sp={on}"] = {"loss": float(loss.detach()),
                               "collectives": tp.counts_since(c0)}
            del loss
            if landed[-1] != landed[0]:
                raise AssertionError(f"sp={on}: gradients of {landed[-1]}, "
                                     f"without sp {landed[0]}")
    finally:
        AX.set_sp(False)
        for h in hooks:
            h.remove()
        for _, t in items:
            t.requires_grad_(False)
            t.grad = None
    out["routes"] = routes.summary()
    out["grad_rel"] = kept
    out["no_gradient"] = sorted({p for p, _ in items} - landed[0])
    return out


def moe_rank(rank: int, work: str) -> None:
    """One rank of phase 19 on the ``(1, 4)`` mesh: deepseek-v2-lite-16b
    (its shards drawn a layer at a time, its experts an expert at a time)
    serving at ``MOE_LAYERS``, ``TPT_STEPS`` bdi8 train steps at
    ``MOE_TRAIN_LAYERS``, then arctic-480b serving at ``ARC_LAYERS``;
    writes ``moe_<rank>.json`` and ``.pt``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tp
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.kernels._device import resolve_device
    from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw, adamw_init, opt_state_bytes
    dev = resolve_device("cuda")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(work) / "rendezvous_moe"), MOE_RANKS), rank=rank,
        world_size=MOE_RANKS)
    res = {"rank": rank, "backend": dist.get_backend()}
    keep = {}
    nbytes = lambda tree: sum(t.numel() * t.element_size()   # noqa: E731
                              for t in _leaves(tree))
    try:
        mesh = make_host_mesh(*MOE_SHAPE)
        with use_mesh(mesh):
            gen = lambda: torch.Generator(device=dev).manual_seed(  # noqa
                MOE_SEED)
            cfg, ocfg = moe_cfg(MOE_DS, MOE_LAYERS), tpt_ocfg()
            t0 = time.perf_counter()
            params = init_params(cfg, gen(), dev, local=SH.Local(mesh))
            sync(dev)
            res["ds"] = {"init_s": time.perf_counter() - t0,
                         "param_bytes_serve": nbytes(params),
                         "experts_held": params["blocks"]["ffn"]["experts"][
                             "gate"]["w"].shape[1]}
            num, keep["ds_served"] = _moe_serve(cfg, params,
                                                tp_prompts(cfg.vocab),
                                                MOE_GEN, dev)
            res["ds"].update(num)
            del params
            torch.cuda.empty_cache()
            cfg = moe_cfg(MOE_DS, MOE_TRAIN_LAYERS)
            params = init_params(cfg, gen(), dev, local=SH.Local(mesh))
            res["ds"]["param_bytes_train"] = nbytes(params)
            wide = tp.check_moments(params, ocfg.moment_dtype)
            state = adamw_init(params, ocfg)
            batches = tpt_batches(cfg, dev)
            step = make_train_step(get_model(cfg), ocfg)
            keep["start"] = tpt_state(params, None, cfg.n_layers)
            sp_start = (_tree_clone(params), _tree_clone(state))
            sync(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launches()
            mets, keep["norms"], held = [], [], 0
            first = 2 * cfg.n_layers          # step 1's forward, recompute
            with RouteReplay(keep_inputs=first) as routes:
                for i, batch in enumerate(batches):
                    params, state, met = step(params, state, batch)
                    mets.append(met)
                    keep["norms"].append(tpt_norms(params, state))
                    if i == 0:
                        launches = dict(ops.LAUNCHES)
                        keep["sample"] = tpt_state(params, state,
                                                   cfg.n_layers)
                        held = dpt_tiles_vs_plain(params, state,
                                                  cfg.n_layers, "19")
                        # the sample's and the plain versions' launches
                        ops.LAUNCHES.update(launches)
            keep["routes"] = routes.routes[:first]
            keep["route_inputs"] = routes.inputs if rank == 0 else []
            train_peak = torch.cuda.max_memory_allocated(dev)
            # the first step's choices, replayed: the sp step routes the same
            # tokens, and its own choices may differ by rounding flips only
            # (no inputs, no check: the same router on its own inputs, and
            # the check's products would count in the step's FLOPs)
            with RouteReplay(keep["routes"]) as sp_routes:
                res["ds"]["sp"], keep["sp_sample"] = sp_step(
                    step, *sp_start, batches[:1], dev, cfg.n_layers)
            res["ds"]["sp"]["routes"] = sp_routes.summary()
            del sp_start
            res["ds"].update(
                train_peak_bytes=train_peak,
                opt_state_bytes=opt_state_bytes(state, ocfg), wide=wide,
                moment_shapes={p: list(s["deltas"].shape) for (p, _), s, w
                               in zip(leaf_paths(params),
                                      adamw._store_leaves(state["m"]), wide)
                               if w},
                losses=[m["loss"] for m in mets],
                grad_norms=[m["grad_norm"] for m in mets],
                fwd_bwd_ms=[m["fwd_bwd_s"] * 1e3 for m in mets],
                opt_ms=[m["opt_s"] * 1e3 for m in mets],
                collectives=[m["collectives"] for m in mets],
                tiles_held_vs_plain=held,
                kernel_launches={k: v for k, v in ops.LAUNCHES.items()
                                 if v})
            del params, state, batches, step
            torch.cuda.empty_cache()
            cfg = moe_cfg(MOE_ARC, ARC_LAYERS)
            t0 = time.perf_counter()
            params = init_params(cfg, gen(), dev, local=SH.Local(mesh))
            sync(dev)
            res["arc"] = {"init_s": time.perf_counter() - t0,
                          "param_bytes_serve": nbytes(params),
                          "experts_held": params["blocks"]["ffn"][
                              "experts"]["gate"]["w"].shape[1]}
            num, keep["arc_served"] = _moe_serve(
                cfg, params, arc_prompts(cfg.vocab), ARC_GEN, dev)
            res["arc"].update(num)
            torch.cuda.empty_cache()      # the serving's cached blocks
            res["arc"]["sp"] = sp_grads(get_model(cfg), params,
                                        tpt_batches(cfg, dev, 1)[0],
                                        cfg.n_layers)
            del params
        torch.save(keep, Path(work) / f"moe_{rank}.pt")
        (Path(work) / f"moe_{rank}.json").write_text(json.dumps(res))
    finally:
        destroy_mesh()


def _moe_checks(r: int, rr: dict, pred: dict) -> None:
    """A rank's bytes, collectives and launches against ``moe_predict``."""
    model = lambda x: [x["model"][k] for k in ("all_reduce", "all_gather",
                                               "backward", "writes",
                                               "bytes")]
    ds, arc = rr["ds"], rr["arc"]
    checks = [("deepseek params serving", ds["param_bytes_serve"],
               pred["param_bytes_ds_serve"]),
              ("deepseek params training", ds["param_bytes_train"],
               pred["param_bytes_ds_train"]),
              ("arctic params", arc["param_bytes_serve"],
               pred["param_bytes_arc"]),
              ("deepseek cache", ds["cache_bytes"], pred["cache_bytes_ds"]),
              ("arctic cache", arc["cache_bytes"], pred["cache_bytes_arc"]),
              ("moments", ds["opt_state_bytes"], pred["moment_bytes"]),
              ("straddling", list(ds["moment_shapes"]), pred["straddling"]),
              ("experts held", [ds["experts_held"], arc["experts_held"]],
               [64 // MOE_SHAPE[1], 128 // MOE_SHAPE[1]])]
    for key, x in (("ds", ds), ("arc", arc)):
        c = x["serve_collectives"]
        checks += [(f"{key} prefill", model(c["prefill"]),
                    pred[key]["prefill"]),
                   (f"{key} decode step", model(c["per_step"]),
                    pred[key]["decode_step"])]
        checks += [(f"{key} {n} over data", sum(c[n]["data"].values()), 0)
                   for n in ("prefill", "per_step")]
    for i, c in enumerate(ds["collectives"]):
        checks += [(f"train step {i}", [c["model"][k] for k in (
            "all_reduce", "all_gather", "backward", "bytes")],
            pred["train_step"]),
            (f"train step {i} over data", sum(c["data"].values()), 0)]
    want = pred["tile_launches_a_step"] * TPT_STEPS
    checks.append(("tile launches", ds["kernel_launches"],
                   {"bdi_compress": want // 2, "bdi_decompress": want // 2}))
    for name, a, b in checks:
        if a != b:
            raise AssertionError(f"phase 19: rank {r}: {name} {a}, "
                                 f"predicted {b}")


def phase_moe_tp(dev, started: dict) -> dict:
    """Phase 19 (see the module docstring); ``started``: the dry run's
    traces (``start_step_traces``)."""
    import math
    import tempfile

    import torch
    from repro_torch.launch.serve import dense_generate
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    ocfg = tpt_ocfg()
    card = smi()
    pred = moe_predict()
    log(f"phase 19 prediction (shapes, (1, 4)): {json.dumps(pred)}")
    work = Path(tempfile.mkdtemp(prefix="moe19_"))
    t0 = time.perf_counter()
    ranks = [(_spawn(f"moe_rank({r}, {str(work)!r})",
                     work / f"moe_{r}.log"), work / f"moe_{r}.log")
             for r in range(MOE_RANKS)]
    _wait_all(ranks, "phase 19: a rank", 900)
    ranks_s = time.perf_counter() - t0
    res = [json.loads((work / f"moe_{r}.json").read_text())
           for r in range(MOE_RANKS)]
    got = [torch.load(work / f"moe_{r}.pt") for r in range(MOE_RANKS)]
    sp_traces = step_traces_of(started, "19 sp")
    per_step = {k: pred["tile_launches_a_step"] // 2
                for k in ("bdi_compress", "bdi_decompress")}
    for r, rr in enumerate(res):
        ds, arc = rr["ds"], rr["arc"]["sp"]
        for name, calls in (("deepseek", 2 * MOE_TRAIN_LAYERS),
                            ("arctic-480b", 2 * ARC_LAYERS)):
            got_calls = (ds["sp"] if name == "deepseek" else arc)[
                "routes"]["calls"]
            if got_calls != calls:
                raise AssertionError(f"phase 19: rank {r}: {name}'s sp run "
                                     f"routed {got_calls} times, not "
                                     f"{calls}")
        ds["sp_checks"] = sp_checks("19", r, ds, ds["sp"], sp_traces[r],
                                    got[r], per_step)
        ds["sp_checks"]["routes"] = ds["sp"]["routes"]
        a, b = arc["sp=True"], arc["sp=False"]
        worst = max(arc["grad_rel"].items(), key=lambda kv: kv[1])
        if abs(a["loss"] - b["loss"]) > TPT_FIRST_RTOL * abs(b["loss"]) \
                or worst[1] > SP_GRAD_RTOL \
                or not a["collectives"]["model"]["reduce_scatter"]:
            raise AssertionError(f"phase 19: rank {r}: arctic-480b with sp: "
                                 f"loss {a['loss']} against {b['loss']}, "
                                 f"worst gradient {worst}, collectives "
                                 f"{a['collectives']}")
        log(f"phase 19 rank {r}: the sequence-parallel steps: deepseek "
            f"{json.dumps(ds['sp_checks'])}; arctic-480b's loss and "
            f"gradients {json.dumps(arc)}")
    median = lambda xs: sorted(xs)[len(xs) // 2]       # noqa: E731
    for r, rr in enumerate(res):
        shown = {k: {**v, "ms_a_step": {"median": median(v["ms_a_step"]),
                                        "min": min(v["ms_a_step"]),
                                        "max": max(v["ms_a_step"])}}
                 for k, v in rr.items() if isinstance(v, dict)}
        log(f"phase 19 rank {r} (gloo through the host on one card, not an "
            f"EP speed; {card}): " + json.dumps(rr | shown))
        if rr["backend"] != "gloo":
            raise AssertionError(f"phase 19: rank {r}: {rr['backend']}")
        if not all(math.isfinite(x) for x in rr["ds"]["losses"]):
            raise AssertionError(f"phase 19: rank {r}: "
                                 f"{rr['ds']['losses']}")
        _moe_checks(r, rr, pred)
    for r in range(1, MOE_RANKS):
        a, b = res[r]["ds"], res[0]["ds"]
        if a["losses"] != b["losses"] or a["grad_norms"] != b["grad_norms"]:
            raise AssertionError("phase 19: the ranks' losses or norms "
                                 "differ")
        for key in ("ds_served", "arc_served"):
            if got[r][key]["tokens"] != got[0][key]["tokens"] or \
                    not torch.equal(got[r][key]["logits"],
                                    got[0][key]["logits"]):
                raise AssertionError(f"phase 19: the ranks' {key} differs")
        for i in range(TPT_STEPS):
            for k, x in got[0]["norms"][i].items():
                if not torch.equal(x, got[r]["norms"][i][k]):
                    raise AssertionError(f"phase 19: step {i}: {k} differs "
                                         f"between ranks 0 and {r}")
        if len(got[r]["routes"]) != len(got[0]["routes"]) or not all(
                torch.equal(a, b) for a, b in zip(got[r]["routes"],
                                                  got[0]["routes"])):
            raise AssertionError(f"phase 19: rank {r} routed otherwise "
                                 f"than rank 0")
    # the same weights, prompts and batches, whole, in this process
    t1 = time.perf_counter()
    gen = lambda: torch.Generator(device=dev).manual_seed(MOE_SEED)  # noqa
    cfg = moe_cfg(MOE_DS, MOE_LAYERS)
    params = init_params(cfg, gen(), dev)
    prompts = tp_prompts(cfg.vocab)
    dense_generate(cfg, params, prompts[:, :13], 3)             # warm-up
    ds_whole = dense_generate(cfg, params, prompts, MOE_GEN,
                              keep_logits=True)
    ds_par, ds_worst = _served_parity(
        "phase 19 deepseek", got[0]["ds_served"]["tokens"],
        got[0]["ds_served"]["logits"], ds_whole, TP_ULPS)
    del params
    release(dev)
    cfg = moe_cfg(MOE_DS, MOE_TRAIN_LAYERS)
    params = init_params(cfg, gen(), dev)
    state = adamw_init(params, ocfg)
    step = make_train_step(get_model(cfg), ocfg)
    wide = res[0]["ds"]["wide"]
    start = [tpt_state(params, None, cfg.n_layers, {"data": 0, "model": r},
                       shape=MOE_SHAPE) for r in range(MOE_RANKS)]
    for r in range(MOE_RANKS):
        for k, t in start[r].items():
            if not torch.equal(t, got[r]["start"][k]):
                raise AssertionError(f"phase 19: rank {r}'s {k} is not "
                                     f"its block of the whole model's")
    mets, want_s = [], None
    with RouteReplay(got[0]["routes"], got[0]["route_inputs"]) as replay:
        for i, batch in enumerate(tpt_batches(cfg, dev)):
            params, state, met = step(params, state, batch)
            mets.append(met)
            if i == 0:
                want_s = [tpt_state(params, state, cfg.n_layers,
                                    {"data": 0, "model": r},
                                    shape=MOE_SHAPE, wide=wide)
                          for r in range(MOE_RANKS)]
    del params, state
    release(dev)
    if len(replay.routes) != TPT_STEPS * len(got[0]["routes"]):
        raise AssertionError(f"phase 19: {len(replay.routes)} route calls "
                             f"in {TPT_STEPS} steps, the ranks' first step "
                             f"{len(got[0]['routes'])}")
    replay.check()
    cfg = moe_cfg(MOE_ARC, ARC_LAYERS)
    params = init_params(cfg, gen(), dev)
    prompts = arc_prompts(cfg.vocab)
    dense_generate(cfg, params, prompts[:, :13], 3)             # warm-up
    arc_whole = dense_generate(cfg, params, prompts, ARC_GEN,
                               keep_logits=True)
    arc_par, arc_worst = _served_parity(
        "phase 19 arctic", got[0]["arc_served"]["tokens"],
        got[0]["arc_served"]["logits"], arc_whole, TP_ULPS, ARC_BATCH)
    del params
    release(dev)
    whole_s = time.perf_counter() - t1
    gaps = [_one_step_gap(got[r]["sample"], want_s[r], got[r]["start"])
            for r in range(MOE_RANKS)]
    losses = [m["loss"] for m in mets]
    ours = res[0]["ds"]["losses"]
    if abs(ours[0] - losses[0]) > TPT_FIRST_RTOL * abs(losses[0]) or \
            any(abs(a - b) > TPT_LOSS_RTOL * abs(b)
                for a, b in zip(ours, losses)):
        raise AssertionError(f"phase 19: losses {ours} against the whole "
                             f"model's {losses}")
    for r, g in enumerate(gaps):
        w = {n: v for n, (_, v) in g["worst"].items()}
        if (w["within_1_ulp"] < TPT_ULP_SHARE
                or w["max_gap_over_lr"] > 2.0
                or max(w["m_err"], w["v_err"]) > TPT_MOMENT_RTOL):
            raise AssertionError(f"phase 19: rank {r} after step 1: "
                                 f"{g['worst']}")
    rest = slice(1, None)
    mean = lambda xs: sum(xs) / len(xs)              # noqa: E731
    out = {"card": card, "cell": (
        f"(1, 4) over gloo on one card: deepseek-v2-lite-16b full width "
        f"(16 MLA heads, 64 experts top-6 + 2 shared, 16 a rank), serving "
        f"{TP_BATCH} x {TP_PROMPT} + {MOE_GEN} at {MOE_LAYERS} layers, "
        f"{TPT_STEPS} train steps of {TPT_BATCH} x {TPT_SEQ} at "
        f"{MOE_TRAIN_LAYERS} layers under {ocfg.moment_dtype}; arctic-480b "
        f"full width (56/8 heads, 128 experts top-2, 32 a rank, dense "
        f"residual FFN), serving {ARC_BATCH} x {ARC_PROMPT} + {ARC_GEN} at "
        f"{ARC_LAYERS} layer"),
        "ranks_wall_s": ranks_s, "whole_wall_s": whole_s,
        "deepseek_tokens_equal": ds_par.compared,
        "deepseek_ties": [t.__dict__ for t in ds_par.ties],
        "deepseek_worst_logit_gap_ulps": ds_worst,
        "arctic_tokens_equal": arc_par.compared,
        "arctic_ties": [t.__dict__ for t in arc_par.ties],
        "arctic_worst_logit_gap_ulps": arc_worst,
        "losses": ours, "losses_whole": losses,
        "step_1_route_choices": replay.choices,
        "step_1_choices_flipped": sum(replay.flips),
        "step_1_tokens_flipped": sum(1 for n in replay.flips if n),
        "step_1_router_input_gap_ulps": replay.input_ulps,
        "grad_norms": res[0]["ds"]["grad_norms"],
        "grad_norms_whole": [m["grad_norm"] for m in mets],
        "after_step_1_worst_rank": min(
            (g["worst"] for g in gaps), key=lambda w: w["within_1_ulp"][1]),
        "ms": {f"rank{r}": {
            "ds_init_s": rr["ds"]["init_s"],
            "ds_prefill": rr["ds"]["prefill_ms"],
            "ds_decode_median": median(rr["ds"]["ms_a_step"]),
            "ds_fwd_bwd": mean(rr["ds"]["fwd_bwd_ms"][rest]),
            "ds_opt": mean(rr["ds"]["opt_ms"][rest]),
            "arc_init_s": rr["arc"]["init_s"],
            "arc_prefill": rr["arc"]["prefill_ms"],
            "arc_decode_median": median(rr["arc"]["ms_a_step"])}
            for r, rr in enumerate(res)},
        "whole_ms": {
            "ds_prefill": ds_whole["prefill_s"] * 1e3,
            "ds_decode_median": median(ds_whole["decode_s"]) * 1e3,
            "ds_fwd_bwd": mean([m["fwd_bwd_s"] * 1e3 for m in mets[rest]]),
            "ds_opt": mean([m["opt_s"] * 1e3 for m in mets[rest]]),
            "arc_prefill": arc_whole["prefill_s"] * 1e3,
            "arc_decode_median": median(arc_whole["decode_s"]) * 1e3},
        "collectives_a_step": {
            "ds_prefill": res[0]["ds"]["serve_collectives"]["prefill"],
            "ds_decode": res[0]["ds"]["serve_collectives"]["per_step"],
            "ds_train": res[0]["ds"]["collectives"][-1],
            "arc_prefill": res[0]["arc"]["serve_collectives"]["prefill"],
            "arc_decode": res[0]["arc"]["serve_collectives"]["per_step"]},
        "peak_gb_a_rank": {k: [rr[m][f"{k}_peak_bytes"] / 1e9 for rr in res]
                           for k, m in (("serve", "ds"), ("train", "ds"))}
        | {"arc_serve": [rr["arc"]["serve_peak_bytes"] / 1e9
                         for rr in res]},
        "tiles_held_vs_plain": [rr["ds"]["tiles_held_vs_plain"]
                                for rr in res],
        "sp_step": {"deepseek": [rr["ds"]["sp_checks"] for rr in res],
                    "arctic_loss_and_gradients": [rr["arc"]["sp"]
                                                  for rr in res]},
        "launches": {k: sum(rr["ds"]["kernel_launches"].get(k, 0)
                            + rr["ds"]["sp"]["kernel_launches"].get(k, 0)
                            for rr in res)
                     for k in ("bdi_compress", "bdi_decompress")},
        "launches_straddling": pred["tile_launches_a_step_straddling"]
        * TPT_STEPS * MOE_RANKS}
    log(f"phase 19: {json.dumps(out)}")
    return out


FAM_SHAPE = (1, 4)                   # (data, model)
FAM_RANKS = FAM_SHAPE[0] * FAM_SHAPE[1]
FAM_SEED = 0
FAM_STEPS = 2                        # bdi8 train steps
FAM_TRAIN = (2, 128)                 # a train batch: rows, positions
FAM_ENC = 64                         # seamless's encoder frames, serving
# arch -> (depth, serving batch, prompt, greedy tokens): hymba at 3 of
# its 32 layers, 1 of them full attention (3 of 32 at full depth), its
# prompts past its window; xlstm at 8 of 24 (7 mLSTM, 1 sLSTM), whose
# prefill is a decode step a token (~0.46 s each through the host);
# seamless at 2 + 2 of 24 + 24
FAM_CELLS = {"hymba-1.5b": ({"n_layers": 3, "n_full_attn": 1}, 2, 1040, 4),
             "xlstm-350m": ({"n_layers": 8}, 4, 8, 4),
             "seamless-m4t-large-v2": ({"n_layers": 2, "enc_layers": 2}, 2,
                                       32, 4)}
# the families whose residual stream JAX's set_sp splits (seamless's never)
FAM_SP = ("hymba-1.5b", "xlstm-350m")


def fam_cfg(arch: str):
    from repro_torch.configs.registry import get_arch
    kw = dict(FAM_CELLS[arch][0])
    return at_depth(get_arch(arch), kw.pop("n_layers"), **kw)


def fam_inputs(cfg, dev) -> dict:
    """The prompts (and seamless's frames) ``dense_generate`` serves, and
    ``FAM_STEPS`` train batches of phase 10's stream, every rank the
    same."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, DataIterator
    _, b, s, _ = FAM_CELLS[cfg.name]
    g = torch.Generator().manual_seed(FAM_SEED + 3)
    out = {"prompts": torch.randint(1, cfg.vocab, (b, s), generator=g)}
    if cfg.is_encdec:
        out["frames"] = (torch.randn((b, FAM_ENC, cfg.d_model), generator=g)
                         * 0.02).to(dev)
    it = DataIterator(cfg, ShapeConfig("train", FAM_TRAIN[1], FAM_TRAIN[0],
                                       "train"), DataConfig(seed=0))
    out["batches"] = [{k: torch.from_numpy(v).to(dev)
                       for k, v in next(it).items()}
                      for _ in range(FAM_STEPS)]
    return out


def fam_counts(cfg, m: int, serve: tuple, train: tuple, sharded: int,
               straddling: list) -> dict:
    """Model-axis collectives of each family as ``distributed/tp.py`` and
    the models issue them: [all_reduce, all_gather, bytes] of
    ``dense_generate``'s prefill and of a decode step, [all_reduce,
    all_gather, backward, bytes] of a train step.  ``serve`` (rows,
    prompt, encoder frames), ``train`` (rows, positions, which are the
    encoder's frames too); ``sharded`` the
    leaves whose squares the clip norm sums over the axis (one f32 each),
    ``straddling`` the bytes of each leaf whose bdi8 tiles straddle the
    shards (its gradient gathered).  Per family:

    * hymba (its heads whole): a layer's prefill gathers ``in_proj``'s
      block (bf16 [B, S, 2 di/m]) and the Mamba state into the cache's
      layout (f32 [B, di/m, n]), sums x_proj's partial (f32 [B, S, R +
      2n]), ``out_proj``'s and the FFN's (f32 [B, S, D]); a decode step
      adds the MAX and SUM over the attention's T or window blocks (f32
      [B, H] and [B, H, Dh + 1]) and the state's re-cut to channels;
      training: forward as the prefill without the state, the recompute
      again without the FFN's sum (past the layer's last saved tensor),
      backward the FFN's gate and up input gradients, the x_proj output's
      (``copy_to_model``), the gathered block's (f32 [B, S, 2 di]) and
      ``in_proj``'s input gradient;
    * xlstm (a decode step a prompt token): the embedding's sum, a
      mLSTM's gathers of u, of q, k and v (bf16 [B, 3 di/m]) and of the
      stabiliser m where it is split, the sum of its numerator and
      normaliser (f32 [B, H, dh + 1]) and of ``down``; an sLSTM's gathers
      of its states (f32 [4, B, D/m]), of Wx x (bf16 [B, 4D/m]) and of r
      where it is split; the logits' gather; training: forward the
      embedding's and ``down``'s sums, the gathers of u (and q and k
      where a head spans ranks), Wx x and r, the loss's MAX and SUM; the
      recompute the loss's and the gathers again; backward the head's
      input gradient, a mLSTM's ``w_if`` weight and bias gradients (f32),
      u's (f32 [B, S, di]), up's and gate_z's input gradients, an
      sLSTM's ``wx`` input gradient;
    * seamless (heads split): an encoder layer sums wo and down (f32 [B,
      S_enc, D]), a decoder layer wo, the cross-attention's wo and down;
      training: forward as serving, the recompute without down, backward
      q, k and v's, the cross-attention's q (and k and v on the memory)
      and the FFN's gate and up input gradients.

    A vocab that divides m adds the embedding's sum and the logits'
    gather, or the loss's MAX and SUM (and again in the recompute) and
    the head's input gradient; a whole one nothing.  Then the clip
    norm's sum and one gather a straddling leaf."""
    (b, s, se), (tb, ts) = serve, train
    d, v = cfg.d_model, cfg.vocab
    split_v = v % m == 0
    emb = lambda rows: [split_v, 0, rows * d * 4 * split_v]  # noqa: E731
    logits = [0, split_v, b * (v // m) * 2 * split_v]
    add = lambda *xs: [sum(c) for c in zip(*xs)]              # noqa: E731
    if cfg.family == "hybrid":
        di, n = cfg.ssm_expand * d, cfg.ssm_state
        r = -(-d // 16) + 2 * n
        h, dh = cfg.n_heads, cfg.head_dim
        state = b * (di // m) * n * 4 if n % m == 0 and n >= m else 0
        ag_state = int(state > 0)
        lay = [3, 1 + ag_state, b * s * (2 * di // m) * 2 + state
               + b * s * r * 4 + 2 * b * s * d * 4]
        pre = add(emb(b * s), logits, *[lay] * cfg.n_layers)
        step = [5, 1 + 2 * ag_state, b * h * 4 + b * h * (dh + 1) * 4
                + b * (2 * di // m) * 2 + 2 * state + b * r * 4
                + 2 * b * d * 4]
        dec = add(emb(b), logits, *[step] * cfg.n_layers)
        x = tb * ts
        fwd = [3, 1, x * (2 * di // m) * 2 + x * r * 4 + 2 * x * d * 4]
        rec = [2, 1, x * (2 * di // m) * 2 + x * r * 4 + x * d * 4]
        bwd = [5, 0, 3 * x * d * 4 + x * r * 4 + x * 2 * di * 4]
        back = 5 * cfg.n_layers
        train_l = [add(fwd, rec, bwd)] * cfg.n_layers
        loss = []
    elif cfg.family == "ssm":
        from repro_torch.models.xlstm import layer_is_slstm
        flags = layer_is_slstm(cfg)
        ns = int(flags.sum())
        nm = cfg.n_layers - ns
        hh, di = cfg.n_heads, cfg.ssm_expand * d
        dh, dhs = di // hh, d // hh
        span = hh % m != 0
        mm = b * (hh // m) * 4 if hh % m == 0 and hh >= m else 0
        rr = (hh // m) * dhs * 4 * dhs * 4 if hh % m == 0 else 0
        mt = [2, 2 + int(mm > 0), b * (di // m) * 2 + b * 3 * (di // m) * 2
              + mm + b * hh * (dh + 1) * 4 + b * d * 4]
        st = [0, 2 + int(rr > 0), 4 * b * (d // m) * 4 + b * (4 * d // m) * 2
              + rr]
        tok = add(emb(b), logits, *[mt] * nm, *[st] * ns)
        pre = [c * s for c in tok]
        dec = tok
        x = tb * ts
        qk = 2 * span
        fwd_m = [1, 1 + qk, x * (di // m) * 2 * (1 + qk) + x * d * 4]
        rec_m = [0, 1 + qk, x * (di // m) * 2 * (1 + qk)]
        bwd_m = [5 + qk, 0, di * 2 * hh * 4 + 2 * hh * 4
                 + x * di * 4 * (1 + qk) + 2 * x * d * 4]
        fwd_s = [0, 1 + int(rr > 0), x * (4 * d // m) * 2 + rr]
        rec_s = fwd_s
        bwd_s = [1, 0, x * d * 4]
        back = nm * (5 + qk) + ns
        train_l = [add(fwd_m, rec_m, bwd_m)] * nm \
            + [add(fwd_s, rec_s, bwd_s)] * ns
        loss = []
    else:
        ne, nd = cfg.enc_layers, cfg.n_layers
        pre = add(emb(b * s), logits, *[[2, 0, 2 * b * se * d * 4]] * ne,
                  *[[3, 0, 3 * b * s * d * 4]] * nd)
        dec = add(emb(b), logits, *[[3, 0, 3 * b * d * 4]] * nd)
        x = tb * ts                       # the encoder's frames: ts too
        train_l = [[8, 0, 8 * x * d * 4]] * ne \
            + [[13, 0, 13 * x * d * 4]] * nd
        back = 5 * ne + 8 * nd
        loss = []
    x = tb * ts
    if split_v:        # embedding; loss MAX + SUM, twice; head's dx
        loss = [[1, 0, x * d * 4], [4, 0, 2 * 12 * x], [1, 0, x * d * 4]]
        back += 1
    tr = add(*train_l, *loss, [1, 0, sharded * 4],
             [0, len(straddling), sum(straddling)])
    return {"prefill": pre, "decode_step": dec,
            "train_step": [tr[0], tr[1], back, tr[2]]}


def fam_predict(arch: str) -> dict:
    """What a rank of phase 20 holds and issues for ``arch``, from the
    shapes alone (meta tensors on an abstract ``(1, 4)`` mesh): bytes of
    its params, of its decode cache after ``dense_generate`` and of its
    bdi8 moments; the leaves whose moment tiles straddle the shards; the
    collectives and their bytes by axis (:func:`fam_counts`; none over
    data); the tile launches a train step (a moment group is two
    decompresses and two compresses)."""
    import torch
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tp
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.launch.elastic import abstract_mesh
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw as AW
    from repro_torch.optim import adamw_init, opt_state_bytes
    cfg = fam_cfg(arch)
    _, b, s, gen = FAM_CELLS[arch]
    model = get_model(cfg)
    ocfg = tpt_ocfg()
    mesh = abstract_mesh(FAM_SHAPE, ("data", "model"))
    m = FAM_SHAPE[1]
    with use_mesh(mesh):
        whole = model.init(torch.Generator(), "meta")
        local = SH.local_params(whole, mesh, coord={"data": 0, "model": 0})
        kw = {"enc_len": FAM_ENC} if cfg.is_encdec else {}
        cache = model.init_cache(b, s + gen, device="meta", **kw)
        wide = tp.check_moments(local, ocfg.moment_dtype)
        sharded = sum(tp.sharded_leaves(whole, local))
        moments = opt_state_bytes(adamw_init(local, ocfg), ocfg)
        shapes = [AW._wide(p.shape, w)
                  for (_, p), w in zip(leaf_paths(local), wide)]
    leaves = leaf_paths(local)
    counts = fam_counts(cfg, m, (b, s, FAM_ENC), FAM_TRAIN, sharded,
                        [t.numel() * t.element_size()
                         for (_, t), w in zip(leaves, wide) if w])
    groups = [len(AW._groups(torch.empty(sh, device="meta")))
              for sh in shapes if AW._tiled(sh, ocfg.moment_dtype)]
    return {"param_bytes": sum(t.numel() * t.element_size()
                               for _, t in leaves),
            "cache_bytes": sum(t.numel() * t.element_size() for t in cache),
            "moment_bytes": moments,
            "straddling": [p for (p, _), w in zip(leaves, wide) if w],
            **counts, "tile_launches_a_step": 4 * sum(groups)}


class Reassociated:
    """Within, the whole model (no mesh) adds its sums as the ranks of a
    model axis of ``m`` add them: the mLSTM decode's numerator and its
    normaliser's dot over ``m`` blocks of the key dim, a product whose
    columns the ranks split (``tp.replicated``, which ``column_parallel``
    runs without a mesh) in ``m`` column blocks, a row-parallel product
    as ``m`` f32 partials added in order, then rounded: the same
    arithmetic, the f32 sums reassociated.  At a random init the mLSTM's
    recurrence (its normaliser's ``max(|q . n|, exp(-m))``, over every
    prompt token and layer) amplifies such roundings: on the CPU, reduced
    xlstm-350m at d_model 256, 8 mLSTM layers and 32 prompt tokens moves
    its logits by 4.5 bf16 ULPs with the decode's sums alone so
    reassociated (18.5 with 2 heads), and the ranks of ``(1, 4)`` move
    them by 5.3."""

    EQS = ("bhk,bhkv->bhv", "bhk,bhk->bh")

    def __init__(self, m: int):
        self.m = m

    def __enter__(self):
        import torch
        from repro_torch.distributed import tp
        self.torch, self.tp = torch, tp
        self.saved = (torch.einsum, tp.replicated, tp.row_parallel)
        m = self.m
        einsum, replicated, _ = self.saved

        def blocks(eq, *ops):
            if eq not in self.EQS:
                return einsum(eq, *ops)
            a, b = ops
            n = a.shape[-1] // m
            cut = (lambda t, i: t.narrow(2, i * n, n)) \
                if eq == self.EQS[0] else \
                (lambda t, i: t.narrow(-1, i * n, n))
            out = einsum(eq, a.narrow(-1, 0, n), cut(b, 0))
            for i in range(1, m):
                out = out + einsum(eq, a.narrow(-1, i * n, n), cut(b, i))
            return out

        def columns(x, w):
            w = tp.weight(w)
            w2d = w.reshape(w.shape[0], -1)
            if w2d.shape[1] % m:
                return replicated(x, w)
            n = w2d.shape[1] // m
            y = torch.cat([replicated(x, w2d[:, i * n:(i + 1) * n])
                           for i in range(m)], dim=-1)
            return y.reshape(*x.shape[:-1], *w.shape[1:])

        def rows(x, w, seq=True):
            w = tp.weight(w)
            w2d = w.reshape(-1, w.shape[-1])
            n = w2d.shape[0] // m
            y = sum(torch.matmul(x[..., i * n:(i + 1) * n].float(),
                                 w2d[i * n:(i + 1) * n].float())
                    for i in range(m))
            return y.to(x.dtype)
        torch.einsum, tp.replicated, tp.row_parallel = blocks, columns, rows
        return self

    def __exit__(self, *exc):
        self.torch.einsum, self.tp.replicated, self.tp.row_parallel = \
            self.saved


def _fam_parity(name: str, tokens, logits, whole: dict, ulps: float,
                batch: int) -> tuple[int, list, float]:
    """A rank's greedy ``tokens``/``logits`` against the whole model's:
    every live row's logits within ``ulps`` bf16 ULPs of its array's
    largest |value|; where a row's token differs, the whole model's
    margin between the two tokens within ``ulps`` too (a near tie at the
    bound), and the row is compared no further.  Returns (tokens equal,
    the near ties, the worst gap in ULPs)."""
    from repro_torch.serving.parity import bf16_ulp
    stopped, ties, worst, equal = set(), [], 0.0, 0
    for j in range(logits.shape[0]):
        live = [b for b in range(batch) if b not in stopped]
        if not live:
            break
        a, w = logits[j, live], whole["logits"][j, live]
        unit = bf16_ulp(float(w.abs().max()))
        gap = float((a - w).abs().max()) / unit
        worst = max(worst, gap)
        if gap > ulps:
            raise AssertionError(f"{name}: step {j} logits {gap:.2f} ULPs "
                                 f"from the whole model's (bound {ulps})")
        for b in live:
            g, t = tokens[b][j], whole["tokens"][b][j]
            if g == t:
                equal += 1
                continue
            row = whole["logits"][j, b]
            margin = float(row[t] - row[g]) / unit
            if margin > ulps:
                raise AssertionError(f"{name}: step {j} row {b}: token {g} "
                                     f"for {t}, {margin:.2f} ULPs apart")
            ties.append({"step": j, "row": b, "want": t, "got": g,
                         "margin_ulps": margin})
            stopped.add(b)
    return equal, ties, worst


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.clone()


def _fam_model(counts: dict) -> list:
    return [counts["model"][k] for k in ("all_reduce", "all_gather",
                                         "bytes")]


def fam_rank(rank: int, work: str) -> None:
    """One rank of phase 20 on the ``(1, 4)`` mesh: each family in turn,
    the whole model drawn on the card and cut to the rank's blocks, served
    through ``dense_generate``, then ``FAM_STEPS`` bdi8 train steps;
    writes ``fam_<rank>.json`` and ``.pt``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tp
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.kernels._device import resolve_device
    from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
    from repro_torch.launch.serve import dense_generate
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw, adamw_init, opt_state_bytes
    dev = resolve_device("cuda")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(work) / "rendezvous_fam"), FAM_RANKS), rank=rank,
        world_size=FAM_RANKS)
    res = {"rank": rank, "backend": dist.get_backend()}
    keep = {}
    try:
        mesh = make_host_mesh(*FAM_SHAPE)
        with use_mesh(mesh):
            for arch in FAM_CELLS:
                cfg, ocfg = fam_cfg(arch), tpt_ocfg()
                model = get_model(cfg)
                inp = fam_inputs(cfg, dev)
                t0 = time.perf_counter()
                with use_mesh(None):
                    whole = model.init(torch.Generator(
                        device=dev).manual_seed(FAM_SEED), dev)
                params = SH.local_params(whole, mesh)
                del whole
                torch.cuda.empty_cache()
                sync(dev)
                r = {"init_s": time.perf_counter() - t0,
                     "param_bytes": sum(t.numel() * t.element_size()
                                        for t in _leaves(params))}
                frames = inp.get("frames")
                dense_generate(cfg, params, inp["prompts"][:, :6], 2,
                               enc_embeds=frames)             # warm-up
                out = dense_generate(cfg, params, inp["prompts"],
                                     FAM_CELLS[arch][3], keep_logits=True,
                                     enc_embeds=frames)
                r.update(prefill_ms=out["prefill_s"] * 1e3,
                         ms_a_step=[x * 1e3 for x in out["decode_s"]],
                         serve_collectives=out["collectives"],
                         cache_bytes=out["cache_bytes"])
                keep[arch] = {"tokens": out["tokens"],
                              "logits": out["logits"]}
                wide = tp.check_moments(params, ocfg.moment_dtype)
                state = adamw_init(params, ocfg)
                step = make_train_step(model, ocfg)
                sp = arch in FAM_SP
                if sp:
                    keep[arch]["start"] = tpt_state(params, None,
                                                    cfg.n_layers)
                    sp_start = (_tree_clone(params), _tree_clone(state))
                ops.reset_launches()
                mets, norms, held = [], [], 0
                for i, batch in enumerate(inp["batches"]):
                    params, state, met = step(params, state, batch)
                    mets.append(met)
                    norms.append(tpt_norms(params, state))
                    if i == 0:
                        launches = dict(ops.LAUNCHES)
                        if sp:
                            keep[arch]["sample"] = tpt_state(
                                params, state, cfg.n_layers)
                        held = dpt_tiles_vs_plain(params, state,
                                                  cfg.n_layers, "20")
                        ops.LAUNCHES.update(launches)
                if sp:
                    r["sp"], keep[arch]["sp_sample"] = sp_step(
                        step, *sp_start, inp["batches"], dev, cfg.n_layers)
                    del sp_start
                keep[arch]["norms"] = norms
                r.update(opt_state_bytes=opt_state_bytes(state, ocfg),
                         straddling=[p for (p, _), w in zip(
                             leaf_paths(params), wide) if w],
                         losses=[x["loss"] for x in mets],
                         grad_norms=[x["grad_norm"] for x in mets],
                         fwd_bwd_ms=[x["fwd_bwd_s"] * 1e3 for x in mets],
                         opt_ms=[x["opt_s"] * 1e3 for x in mets],
                         collectives=[x["collectives"] for x in mets],
                         tiles_held_vs_plain=held,
                         kernel_launches={k: v for k, v in
                                          ops.LAUNCHES.items() if v})
                res[arch] = r
                del params, state, step, inp
                torch.cuda.empty_cache()
        torch.save(keep, Path(work) / f"fam_{rank}.pt")
        (Path(work) / f"fam_{rank}.json").write_text(json.dumps(res))
    finally:
        destroy_mesh()


def _fam_checks(r: int, arch: str, x: dict, pred: dict) -> None:
    """A rank's bytes, collectives and launches against ``fam_predict``."""
    c = x["serve_collectives"]
    checks = [("params", x["param_bytes"], pred["param_bytes"]),
              ("cache", x["cache_bytes"], pred["cache_bytes"]),
              ("moments", x["opt_state_bytes"], pred["moment_bytes"]),
              ("straddling", x["straddling"], pred["straddling"]),
              ("prefill", _fam_model(c["prefill"]), pred["prefill"]),
              ("decode step", _fam_model(c["per_step"]),
               pred["decode_step"])]
    checks += [(f"{n} over data", sum(c[n]["data"].values()), 0)
               for n in ("prefill", "per_step")]
    for i, cc in enumerate(x["collectives"]):
        checks += [(f"train step {i}", [cc["model"][k] for k in (
            "all_reduce", "all_gather", "backward", "bytes")],
            pred["train_step"]),
            (f"train step {i} over data", sum(cc["data"].values()), 0)]
    want = pred["tile_launches_a_step"] * FAM_STEPS
    checks.append(("tile launches", x["kernel_launches"],
                   {"bdi_compress": want // 2, "bdi_decompress": want // 2}))
    for name, a, b in checks:
        if a != b:
            raise AssertionError(f"phase 20: rank {r}: {arch}: {name} {a}, "
                                 f"predicted {b}")


def phase_families_tp(dev, started: dict) -> dict:
    """Phase 20 (see the module docstring); ``started``: the dry run's
    traces (``start_step_traces``)."""
    import math
    import tempfile

    import torch
    from repro_torch.launch.serve import dense_generate
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw_init
    card = smi()
    pred = {arch: fam_predict(arch) for arch in FAM_CELLS}
    log(f"phase 20 prediction (shapes, (1, 4)): {json.dumps(pred)}")
    work = Path(tempfile.mkdtemp(prefix="fam20_"))
    t0 = time.perf_counter()
    ranks = [(_spawn(f"fam_rank({r}, {str(work)!r})",
                     work / f"fam_{r}.log"), work / f"fam_{r}.log")
             for r in range(FAM_RANKS)]
    _wait_all(ranks, "phase 20: a rank", 600)
    ranks_s = time.perf_counter() - t0
    res = [json.loads((work / f"fam_{r}.json").read_text())
           for r in range(FAM_RANKS)]
    got = [torch.load(work / f"fam_{r}.pt") for r in range(FAM_RANKS)]
    sp_traces = {arch: step_traces_of(started, f"20 sp {arch}")
                 for arch in FAM_SP}
    median = lambda xs: sorted(xs)[len(xs) // 2]       # noqa: E731
    for r, rr in enumerate(res):
        log(f"phase 20 rank {r} (gloo through the host on one card, not a "
            f"TP speed; {card}): {json.dumps(rr)}")
        if rr["backend"] != "gloo":
            raise AssertionError(f"phase 20: rank {r}: {rr['backend']}")
        for arch in FAM_CELLS:
            if not all(math.isfinite(x) for x in rr[arch]["losses"]):
                raise AssertionError(f"phase 20: rank {r}: {arch}: "
                                     f"{rr[arch]['losses']}")
            _fam_checks(r, arch, rr[arch], pred[arch])
    for r in range(1, FAM_RANKS):
        for arch in FAM_CELLS:
            a, b = res[r][arch], res[0][arch]
            if a["losses"] != b["losses"] or \
                    a["grad_norms"] != b["grad_norms"]:
                raise AssertionError(f"phase 20: {arch}: the ranks' losses "
                                     f"or norms differ")
            ga, gb = got[r][arch], got[0][arch]
            if ga["tokens"] != gb["tokens"] or \
                    not torch.equal(ga["logits"], gb["logits"]):
                raise AssertionError(f"phase 20: {arch}: the ranks' served "
                                     f"tokens or logits differ")
            for i in range(FAM_STEPS):
                for k, t in gb["norms"][i].items():
                    if not torch.equal(t, ga["norms"][i][k]):
                        raise AssertionError(f"phase 20: {arch}: step {i}: "
                                             f"{k} differs between ranks 0 "
                                             f"and {r}")
    # the same weights, prompts and batches, whole, in this process
    t1 = time.perf_counter()
    out = {"card": card, "ranks_wall_s": ranks_s, "cells": {}}
    for arch, (_, b, s, gen) in FAM_CELLS.items():
        cfg, ocfg = fam_cfg(arch), tpt_ocfg()
        model = get_model(cfg)
        inp = fam_inputs(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(
            FAM_SEED), dev)
        frames = inp.get("frames")
        dense_generate(cfg, params, inp["prompts"][:, :6], 2,
                       enc_embeds=frames)                    # warm-up
        whole = dense_generate(cfg, params, inp["prompts"], gen,
                               keep_logits=True, enc_embeds=frames)
        bound, moved = TP_ULPS, None
        if cfg.family == "ssm":
            # the mLSTM's recurrence amplifies f32 reassociation: the
            # bound is twice what reassociating the whole model's sums as
            # the ranks do moves its logits (``Reassociated``)
            with Reassociated(FAM_SHAPE[1]):
                moved = dense_generate(cfg, params, inp["prompts"], gen,
                                       keep_logits=True)
            moved = _fam_parity(f"phase 20 {arch} reassociated",
                                moved["tokens"], moved["logits"], whole,
                                float("inf"), b)[2]
            bound = max(TP_ULPS, 2 * moved)
            equal, ties, worst = _fam_parity(
                f"phase 20 {arch}", got[0][arch]["tokens"],
                got[0][arch]["logits"], whole, bound, b)
        else:
            par, worst = _served_parity(f"phase 20 {arch}",
                                        got[0][arch]["tokens"],
                                        got[0][arch]["logits"], whole,
                                        TP_ULPS, b)
            equal, ties = par.compared, [t.__dict__ for t in par.ties]
        params0 = None
        if cfg.family == "ssm" or arch in FAM_SP:   # the weights before
            with torch.no_grad():                   # the update
                params0 = _tree_clone(params)
        state = adamw_init(params, ocfg)
        step = make_train_step(model, ocfg)
        mets = []
        for batch in inp["batches"]:
            params, state, met = step(params, state, batch)
            mets.append(met)
            if arch in FAM_SP and len(mets) == 1:
                sample = tpt_state(params, state, cfg.n_layers)
        del params, state
        sp_bounds = moved_state = None
        if arch in FAM_SP:
            # what reassociating the whole model's sums moves its first
            # step's state: the sp steps' state is held to twice that
            p1 = _tree_clone(params0)
            with Reassociated(FAM_SHAPE[1]):
                p1, st1, _ = step(p1, adamw_init(p1, ocfg),
                                  inp["batches"][0])
            moved_state = _one_step_gap(
                tpt_state(p1, st1, cfg.n_layers), sample,
                tpt_state(params0, None, cfg.n_layers))["worst"]
            del p1, st1, sample
            w = {n: v for n, (_, v) in moved_state.items()}
            sp_bounds = {
                "within_1_ulp": min(TPT_ULP_SHARE,
                                    1 - 2 * (1 - w["within_1_ulp"])),
                "max_gap_over_lr": SP_STATE_BOUNDS["max_gap_over_lr"],
                "moment_err": max(TPT_MOMENT_RTOL,
                                  2 * max(w["m_err"], w["v_err"]))}
            for r, x in enumerate(res):
                x = x[arch]
                x["sp_checks"] = sp_checks(
                    f"20 {arch}", r, x, x["sp"], sp_traces[arch][r],
                    got[r][arch], {k: pred[arch]["tile_launches_a_step"] // 2
                                   for k in ("bdi_compress",
                                             "bdi_decompress")}, sp_bounds)
                log(f"phase 20 rank {r}: {arch}'s sequence-parallel steps: "
                    f"{json.dumps(x['sp_checks'])}")
        del step
        losses = [x["loss"] for x in mets]
        ours = res[0][arch]["losses"]
        first = TPT_FIRST_RTOL
        if cfg.family == "ssm":          # as the logits' bound above
            with Reassociated(FAM_SHAPE[1]), torch.no_grad():
                moved_loss = float(model.loss(params0, inp["batches"][0]))
            first = max(first, 2 * abs(moved_loss - losses[0])
                        / abs(losses[0]))
        if abs(ours[0] - losses[0]) > first * abs(losses[0]) or \
                any(abs(a - w) > TPT_LOSS_RTOL * abs(w)
                    for a, w in zip(ours, losses)):
            raise AssertionError(f"phase 20: {arch}: losses {ours} against "
                                 f"the whole model's {losses}")
        del params0
        release(dev)
        rr = [x[arch] for x in res]
        out["cells"][arch] = {
            "cell": f"{arch} full width, {cfg.n_layers} layers"
                    + (f" + {cfg.enc_layers} encoder layers, {FAM_ENC} frames"
                       if cfg.is_encdec else "")
                    + f", {b} x {s} + {gen}, {FAM_STEPS} train steps of "
                      f"{FAM_TRAIN[0]} x {FAM_TRAIN[1]} under bdi8",
            "tokens_equal": equal, "near_ties": ties,
            "worst_logit_gap_ulps": worst, "bound_ulps": bound,
            "reassociated_gap_ulps": moved,
            "losses": ours, "losses_whole": losses,
            "first_loss_rtol": first,
            "grad_norms": rr[0]["grad_norms"],
            "grad_norms_whole": [x["grad_norm"] for x in mets],
            "rank_ms": {"prefill": [x["prefill_ms"] for x in rr],
                        "decode_median": [median(x["ms_a_step"])
                                          for x in rr],
                        "fwd_bwd": [x["fwd_bwd_ms"][-1] for x in rr],
                        "opt": [x["opt_ms"][-1] for x in rr]},
            "whole_ms": {"prefill": whole["prefill_s"] * 1e3,
                         "decode_median": median(whole["decode_s"]) * 1e3,
                         "fwd_bwd": mets[-1]["fwd_bwd_s"] * 1e3,
                         "opt": mets[-1]["opt_s"] * 1e3},
            "bytes_a_rank": {k: rr[0][k] for k in (
                "param_bytes", "cache_bytes", "opt_state_bytes")},
            "collectives": {"prefill": rr[0]["serve_collectives"]["prefill"],
                            "decode": rr[0]["serve_collectives"]["per_step"],
                            "train": rr[0]["collectives"][-1]},
            "tiles_held_vs_plain": [x["tiles_held_vs_plain"] for x in rr],
            "sp_step": [x["sp_checks"] for x in rr] if arch in FAM_SP
            else None, "reassociated_state_gap": moved_state}
    out["whole_wall_s"] = time.perf_counter() - t1
    out["launches"] = {k: sum(x[arch]["kernel_launches"].get(k, 0)
                              + x[arch].get("sp", {}).get(
                                  "kernel_launches", {}).get(k, 0)
                              for x in res for arch in FAM_CELLS)
                       for k in ("bdi_compress", "bdi_decompress")}
    log(f"phase 20: {json.dumps(out)}")
    return out


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
    traces = start_step_traces()
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
    dp = phase_dp_train(dev, at_depth(cfg, DP_LAYERS))
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
    phase_tensor_parallel(dev)
    phase_done("15 tensor-parallel serving of internvl2-76b at full width, "
               "4 layers, two ranks on one card")
    tp_trained = phase_tp_train(dev)
    phase_done("16 tensor-parallel training of internvl2-76b at full width, "
               "4 layers, two ranks on one card, bdi8 moments")
    dpt = phase_dp_tp(dev, traces)
    phase_done("17 DP x TP serving and training (bdi8) of internvl2-76b at "
               "full width, 4 layers, four ranks on one card")
    rep = phase_replicated(dev, traces)
    phase_done("18 yi-6b on a model axis of 8 (K/V whole, the cache over "
               "T, bdi8 tiles across shards), eight ranks on one card")
    moe = phase_moe_tp(dev, traces)
    phase_done("19 deepseek-v2-lite-16b and arctic-480b on a model axis of "
               "4 (experts a rank, MLA heads, the latent split), four ranks "
               "on one card")
    fam = phase_families_tp(dev, traces)
    phase_done("20 hymba-1.5b, xlstm-350m and seamless-m4t-large-v2 on a "
               "model axis of 4 (Mamba's channels, rings over the window, "
               "xLSTM's heads, whole vocabularies), four ranks on one card")

    # launches of the paths that ran each kernel (3b set its own): the
    # serve run of phase 4 or 4b, the tile path and the training runs of
    # phases 10, 13 (the compressed all-reduce), 16, 17, 18, 19 and 20
    # (every rank), and
    # for the serving kernels phases 9 and 9b, each counted from 0 over
    # its own run
    path = {"bdi_compress_kv": bdi, "paged_attention_tail": bdi,
            "gbdi_compress_kv": gbdi, "gbdi_decompress_kv": gbdi,
            "bdi_compress": tile, "bdi_decompress": tile}
    for k in kernels:
        name = k["name"]
        if name in path:
            k["launches"] = path[name]["launches"][name]
        if name in ("bdi_compress", "bdi_decompress"):
            k["launches"] += (trained["launches"][name]
                              + dp["launches"][name]
                              + tp_trained["launches"][name]
                              + dpt["launches"][name]
                              + rep["launches"][name]
                              + moe["launches"][name]
                              + fam["launches"][name])
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
