"""Tensor parallelism over the mesh's ``model`` axis: the one module that
issues that axis's collectives.

The JAX package has no counterpart.  There the models call ``shard(x,
DP, None, MODEL)`` at every layer boundary, the launcher places the
params under the rule table (``distributed/sharding.py``) and GSPMD
turns both into a tensor-parallel program, inserting the collectives
itself.  The compiled HLO of a dense GQA model under a ``(1, m)`` mesh
holds these, each of which has its function here:

  * an f32 ``all-reduce`` of [B, S, D] after attention's output
    projection and after the MLP's down projection (row-parallel: each
    rank's partial dot over its heads or its d_ff columns is kept in f32,
    summed over the ranks and rounded to bf16 afterwards):
    :func:`reduce_from_model` and :func:`row_parallel`;
  * the embedding: a lookup masked to this rank's rows of the vocab,
    ``all-reduce``-d in f32: :func:`vocab_embed`;
  * logits that come out sharded over the vocab (``PartitionSpec(None,
    'model')``), which a caller of ``prefill``/``decode_step`` reads as
    one global array: :func:`gather_vocab` gives every rank the whole
    ``[..., V]`` by an ``all_gather`` of the ranks' columns;
  * the loss, a vocab-parallel cross-entropy (an f32 ``all-reduce`` of
    the row max, then one of the gold logit and the sum of exp): not
    here.  Training under a model axis raises (:func:`refuse_training`).

Column-parallel products (q/k/v, the MLP's gate and up, the LM head) need
no collective: each rank computes its own heads or columns from the
replicated residual stream, the same arithmetic as the whole product.

The layers call these functions at every m: with no mesh, or a model
axis of one, each is the plain single-device form.  The collectives go
through ``torch.distributed`` on the mesh's ``model`` group, whatever
its backend (NCCL; or gloo, which takes CUDA tensors for ``all_reduce``
and ``all_gather``): no host copy and no branch on the backend.
Forward only: the serving paths run under ``no_grad``.

:data:`COUNTS` counts the collectives issued here and the bytes of their
inputs, for the serving loop's report (``launch/serve.dense_generate``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import axes as AX

ROADMAP_ITEM = "ROADMAP Queue 1 item 2"
COUNTS = {"all_reduce": 0, "all_gather": 0, "bytes": 0}


def model_size() -> int:
    """Size of the active mesh's ``model`` axis (1 with no mesh)."""
    mesh = AX.current_mesh()
    if mesh is None:
        return 1
    return int(AX.mesh_axes(mesh).get("model", 1))


def model_rank() -> int:
    """This rank's coordinate on the ``model`` axis (0 with no mesh)."""
    if model_size() == 1:
        return 0
    return int(AX.current_mesh().get_local_rank("model"))


def model_group():
    """The process group of this rank's ``model`` axis."""
    return AX.current_mesh().get_group("model")


def _count(op: str, t: torch.Tensor) -> None:
    COUNTS[op] += 1
    COUNTS["bytes"] += t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=model_group())
    _count("all_reduce", t)
    return t


def reduce_from_model(partial: torch.Tensor) -> torch.Tensor:
    """Sum an f32 partial over the ``model`` axis, in place; the caller
    rounds the sum."""
    if partial.dtype != torch.float32:
        raise TypeError(f"reduce_from_model sums f32 partials, not "
                        f"{partial.dtype}")
    if model_size() == 1:
        return partial
    return _all_reduce(partial)


def _partial_f32(x2d: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """x2d @ w2d accumulated and kept in f32.  On the card
    ``torch.mm(out_dtype=float32)`` reads the bf16 operands as they are;
    on the CPU, which lacks that overload, they are widened (bf16
    products are exact in f32)."""
    if x2d.is_cuda:
        return torch.mm(x2d, w2d, out_dtype=torch.float32)
    return torch.mm(x2d.to(torch.float32), w2d.to(torch.float32))


def row_parallel(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w2d [K, N] -> [..., N] in x's dtype, where K is split
    over the ``model`` axis (this rank's heads or d_ff columns): the f32
    partial summed over the ranks, then rounded once.  With a model axis
    of one, the plain product that rounds once (``layers.linear``)."""
    if model_size() == 1:
        return torch.matmul(x, w2d)
    part = _partial_f32(x.reshape(-1, x.shape[-1]), w2d)
    return reduce_from_model(part).to(x.dtype).reshape(*x.shape[:-1], -1)


def vocab_embed(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table for ``tokens``, where this rank holds
    rows [r V/m, (r + 1) V/m) of it (``w``): the tokens outside read 0,
    and the f32 sum over the ranks is exact."""
    m = model_size()
    if m == 1:
        return F.embedding(tokens, w)
    lo = model_rank() * w.shape[0]
    mine = (tokens >= lo) & (tokens < lo + w.shape[0])
    rows = F.embedding(torch.where(mine, tokens - lo, 0), w)
    part = torch.where(mine[..., None], rows.to(torch.float32), 0.0)
    return reduce_from_model(part).to(w.dtype)


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """This rank's vocab columns ``[..., V/m]`` -> the whole ``[..., V]``
    on every rank, the ranks' blocks in model-axis order."""
    m = model_size()
    if m == 1:
        return logits
    logits = logits.contiguous()
    parts = [torch.empty_like(logits) for _ in range(m)]
    dist.all_gather(parts, logits, group=model_group())
    _count("all_gather", logits)
    return torch.cat(parts, dim=-1)


def check_layout(cfg) -> None:
    """Raise unless this slice lays ``cfg`` out over the active mesh:
    the dense GQA decoders (yi, qwen2.5, gemma3, internvl2's language
    model) with heads, KV heads, d_ff and the vocab each dividing the
    model axis, on a mesh whose data axes are 1.  Where the rule table
    would drop ``model`` from a leaf (a dim that does not divide), JAX
    replicates it (K/V, and a cache sharded over T): not laid out here."""
    m = model_size()
    if m == 1:
        return
    sizes = AX.mesh_axes(AX.current_mesh())
    dp = {a: sizes[a] for a in ("pod", "data") if sizes.get(a, 1) > 1}
    if dp:
        raise NotImplementedError(
            f"{cfg.name}: a model axis of {m} beside data axes {dp}: DP x TP "
            f"serving is not ported ({ROADMAP_ITEM})")
    if (cfg.attn_kind != "gqa" or cfg.is_moe or cfg.is_encdec
            or cfg.family in ("ssm", "hybrid")):
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism is ported for the dense GQA "
            f"decoders only, not for MLA, MoE, the recurrent or the "
            f"encoder-decoder families ({ROADMAP_ITEM})")
    dims = {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab}
    odd = {k: v for k, v in dims.items() if v % m}
    if odd:
        raise NotImplementedError(
            f"{cfg.name}: {odd} do not divide the model axis of {m}; the "
            f"rule table would replicate those leaves (and shard the cache "
            f"over T), which is not laid out ({ROADMAP_ITEM})")


def refuse_training(what: str) -> None:
    """Raise under a model axis larger than one: training under TP (the
    vocab-parallel loss, gradients of sharded leaves) is the next slice."""
    if model_size() > 1:
        raise NotImplementedError(
            f"{what} under a model axis of {model_size()}: training under "
            f"tensor parallelism is not ported ({ROADMAP_ITEM})")
