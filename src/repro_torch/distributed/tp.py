"""Tensor parallelism over the mesh's ``model`` axis: the one module that
issues that axis's collectives, forward and backward.

The JAX package has no counterpart.  There the models call ``shard(x,
DP, None, MODEL)`` at every layer boundary, the launcher places the
params under the rule table (``distributed/sharding.py``) and GSPMD
turns both into a tensor-parallel program, inserting the collectives
itself.  The compiled HLO of a dense GQA model under a ``(1, m)`` mesh
holds these, each of which has its function here.

Forward (serving and training):

  * an f32 ``all-reduce`` of [B, S, D] after attention's output
    projection and after the MLP's down projection (row-parallel: each
    rank's partial dot over its heads or its d_ff columns is kept in f32,
    summed over the ranks and rounded to bf16 afterwards):
    :func:`row_parallel`, over :func:`reduce_from_model`;
  * the embedding: a lookup masked to this rank's rows of the vocab,
    ``all-reduce``-d in f32: :func:`vocab_embed`;
  * column-parallel products (q/k/v, the MLP's gate and up, the LM
    head): no collective, each rank computes its own heads or columns
    from the replicated residual stream: :func:`column_parallel`;
  * logits that come out sharded over the vocab (``PartitionSpec(None,
    'model')``), which a caller of ``prefill``/``decode_step`` reads as
    one global array: :func:`gather_vocab` gives every rank the whole
    ``[..., V]`` by an ``all_gather`` of the ranks' columns.

Training (``jax.value_and_grad`` of the loss under the same mesh):

  * the loss is a vocab-parallel cross-entropy on each rank's columns of
    the logits: a **max** ``all-reduce`` of the row max [B, S], then sum
    ``all-reduce``s of the sum of exp [B, S] and of the gold logit [B, S,
    1], which only the rank holding the target gives: :func:`vocab_cross_
    entropy`.  Its backward is local (softmax minus one-hot);
  * the backward of a row-parallel sum hands the incoming gradient to
    every rank unchanged (the weight gradient and the input-gradient
    partial over the rank's heads or columns are local);
  * the backward of a column-parallel product: the input-gradient
    partial ``g @ w.T`` in f32, summed over the ranks, then rounded once;
    the weight gradient is local.  Where one input feeds several products
    (q, k, v; gate, up) the HLO sums each partial on its own (a tuple
    ``all-reduce``), rounds each and adds them afterwards: autograd's
    accumulation of the separately rounded sums does the same.  Each
    layer's backward therefore issues 1 (gate and up: 2, q/k/v: 3) such
    sums, plus the forward's attention sum once more, which the layer's
    recompute (``jax.checkpoint`` there, ``torch.utils.checkpoint``
    here) issues again, in the same order on every rank;
  * the embedding's backward scatters into this rank's rows only;
  * the clip norm: one f32[] ``all-reduce`` per leaf sharded over
    ``model`` (that leaf's local sum of squares); the replicated leaves
    (the norms) add theirs once.  ``optim/adamw._global_norm`` sums them
    in one ``all-reduce`` of the stacked scalars (:func:`sharded_leaves`
    says which leaves, from the rule table by path).

The layers call these functions at every m: with no mesh, or a model
axis of one, each is the plain single-device form.  The collectives go
through ``torch.distributed`` on the mesh's ``model`` group, whatever
its backend (NCCL; or gloo, which takes CUDA tensors for ``all_reduce``
and ``all_gather``): no host copy and no branch on the backend.  A
collective that fails raises.

:data:`COUNTS` counts the collectives issued here and the bytes of their
inputs (``backward``: those of them issued by a backward pass), for the
serving loop's and the train step's reports (``launch/serve.
dense_generate``, ``launch/train.make_train_step``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.checkpoint.store import leaf_paths

from . import axes as AX
from .sharding import rule_template

ROADMAP_ITEM = "ROADMAP Queue 1 item 2"
COUNTS = {"all_reduce": 0, "all_gather": 0, "bytes": 0, "backward": 0}
_TILE = 128                            # optim/adamw.py's moment tile


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


def _count(op: str, t: torch.Tensor, backward: bool = False) -> None:
    COUNTS[op] += 1
    COUNTS["bytes"] += t.numel() * t.element_size()
    COUNTS["backward"] += backward


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None,
                backward: bool = False) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group or model_group())
    _count("all_reduce", t, backward)
    return t


def under_mesh(fn):
    """``fn`` run under the mesh active now, wherever it is called: the
    active mesh is per thread (``axes.use_mesh``), and on the card
    autograd runs the backward, and with it a checkpoint's recompute, on
    a thread of its own.  The backward functions here take the group from
    the forward's context instead."""
    mesh = AX.current_mesh()

    def run(*args, **kw):
        with AX.use_mesh(mesh):
            return fn(*args, **kw)
    return run


class _Sum(torch.autograd.Function):
    """All-reduce (SUM) forward, in place; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, partial):
        ctx.mark_dirty(partial)
        return _all_reduce(partial)

    @staticmethod
    def backward(ctx, g):
        return g


def reduce_from_model(partial: torch.Tensor) -> torch.Tensor:
    """Sum an f32 partial over the ``model`` axis, in place; the caller
    rounds the sum.  Its gradient is the incoming one, on every rank."""
    if partial.dtype != torch.float32:
        raise TypeError(f"reduce_from_model sums f32 partials, not "
                        f"{partial.dtype}")
    if model_size() == 1:
        return partial
    return _Sum.apply(partial)


def _partial_f32(x2d: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """x2d @ w2d accumulated and kept in f32.  On the card
    ``torch.mm(out_dtype=float32)`` reads the bf16 operands as they are;
    on the CPU, which lacks that overload, they are widened (bf16
    products are exact in f32)."""
    if x2d.is_cuda:
        return torch.mm(x2d, w2d, out_dtype=torch.float32)
    return torch.mm(x2d.to(torch.float32), w2d.to(torch.float32))


class _PartialF32(torch.autograd.Function):
    """:func:`_partial_f32` of bf16 operands, whose gradients round once
    to the operands' dtype, as ``layers.linear``'s do."""

    @staticmethod
    def forward(ctx, x2d, w2d):
        ctx.save_for_backward(x2d, w2d)
        return _partial_f32(x2d, w2d)

    @staticmethod
    def backward(ctx, g):
        x2d, w2d = ctx.saved_tensors
        g = g.to(x2d.dtype)           # bf16 values: the sum's rounding
        dx = torch.mm(g, w2d.t()) if ctx.needs_input_grad[0] else None
        dw = torch.mm(x2d.t(), g) if ctx.needs_input_grad[1] else None
        return dx, dw


def row_parallel(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w2d [K, N] -> [..., N] in x's dtype, where K is split
    over the ``model`` axis (this rank's heads or d_ff columns): the f32
    partial summed over the ranks, then rounded once.  With a model axis
    of one, the plain product that rounds once (``layers.linear``)."""
    if model_size() == 1:
        return torch.matmul(x, w2d)
    # the partial and the sum are two nodes: a layer's recompute stops
    # after the last node that saves tensors, so it issues the MLP's sum
    # no more (as XLA's remat does not), the attention's again
    part = _PartialF32.apply(x.reshape(-1, x.shape[-1]), w2d)
    return reduce_from_model(part).to(x.dtype).reshape(*x.shape[:-1], -1)


class _ColumnParallel(torch.autograd.Function):
    """x2d [N, K] @ w2d [K, M/m], no collective.  Backward: the input
    gradient's f32 partial summed over the ranks and rounded once; the
    weight gradient local."""

    @staticmethod
    def forward(ctx, x2d, w2d):
        ctx.save_for_backward(x2d, w2d)
        ctx.group = model_group()
        return torch.mm(x2d, w2d)

    @staticmethod
    def backward(ctx, g):
        x2d, w2d = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _all_reduce(_partial_f32(g, w2d.t()), group=ctx.group,
                             backward=True).to(x2d.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x2d.t(), g)
        return dx, dw


def column_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, *out] -> [..., *out] in x's dtype, f32
    accumulated and rounded once (``layers.linear``'s product), where
    ``out`` is this rank's heads or columns.  The forward issues nothing;
    under a model axis the backward sums the input gradient's partial."""
    w2d = w.reshape(w.shape[0], -1)
    if model_size() == 1:
        y = torch.matmul(x, w2d)
    else:
        y = _ColumnParallel.apply(x.reshape(-1, x.shape[-1]), w2d)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def vocab_embed(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table for ``tokens``, where this rank holds
    rows [r V/m, (r + 1) V/m) of it (``w``): the tokens outside read 0,
    and the f32 sum over the ranks is exact.  The backward scatters into
    this rank's rows only."""
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
    on every rank, the ranks' blocks in model-axis order.  Forward only:
    the loss reads the columns where they are (:func:`vocab_cross_
    entropy`)."""
    m = model_size()
    if m == 1:
        return logits
    logits = logits.contiguous()
    parts = [torch.empty_like(logits) for _ in range(m)]
    dist.all_gather(parts, logits, group=model_group())
    _count("all_gather", logits)
    return torch.cat(parts, dim=-1)


class _VocabCE(torch.autograd.Function):
    """Per-token ``logsumexp - gold`` over logits whose vocab is split
    over the ranks (see :func:`vocab_cross_entropy`)."""

    @staticmethod
    def forward(ctx, logits, targets):
        v = logits.shape[-1]
        lo = model_rank() * v
        # jax.nn.logsumexp's max is a constant of the gradient
        mx = _all_reduce(logits.amax(dim=-1), op=dist.ReduceOp.MAX)
        e = torch.exp(logits - mx[..., None])
        mine = (targets >= lo) & (targets < lo + v)
        idx = torch.where(mine, targets - lo, 0).long()
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        sums = torch.stack([e.sum(dim=-1), torch.where(mine, gold, 0.0)])
        se, gold = _all_reduce(sums)
        ctx.save_for_backward(e, se, mine, idx)
        return (torch.log(se) + mx) - gold

    @staticmethod
    def backward(ctx, g):
        e, se, mine, idx = ctx.saved_tensors
        dl = e * (g / se)[..., None]
        dl.scatter_add_(-1, idx[..., None],
                        torch.where(mine, -g, 0.0)[..., None])
        return dl, None


def vocab_cross_entropy(logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy ``[...]`` (f32) of this rank's vocab
    columns ``logits`` f32 ``[..., V/m]`` (``V/m`` columns from ``r V/m``)
    and the global ``targets``: a MAX all-reduce of the row max, then one
    SUM all-reduce of the stacked sum of exp and gold logit (the gold
    read on the rank that holds the target, 0 elsewhere); the result is
    ``max + log(sum exp) - gold`` on every rank.  The backward is local:
    the softmax of the local columns minus the one-hot on the target's
    rank, times the incoming gradient."""
    if logits.dtype != torch.float32:
        raise TypeError(f"vocab_cross_entropy takes f32 logits, not "
                        f"{logits.dtype}")
    if model_size() == 1:
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - gold
    return _VocabCE.apply(logits, targets)


def sharded_leaves(tree) -> list[bool]:
    """For each leaf of a params tree (``jax.tree.leaves`` order), whether
    the rule table shards it over ``model`` (read from its path, not from
    its local shape); all False with a model axis of one."""
    m = model_size()
    return [m > 1 and "m" in rule_template(path)
            for path, _ in leaf_paths(tree)]


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
            f"(and FSDP) is not ported ({ROADMAP_ITEM})")
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


def check_moments(params, moment_dtype: str) -> None:
    """Raise where a ``bdi8``/``q8`` moment tile would straddle two shards:
    a leaf whose last dim is sharded over ``model`` and whole tiles of 128
    (so JAX stores it tiled) but whose tile count does not divide the
    model axis.  The rule table then drops ``model`` from the moment's
    tile dim and JAX gathers: it all-reduces the tile statistics (max,
    min, the base predicate) and all-gathers the deltas and masks of
    every such leaf, around each compress.  Not laid out here.  ``params``
    is this rank's tree; f32 and bf16 moments have no tiles."""
    m = model_size()
    if m == 1 or moment_dtype not in ("bdi8", "q8"):
        return
    for path, leaf in leaf_paths(params):
        tpl = rule_template(path)
        if not tpl or tpl[-1] != "m" or leaf.dim() < len(tpl):
            continue
        whole = leaf.shape[-1] * m
        if whole % _TILE == 0 and leaf.shape[-1] % _TILE:
            raise NotImplementedError(
                f"{path}: {whole // _TILE} {moment_dtype} moment tiles of "
                f"{_TILE} do not divide the model axis of {m}; a tile would "
                f"straddle two shards, which is not laid out "
                f"({ROADMAP_ITEM})")


def refuse_model_axis(what: str) -> None:
    """Raise under a model axis larger than one: ``what`` (``launch/
    train.train``, its checkpoints and driver loop) runs no mesh, as
    JAX's ``train()`` runs none."""
    if model_size() > 1:
        raise NotImplementedError(
            f"{what} under a model axis of {model_size()}: the training "
            f"driver and its checkpoints run no mesh; the train step does "
            f"(launch/train.make_train_step) ({ROADMAP_ITEM})")
