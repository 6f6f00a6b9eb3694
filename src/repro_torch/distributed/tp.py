"""Tensor and data parallelism over the mesh's ``model`` and ``data``
axes: the one module that issues those axes' collectives, forward and
backward.

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
    (the norms, and any leaf the rule table keeps whole) add theirs once.
    ``optim/adamw._global_norm`` sums them in one ``all-reduce`` of the
    stacked scalars (:func:`sharded_leaves` says which leaves, from the
    rule table's spec after it drops the axis from a dim that does not
    divide it).

Heads that do not divide the model axis (JAX's production mesh: yi's 4
KV heads, qwen2.5's 40 heads at m = 16).  The rule table then drops
``model`` from wk and wv (and from wq, wo and the QKV biases where the
heads do not divide) and ``cache_specs`` shards the decode cache over T
instead of its KV heads.  A model's entry points mark those leaves
:class:`Whole` (:func:`model_whole`), and the HLO of GSPMD's program
holds, per layer:

  * split Q, whole K/V: every rank computes all KV heads from the
    replicated residual stream and its query heads read theirs
    (``models/attention.heads_kv``); the input gradient's partial of
    k and v is summed like q's, and wk's and wv's weight gradients are
    f32 partials summed over ``model`` and rounded once (an f32 tuple
    all-reduce): :class:`_ModelSum`, reached through :func:`weight`;
  * whole Q (and wo): attention runs whole on every rank, with no sum
    forward or backward;
  * decode over a cache sharded over T: the query heads gathered over
    ``model`` (:func:`all_gather`), every head scored against this
    rank's rows, a MAX all-reduce of the row maxima and a SUM all-reduce
    of the weighted values and sums of exp (:func:`softmax_over_rows`),
    then this rank's heads for wo; the new token's K/V written on the
    one rank that holds row t (:func:`write_row`).

Data axis (a ``(d, m)`` mesh with d > 1, laid out as JAX's dry run lays
out every production cell: params by ``param_shardings(fsdp=True)``,
batches by ``batch_specs``).  The HLO of a dense GQA train step under a
``(2, 2)`` mesh holds, beside the model axis's collectives above:

  * each rank computes on its rows of the batch (dim 0 split over
    ``data``); a batch whose rows do not divide d stays whole on every
    rank, as ``batch_specs`` replicates it (:func:`whole_rows`);
  * an all-gather over ``data`` of each FSDP weight block (a leaf above
    ``sharding.FSDP_THRESHOLD_BYTES`` a model shard) just before its
    product, forward and again in the layer's recompute, which JAX widens
    to f32 first (the same values): :func:`fsdp_gather`, reached through
    :func:`weight` at the weight's one use;
  * every weight gradient's f32 partial over the rank's rows summed over
    ``data`` (f32 all-reduces, no reduce-scatter), rounded once to the
    weight's dtype afterwards and, for an FSDP leaf, cut to the rank's
    block: the backward of :func:`fsdp_gather`, and of :func:`weight` for
    a leaf replicated over ``data`` (its partial summed, not cut);
  * the loss's sum and token count summed over ``data`` before the
    division (the global mean): :func:`reduce_from_data`;
  * the clip norm's sums of squares over each axis that splits a leaf;
  * the logits: a caller of ``prefill``/``decode_step``/``forward`` gets
    the whole batch's (JAX's ``out_shardings=None``), :func:`gather_vocab`
    gathering the rows over ``data`` after the columns over ``model``.

Where the data axes divide a stacked leaf's depth and none of its wider
dims, the rule table splits its layers over ``data`` (qwen2.5-14b's 48
layers on a data axis of 6, yi-9b's on 3): each rank holds L/d whole
layers, layer l on data rank ``l // (L/d)``.  GSPMD's HLO all-gathers the
whole stack (in f32) before the layer loop and again for the backward,
and all-reduces each layer's f32 gradient.  The port moves one layer at
a time instead: :func:`layer_gather` broadcasts layer l from its owner
to the data group just before its product (again in the layer's
recompute), and its f32 gradient is all-reduced over ``data`` and
rounded once into the owner's row (:class:`_LayerLeaf`); a model's
entry points see such a leaf's layer as a :class:`Layer`
(:func:`placed`).

The weight products therefore take f32 weights (a gathered or widened
leaf) as well as bf16 ones: the product runs on the bf16 values as
before, and the weight gradient leaves it in f32, for the data axis's
sum to round once.  A rank's params carry no layout of their own; a
model's entry points find it by comparing each leaf's shape with the
rule table's blocks of the whole model (:func:`placement`) and wrap the
leaves split over ``data`` as :class:`Fsdp` and those kept whole over
``model`` as :class:`Whole` (:func:`layout_view`).

Expert parallelism and MLA under the model axis (deepseek-v2-lite-16b,
arctic-480b).  JAX's ``moe_ffn`` runs a ``shard_map`` over ``model`` and
the data axes, whose HLO (a train step of the reduced configs on ``(1,
4)`` and ``(2, 2)``) holds, per layer:

  * each rank routes its rows (``in_specs=P(dp, None)``: the rows the
    rank holds already, :func:`rows_split`) through its E/m experts and
    the f32 outputs [T, D] are summed over ``model`` (a psum, identity
    backward): :func:`reduce_from_model`;
  * the transpose sums the FFN input's gradient over ``model``: each
    rank's bf16 cotangent (from its own experts' dispatch and from the
    router) widened to f32, summed, rounded once to bf16 (a bf16 psum
    that XLA promotes to f32): :func:`copy_to_model`;
  * the router's f32 weight gradient, each rank's partial from its own
    experts' gates, summed over ``model`` and the data axes in f32 (one
    all-reduce over both; here one over each, :class:`Whole` with
    ``partial``, then over ``data`` as any replicated leaf's);
  * the experts' weight gradients: each rank's rounded to bf16 (the
    products' transposes), then summed over ``data`` in f32 and rounded
    once (``weight`` of the stack, :class:`_DataLeaf`).

MLA splits its heads (wq, wuk, wuv column-parallel, wo row-parallel) and
replicates wdkv, wkr and kv_norm (:func:`replicated`).  Backward, per
layer: the input gradient's partials of wq and, for the latent, of wuk
and wuv (f32, summed, each rounded on its own), and the rope key's
gradient, which every query head shares: an f32 sum over this rank's
heads, summed over ``model``, rounded once (:func:`heads_broadcast`).
The latent's and the rope key's gradients are then whole on every rank,
and so are those of wdkv, wkr and kv_norm.  The decode cache holds this
rank's block of the latent's last dim (``cache_specs`` splits it), which
a decode step gathers over ``model`` in f32 at its use; GSPMD gathers the
same, and besides gathers the softmax weights ``[B, H, T]`` over the
heads, so that each rank contracts them with its own block of the
latent, then an all-to-all returns that ``[B, H, r]`` context to the
heads: the port contracts the gathered latent on its own heads instead
and needs neither.

The recurrent and encoder-decoder families under the model axis
(``models/ssm.py``, ``hybrid.py``, ``xlstm.py``, ``encdec.py``): a
block split over ``model`` whose whole each rank reads a share of is
gathered forward and its gradient summed and cut backward
(:func:`gather_model`: Mamba's ``in_proj`` block, whose columns hold u
on the first m/2 ranks and z on the rest, and mLSTM's u, q and k); one
that every rank reads all of, computing alike (sLSTM's gate-major
``wx`` columns), has its gradient cut without a sum.  mLSTM's ``w_if``,
whole and read by each rank's heads, sums its gradient over ``model``
(:func:`summed_weight`).  A vocab that does not divide the axis keeps
the embedding and the head whole (:class:`Whole`): the plain lookup,
logits and cross-entropy on every rank.  A ring cache whose KV heads do
not divide the axis is sharded over its window as over T.  Every
family's entry points find the layout by shape (:func:`placed`) and make
their caches as ``cache_specs`` cuts them (:func:`new_cache`).

The pod axis of the multi-pod mesh (``(2, 16, 16)`` over ``("pod",
"data", "model")``) is one more data axis, as JAX's ``DP = ("pod",
"data")``: :func:`data_size` is their product, :func:`data_rank` the
rank's coordinate over them major to minor and :func:`data_group` the
mesh's two dims flattened into one group; batches, FSDP blocks and
ZeRO-1 blocks lie over both.

The sequence-parallel residual stream (JAX's ``axes.set_sp``, off by
default; ``axes.seq_split``): each layer body constrains its input to
``(DP, "model", None)`` where m divides S, so that a layer's input and
output, and the checkpoint each layer keeps for its recompute, are the
rank's block of S/m positions.  The HLO of GSPMD's train step (reduced
yi-6b on ``(1, 4)``) holds, per layer: the norms on the block, their
weights' f32 gradients summed as partials over ``model``; the normed block
all-gathered before the projections (GSPMD gathers the f32 widening of
the same bf16 values); each row-parallel output's f32 partial summed and
cut to the block, and each column-parallel product's input-gradient
partial summed and cut likewise, every one rounded once (on the CPU an
all-reduce and a dynamic slice: XLA's CPU pipeline forms no
reduce-scatter); the final norm on the block, gathered before the head,
whose cross-entropy chunks XLA then recomputes in the backward.  The
layer bodies enter :func:`seq_parallel`; :func:`gather_seq` gathers,
:func:`row_parallel` reduce-scatters (:func:`sum_seq`, counted as
``reduce_scatter``) or, for a product every rank computes whole (wo
whose heads do not divide the axis, sLSTM's output), cuts the block
(:func:`scatter_seq`, whose gradient is gathered: every rank then runs
the whole backward alike and nothing is summed), and a column-parallel
product that read the gathered sequence reduce-scatters its input
gradient's partial (``_seq_dx``).  MoE routes the gathered tokens, as
its ``shard_map`` takes ``P(dp, None)``: the capacity and the drops are
those of the run without it.  Prefill, decode and the encoder-decoder
never split the stream, as JAX's never call ``shard_seq``.

The layers call these functions at every mesh: with no mesh, or axes
of one, each is the plain single-device form.  The collectives go
through ``torch.distributed`` on the mesh's ``model`` or data group,
whatever its backend (NCCL; or gloo, which takes CUDA tensors for
``all_reduce`` and ``all_gather``): no host copy and no branch on the
backend.  A collective that fails raises.  Under an abstract mesh
(``launch/elastic.AbstractMesh``, the dry run's: a coordinate and no
process group) a collective takes ``meta`` tensors only: it is counted
with the same bytes and gives its result's shape (an all-reduce its
input, an all-gather d or m blocks of it), and nothing is sent; a CPU
or CUDA tensor there raises, as does a ``meta`` tensor on a process
group.

:data:`COUNTS` counts the collectives issued here, by axis (``data``
holds the pod axis's too), and the bytes of their inputs (a
reduce-scatter's whole input, as XLA counts its operand), in all and by
kind (``<op>_bytes``, ``broadcast`` among the kinds: a layer moved from
its owner; ``backward``: those of them issued by a backward pass;
``writes``: decode-cache rows written into this rank's T block),
for the serving loop's and the train step's reports (``launch/
serve.dense_generate``, ``launch/train.make_train_step``);
``optim/adamw.py`` adds the ZeRO-1 gathers of updated blocks, the
gathers of the gradients of leaves whose moment tiles straddle the
model shards (:func:`check_moments`) and the all-to-alls of leaves whose
tiles straddle the data blocks (:func:`all_to_all`).
"""

from __future__ import annotations

import contextlib
import functools
import re
import threading
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.checkpoint.store import leaf_paths
from repro_torch.launch.elastic import AbstractGroup

from . import axes as AX
from . import sharding as SH
from .sharding import rule_template

ROADMAP_ITEM = "ROADMAP Queue 1 item 2"
AXES = ("model", "data")
OPS = ("all_reduce", "all_gather", "all_to_all", "reduce_scatter",
       "broadcast")
COUNTS = {a: {**{op: 0 for op in OPS}, "bytes": 0, "backward": 0,
              "writes": 0, **{f"{op}_bytes": 0 for op in OPS}}
          for a in AXES}
_TILE = 128                            # optim/adamw.py's moment tile
_rows = threading.local()


def axis_size(axis: str) -> int:
    """Size of the active mesh's ``axis`` (1 with no mesh or no such
    axis)."""
    mesh = AX.current_mesh()
    if mesh is None:
        return 1
    return int(AX.mesh_axes(mesh).get(axis, 1))


def model_size() -> int:
    """Size of the active mesh's ``model`` axis (1 with no mesh)."""
    return axis_size("model")


def data_size() -> int:
    """Size of the active mesh's data axes, ``("pod", "data")`` where a
    pod axis exists (1 with no mesh): the product, as JAX's ``DP`` shards
    batches, FSDP blocks and caches over both."""
    return axis_size("pod") * axis_size("data")


def model_rank() -> int:
    """This rank's coordinate on the ``model`` axis (0 with no mesh)."""
    if model_size() == 1:
        return 0
    return int(AX.current_mesh().get_local_rank("model"))


def data_rank() -> int:
    """This rank's coordinate on the data axes, read major to minor over
    ``("pod", "data")`` (``sharding._cuts`` reads a block's index so; 0
    with no mesh)."""
    r = 0
    for a in ("pod", "data"):
        if axis_size(a) > 1:
            r = r * axis_size(a) + int(AX.current_mesh().get_local_rank(a))
    return r


def model_group():
    """The process group of this rank's ``model`` axis."""
    return AX.current_mesh().get_group("model")


def data_group():
    """The process group of this rank's data axes: the ``data`` axis's,
    or with a pod axis the mesh's ``("pod", "data")`` dims flattened into
    one (ranks numbered as :func:`data_rank` numbers them)."""
    mesh = AX.current_mesh()
    if axis_size("pod") == 1:
        return mesh.get_group("data")
    if isinstance(mesh, DeviceMesh):      # made once, then found by name
        return mesh["pod", "data"]._flatten("pod_data").get_group()
    return mesh.get_group(("pod", "data"))


def _group(axis: str):
    return model_group() if axis == "model" else data_group()


def _group_size(group) -> int:
    return group.size if isinstance(group, AbstractGroup) else \
        dist.get_world_size(group)


def _sent(t: torch.Tensor, group) -> bool:
    """Whether a collective on ``group`` sends ``t``: on a process group,
    a tensor of a device that holds data; on an abstract mesh's group (a
    rank traced on ``meta``, ``launch/dryrun.py``), a ``meta`` tensor,
    which nothing sends.  Any other pairing raises: the device and the
    mesh choose the path."""
    abstract = isinstance(group, AbstractGroup)
    if abstract != (t.device.type == "meta"):
        raise ValueError(
            f"a collective of a {t.device.type} tensor on "
            + ("an abstract mesh, which runs on meta tensors only"
               if abstract else "a process group, which sends no meta "
               "tensor"))
    return not abstract


def counts() -> dict:
    """A copy of :data:`COUNTS`."""
    return {a: dict(c) for a, c in COUNTS.items()}


def counts_since(before: dict) -> dict:
    """What :data:`COUNTS` gained since ``before`` (:func:`counts`)."""
    return {a: {k: COUNTS[a][k] - before[a][k] for k in c}
            for a, c in before.items()}


def _count(axis: str, op: str, t: torch.Tensor,
           backward: bool = False) -> None:
    c = COUNTS[axis]
    n = t.numel() * t.element_size()
    c[op] += 1
    c["bytes"] += n
    c[f"{op}_bytes"] += n
    c["backward"] += backward


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None,
                backward: bool = False, axis: str = "model") -> torch.Tensor:
    group = group or _group(axis)
    if _sent(t, group):
        dist.all_reduce(t, op=op, group=group)
    _count(axis, "all_reduce", t, backward)
    return t


def all_reduce(t: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum ``t`` over ``axis``, in place (no gradient)."""
    return _all_reduce(t, axis=axis)


def all_gather(t: torch.Tensor, dim: int, axis: str, group=None,
               backward: bool = False) -> torch.Tensor:
    """The blocks of ``t`` over ``axis`` (this rank's among them),
    concatenated along ``dim`` in the axis's order."""
    group = group or _group(axis)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_group_size(group))]
    if _sent(t, group):
        dist.all_gather(parts, t, group=group)
    _count(axis, "all_gather", t, backward)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, axis: str = "model",
                   group=None, backward: bool = False) -> torch.Tensor:
    """The sum of ``t`` over ``axis``, this rank's block of it along
    ``dim`` (one ``reduce_scatter_tensor`` of the blocks stacked in the
    axis's order), counted with the bytes of the whole input, as XLA
    counts a reduce-scatter's operand."""
    group = group or _group(axis)
    n = _group_size(group)
    inp = torch.stack(t.chunk(n, dim))
    out = torch.empty_like(inp[0])
    if _sent(inp, group):
        dist.reduce_scatter_tensor(out.view(-1), inp.view(-1), group=group)
    _count(axis, "reduce_scatter", inp, backward)
    return out


def all_to_all(t: torch.Tensor, split: int, cat: int,
               axis: str = "data") -> torch.Tensor:
    """This rank's block of ``t`` along ``cat`` over ``axis`` -> the
    whole along ``cat`` and this rank's block along ``split``: rank j
    gets block j of ``split`` from every rank, concatenated along ``cat``
    in the axis's order (one ``all_to_all_single``)."""
    group = _group(axis)
    n = _group_size(group)
    inp = torch.stack(t.chunk(n, split))
    out = torch.empty_like(inp)
    if _sent(inp, group):
        dist.all_to_all_single(out, inp, group=group)
    _count(axis, "all_to_all", inp)
    return torch.cat(out.unbind(0), dim=cat)


class _Gather(torch.autograd.Function):
    """All-gather over ``model`` along ``dim``.  Backward: this rank's
    block of the gradient, the gradient first summed over ``model`` in
    f32 and rounded once where ``summed``."""

    @staticmethod
    def forward(ctx, x, dim, summed):
        ctx.dim, ctx.summed = dim, summed
        ctx.group, ctx.rank = model_group(), model_rank()
        return all_gather(x, dim, "model")

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            s = torch.empty(g.shape, dtype=torch.float32, device=g.device)
            s.copy_(g)
            g = _all_reduce(s, group=ctx.group, backward=True).to(g.dtype)
        n = g.shape[ctx.dim] // _group_size(ctx.group)
        return g.narrow(ctx.dim, ctx.rank * n, n), None, None


class _Scatter(torch.autograd.Function):
    """This rank's block along ``dim`` (a copy); backward: the gradient's
    blocks gathered over ``model``."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.group, ctx.dim = model_group(), dim
        n = x.shape[dim] // model_size()
        return x.narrow(dim, model_rank() * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, "model", ctx.group, backward=True), \
            None


def scatter_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, whole and the same on
    every rank (a mixer every rank runs whole, read by a row-parallel
    product): its gradient, a block on each rank, is gathered over
    ``model``, so that the whole one is the same on every rank."""
    if model_size() == 1:
        return x
    return _Scatter.apply(x, dim % x.dim())


def gather_model(x: torch.Tensor, dim: int = -1,
                 summed: bool = True) -> torch.Tensor:
    """The whole over ``model`` of this rank's block ``x`` along ``dim``
    (the blocks in axis order; ``x`` itself with a model axis of one).
    Its gradient is this rank's block of the whole one's: ``summed`` where
    each rank reads only its share of the whole (each rank's gradient a
    partial: Mamba's u and z, mLSTM's u, q and k), not where every rank
    computes all of it alike (the sLSTM recurrence)."""
    if model_size() == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), summed)


def rows_split() -> bool:
    """Whether this rank computes on its rows of the batch, the layout
    under a data axis unless :func:`whole_rows` says otherwise."""
    return data_size() > 1 and getattr(_rows, "split", True)


@contextlib.contextmanager
def whole_rows(whole: bool = True):
    """Within, every rank of a data axis holds the whole batch (rows that
    do not divide it, which ``batch_specs`` replicates): the loss and the
    gradients are not summed over ``data``, nor the logits gathered."""
    prev = getattr(_rows, "split", True)
    _rows.split = not whole
    try:
        yield
    finally:
        _rows.split = prev


def under_mesh(fn):
    """``fn`` run under the mesh (and the rows' layout) active now,
    wherever it is called: both are per thread (``axes.use_mesh``), and
    on the card autograd runs the backward, and with it a checkpoint's
    recompute, on a thread of its own.  The backward functions here take
    the groups from the forward's context instead.  The sequence-parallel
    switch (``axes.set_sp``) is process-wide, so the recompute sees it,
    and a layer body enters :func:`seq_parallel` itself."""
    mesh = AX.current_mesh()
    whole = not getattr(_rows, "split", True)

    def run(*args, **kw):
        with AX.use_mesh(mesh), whole_rows(whole):
            return fn(*args, **kw)
    return run


# ---------------------------------------------------------------------------
# sequence parallelism: the residual stream's S blocks over ``model``
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def seq_parallel(x: torch.Tensor, s: int):
    """The residual stream ``x`` of a sequence of ``s`` positions as a
    layer holds it, ``axes.shard_seq``'s layout: where ``axes.seq_split(s)``
    says so, this rank's block of S/m positions (a whole ``x`` cut by
    :func:`scatter_seq`, a block as it is), else ``x`` as it is.  Within,
    :func:`gather_seq` gathers the whole before the layer's mixers, whose
    row-parallel outputs are reduce-scattered back to the block
    (:func:`row_parallel`), and a norm on the block sums its weight's
    gradient over ``model`` (``layers.rmsnorm``: :func:`on_block`).  A
    layer body enters it itself, so that its recompute, on autograd's
    thread, does too."""
    split = AX.seq_split(s)
    if split and x.shape[1] == s:
        x = scatter_seq(x)
    elif split and x.shape[1] != s // model_size():
        raise ValueError(f"seq_parallel: {tuple(x.shape)} is neither a "
                         f"sequence of {s} nor its block of "
                         f"{s // model_size()}")
    prev = (getattr(_rows, "seq", None), getattr(_rows, "gathered", None))
    _rows.seq = s if split else None
    _rows.gathered = None
    try:
        yield x
    finally:
        _rows.seq, _rows.gathered = prev


def _seq() -> int | None:
    return getattr(_rows, "seq", None)


def on_block(x: torch.Tensor) -> bool:
    """Whether ``x`` [B, S/m, ...] is this rank's S block of the residual
    stream (within :func:`seq_parallel`, the stream split)."""
    s = _seq()
    return s is not None and x.dim() >= 2 and x.shape[1] == s // model_size()


def seq_whole(x: torch.Tensor) -> bool:
    """Whether ``x`` [B, S, ...] spans the whole sequence of a residual
    stream split by :func:`seq_parallel`."""
    s = _seq()
    return s is not None and x.dim() >= 2 and x.shape[1] == s


def scatter_seq(x: torch.Tensor) -> torch.Tensor:
    """This rank's S block ``[B, S/m, ...]`` of ``x`` ``[B, S, ...]``,
    whole and the same on every rank (the embedding's output, a mixer
    whose output every rank computes whole: attention whose heads do not
    divide the axis, sLSTM): its gradient, a block on each rank, is
    gathered over ``model``."""
    return scatter_model(x, 1)


class _SeqGather(torch.autograd.Function):
    """All-gather over ``model`` along dim 1; backward: this rank's block
    of the gradient, whose every consumer has summed its partial."""

    @staticmethod
    def forward(ctx, x):
        ctx.rank, ctx.n = model_rank(), x.shape[1]
        return all_gather(x, 1, "model")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.rank * ctx.n, ctx.n)


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """The whole sequence ``[B, S, ...]`` of this rank's S block ``x``
    (within :func:`seq_parallel`; anything else comes back as it is), for
    the mixers that read every position.  The column-parallel products
    that read the result sum their input gradient's f32 partials by a
    reduce-scatter over S and round each once (:class:`_Product`); a
    product every rank computes whole hands back the whole gradient; the
    backward here keeps this rank's block of their sum."""
    if not on_block(x):
        return x
    out = _SeqGather.apply(x)
    _rows.gathered = out
    return out


def seq_block(y: torch.Tensor) -> torch.Tensor:
    """A mixer's output as the residual stream holds it: a whole ``y``
    (within :func:`seq_parallel`, the stream split) cut to this rank's
    block (:func:`scatter_seq`), a block as it is."""
    return scatter_seq(y) if seq_whole(y) else y


class _SumScatter(torch.autograd.Function):
    """Reduce-scatter over ``model`` along dim 1 (an f32 partial summed,
    this rank's S block of the sum); backward: the gradient's blocks
    gathered over ``model``."""

    @staticmethod
    def forward(ctx, partial):
        ctx.group = model_group()
        return reduce_scatter(partial, 1, "model", ctx.group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, 1, "model", ctx.group, backward=True)


def sum_seq(partial: torch.Tensor) -> torch.Tensor:
    """:func:`reduce_from_model` of an f32 partial ``[B, S, ...]`` under
    sequence parallelism: the sum's S block of this rank (a reduce-scatter
    where the plain path all-reduces); the caller rounds it."""
    if partial.dtype != torch.float32:
        raise TypeError(f"sum_seq sums f32 partials, not {partial.dtype}")
    return _SumScatter.apply(partial)


class _Sum(torch.autograd.Function):
    """All-reduce (SUM) forward, in place; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, partial, axis):
        ctx.mark_dirty(partial)
        return _all_reduce(partial, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_model(partial: torch.Tensor) -> torch.Tensor:
    """Sum an f32 partial over the ``model`` axis, in place; the caller
    rounds the sum.  Its gradient is the incoming one, on every rank."""
    if partial.dtype != torch.float32:
        raise TypeError(f"reduce_from_model sums f32 partials, not "
                        f"{partial.dtype}")
    if model_size() == 1:
        return partial
    return _Sum.apply(partial, "model")


class _Copy(torch.autograd.Function):
    """Identity forward; backward: the incoming gradient (this rank's
    partial) widened to f32, summed over ``model``, rounded once to its
    dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.group = model_group()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = torch.empty(g.shape, dtype=torch.float32, device=g.device)
        s.copy_(g)
        return _all_reduce(s, group=ctx.group, backward=True).to(g.dtype)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, read by this rank's share of a computation (the
    routed experts' FFN): the conjugate of :func:`reduce_from_model`.  Its
    gradient, this rank's partial, is summed over the ``model`` axis in
    f32 and rounded once to x's dtype, as JAX's ``shard_map`` transpose
    sums its replicated input's."""
    if model_size() == 1:
        return x
    return _Copy.apply(x)


class _HeadSum(torch.autograd.Function):
    """x [..., d] broadcast to [..., h, d]; backward: the f32 sum over the
    h heads, summed over ``model``, rounded once to x's dtype."""

    @staticmethod
    def forward(ctx, x, h):
        ctx.group = model_group()
        return x.unsqueeze(-2).expand(*x.shape[:-1], h, x.shape[-1]) \
            .contiguous()

    @staticmethod
    def backward(ctx, g):
        s = g.to(torch.float32).sum(dim=-2)
        return _all_reduce(s, group=ctx.group,
                           backward=True).to(g.dtype), None


def heads_broadcast(x: torch.Tensor, h: int, split: bool = True
                    ) -> torch.Tensor:
    """x [..., d], shared by every head (MLA's rope key), broadcast over
    this rank's ``h`` query heads -> [..., h, d].  Under a model axis
    that splits the heads (``split``) the gradient is summed over the
    rank's heads in f32, then over the axis, and rounded once, as JAX's
    HLO sums it; with none, or heads whole on every rank, ``expand``."""
    if model_size() == 1 or not split:
        return x.unsqueeze(-2).expand(*x.shape[:-1], h, x.shape[-1])
    return _HeadSum.apply(x, h)


def model_block(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` split over ``model`` (the
    whole of it with a model axis of one)."""
    m = model_size()
    if m == 1:
        return t
    n = t.shape[dim] // m
    return t.narrow(dim, model_rank() * n, n)


def reduce_from_data(partial: torch.Tensor) -> torch.Tensor:
    """Sum an f32 partial over this rank's rows over the ``data`` axis, in
    place (the loss's sum and count); unchanged where the rows are not
    split.  Its gradient is the incoming one, on every rank."""
    if partial.dtype != torch.float32:
        raise TypeError(f"reduce_from_data sums f32 partials, not "
                        f"{partial.dtype}")
    if not rows_split():
        return partial
    return _Sum.apply(partial, "data")


# ---------------------------------------------------------------------------
# weights: FSDP blocks and leaves replicated over the data axis
# ---------------------------------------------------------------------------

class Fsdp(NamedTuple):
    """A weight's block split over ``data`` along ``dim`` (an FSDP leaf,
    or one layer of a stacked one), read whole through :func:`weight` at
    its use."""
    block: torch.Tensor
    dim: int


class Layer(NamedTuple):
    """Layer ``index`` of a stacked leaf that the rule table splits over
    ``data`` along its layer dim (FSDP where the data axes divide the
    depth and no wider dim): ``block`` is this rank's L/d whole layers
    (over ``data``; its other dims as the rule table cuts them over
    ``model``), layer l owned by data rank ``l // (L/d)``.  ``row``: on
    the owner, this layer's view from one ``unbind`` of the block (whose
    backward stacks the layers' gradients into the block's once); None
    on the other ranks.  Read through :func:`weight`, which moves that
    one layer to the data group."""
    block: torch.Tensor
    index: int
    row: torch.Tensor | None = None


class _DataLeaf(torch.autograd.Function):
    """A leaf whole over ``data`` (its blocks gathered along ``dim``, or
    itself with ``dim`` None) widened to f32.  Backward: the f32
    gradient, this rank's rows' partial, summed over ``data``, rounded
    once to the leaf's dtype, cut to this rank's block."""

    @staticmethod
    def forward(ctx, w, dim):
        ctx.dim, ctx.dtype = dim, w.dtype
        ctx.group, ctx.rank = data_group(), data_rank()
        ctx.summed = rows_split()
        if dim is None:
            return w.to(torch.float32, copy=True)
        return all_gather(w, dim, "data").to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        # the gradient of the leaf's one use, summed in place where it is
        # a contiguous f32 buffer (a model shard's f32 partial is GBs)
        s = g
        if g.dtype != torch.float32 or not g.is_contiguous():
            s = torch.empty(g.shape, dtype=torch.float32, device=g.device)
            s.copy_(g)
        if ctx.summed:
            _all_reduce(s, group=ctx.group, backward=True, axis="data")
        if ctx.dim is not None:
            n = s.shape[ctx.dim] // _group_size(ctx.group)
            s = s.narrow(ctx.dim, ctx.rank * n, n)
        return s.to(ctx.dtype), None


def fsdp_gather(block: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole (over ``data``) of this rank's FSDP ``block``, split
    along ``dim``: an all-gather over ``data`` just before the product
    that reads it (again in a layer's recompute, in the same order on
    every rank).  Where the block needs a gradient the result is in f32
    (the gathered bf16 values) and its gradient, an f32 partial, is
    summed over ``data``, rounded once and cut to the block; otherwise it
    keeps the block's dtype."""
    if torch.is_grad_enabled() and block.requires_grad:
        return _DataLeaf.apply(block, dim)
    return all_gather(block, dim, "data")


def _broadcast_layer(w: Layer, group, backward: bool = False
                     ) -> torch.Tensor:
    """Layer ``w.index`` of a layer-split leaf on every rank of the data
    group: the owner's row, broadcast from it (one ``broadcast`` over
    ``data`` of one layer, counted with its bytes)."""
    owner, row = divmod(w.index, w.block.shape[0])    # L/d layers a rank
    if data_rank() == owner:
        t = (w.block[row] if w.row is None else w.row).contiguous()
    else:
        t = torch.empty(w.block.shape[1:], dtype=w.block.dtype,
                        device=w.block.device)
    if _sent(t, group):
        dist.broadcast(t, src=dist.get_global_rank(group, owner),
                       group=group)
    _count("data", "broadcast", t, backward)
    return t


class _LayerLeaf(torch.autograd.Function):
    """One layer of a layer-split leaf, broadcast from its owner and
    widened to f32.  ``src``: the owner's row (``Layer.row``), else the
    rank's block, which gets nothing from it.  Backward: the layer's f32
    gradient, this rank's rows' partial, summed over ``data`` (an
    all-reduce, as JAX's HLO sums each layer's), rounded once to the
    leaf's dtype as the owner's row's gradient."""

    @staticmethod
    def forward(ctx, src, w):
        ctx.dtype, ctx.owns = src.dtype, w.row is not None
        ctx.group, ctx.summed = data_group(), rows_split()
        return _broadcast_layer(w, ctx.group).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        s = g
        if g.dtype != torch.float32 or not g.is_contiguous():
            s = torch.empty(g.shape, dtype=torch.float32, device=g.device)
            s.copy_(g)
        if ctx.summed:
            _all_reduce(s, group=ctx.group, backward=True, axis="data")
        return (s.to(ctx.dtype) if ctx.owns else None), None


def layer_gather(w: Layer) -> torch.Tensor:
    """Layer ``w.index`` of a leaf split over ``data`` along its layer dim
    (:class:`Layer`), moved from its owner to the data group just before
    the product that reads it (again in the layer's recompute, in the
    same order on every rank); never the whole stack.  Where the block
    needs a gradient the result is in f32 and its gradient is summed over
    ``data`` onto the owner's row (:class:`_LayerLeaf`); otherwise it
    keeps the block's dtype."""
    if torch.is_grad_enabled() and w.block.requires_grad:
        return _LayerLeaf.apply(w.block if w.row is None else w.row, w)
    return _broadcast_layer(w, data_group())


class Whole(NamedTuple):
    """A leaf the rule table would split over ``model`` but keeps whole,
    since the dim does not divide the axis (wk and wv where the KV heads
    do not divide it; wq, wo and every attention leaf where the heads do
    not): ``w`` a tensor or an :class:`Fsdp` block.  ``partial``: each
    rank reads only its query heads' part of it (K/V under split Q), so
    its gradient is a partial, summed over ``model`` (:class:`_ModelSum`);
    otherwise every rank computes with the whole of it alike."""
    w: object
    partial: bool


class _ModelSum(torch.autograd.Function):
    """A leaf whole over ``model`` that this rank reads for its own heads
    only, widened to f32.  Backward: its f32 gradient partial summed over
    ``model`` and rounded once to the leaf's dtype (f32 for a leaf widened
    over ``data`` already, whose node sums over ``data`` and rounds), as
    JAX's HLO sums wk's and wv's (an f32 tuple all-reduce, then one
    convert)."""

    @staticmethod
    def forward(ctx, w):
        ctx.dtype, ctx.group = w.dtype, model_group()
        return w.to(torch.float32, copy=True)

    @staticmethod
    def backward(ctx, g):
        s = g
        if g.dtype != torch.float32 or not g.is_contiguous():
            s = torch.empty(g.shape, dtype=torch.float32, device=g.device)
            s.copy_(g)
        _all_reduce(s, group=ctx.group, backward=True)
        return s.to(ctx.dtype)


def weight(w) -> torch.Tensor:
    """A weight at its use: an :class:`Fsdp` block gathered
    (:func:`fsdp_gather`); a :class:`Layer` moved from its owner
    (:func:`layer_gather`); under split rows, a leaf replicated over
    ``data`` that needs a gradient widened to f32, its gradient's partial
    summed over ``data`` and rounded once; a :class:`Whole` leaf read by
    this rank's heads only, its gradient's partial summed over ``model``
    too; otherwise the tensor itself."""
    if isinstance(w, Whole):
        t = weight(w.w)
        if w.partial and torch.is_grad_enabled() and t.requires_grad:
            return _ModelSum.apply(t)
        return t
    if isinstance(w, Fsdp):
        return fsdp_gather(w.block, w.dim)
    if isinstance(w, Layer):
        return layer_gather(w)
    if rows_split() and torch.is_grad_enabled() and w.requires_grad:
        return _DataLeaf.apply(w, None)
    return w


def summed_weight(w) -> torch.Tensor:
    """A leaf the rule table replicates over ``model`` but each rank reads
    for its own heads only (mLSTM's ``w_if``): :func:`weight` of it as a
    ``Whole(w, partial=True)``, its gradient's partial summed over
    ``model``; :func:`weight` itself with a model axis of one."""
    return weight(Whole(w, True) if model_size() > 1 else w)


@functools.lru_cache(maxsize=64)
def _placement(key: tuple, sizes: tuple, threshold: int) -> tuple:
    mesh = _Sizes(dict(sizes))
    out = []
    for path, whole, itemsize, local in key:
        base = SH._spec_for(path, whole, mesh, itemsize, False)
        full = SH._spec_for(path, whole, mesh, itemsize, True)
        model = mesh.shape.get("model", 1) > 1 and "model" in base
        if local == AX.local_shape(whole, base, mesh):
            out.append((path, model, None))
        elif local == AX.local_shape(whole, full, mesh):
            out.append((path, model, SH.data_dim(full)))
        else:
            raise ValueError(f"{path}: {local} is no rank's block of {whole} "
                             f"under the rule table ({base} or {full})")
    return tuple(out)


class _Sizes:
    """The axis sizes of a mesh, as the rule table reads them."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def model_axis() -> _Sizes:
    """The active mesh's model axis alone, as the rule table reads a mesh
    (``sharding.cache_specs`` of a cache whose rows are this rank's)."""
    return _Sizes({"model": model_size()})


def cache_dims(whole) -> list:
    """For each leaf of a decode cache (a NamedTuple of ``meta`` tensors
    of the whole cache over the model axis, its rows this rank's already),
    the dim ``sharding.cache_specs`` splits over the model axis alone, or
    None where it keeps the leaf whole (every dim it tries does not divide
    the axis)."""
    if model_size() == 1:
        return [None] * len(whole)
    out = []
    for _, spec in SH.spec_leaves(SH.cache_specs(whole, model_axis())):
        dims = [i for i, a in enumerate(spec) if a == "model"]
        out.append(dims[0] if dims else None)
    return out


def new_cache(whole, device, fill: dict | None = None):
    """This rank's blocks of a decode cache (a NamedTuple) whose rows are
    this rank's already (``whole``: ``meta`` tensors of the whole cache
    over the model axis), each leaf cut as ``sharding.cache_specs`` cuts
    it on the model axis alone (:func:`cache_dims`), allocated on
    ``device`` with its dtype and filled with ``fill[field]`` (0 by
    default); each leaf remembers the dim it is split at
    (:func:`split_dim`), which a decode step reads to pick its
    attention."""
    fill = fill or {}
    axis = model_axis()
    out = []
    for field, t, dim in zip(whole._fields, whole, cache_dims(whole)):
        spec = [None] * t.dim()
        if dim is not None:
            spec[dim] = "model"
        leaf = torch.full(AX.local_shape(tuple(t.shape), tuple(spec), axis),
                          fill.get(field, 0), dtype=t.dtype, device=device)
        leaf._model_dim = dim
        out.append(leaf)
    return type(whole)(*out)


def split_dim(leaf: torch.Tensor) -> int | None:
    """The dim a cache leaf made by :func:`new_cache` is split at over the
    model axis (None: whole over it, or no model axis).  Under a model
    axis a leaf made otherwise raises: its layout is not known."""
    if model_size() == 1:
        return None
    if not hasattr(leaf, "_model_dim"):
        raise ValueError(f"a decode cache leaf {tuple(leaf.shape)} not made "
                         f"by tp.new_cache (the model's init_cache): its "
                         f"split over the model axis is not known")
    return leaf._model_dim


def placement(whole: dict, params: dict) -> tuple:
    """For each leaf of this rank's ``params`` (``jax.tree.leaves``
    order): ``(path, split over model, dim split over data)``, the last
    the dim of an FSDP block (``sharding.param_specs(fsdp=True)``) or None
    for a leaf whole over ``data`` (as ``fsdp=False`` places every leaf).
    ``whole`` is the whole model's tree (``meta`` tensors do); a leaf of
    neither shape raises."""
    sizes = tuple(AX.mesh_axes(AX.current_mesh()).items())
    key = tuple((path, tuple(w.shape), w.element_size(), tuple(p.shape))
                for (path, w), (_, p) in zip(leaf_paths(whole),
                                             leaf_paths(params)))
    if len(key) != len(leaf_paths(params)):
        raise ValueError("placement: params and the whole tree differ")
    return _placement(key, sizes, SH.FSDP_THRESHOLD_BYTES)


_KV = re.compile(r"(.*\['(?:attn|cross)'\])\['w[kv]'\]")


def model_whole(lay: tuple) -> dict:
    """``{path: partial}`` for each leaf of a :func:`placement` that the
    rule table would split over ``model`` but keeps whole (the dim does
    not divide the axis): ``partial`` for wk's and wv's leaves where the
    same attention's wq is split (each rank's query heads read their KV
    heads of the whole K/V; :class:`Whole`).  Empty with a model axis of
    one."""
    if model_size() == 1:
        return {}
    split = {path: model for path, model, _ in lay}
    out = {}
    for path, model, _ in lay:
        if model or "m" not in rule_template(path):
            continue
        kv = _KV.match(path)
        out[path] = bool(kv) and split.get(kv.group(1) + "['wq']['w']",
                                           False)
    return out


def placed(whole, params: dict, stacks: tuple) -> tuple[dict, dict]:
    """``(top, layers)``: this rank's ``params`` outside the stacked
    ``stacks`` and, by stack, the views of each layer
    (``models/params.unstack``), with every leaf split over ``data`` an
    :class:`Fsdp` block, every stacked leaf split over ``data`` along its
    layer dim a :class:`Layer` of its block, and every leaf kept whole
    over ``model`` a :class:`Whole` (:func:`placement` against the whole
    model's shapes, which ``whole()`` returns, :func:`model_whole`,
    :func:`layout_view`).  With no mesh, the params and their layers as
    they are."""
    from repro_torch.models import params as P
    if model_size() == 1 and data_size() == 1:
        return ({k: v for k, v in params.items() if k not in stacks},
                {k: P.unstack(params[k]) for k in stacks})
    full = whole()
    lay = placement(full, params)
    layered = {path for path, _, d in lay if d == 0 and SH.STACKS.match(path)}
    dims = {path: d for path, _, d in lay
            if d is not None and path not in layered}
    kept = model_whole(lay)
    top = layout_view({k: v for k, v in params.items() if k not in stacks},
                      dims, kept)
    out = {}
    for k in stacks:
        n = P.leaves(full[k])[0].shape[0]
        views = P.unstack(params[k], n, lambda path, t, k=k: _layers(t, n)
                          if f"['{k}']{path}" in layered else None)
        out[k] = [layout_view(bp, dims, kept, f"['{k}']", lead=1)
                  for bp in views]
    return top, out


def _layers(block: torch.Tensor, n: int) -> list[Layer]:
    """The n :class:`Layer` views of a layer-split leaf's ``block``, the
    rank's own rows split with one ``unbind``."""
    rows = block.unbind(0)
    lo = data_rank() * len(rows)
    return [Layer(block, li, rows[li - lo] if 0 <= li - lo < len(rows)
                  else None) for li in range(n)]


def layout_view(tree: dict, dims: dict, whole: dict | None = None,
                prefix: str = "", lead: int = 0) -> dict:
    """``tree`` with every leaf whose path (``prefix`` + its keys) is in
    ``dims`` as ``Fsdp(leaf, dims[path] - lead)`` (``lead`` 1 for one
    layer of the stacked blocks), and every one in ``whole``
    (:func:`model_whole`) as ``Whole(leaf, whole[path])``."""
    whole = whole or {}
    out = {}
    for k, v in tree.items():
        path = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out[k] = layout_view(v, dims, whole, path, lead)
            continue
        if path in dims:
            v = Fsdp(v, dims[path] - lead)
        out[k] = Whole(v, whole[path]) if path in whole else v
    return out


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _partial_f32(x2d: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """x2d @ w2d accumulated and kept in f32.  On the card
    ``torch.mm(out_dtype=float32)`` reads the bf16 operands as they are;
    on the CPU, which lacks that overload, they are widened (bf16
    products are exact in f32)."""
    if x2d.is_cuda:
        return torch.mm(x2d, w2d, out_dtype=torch.float32)
    return torch.mm(x2d.to(torch.float32), w2d.to(torch.float32))


class _Product(torch.autograd.Function):
    """x2d [N, K] @ w2d [K, M] on bf16 values (``w2d`` bf16, or f32 holding
    bf16 values: a gathered or widened leaf), f32 accumulated.
    ``out_f32``: the f32 partial of a row-parallel product (the caller
    sums it over ``model`` and rounds), else rounded once to x's dtype.
    Backward: the input gradient rounds once to x's dtype, its f32
    partial summed over ``model`` first where ``sum_dx`` (a
    column-parallel product); the weight gradient rounds once to the
    weight's dtype, so a widened weight's stays in f32."""

    @staticmethod
    def forward(ctx, x2d, w2d, out_f32, sum_dx, seq=None):
        wb = w2d.to(x2d.dtype)
        ctx.save_for_backward(x2d, wb)
        ctx.out_f32, ctx.wide = out_f32, w2d.dtype != x2d.dtype
        ctx.group = model_group() if sum_dx else None
        ctx.seq = seq
        if seq is not None:
            ctx.rank = model_rank()
        return _partial_f32(x2d, wb) if out_f32 else torch.mm(x2d, wb)

    @staticmethod
    def backward(ctx, g):
        x2d, wb = ctx.saved_tensors
        if ctx.out_f32:
            g = g.to(x2d.dtype)       # bf16 values: the sum's rounding
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.seq is not None:
                dx = _seq_dx(ctx, _partial_f32(g, wb.t()), x2d.dtype)
            elif ctx.group is not None:
                dx = _all_reduce(_partial_f32(g, wb.t()), group=ctx.group,
                                 backward=True).to(x2d.dtype)
            else:
                dx = torch.mm(g, wb.t())
        if ctx.needs_input_grad[1]:
            dw = _partial_f32(x2d.t(), g) if ctx.wide else \
                torch.mm(x2d.t(), g)
        return dx, dw, None, None, None


def _seq_dx(ctx, part: torch.Tensor, dtype) -> torch.Tensor:
    """The input gradient of a column-parallel product that read the
    gathered sequence: its f32 partial [B S, K] reduce-scattered over S,
    rounded once to ``dtype``, placed at this rank's block of a whole
    gradient that is 0 elsewhere (the gather's backward keeps the block)."""
    b, s = ctx.seq
    blk = reduce_scatter(part.view(b, s, -1), 1, group=ctx.group,
                         backward=True).to(dtype)
    dx = blk.new_zeros((b, s, blk.shape[-1]))
    dx.narrow(1, ctx.rank * blk.shape[1], blk.shape[1]).copy_(blk)
    return dx.view(b * s, -1)


def row_parallel(x: torch.Tensor, w, seq: bool = True) -> torch.Tensor:
    """x [..., K] @ w [*k, N] -> [..., N] in x's dtype (K the product of
    ``k``), where K is split over the ``model`` axis (this rank's heads
    or d_ff columns): the f32 partial summed over the ranks, then rounded
    once.  With a model axis of one, or for a :class:`Whole` leaf (wo
    where the heads do not divide the axis: every rank has every head),
    the plain product that rounds once (``layers.linear``).  ``w``: a
    tensor, an :class:`Fsdp` block or a :class:`Whole` leaf.

    Within :func:`seq_parallel`, the stream split, a mixer's output over
    the whole sequence x [B, S, K] returns to the stream's S block: the
    partial reduce-scattered over S (:func:`sum_seq`), a whole product
    cut (:func:`scatter_seq`).  ``seq`` False keeps the whole sum (Mamba's
    ``x_proj``, read by the scan)."""
    plain = model_size() == 1 or isinstance(w, Whole)
    scatter = seq and seq_whole(x)
    w = weight(w)
    w2d = w.reshape(-1, w.shape[-1])
    if plain and w.dtype == x.dtype:
        y = torch.matmul(x, w2d)
        return scatter_seq(y) if scatter else y
    x2d = x.reshape(-1, x.shape[-1])
    if plain:
        y = _Product.apply(x2d, w2d, False, False).reshape(
            *x.shape[:-1], -1)
        return scatter_seq(y) if scatter else y
    # the partial and the sum are two nodes: a layer's recompute stops
    # after the last node that saves tensors, so it issues the MLP's sum
    # no more (as XLA's remat does not), the attention's again
    part = _Product.apply(x2d, w2d, True, False)
    if scatter:
        return sum_seq(part.view(*x.shape[:-1], -1)).to(x.dtype)
    return reduce_from_model(part).to(x.dtype).reshape(*x.shape[:-1], -1)


def column_parallel(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w [K, *out] -> [..., *out] in x's dtype, f32
    accumulated and rounded once (``layers.linear``'s product), where
    ``out`` is this rank's heads or columns.  The forward issues nothing;
    under a model axis the backward sums the input gradient's partial.
    ``w``: a tensor, an :class:`Fsdp` block or a :class:`Whole` leaf: one
    read by this rank's heads only (``partial``) is a column product too,
    all of whose columns the rank computes; one read whole on every rank
    the plain product, no sum either way."""
    if model_size() == 1 or isinstance(w, Whole) and not w.partial:
        return replicated(x, w)
    seq = tuple(x.shape[:2]) if x is getattr(_rows, "gathered", None) \
        else None
    w = weight(w)
    y = _Product.apply(x.reshape(-1, x.shape[-1]),
                       w.reshape(w.shape[0], -1), False, True, seq)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def replicated(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w [K, *out] -> [..., *out] in x's dtype, f32
    accumulated and rounded once, for a weight the rule table replicates
    over ``model`` (MLA's wdkv and wkr; the router, in f32): every rank
    computes all of it, no sum forward or backward, the weight read
    through :func:`weight` (an FSDP block gathered; under split rows its
    gradient summed over ``data``)."""
    w = weight(w)
    w2d = w.reshape(w.shape[0], -1)
    if w.dtype == x.dtype:
        y = torch.matmul(x, w2d)
    else:
        y = _Product.apply(x.reshape(-1, x.shape[-1]), w2d, False, False)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def vocab_embed(w, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table for ``tokens``, where this rank holds
    rows [r V/m, (r + 1) V/m) of it (``w``, a tensor or an :class:`Fsdp`
    block): the tokens outside read 0, and the f32 sum over the ranks is
    exact.  The backward scatters into this rank's rows only.  A
    :class:`Whole` table (a vocab that does not divide the axis) is the
    plain lookup on every rank, no sum."""
    whole = isinstance(w, Whole)
    if whole:
        w = w.w
    dt = w.block.dtype if isinstance(w, Fsdp) else w.dtype
    w = weight(w)
    if model_size() == 1 or whole:
        return F.embedding(tokens, w).to(dt)
    lo = model_rank() * w.shape[0]
    mine = (tokens >= lo) & (tokens < lo + w.shape[0])
    rows = F.embedding(torch.where(mine, tokens - lo, 0), w)
    part = torch.where(mine[..., None], rows.to(torch.float32), 0.0)
    return reduce_from_model(part).to(dt)


def gather_vocab(logits: torch.Tensor, split: bool = True) -> torch.Tensor:
    """This rank's vocab columns ``[..., V/m]`` of its rows -> the whole
    batch's ``[B, ..., V]`` on every rank, the blocks in axis order: the
    columns over ``model`` (``split``: not where the head is whole over
    it, a vocab that does not divide the axis), then the rows over
    ``data`` where they are split.  Forward only: the loss reads the
    columns where they are (:func:`vocab_cross_entropy`)."""
    if model_size() > 1 and split:
        logits = all_gather(logits, -1, "model")
    if rows_split():
        logits = all_gather(logits, 0, "data")
    return logits


def softmax_over_rows(scores: torch.Tensor, v: torch.Tensor
                      ) -> torch.Tensor:
    """Attention whose cache rows are split over ``model`` (a decode cache
    sharded over T): ``scores`` f32 [B, K, G, n] of every query head
    against this rank's n rows (n may be 0; masked rows at ``-1e30``),
    ``v`` f32 [B, n, K, Dh] those rows' values -> the softmax-weighted
    values over every rank's rows, f32 [B, K, G, Dh], on every rank.  A
    MAX all-reduce of the row maxima, then one SUM all-reduce of the
    weighted values and the sum of exp stacked, then the division, as
    JAX's decode HLO combines its T blocks."""
    if scores.shape[-1]:
        mx = scores.amax(dim=-1)
    else:
        mx = scores.new_full(scores.shape[:-1], -1e30)
    mx = _all_reduce(mx, op=dist.ReduceOp.MAX)
    e = torch.exp(scores - mx[..., None])
    part = torch.cat([torch.einsum("bkgt,btkd->bkgd", e, v),
                      e.sum(dim=-1, keepdim=True)], dim=-1)
    part = _all_reduce(part)
    return part[..., :-1] / part[..., -1:]


def write_row(cache: torch.Tensor, t: int, row: torch.Tensor) -> None:
    """Write ``row`` [B, ...] at position ``t`` of a cache [B, T/m, ...]
    whose rows are split over ``model`` (rank r holds [r T/m, (r + 1)
    T/m)), on the one rank that holds row t (counted in ``writes``)."""
    lo = model_rank() * cache.shape[1]
    if lo <= t < lo + cache.shape[1]:
        cache[:, t - lo] = row.to(cache.dtype)
        COUNTS["model"]["writes"] += 1


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


def vocab_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        split: bool = True) -> torch.Tensor:
    """Per-token cross-entropy ``[...]`` (f32) of this rank's vocab
    columns ``logits`` f32 ``[..., V/m]`` (``V/m`` columns from ``r V/m``)
    and the global ``targets``: a MAX all-reduce of the row max, then one
    SUM all-reduce of the stacked sum of exp and gold logit (the gold
    read on the rank that holds the target, 0 elsewhere); the result is
    ``max + log(sum exp) - gold`` on every rank.  The backward is local:
    the softmax of the local columns minus the one-hot on the target's
    rank, times the incoming gradient.  With ``split`` False (a head whole
    over the axis: every rank has every column) the plain cross-entropy,
    no collective."""
    if logits.dtype != torch.float32:
        raise TypeError(f"vocab_cross_entropy takes f32 logits, not "
                        f"{logits.dtype}")
    if model_size() == 1 or not split:
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - gold
    return _VocabCE.apply(logits, targets)


def sharded_leaves(whole: dict, params: dict) -> list[bool]:
    """For each leaf of this rank's ``params`` (``jax.tree.leaves``
    order), whether the rule table shards it over ``model`` once it has
    dropped the axis from a dim that does not divide it (``placement``
    against the whole model's shapes ``whole``): a replicated wk adds its
    squares to the clip norm once, not once a rank.  All False with a
    model axis of one."""
    if model_size() == 1:
        return [False] * len(leaf_paths(params))
    return [model for _, model, _ in placement(whole, params)]


def check_layout(cfg) -> None:
    """Raise unless the port lays ``cfg`` out over the active mesh, as
    JAX's rule table does: every family (the dense GQA decoders, the MoE
    decoders with MLA, xLSTM's recurrent cells, hymba's attention beside
    Mamba, seamless's encoder-decoder) beside data axes of any size (a
    pod axis is one more, :func:`data_size`).  The rule table decides
    each leaf by its own dims: where a dim does not divide the model axis
    it keeps the leaf whole, and so does the port (:class:`Whole`): heads
    or KV heads (K/V, and Q and wo where the heads do not divide; MLA's
    wq, wuk, wuv and wo), a dense d_ff (a dense MLP's gate, up and down,
    hymba's and seamless's FFNs, arctic's residual FFN), Mamba's channel
    leaves where d_inner does not divide (``in_proj`` split while 2
    d_inner does), xLSTM's inner width, a vocab (the embedding and the
    head), sLSTM's recurrent kernel, MoE shared experts; where a leaf's
    split dim cuts through heads (xLSTM heads that neither divide the
    axis nor are divided by it) every rank runs every head.  A decode
    cache takes every split ``cache_specs`` gives (:func:`new_cache`):
    its KV heads, else its rows of T, a ring's window or the encoder's
    frames, else the head dim or a state's other dims, else whole on
    every rank.  Refused by name with the ROADMAP item, as JAX refuses
    them: experts that do not divide the model axis (JAX's ``moe_ffn``
    asserts), and, in ``models/moe.py``, rows that do not divide the data
    axes (JAX's stream constraint raises for them).  FSDP over a stacked
    leaf's layer dim is laid out (:class:`Layer`)."""
    m = model_size()
    if cfg.is_moe and cfg.n_experts % m:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_experts} experts do not divide the model "
            f"axis of {m} (JAX's moe_ffn asserts it) ({ROADMAP_ITEM})")


def check_moments(params, moment_dtype: str) -> list[bool]:
    """For each leaf of this rank's ``params``, whether its
    ``bdi8``/``q8`` moment tiles straddle two model shards: a leaf whose
    last dim is sharded over ``model`` and whole tiles of 128 (so JAX
    stores it tiled) but whose tile count does not divide the model axis.
    The rule table then drops ``model`` from the moment's tile dim and
    every rank holds the leaf's whole moments (``optim/adamw.py`` updates
    them from the gradient gathered over ``model``).  f32 and bf16 moments
    have no tiles; all False then, and with a model axis of one.  The
    same straddle over the data axes is laid out where the update's
    blocks are cut (``optim/adamw.plan``: the rank owns another dim's
    block)."""
    m = model_size()
    out = []
    for path, leaf in leaf_paths(params):
        tpl = rule_template(path)
        straddles = False
        if m > 1 and moment_dtype in ("bdi8", "q8") and tpl \
                and tpl[-1] == "m" and leaf.dim() >= len(tpl):
            straddles = (leaf.shape[-1] * m) % _TILE == 0 \
                and leaf.shape[-1] % _TILE != 0
        out.append(straddles)
    return out


def refuse_model_axis(what: str) -> None:
    """Raise under a model or data axis larger than one: ``what``
    (``launch/train.train``, its checkpoints and driver loop) runs no
    mesh, as JAX's ``train()`` runs none."""
    if model_size() > 1 or data_size() > 1:
        raise NotImplementedError(
            f"{what} under a model axis of {model_size()} and a data axis "
            f"of {data_size()}: the training driver and its checkpoints run "
            f"no mesh; the train step does (launch/train.make_train_step) "
            f"({ROADMAP_ITEM})")
