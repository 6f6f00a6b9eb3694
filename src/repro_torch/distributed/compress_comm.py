"""BDI-compressed collectives for gradient synchronisation (port of
``repro/distributed/compress_comm.py``).

The thesis' bandwidth-compression chapter maps onto the DP gradient
all-reduce: each worker quantises its local gradient with the
value-space BDI tile codec (int8 deltas, per-tile base and scale, a
zero-base mask), all-gathers the *compressed* form, and dequantise-sums
it locally.  On the card the codec is tile kernels 4 and 5
(``kernels.ops.compress``/``decompress``: ``csrc/bdi_compress_tile.cu``
and ``bdi_decompress_tile.cu``), on the CPU their plain versions; the
collectives are ``torch.distributed``'s on the mesh's process group for
the axis (NCCL on the card, gloo on the CPU).  On one card the group has
one rank and its all-gather and all-reduce are copies.

Error feedback carries each worker's quantisation residual into its next
step's gradient, which keeps the lossy codec unbiased over steps.

**Energy Control** (thesis §6.4.2) is the per-bucket gate:
:func:`plan_compression` measures each gradient leaf's compressibility on
the host and returns a static compress/raw decision per leaf.

What differs from the JAX package, none of it in the numbers:

  * the wire payload is one uint8 buffer a rank (int8 deltas, f32 base
    and scale, the 16-byte mask a tile in the tile kernels' bit planes;
    JAX gathers four arrays with ``pack_mask``'s byte layout): one
    collective, on both backends, of ``wire_bytes(shape, True)`` bytes;
  * a leaf of at least ``optim/adamw.BIG_LEAF`` elements whose rows are
    whole tiles is reduced in groups of dim-0 rows of at most
    ``BIG_LEAF`` elements, so the f32 temporaries stay one group's.
    Tiles lie along the flattened leaf, so each group's tiles are the
    whole leaf's, and the numbers are the same;
  * :func:`tree_all_reduce` writes each mean into its gradient and each
    new residual into its residual, in place (at yi-6b's full width the
    f32 residuals alone take 24 GB of the card);
  * the ranks' dequantised payloads are summed in rank order and divided
    by the world size as a tensor (IEEE division), as ``jnp.sum`` and
    ``/ psum(1)`` give them at one and two ranks, bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import leaf_paths
from repro_torch.core import bdi_value as bv
from repro_torch.kernels import ops, ref
from repro_torch.models import params as P
from repro_torch.optim.adamw import BIG_LEAF

TILE = 128
_TILE_BYTES = TILE + 4 + 4 + TILE // 8        # deltas, base, scale, mask


def _quantize(x: torch.Tensor) -> tuple[ref.PackedTiles, int]:
    tiles, n = bv.fold_to_tiles(x.to(torch.float32), TILE)
    return ops.compress(tiles), n


def _pack(p: ref.PackedTiles) -> torch.Tensor:
    """The wire payload: one uint8 buffer of ``tiles * 152`` bytes."""
    return torch.cat([p.deltas.reshape(-1).view(torch.uint8),
                      p.base.reshape(-1).view(torch.uint8),
                      p.scale.reshape(-1).view(torch.uint8),
                      p.maskp.reshape(-1)])


def _unpack(buf: torch.Tensor, tiles: int) -> ref.PackedTiles:
    """The inverse of :func:`_pack`, as views of ``buf`` (every part
    starts 4-byte aligned: ``tiles * 128`` and ``tiles * 4`` are)."""
    a, b, c = tiles * TILE, tiles * (TILE + 4), tiles * (TILE + 8)
    return ref.PackedTiles(
        buf[:a].view(torch.int8).view(tiles, TILE),
        buf[a:b].view(torch.float32).view(tiles, 1),
        buf[b:c].view(torch.float32).view(tiles, 1),
        buf[c:].view(tiles, TILE // 8), None)


def all_reduce_bdi(x: torch.Tensor, group, residual: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean-all-reduce over ``group`` with BDI compression and error
    feedback; every rank calls it with its own ``x`` and ``residual``.
    Returns ``(mean in x's dtype, new f32 residual)``."""
    xc = x.to(torch.float32) + residual
    c, n = _quantize(xc)
    local_q = bv.unfold_from_tiles(ops.decompress(c), n, x.shape)
    new_residual = xc - local_q
    del local_q

    payload = _pack(c)
    tiles = c.deltas.shape[0]
    if payload.numel() != wire_bytes(x.shape, True):
        raise AssertionError(f"payload {payload.numel()} B != wire_bytes "
                             f"{wire_bytes(x.shape, True)}")
    world = dist.get_world_size(group)
    gathered = [torch.empty_like(payload) for _ in range(world)]
    dist.all_gather(gathered, payload, group=group)
    total = ops.decompress(_unpack(gathered[0], tiles))
    for buf in gathered[1:]:                        # rank order
        total = total + ops.decompress(_unpack(buf, tiles))
    mean = bv.unfold_from_tiles(total, n, x.shape) / torch.full(
        (), float(world), device=total.device)
    return mean.to(x.dtype), new_residual


def all_reduce_raw(x: torch.Tensor, group, residual: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``pmean``: a sum over ``group`` in x's dtype, then the mean
    (``ReduceOp.AVG`` is NCCL's only, so both backends sum and divide)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    world = dist.get_world_size(group)
    return out / torch.full((), float(world), dtype=out.dtype,
                            device=out.device), residual


def wire_bytes(shape, compressed: bool) -> int:
    """Bytes a single worker contributes per all-gather leg."""
    n = int(np.prod(shape))
    tiles = (n + TILE - 1) // TILE
    if compressed:
        return tiles * _TILE_BYTES
    return n * 4


def _groups(t: torch.Tensor) -> list[tuple[int, int | None]]:
    """Row ranges of dim 0 reduced at a time: ``BIG_LEAF``-element groups
    for a big leaf whose rows are whole tiles (each group starts on a
    tile boundary), else the whole leaf."""
    if t.dim() < 2 or t.numel() < BIG_LEAF \
            or (t.numel() // t.shape[0]) % TILE:
        return [(0, None)]
    rows = max(1, BIG_LEAF // (t.numel() // t.shape[0]))
    return [(r, min(r + rows, t.shape[0]))
            for r in range(0, t.shape[0], rows)]


# ---------------------------------------------------------------------------
# EC planning (static per-bucket decision)
# ---------------------------------------------------------------------------

def _max_error_bound(g: torch.Tensor) -> float:
    """The codec's largest elementwise error bound over a leaf's tiles
    (``bv.error_bound``: 0 for ZERO and REP tiles, else scale / 2),
    compressed a group of rows at a time (kernel 4 on the card)."""
    err = torch.zeros((), dtype=torch.float32, device=g.device)
    for r0, r1 in _groups(g):
        p, _ = _quantize(g if r1 is None else g[r0:r1])
        exact = (p.enc == bv.ENC_ZERO) | (p.enc == bv.ENC_REP)
        err = torch.maximum(err, torch.where(
            exact, torch.zeros_like(p.scale), 0.5 * p.scale).max())
    return float(err)


def plan_compression(grads, *, rel_err_budget: float = 0.05,
                     min_ratio: float = 2.0) -> dict:
    """Host-side EC pass: measure each gradient bucket's compressibility.

    Returns {path: bool}; a bucket ships compressed iff the codec's
    worst-case error fits the budget relative to the 99th percentile of
    |g| AND the wire-byte ratio clears ``min_ratio`` (the paper's
    benefit-vs-cost comparison with E_toggle folded into the error
    budget).  The percentile is numpy's (linear interpolation) on the
    host, as in JAX: ``torch.quantile`` takes at most 2^24 elements.
    """
    plan = {}
    for path, g in leaf_paths(grads):
        err = _max_error_bound(g)
        a = g.detach().to(torch.float32).cpu().numpy()
        np.abs(a, out=a)
        scale_ref = float(np.percentile(a, 99, overwrite_input=True)
                          + 1e-12)
        del a
        ratio = wire_bytes(g.shape, False) / wire_bytes(g.shape, True)
        plan[path] = bool(err <= rel_err_budget * max(scale_ref, 1e-12)
                          and ratio >= min_ratio)
    return plan


def tree_all_reduce(grads, residuals, group, plan: dict | None):
    """Apply (compressed|raw) mean-all-reduce per bucket, in place: each
    gradient leaf takes its mean, each residual leaf (this rank's, the
    gradient's shape) its new value.  Returns ``(grads, residuals)``."""
    flat_r = [r for _, r in leaf_paths(residuals)]
    for (path, g), r in zip(leaf_paths(grads), flat_r):
        use = plan.get(path, True) if plan else True
        fn = all_reduce_bdi if use else all_reduce_raw
        for r0, r1 in _groups(g):
            gs, rs = (g, r) if r1 is None else (g[r0:r1], r[r0:r1])
            o, nr = fn(gs, group, rs)
            gs.copy_(o)
            if nr is not rs:
                rs.copy_(nr)
    return grads, residuals


def init_residuals(params, n_dev: int = 1):
    """Error-feedback state: zeros ``[n_dev, ...]`` in f32 beside each
    param.  JAX's ``n_dev`` is the data axis's device count and its array
    is sharded over it; in the port every rank holds its own block, so a
    rank calls this with ``n_dev=1`` (at one rank the tree is JAX's)."""
    return P.tree_map(lambda p: torch.zeros((n_dev,) + tuple(p.shape),
                                            dtype=torch.float32,
                                            device=p.device), params)


# ---------------------------------------------------------------------------
# Data-parallel training step with compressed grad sync
# ---------------------------------------------------------------------------

def _local_rows(batch: dict, rank: int, world: int) -> dict:
    """This rank's rows of every batch leaf (``P("data")`` on dim 0)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"batch leaf {k!r} of {v.shape[0]} rows does "
                             f"not split over {world} ranks")
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def make_dp_train_step(loss_fn, update_fn, mesh, *, plan: dict | None = None,
                       compress: bool = True):
    """Build a DP-only train step with explicit (compressed) grad sync.

    loss_fn(params, batch) -> scalar;
    update_fn(params, grads, opt_state) -> (params', opt_state', metrics)
    (the port's in-place ``adamw_update``).  ``step(params, opt_state,
    residuals, batch)`` takes the global batch and runs this rank's rows
    of it (dim 0 over "data"); params and opt_state are replicated;
    residuals are this rank's ``[1, ...]`` block (:func:`init_residuals`).
    Returns ``(params, opt_state, residuals, metrics)``; ``metrics`` adds
    ``loss`` (the mean over ranks) and the host seconds of the forward
    and backward (``fwd_bwd_s``), the all-reduce (``allreduce_s``) and
    the update (``opt_s``), each ending in a read of its result, and
    ``allreduce_launches``: the tile kernels' launches inside the
    all-reduce (``kernels.ops.LAUNCHES``, apart from the optimizer's).
    """
    group = mesh.get_group("data")
    rank = mesh.get_local_rank("data")
    world = dist.get_world_size(group)

    def step(params, opt_state, residuals, batch):
        t0 = time.perf_counter()
        local = _local_rows(batch, rank, world)
        leaves = [t.requires_grad_() for t in P.leaves(params)]
        loss = loss_fn(params, local)
        grads = P.unflatten(params, torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True))
        loss = loss.detach().to(torch.float32).reshape(1)
        float(loss[0])                              # waits for the backward
        t1 = time.perf_counter()
        before = {k: ops.LAUNCHES[k] for k in ("bdi_compress",
                                               "bdi_decompress")}
        if compress:
            res_local = P.tree_map(lambda r: r[0], residuals)
            tree_all_reduce(grads, res_local, group, plan)
        else:
            for g in P.leaves(grads):
                g.copy_(all_reduce_raw(g, group, None)[0])
        launches = {k: ops.LAUNCHES[k] - v for k, v in before.items()}
        last = P.leaves(grads)[-1]
        float(last.reshape(-1)[-1])                 # waits for the reduce
        t2 = time.perf_counter()
        params, opt_state, metrics = update_fn(params, grads, opt_state)
        del grads
        metrics = {k: float(v) for k, v in metrics.items()}
        t3 = time.perf_counter()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        metrics.update(
            loss=float(loss[0] / torch.full_like(loss[0], float(world))),
            fwd_bwd_s=t1 - t0, allreduce_s=t2 - t1, opt_s=t3 - t2,
            allreduce_launches=launches)
        return params, opt_state, residuals, metrics

    return step
