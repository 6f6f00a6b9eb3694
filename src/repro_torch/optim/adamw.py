"""AdamW with optionally BDI-compressed moment state (port of
``repro/optim/adamw.py``).

Optimizer moments are pure capacity in device memory — the thesis'
"effective capacity" target.  ``moment_dtype``:

  * ``f32``  — classic AdamW (reference);
  * ``bf16`` — moments stored in bf16;
  * ``bdi8`` — moments stored as BDI value-space tiles (int8 deltas, f32
    base and scale, a 16-byte mask per 128-element tile: 152 bytes for
    512, ~3.4x smaller than f32): compressed after the update,
    decompressed before use.  On the card the two tile kernels do it
    (``kernels.ops.compress``/``decompress``: ``csrc/bdi_compress_tile.cu``,
    ``bdi_decompress_tile.cu``), their plain versions for CPU tensors;
  * ``q8``   — zero-base-only BDI: int8 deltas and a power-of-two scale
    per tile, plain tensor ops.

All update math runs in f32 regardless of storage.

The state has the JAX package's layout leaf for leaf: ``{"step": int32
[], "m": tree, "v": tree}``, a ``bdi8`` moment ``{"deltas": int8 [...,
D/128, 128], "base": f32 [..., D/128], "scale": f32 [..., D/128],
"maskp": uint8 [..., D/128, 16]}`` (a ``q8`` one ``deltas`` and
``scale``); leaves whose last dim is not a multiple of 128 stay f32.
One difference: while training, ``maskp`` holds the tile kernels' bit
planes (``kernels/ref.py``), so a step stores and loads it as the
kernels write and read it; JAX's state holds
``core.bdi_value.pack_mask``'s byte layout.  :func:`export_state` and
:func:`import_state` convert between the two where a state leaves or
enters the port (a checkpoint, a state handed to or taken from the JAX
package), so states and checkpoints cross the packages.

Under tensor parallelism (a ``(1, m)`` mesh, ``distributed/tp.py``)
every tree here is this rank's shards: the moments are those of the
local params (equal to ``local_shards`` of the whole state, as JAX places
it with the params' specs), compressed and decompressed tile by tile on
the shard, and the clip norm sums, over the ``model`` axis, the sum of
squares of each leaf the rule table shards (``tp.sharded_leaves``, which
needs the whole params' shapes, ``whole=``), the replicated ones counting
once.  Under ``bdi8``/``q8`` a leaf whose tiles would straddle two shards
(``tp.check_moments``: its last dim split over ``model``, its tile count
not) keeps its whole moments on every rank, as JAX's rule table drops
``model`` from their tile dim: the update gathers the leaf's gradient
over ``model`` (2 bytes an element, fewer than gathering the f32 slices
of m and v or JAX's tile statistics, deltas and masks), updates the
whole moments, compresses whole tiles (kernel 4 on the card) and steps
this rank's columns of the param.

Under a ``(d, m)`` mesh (ZeRO-1, :func:`plan`; d the product of the
data axes, ``("pod", "data")`` on the multi-pod mesh) each rank keeps
the moments of one block of each leaf, whole tiles only: an FSDP leaf's
data block, or a block of a leaf whole over ``data`` whose moment the
rule table splits, which the rank updates alone and all-gathers over
``data`` afterwards.  A ``bdi8``/``q8`` leaf whose FSDP block lies along
its last dim with a tile count that d does not divide (arctic-480b's
``wo`` at the production mesh) keeps the moments of another dim's block,
the one the rule table splits the moment's ``deltas`` over: the rank
moves its gradient and param block there by an all-to-all over the data
axes, updates, and moves the param back.  The clip norm sums a leaf's
squares over each axis that splits it.  The update itself stays
elementwise.

Unlike the JAX version, :func:`adamw_update` writes the new params and
moments into the tensors it is given (at yi-6b's full width a second
copy of params and moments would not fit beside the gradients).  Leaves
of ``ndim >= 2`` and at least ``BIG_LEAF`` elements update in groups of
dim-0 rows of at most ``BIG_LEAF`` elements (one layer of a stacked
block leaf), which bounds the f32 temporaries to one group; JAX scans
them row by row over dim 0.  The update is elementwise and tiles lie
along the last dim, so the numbers are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.checkpoint.store import leaf_paths
from repro_torch.core import bdi_value as bv
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tp
from repro_torch.kernels import ops, ref
from repro_torch.models import params as P


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "f32"          # f32 | bf16 | bdi8 | q8


MOMENT_DTYPES = ("f32", "bf16", "bdi8", "q8")
BIG_LEAF = 1 << 24                     # elements; see the module docstring
_TILE = 128


# -- moment storage codecs ---------------------------------------------------

def to_byte_mask(maskp: torch.Tensor) -> torch.Tensor:
    """Bit-plane packed mask (the tile kernels', the live state's) ->
    ``pack_mask``'s byte layout (JAX's state's, the checkpoints')."""
    return bv.pack_mask(ref.unpack_mask_bitplane(maskp))


def to_bitplane_mask(maskp: torch.Tensor) -> torch.Tensor:
    """The reverse of :func:`to_byte_mask`."""
    return ref.pack_mask_bitplane(bv.unpack_mask(maskp))


def _convert_masks(tree, fn):
    """``tree`` with every ``bdi8`` mask converted by ``fn``, in chunks of
    ``BIG_LEAF`` elements' tiles (the unpacked mask is 8x the packed);
    the other leaves are shared, not copied."""
    if not isinstance(tree, dict):
        return tree
    if "maskp" not in tree:
        return {k: _convert_masks(v, fn) for k, v in tree.items()}
    src = tree["maskp"].reshape(-1, _TILE // 8)
    out = torch.empty_like(src)
    step = BIG_LEAF // _TILE
    for i in range(0, src.shape[0], step):
        out[i:i + step] = fn(src[i:i + step])
    return {**tree, "maskp": out.view(tree["maskp"].shape)}


def export_state(state: dict) -> dict:
    """The state as JAX holds it and checkpoints store it: ``bdi8`` masks
    in ``pack_mask``'s byte layout (new tensors; ``state`` is unchanged)."""
    return _convert_masks(state, to_byte_mask)


def import_state(state: dict) -> dict:
    """The reverse of :func:`export_state`: the live state of a state in
    JAX's layout (a checkpoint, ``params.from_numpy`` of JAX's state)."""
    return _convert_masks(state, to_bitplane_mask)


def _tiled(shape, kind: str) -> bool:
    # decided by the LAST dim only, so a group of rows keeps the storage
    # structure of the whole leaf
    return kind in ("bdi8", "q8") and len(shape) > 0 \
        and shape[-1] % _TILE == 0


def _codec(x: torch.Tensor, kernel, plain):
    """The tile codec for ``x``'s device: the kernel's wrapper (which
    launches the kernel on the card and takes the plain version on the
    CPU), or on ``meta`` (the dry run's shapes, where no op runs) the
    plain version, whose shapes and allocations the trace counts."""
    return plain if x.device.type == "meta" else kernel


def _store(x: torch.Tensor, kind: str):
    if kind == "f32":
        return x.to(torch.float32)
    if kind == "bf16":
        return x.to(torch.bfloat16)
    if kind not in ("bdi8", "q8"):
        raise ValueError(kind)
    if not _tiled(x.shape, kind):
        return x.to(torch.float32)     # small/odd leaves stay exact
    lead = (*x.shape[:-1], x.shape[-1] // _TILE)
    tiles = x.to(torch.float32).reshape(-1, _TILE)
    if kind == "q8":
        scale = bv._pow2_scale(tiles.abs().amax(dim=-1), 127.0)
        deltas = torch.clamp(torch.round(tiles / scale[:, None]), -127, 127)
        return {"deltas": deltas.to(torch.int8).view(*lead, _TILE),
                "scale": scale.view(lead)}
    p = _codec(tiles, ops.compress, ref.compress_ref)(tiles)
    return {"deltas": p.deltas.view(*lead, _TILE), "base": p.base.view(lead),
            "scale": p.scale.view(lead),
            "maskp": p.maskp.view(*lead, _TILE // 8)}


def _zero_store(p: torch.Tensor, kind: str, shape: tuple | None = None):
    """What :func:`_store` gives for zeros of ``p``'s shape, or of
    ``shape`` on ``p``'s device (a zero tile has base 0, scale 1, no mask
    bit), made without compressing."""
    if kind not in MOMENT_DTYPES:
        raise ValueError(kind)
    dev = p.device
    shape = tuple(p.shape) if shape is None else tuple(shape)
    if not _tiled(shape, kind):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        return torch.zeros(shape, dtype=dt, device=dev)
    lead = (*shape[:-1], shape[-1] // _TILE)
    out = {"deltas": torch.zeros((*lead, _TILE), dtype=torch.int8,
                                 device=dev),
           "scale": torch.ones(lead, dtype=torch.float32, device=dev)}
    if kind == "bdi8":
        out["base"] = torch.zeros(lead, dtype=torch.float32, device=dev)
        out["maskp"] = torch.zeros((*lead, _TILE // 8), dtype=torch.uint8,
                                   device=dev)
    return out


def _load(s, shape) -> torch.Tensor:
    if not isinstance(s, dict):
        return s.to(torch.float32)
    if "maskp" in s:
        packed = ref.PackedTiles(
            s["deltas"].reshape(-1, _TILE), s["base"].reshape(-1, 1),
            s["scale"].reshape(-1, 1), s["maskp"].reshape(-1, _TILE // 8),
            None)
        tiles = _codec(packed.deltas, ops.decompress,
                       ref.decompress_ref)(packed)
    else:
        tiles = s["deltas"].to(torch.float32) * s["scale"][..., None]
    return tiles.reshape(shape)


class Leaf(NamedTuple):
    """Where a leaf lies under a data axis: split over ``model`` (its
    squares summed over it); ``data``, the dim of its FSDP block (its
    squares summed over ``data``) or None; ``owner``, the dim along which
    this rank updates and stores the moments of 1/d of the leaf, or None
    (every rank updates the whole leaf, bit for bit alike).  ``owner``
    differs from a set ``data`` where the leaf's moment tiles straddle
    its data blocks: the rank moves its gradient and param from the one
    block to the other (:func:`tp.all_to_all`)."""
    model: bool
    data: int | None
    owner: int | None


def _wide(shape, straddles: bool) -> tuple:
    """A moment's shape for a rank's block ``shape`` of a leaf: whole over
    ``model`` (the last dim times the axis) where its tiles straddle the
    model shards (``tp.check_moments``), as the rule table keeps it."""
    shape = tuple(shape)
    if not straddles:
        return shape
    return (*shape[:-1], shape[-1] * tp.model_size())


def _straddle_owner(path: str, w, shard: list, mesh, d: int
                    ) -> int | None:
    """The dim whose data blocks a rank updates for a leaf whose FSDP block
    lies along its tiled last dim but whose tiles straddle those blocks:
    the dim the rule table splits the moment's ``deltas`` over (as JAX's
    ``_spec_for`` gives a moment leaf its own spec, ``_MOMENT_SUFFIX``),
    where that is a dim of the leaf other than the last; else the largest
    other dim that divides d; else None (no dim but the last divides:
    every rank updates the whole leaf over the data axes)."""
    nd = len(shard)
    tiles = (*w.shape[:-1], w.shape[-1] // _TILE, _TILE)
    dspec = SH._spec_for(f"['m']{path}['deltas']", tiles, mesh, 1, True)
    dd = SH.data_dim(dspec)
    if dd is not None and dd < nd - 1:
        return dd
    cands = [i for i in range(nd - 1) if shard[i] % d == 0]
    return max(cands, key=lambda i: shard[i]) if cands else None


def plan(params: dict, whole: dict | None, cfg: AdamWConfig
         ) -> list[Leaf] | None:
    """Each leaf's :class:`Leaf` under the active mesh's data axes (None
    without one).  ``whole``: the whole params' shapes (``meta`` tensors).

    ZeRO-1 on whole tiles: a rank owns one block of each parameter and
    keeps the moments of exactly that block: an FSDP leaf's data block
    (``sharding.param_specs(fsdp=True)``; for a stacked leaf split along
    its layer dim, the rank's L/d layers, whose tiles lie inside a
    layer); for a leaf whole over ``data``
    whose rule-table spec or whose moment's (f32 and bf16 moments have
    the leaf's shape) splits it over ``data``, that dim's block, which it
    updates and then all-gathers over ``data``.  A ``bdi8``/``q8`` leaf
    whose FSDP block lies along its last dim, with a tile count that does
    not divide d (arctic-480b's ``wo`` at the production mesh: 56 tiles
    over 16), owns the block of another dim (:func:`_straddle_owner`),
    whole tiles over all of the last dim; where no other dim divides d
    (arctic-480b's dense residual ``down`` on the multi-pod mesh: 56 tiles
    over 32, 304 rows) it owns none and updates the whole leaf over the
    data axes, as every rank does a leaf whole over them.  A rank thus
    stores at most the rule table's share of every moment leaf but those,
    and the blocks gathered give JAX's whole state."""
    d = tp.data_size()
    if d == 1:
        return None
    if whole is None:
        raise TypeError("under a data axis the optimizer needs the whole "
                        "params' shapes (whole=, a tree of meta tensors)")
    mesh = AX.current_mesh()
    kind = cfg.moment_dtype
    out = []
    for (path, model, data), (_, w), p, wide in zip(
            tp.placement(whole, params), leaf_paths(whole),
            P.leaves(params), tp.check_moments(params, kind)):
        spec = SH._spec_for(path, tuple(w.shape), mesh, w.element_size(),
                            True)
        owner = SH.data_dim(spec)
        if owner is None and not _tiled(w.shape, kind):
            # a moment of the leaf's shape (f32 or bf16) that the rule
            # table splits, the leaf not; a tile store never is (its
            # bytes are at most the leaf's)
            owner = SH.data_dim(SH._spec_for(
                f"['m']{path}", tuple(w.shape), mesh,
                2 if kind == "bf16" else 4, True))
        shard = list(_wide(p.shape, wide))  # the leaf's moment, whole
        if data is not None:                 # over data
            shard[data] *= d
        if owner == len(shard) - 1 and _tiled(shard, kind) and \
                (shard[-1] // d) % _TILE:
            owner = _straddle_owner(path, w, shard, mesh, d)
        out.append(Leaf(model, data, owner))
    return out


def _moment_shape(p: torch.Tensor, leaf: Leaf | None, wide: bool) -> tuple:
    """The shape of the part of a rank's leaf ``p`` whose moments it
    keeps (:func:`plan`): the 1/d block along the owner dim, whole along
    a data dim that differs from it; whole over ``model`` where the tiles
    straddle the model shards."""
    shape = list(_wide(p.shape, wide))
    if leaf is not None and leaf.owner != leaf.data:
        if leaf.data is not None:
            shape[leaf.data] *= tp.data_size()
        if leaf.owner is not None:
            shape[leaf.owner] //= tp.data_size()
    return tuple(shape)


def _owned(p: torch.Tensor, leaf: Leaf | None) -> torch.Tensor:
    """The part of a rank's leaf ``p`` (a param or its gradient) whose
    moments it keeps: ``p`` itself where it owns its block, the 1/d block
    along the owner dim of a leaf whole over ``data``, or the block of the
    owner dim over all of the data dim, moved by an all-to-all over the
    data axes."""
    if leaf is None or leaf.owner == leaf.data:
        return p
    if leaf.owner is None:              # the whole over the data axes
        return tp.all_gather(p, leaf.data, "data")
    if leaf.data is None:
        n = p.shape[leaf.owner] // tp.data_size()
        return p.narrow(leaf.owner, tp.data_rank() * n, n)
    return tp.all_to_all(p, leaf.owner, leaf.data)


def _returned(pb: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    """The rank's own block of the updated part ``pb`` (:func:`_owned`):
    the blocks gathered over the data axes (a leaf whole over them), moved
    back by an all-to-all, or cut from the whole."""
    if leaf.data is None:
        return tp.all_gather(pb, leaf.owner, "data")
    if leaf.owner is not None:
        return tp.all_to_all(pb, leaf.data, leaf.owner)
    n = pb.shape[leaf.data] // tp.data_size()
    return pb.narrow(leaf.data, tp.data_rank() * n, n)


def adamw_init(params: dict, cfg: AdamWConfig,
               whole: dict | None = None) -> dict:
    """Zero moments for ``params`` (on each leaf's device; shapes only,
    so a tree of ``meta`` tensors sizes a state without allocating).
    Under a data axis, ``whole`` (the whole params' shapes) is needed:
    the moments are those of this rank's blocks (:func:`plan`)."""
    wide = tp.check_moments(params, cfg.moment_dtype)
    lay = plan(params, whole, cfg)
    leaves = P.leaves(params)
    shapes = [_moment_shape(p, None if lay is None else lay[i], wide[i])
              for i, p in enumerate(leaves)]
    step_dev = leaves[0].device

    def zeros():
        return P.unflatten(params, [
            _zero_store(p, cfg.moment_dtype, s)
            for p, s in zip(leaves, shapes)])
    return {"step": torch.zeros((), dtype=torch.int32, device=step_dev),
            "m": zeros(), "v": zeros()}


# -- the update ----------------------------------------------------------------

def _groups(t: torch.Tensor):
    """Row ranges of dim 0 that one update handles at a time."""
    if t.dim() < 2 or t.numel() < BIG_LEAF:
        return [(0, t.shape[0] if t.dim() else None)]
    rows = max(1, BIG_LEAF // (t.numel() // t.shape[0]))
    return [(r, min(r + rows, t.shape[0])) for r in range(0, t.shape[0], rows)]


def _rows(s, r0: int, r1: int | None):
    if r1 is None:
        return s
    if isinstance(s, dict):
        return {k: v[r0:r1] for k, v in s.items()}
    return s[r0:r1]


def _sumsq(g: torch.Tensor) -> torch.Tensor:
    """Sum of squares in f32, a group of rows at a time for big leaves."""
    total = torch.zeros((), dtype=torch.float32, device=g.device)
    for r0, r1 in _groups(g):
        total = total + _rows(g, r0, r1).to(torch.float32).square().sum()
    return total


def _global_norm(grads: list[torch.Tensor],
                 axes: list[tuple[str, ...]] | None = None) -> torch.Tensor:
    """sqrt of the leaves' sums of squares added in leaf order, where a
    leaf split over an axis (``axes``, by leaf) adds its sum over that
    axis: one all-reduce of those leaves' stacked sums over ``model``,
    then one over ``data`` (JAX issues tuples of them)."""
    sq = [_sumsq(g) for g in grads]
    for axis in tp.AXES:
        idx = [i for i, a in enumerate(axes or ()) if axis in a]
        if not idx:
            continue
        both = torch.stack([sq[i] for i in idx])
        summed = tp.reduce_from_model(both) if axis == "model" else \
            tp.all_reduce(both, "data")
        for j, i in enumerate(idx):
            sq[i] = summed[j]
    return torch.sqrt(sum(sq))


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                 whole: dict | None = None):
    """One AdamW step.  Writes the new params and moments into ``params``
    and ``state``'s tensors and returns ``(params, state', metrics)``,
    ``state'`` holding the new step counter.  Under a data axis (``whole``
    as for :func:`adamw_init`) a rank updates its blocks (:func:`plan`)
    and all-gathers over ``data`` those of the leaves whole over it."""
    wide = tp.check_moments(params, cfg.moment_dtype)
    lay = plan(params, whole, cfg)
    step = state["step"] + 1
    gs = P.leaves(grads)
    if lay is None and tp.model_size() > 1:
        if whole is None:
            raise TypeError("under a model axis the optimizer needs the "
                            "whole params' shapes (whole=, a tree of meta "
                            "tensors) for the clip norm")
        axes = [("model",) if s else ()
                for s in tp.sharded_leaves(whole, params)]
    elif lay is None:
        axes = None
    else:
        axes = [("model",) * leaf.model + ("data",) * (leaf.data is not None)
                for leaf in lay]
    gnorm = _global_norm(gs, axes)
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / (gnorm + 1e-9), max=1.0) if cfg.grad_clip else 1.0
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    kind = cfg.moment_dtype

    def upd(p, g, m_s, v_s):
        # g and the moments may be whole over model where p is this
        # rank's columns (a straddling leaf): the moments update whole,
        # the param its columns
        g = g.to(torch.float32) * scale
        m = cfg.b1 * _load(m_s, g.shape) + (1 - cfg.b1) * g
        v = cfg.b2 * _load(v_s, g.shape) + (1 - cfg.b2) * g * g
        _copy_into(m_s, _store(m, kind))
        _copy_into(v_s, _store(v, kind))
        if g.shape != p.shape:
            w = p.shape[-1]
            m, v = (t.narrow(-1, tp.model_rank() * w, w) for t in (m, v))
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - cfg.lr * delta).to(p.dtype))

    for i, (p, g, m_s, v_s) in enumerate(zip(P.leaves(params), gs,
                                             _store_leaves(state["m"]),
                                             _store_leaves(state["v"]))):
        leaf = None if lay is None else lay[i]
        pb, gb = _owned(p, leaf), _owned(g, leaf)
        if wide[i]:                       # every rank its whole moments
            gb = tp.all_gather(gb, -1, "model")
        for r0, r1 in _groups(gb):
            upd(*(_rows(t, r0, r1) for t in (pb, gb, m_s, v_s)))
        if pb is not p:
            p.copy_(_returned(pb, leaf))
    return params, {"step": step, "m": state["m"], "v": state["v"]}, {
        "grad_norm": gnorm, "clip_scale": scale}


def _store_leaves(tree: dict) -> list:
    """Moment leaves in ``jax.tree.leaves`` order of the params, a tile
    store (a dict with ``deltas``) as one."""
    return [leaf for k in sorted(tree)
            for leaf in (_store_leaves(tree[k]) if isinstance(tree[k], dict)
                         and "deltas" not in tree[k] else [tree[k]])]


def opt_state_bytes(state: dict, cfg: AdamWConfig) -> int:
    """Storage accounting for the moment state."""
    return sum(t.numel() * t.element_size()
               for t in P.leaves(state["m"]) + P.leaves(state["v"]))
