"""Multi-pod dry run of the port: trace one (arch x shape x mesh) cell on
the ``meta`` device (port of ``repro/launch/dryrun.py``).

JAX's dry run lowers and compiles a cell for 256 (or 512) placeholder CPU
devices and reads XLA's memory and cost analyses and the compiled HLO.
PyTorch has no placeholder-device compile.  The port counts one level
down, at PyTorch's dispatcher, on the ``meta`` device, where a tensor has
a shape and a dtype and no data:

  * train cells run :func:`build_train_step`'s step (forward, backward
    and AdamW over ``MICROBATCHES`` microbatches), prefill cells
    ``model.prefill``, decode cells one ``decode_step`` at t = seq_len - 1
    against a seq_len cache (the quantised one under ``--kv-compressed``),
    each on meta tensors under :class:`Count`: PyTorch's
    ``FlopCounterMode`` for the FLOPs and a tracker of live storages for
    the peak, with ``models/trips`` multipliers for the Python loops whose
    trips grow with the sequence (as JAX's ``_parse_hlo`` multiplies a
    ``while`` body by its trip count);
  * argument, output and alias bytes come from shapes, dtypes and
    ``sharding.param_specs`` / ``batch_specs`` / ``cache_specs`` on the
    abstract production mesh (``launch/mesh.production_axes``), with
    donation as JAX's ``donate_argnums`` and XLA's conventions: an input
    the step neither reads nor returns is no argument (``jit`` drops it),
    an output tuple adds 8 bytes a leaf, logits come out over the data
    axes and, where the vocabulary divides, the model axis.

No op of the model executes anywhere, as JAX's dry run compiles and
runs nothing: it needs no card and gives the same rows on any host.
Where JAX's figures are per device under GSPMD, the port's are a rank's:
the step runs at one coordinate of the mesh (0 on every axis unless the
caller picks another, ``launch/elastic.abstract_mesh(coord=)``) on that
rank's own tensors: its blocks of the params under the rule table
(``sharding.local_params``, FSDP blocks unless ``--no-fsdp``, for train,
prefill and decode alike, as JAX's ``lower_cell`` places them), its ZeRO-1
optimizer state (``optim/adamw.plan``), its rows of the batch and its
blocks of the caches (``tp.cache_blocks``).  Every collective of
``distributed/tp.py`` is counted there and sends nothing (a ``meta``
tensor under an abstract mesh): ``collectives`` is the rank's, in JAX's
``collective_bytes`` schema, and ``traced_flops`` and
``temp_size_in_bytes`` are the rank's program's.  Where a microbatch's
rows do not divide over the data axes, a rank runs each microbatch at the
rows rounded up, as XLA pads a dimension it cannot divide; where the
batch's rows do not divide them, every rank runs them all, as
``batch_specs`` replicates them.  Where ranks' programs differ, the row
says how (``rank``).

The HLO parsers (``_parse_hlo``, ``hlo_cost``, ``collective_bytes``,
``_shape_bytes``) are not ported: they read XLA's text, and the port
makes none.  The counters above do their work; the keys only XLA can
give are null and listed under ``not_measured`` with the reason.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape train_4k [--multi-pod] [--microbatches N] [--sp] \\
      [--out out.json]
"""

from __future__ import annotations

import argparse
import json
import re
import time
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.checkpoint.store import leaf_paths
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      applicable_shapes)
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import compress_comm as CC
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tp
from repro_torch.distributed.axes import P, mesh_axes
from repro_torch.launch.elastic import abstract_mesh
from repro_torch.launch.mesh import production_axes
from repro_torch.models import frontends, trips
from repro_torch.models import params as PT
from repro_torch.models import transformer as T
from repro_torch.models.api import ModelAPI, family_module, get_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

META = torch.device("meta")

# The JAX dry-run matrix's choices (repro/launch/dryrun.py:46-61), sized
# there for its TPU target's memory and kept here so that the rows of the
# two packages compare cell for cell: moment storage, gradient
# accumulation dtype and train_4k microbatches by arch.
MOMENT_DTYPE = {"arctic-480b": "q8"}
GRAD_ACC_DTYPE = {"arctic-480b": "bf16"}
MICROBATCHES = {
    "arctic-480b": 16, "internvl2-76b": 16, "gemma3-27b": 8,
    "qwen2.5-14b": 4, "yi-9b": 4, "yi-6b": 4, "deepseek-v2-lite-16b": 2,
    "hymba-1.5b": 4, "seamless-m4t-large-v2": 2, "xlstm-350m": 1,
}

NOT_MEASURED = {
    "lower_s": "the port lowers no program: PyTorch runs op by op "
               "(trace_s is the trace's wall time)",
    "compile_s": "the port compiles no program",
    "flops": "XLA's cost_analysis of a compiled program; traced_flops "
             "counts the port's operations",
    "bytes_accessed": "XLA's cost_analysis; an eager program has no "
                      "fusion plan that fixes its HBM traffic",
    "hlo_flops": "read from XLA's HLO text, which the port does not make "
                 "(traced_flops is its counterpart)",
    "hlo_bytes": "read from XLA's HLO text at its fusion boundaries",
    "seq_depth": "XLA's while-loop nesting; the port's loops are Python "
                 "(models/trips)",
    "generated_code_size_in_bytes": "XLA's executable; the port has none",
}
SCOPE = ("one rank of the mesh, at the coordinate in 'rank': its blocks of "
         "the params, optimizer state, batch and caches under the rule "
         "table (sharding.py); traced_flops, temp_size_in_bytes and "
         "collectives are that rank's program's, argument, output and "
         "alias bytes its share")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def build_train_step(model: ModelAPI, ocfg: AdamWConfig, n_micro: int = 1,
                     acc_dtype: torch.dtype = torch.float32,
                     whole: dict | None = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss and its gradients over ``n_micro`` microbatches (the batch's
    rows in order, as JAX's ``split_micro``), summed in ``acc_dtype`` and
    divided by ``n_micro``, then ``adamw_update`` (in place).  With one
    microbatch the gradients go to the update as they come, each in its
    leaf's dtype, as JAX's.  ``metrics`` adds ``loss``, the mean loss, as
    a tensor: the step runs on the card, the CPU and ``meta`` alike.

    Under a mesh, ``params`` and ``opt_state`` are a rank's blocks and
    ``batch`` its rows (``launch/train.make_train_step`` cuts them; the
    caller opens ``tp.whole_rows`` where they do not divide); the update
    needs the whole params' shapes, ``whole`` (the model's
    ``whole_shapes``, read at the first step where not given).
    ``on_grads``, a keyword of the step: called with the loss between the
    gradients and the update."""
    meta = {"params": whole}

    def whole_shapes():
        if tp.data_size() == 1 and tp.model_size() == 1:
            return None
        if meta["params"] is None:
            meta["params"] = family_module(model.cfg).whole_shapes(
                model.cfg)
        return meta["params"]

    def grads_of(params, batch):
        leaves = [t.requires_grad_() for t in PT.leaves(params)]
        loss = model.loss(params, batch)
        # a leaf the loss does not reach (xLSTM's idle cell in a block)
        # gets a zero gradient, as jax.grad gives it
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    def step(params, opt_state, batch, on_grads=None):
        shapes = whole_shapes()
        if n_micro == 1:
            loss, grads = grads_of(params, batch)
        else:
            rows = [v.shape[0] for v in batch.values()]
            if len(set(rows)) != 1 or rows[0] % n_micro:
                raise ValueError(f"batch rows {rows} do not split into "
                                 f"{n_micro} microbatches")
            grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for p in PT.leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=grads[0].device)
            for i in trips.steps(n_micro):
                mb = {k: v[i * (v.shape[0] // n_micro):
                           (i + 1) * (v.shape[0] // n_micro)]
                      for k, v in batch.items()}
                lm, gm = grads_of(params, mb)
                for a, g in zip(grads, gm):
                    # JAX adds g.astype(acc_dtype): a narrower accumulator
                    # takes g rounded first; a wider one adds it exactly
                    a.add_(g.to(a.dtype) if g.element_size()
                           > a.element_size() else g)
                del gm
                loss = loss + lm
            loss = loss / n_micro
            for a in grads:
                a.div_(n_micro)
        if on_grads is not None:
            on_grads(loss)
        params, opt_state, metrics = adamw_update(
            params, PT.unflatten(params, grads), opt_state, ocfg,
            whole=shapes)
        metrics["loss"] = loss
        return params, opt_state, metrics
    return step


# ---------------------------------------------------------------------------
# counting on meta tensors
# ---------------------------------------------------------------------------

def _seq_nr() -> int:
    """The sequence number the next autograd node made on this thread
    gets (nodes are numbered in the order the forward makes them)."""
    return torch._C._autograd._get_sequence_nr()


class Count(TorchDispatchMode):
    """FLOPs and the peak of live storages of what runs under it, with
    ``models/trips`` multipliers; only ``meta`` tensors carry data-sized
    work here (a CPU or CUDA result of more than one element raises, so
    nothing real runs with loops cut short).

    FLOPs are ``FlopCounterMode``'s, entered beneath this mode: each op's
    count is read as a difference and weighted by the product of the
    open trips' weights, or in the backward by those of the trips whose
    autograd nodes it runs.  Memory: a storage an op makes is live until
    its last tensor goes; ``peak`` is the most live at once.  Storages
    made before the count (the step's inputs) are not counted, nor are
    views and in-place results, which share an input's storage.  ``read``
    holds the storages that ops other than views take.
    """

    def __init__(self):
        super().__init__()
        self.fc = FlopCounterMode(display=False)
        self.extra_flops = 0
        self.live = self.peak = 0
        self._sizes: dict[int, int] = {}      # storage -> bytes counted
        self._refs: dict[int, weakref.ref] = {}
        self._made: list[set] = []            # storages of open weighted trips
        self._kept: list[set] = []            # and of those not yet scaled
        self._weight = 1                      # weight of the open trips
        self._ranges: list[tuple] = []        # weighted trips' nodes
        self._node_w: dict[int, int] = {}
        self.read: set[int] = set()           # taken by ops but views

    @property
    def flops(self) -> int:
        return self.fc.get_total_flops() + self.extra_flops

    def __enter__(self):
        self.fc.__enter__()
        super().__enter__()
        self._trips = trips.counting(self)
        self._trips.__enter__()
        return self

    def __exit__(self, *exc):
        self._trips.__exit__(*exc)
        super().__exit__(*exc)
        self.fc.__exit__(*exc)

    # -- trips ---------------------------------------------------------------

    def loop(self, n: int):
        """Trips 0, 1 and n - 1 of a loop of ``n`` > ``trips.TRACED``
        trips; trip 1 weighs n - 2 (``models/trips.py``)."""
        w, first, made = n - 2, set(), set()
        state = {"open": True}
        self._kept += [first, made]
        try:
            self._made.append(first)
            try:
                yield 0
            finally:
                self._made.pop()
            lo, prev = _seq_nr(), self._weight
            self._made.append(made)
            self._weight = prev * w
            try:
                yield 1
            finally:
                self._weight = prev
                self._made.pop()
            self._ranges.append((lo, _seq_nr(), w, state))
            self._node_w.clear()
            # trip n - 1 runs with trip 1's survivors alive throughout; in
            # the loop it stands for, n - 3 more trips' worth of them are
            saved, self.peak = self.peak, self.live
            yield n - 1
            added = (w - 1) * sum(self._sizes[k] for k in made)
            if added:
                self._add(first if any(self._sizes[k] for k in first)
                          else made, added)
            self.peak = max(saved, self.peak + added)
        finally:
            state["open"] = False
            self._node_w.clear()
            self._kept = [k for k in self._kept
                          if k is not first and k is not made]

    def _add(self, keys: set, added: int) -> None:
        """Count ``added`` more bytes as live, shared by the storages
        ``keys`` in proportion to their sizes, until each goes.  They are
        trip 0's survivors where it has any: a backward frees each trip's
        saved tensors in turn, trip 0's last, so that the n - 3 trips'
        worth stays counted until the last of them would go."""
        keys = sorted(keys)
        total, left = sum(self._sizes[k] for k in keys), added
        for i, k in enumerate(keys):
            extra = left if i == len(keys) - 1 \
                else added * self._sizes[k] // total
            self._sizes[k] += extra
            left -= extra
        self.live += added

    def _op_weight(self) -> int:
        w = self._weight
        if self._ranges and not torch.is_grad_enabled():
            # the backward proper (a recompute runs with grad enabled, and
            # under the trips it reruns)
            node = torch._C._current_autograd_node()
            if node is not None:
                seq = node._sequence_nr()
                nw = self._node_w.get(seq)
                if nw is None:
                    nw = 1
                    for lo, hi, rw, state in self._ranges:
                        # a loop still open runs its own backward inside
                        # its trips, already weighted
                        if lo <= seq < hi and not state["open"]:
                            nw *= rw
                    self._node_w[seq] = nw
                w *= nw
        return w

    # -- storages ------------------------------------------------------------

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)
        del self._refs[key]
        for made in self._kept:       # the address may be reused
            made.discard(key)

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        st = t.untyped_storage()
        key = _key(t)
        if key in self._sizes or key in inputs:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))
        for made in self._made:
            made.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        w = self._op_weight()
        before = self.fc.get_total_flops() if w != 1 else 0
        out = func(*args, **kwargs)
        if w != 1:
            self.extra_flops += (w - 1) * (self.fc.get_total_flops() - before)
        inputs = {_key(t) for t in _tensors((args, tuple(kwargs.values())))
                  if t.device.type == "meta"}
        if not func.is_view:
            self.read |= inputs
        for t in _tensors((out,)):
            if t.device.type == "meta":
                self._track(t, inputs)
            elif t.numel() > 1:
                raise ValueError(f"the dry run counts meta tensors only; "
                                 f"{func} made one on {t.device}")
        return out


def _tensors(xs):
    """The tensors in ``xs`` and in the lists and tuples inside it (an op's
    arguments and results)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


# ---------------------------------------------------------------------------
# bytes per rank
# ---------------------------------------------------------------------------

def _dp(mesh) -> int:
    sizes = mesh_axes(mesh)
    return int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))


def _rank_rows(rows: int, mesh) -> int:
    """A rank's rows of a batch dim of ``rows`` (``sharding.batch_specs``
    and ``cache_specs``: over the data axes where they divide)."""
    dp = _dp(mesh)
    return rows // dp if dp > 1 and rows % dp == 0 else rows


def _shard_bytes(t: torch.Tensor, spec, mesh) -> int:
    """A rank's bytes of ``t`` laid out as ``spec`` on ``mesh`` (a dim that
    does not divide takes its size rounded up, as XLA pads)."""
    sizes = mesh_axes(mesh)
    n = 1
    for i, d in enumerate(t.shape):
        s = spec[i] if i < len(spec) else None
        f = int(np.prod([sizes[a] for a in (
            () if s is None else s if isinstance(s, tuple) else (s,))]))
        n *= -(-d // f)
    return n * t.element_size()


def _tree_bytes(tree, specs, mesh, keep=None) -> int:
    """A rank's bytes of a tree under a tree of specs; ``keep(path, leaf)``
    picks the leaves counted."""
    return sum(_shard_bytes(t, s, mesh) for (path, t), (_, s) in zip(
        leaf_paths(tree), SH.spec_leaves(specs))
        if keep is None or keep(path, t))


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


# What a prefill or decode step takes and gives, as JAX's jit of it keeps
# them; :func:`trace` checks each against the step it traces.  A prefill
# reads every batch leaf but the loss's; an encoder-decoder's decode step
# reads neither the encoder nor the cross-attention's K/V projections (the
# cache holds the cross K/V); logits come in the activations' bf16, but
# xLSTM's prefill hands on its last decode step's logits in f32.
_LOSS_LEAVES = ("targets", "loss_mask")
_NOT_DECODED = re.compile(
    r"^\['enc_(blocks|norm)'\]|^\['dec_blocks'\]\['cross'\]\['w[kv]'\]")


def _takes(cfg: ArchConfig, kind: str, path: str) -> bool:
    """Whether the ``kind`` step of ``cfg`` takes the parameter at
    ``path`` as an argument."""
    return not (kind == "decode" and cfg.is_encdec
                and _NOT_DECODED.search(path))


def _logits_dtype(cfg: ArchConfig, kind: str) -> torch.dtype:
    return torch.float32 if kind == "prefill" and cfg.family == "ssm" \
        else torch.bfloat16


def _cache(model: ModelAPI, shape: ShapeConfig, rows: int,
           kv_compressed: bool):
    """The decode cache of ``rows`` rows on meta and the step that takes
    it (``decode_step_quant`` under ``kv_compressed``, as JAX's)."""
    cfg = model.cfg
    if kv_compressed:
        return (T.init_quant_cache(cfg, rows, shape.seq_len, device=META),
                lambda *a: T.decode_step_quant(cfg, *a))
    kw = {"enc_len": frontends.enc_len_for(cfg, shape)} if cfg.is_encdec \
        else {}
    return (model.init_cache(rows, shape.seq_len, device=META, **kw),
            model.decode_step)


def _batch(cfg: ArchConfig, shape: ShapeConfig, rows: int) -> dict:
    return frontends.batch_struct(cfg, ShapeConfig(
        shape.name, shape.seq_len, rows, shape.kind))


def io_bytes(model: ModelAPI, shape: ShapeConfig, mesh, ocfg: AdamWConfig,
             params: dict, *, kv_compressed: bool = False,
             fsdp: bool = True) -> dict:
    """``argument_size_in_bytes``, ``output_size_in_bytes`` and
    ``alias_size_in_bytes`` of a rank under JAX's jit of the cell's step:
    train ``(params, opt_state, batch) -> (params, opt_state, metrics)``
    donating params and state; prefill ``(params, batch) -> (logits,
    cache)``; decode ``(params, cache, token, t) -> (logits, cache)``
    donating the cache.  ``params`` is the model's tree on meta."""
    cfg = model.cfg
    psp = SH.param_specs(params, mesh, fsdp=fsdp)
    p_args = _tree_bytes(params, psp, mesh,
                        keep=lambda path, _: _takes(cfg, shape.kind, path))
    if shape.kind == "train":
        opt = adamw_init(params, ocfg)
        o = _tree_bytes(opt, SH.param_specs(opt, mesh, fsdp=fsdp), mesh)
        batch = frontends.batch_struct(cfg, shape)
        b = _tree_bytes(batch, SH.batch_specs(batch, mesh), mesh)
        n_out = len(leaf_paths(params)) + len(leaf_paths(opt)) + 3
        # metrics: grad_norm, clip_scale and loss, f32 scalars
        return {"argument_size_in_bytes": p_args + o + b,
                "output_size_in_bytes": p_args + o + 3 * 4 + 8 * n_out,
                "alias_size_in_bytes": p_args + o}
    rows = shape.global_batch
    if shape.kind == "prefill":
        batch = frontends.batch_struct(cfg, shape)
        args = p_args + _tree_bytes(
            batch, SH.batch_specs(batch, mesh), mesh,
            keep=lambda path, _: path not in {f"[{k!r}]"
                                              for k in _LOSS_LEAVES})
        kw = {"enc_len": frontends.enc_len_for(cfg, shape)} \
            if cfg.is_encdec else {}
        cache = model.init_cache(rows, shape.seq_len, device=META, **kw)
    else:
        cache, _ = _cache(model, shape, rows, kv_compressed)
    c = _tree_bytes(cache, SH.cache_specs(cache, mesh), mesh)
    if shape.kind == "decode":
        token = torch.empty((rows,), dtype=torch.int32, device=META)
        # the cache, the token and t (an int32 scalar)
        args = p_args + c + _shard_bytes(
            token, SH.batch_specs({"t": token}, mesh)["t"], mesh) + 4
    sizes = mesh_axes(mesh)
    logits = torch.empty((rows, cfg.vocab), device=META,
                         dtype=_logits_dtype(cfg, shape.kind))
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    lspec = P(dp if _rank_rows(rows, mesh) != rows else None,
              "model" if sizes.get("model", 1) > 1
              and cfg.vocab % sizes["model"] == 0 else None)
    n_out = 1 + len(leaf_paths(cache))
    return {"argument_size_in_bytes": args,
            "output_size_in_bytes": _shard_bytes(logits, lspec, mesh) + c
            + 8 * n_out,
            "alias_size_in_bytes": c if shape.kind == "decode" else 0}


def _check_io(cfg: ArchConfig, kind: str, params: dict, batch: dict,
              read: set, logits: torch.Tensor) -> None:
    """The traced step read no input that :func:`io_bytes` leaves out,
    and its logits have the dtype it counts."""
    extra = [path for path, t in leaf_paths(params)
             if _key(t) in read and not _takes(cfg, kind, path)]
    extra += [k for k, t in batch.items()
              if k in _LOSS_LEAVES and _key(t) in read]
    if extra or logits.dtype != _logits_dtype(cfg, kind):
        raise AssertionError(
            f"{cfg.name} {kind}: the step reads {extra} and gives "
            f"{logits.dtype} logits; io_bytes counts neither")


def param_bytes(params: dict) -> int:
    return sum(t.numel() * t.element_size() for t in PT.leaves(params))


def _nbytes(tree) -> int:
    """The bytes of the tensors of a tree (none for None)."""
    return 0 if tree is None else sum(
        t.numel() * t.element_size() for _, t in leaf_paths(tree))


def dp_collectives(params: dict) -> dict:
    """What the port's compressed DP step (``compress_comm.
    make_dp_train_step``, a pure data-parallel run with whole weights, not
    the production mesh's step) puts on the wire a step, per rank, in
    JAX's ``collective_bytes`` shape:
    every gradient leaf compressed (one all-gather of its payload a row
    group) and the loss's all-reduce; ``raw`` is the uncompressed step's
    (one all-reduce a leaf, f32 ``wire_bytes``); ``leaves`` both per
    leaf."""
    per_leaf = {path: {"raw": CC.wire_bytes(t.shape, False),
                       "compressed": CC.wire_bytes(t.shape, True)}
                for path, t in leaf_paths(params)}
    comp = sum(v["compressed"] for v in per_leaf.values())
    raw = sum(v["raw"] for v in per_leaf.values())
    groups = sum(len(CC._groups(t)) for t in PT.leaves(params))
    return {"all-gather": comp, "all-reduce": 4,
            "counts": {"all-gather": groups, "all-reduce": 1},
            "total": comp + 4,
            "raw": {"all-reduce": raw + 4,
                    "counts": {"all-reduce": len(per_leaf) + 1},
                    "total": raw + 4},
            "leaves": per_leaf}


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------

def collectives(counts: dict) -> dict:
    """A rank's ``tp.COUNTS`` over a step (``tp.counts_since``) in JAX's
    ``collective_bytes`` schema: input bytes by kind, ``total`` and
    ``counts``, over both axes; ``by_axis`` the counts themselves."""
    kinds = {op: op.replace("_", "-") for op in tp.OPS}
    out = {k: sum(c[f"{op}_bytes"] for c in counts.values())
           for op, k in kinds.items()}
    out["total"] = sum(out.values())
    out["counts"] = {k: sum(c[op] for c in counts.values())
                     for op, k in kinds.items()}
    out["by_axis"] = counts
    return out


def _differs(cfg: ArchConfig, shape: ShapeConfig, mesh, cache) -> list:
    """How other ranks' programs differ from the traced one's."""
    out = []
    d, sizes = _dp(mesh), mesh_axes(mesh)
    if d > 1 and shape.global_batch % d:
        out.append(f"the batch's {shape.global_batch} rows do not divide "
                   f"the data axes of {d}: every rank runs all of them "
                   f"(batch_specs replicates them)")
    m = sizes.get("model", 1)
    if shape.kind == "decode" and m > 1 and any(
            s[2] == "model" for _, s in SH.spec_leaves(
                SH.cache_specs(cache, tp.model_axis()))
            if len(s) == 5):
        t = shape.seq_len - 1
        out.append(f"the cache is split over T: row t = {t} is written "
                   f"(tp.write_row) by the rank whose T block holds it, "
                   f"model coordinate {t * m // shape.seq_len}")
    return out


def trace(cfg: ArchConfig, shape: ShapeConfig, mesh, ocfg: AdamWConfig,
          n_micro: int, acc_dtype: torch.dtype, *,
          kv_compressed: bool = False, fsdp: bool = True,
          batch: dict | None = None, sp: bool = False) -> dict:
    """The dry-run row of one cell: ``cfg`` x ``shape`` on ``mesh`` (an
    abstract mesh, ``launch/elastic.abstract_mesh``, whose ``coord`` is
    the rank traced), everything on meta.  ``batch``: a train step's
    whole batch (``meta`` tensors of ``shape``'s rows) in place of
    ``frontends.batch_struct``'s, such as a data stream's without its
    frontend embeds; the rank takes its rows.  ``sp``: the sequence-
    parallel residual stream, switched on or off for the process
    (``axes.set_sp``) on every call, as JAX's ``lower_cell`` switches it:
    it changes the train step's forward and backward only (the models'
    prefill and decode never split the stream)."""
    t0 = time.perf_counter()
    AX.set_sp(sp)
    model = get_model(cfg)
    # the model's own tree of whole shapes, made here and not inside the
    # count, where its storages would count as live
    whole = family_module(cfg).whole_shapes(cfg)
    io = io_bytes(model, shape, mesh, ocfg, whole,
                  kv_compressed=kv_compressed, fsdp=fsdp)
    rows = _rank_rows(shape.global_batch, mesh)
    d = _dp(mesh)
    cache = None
    with AX.use_mesh(mesh), tp.whole_rows(d > 1 and rows
                                          == shape.global_batch):
        tp.check_layout(cfg)
        params = SH.local_params(whole, mesh, fsdp=fsdp)
        opt = adamw_init(params, ocfg, whole=whole) \
            if shape.kind == "train" else None
        c0 = tp.counts()
        if shape.kind == "train":
            batch = _batch(cfg, shape, -(-rows // n_micro) * n_micro) \
                if batch is None else SH.local_batch(batch, mesh)
            step = build_train_step(model, ocfg, n_micro, acc_dtype, whole)
            with Count() as count:
                step(params, opt, batch)
        else:
            if shape.kind == "prefill":
                batch = _batch(cfg, shape, rows)
                with Count() as count:
                    logits, _ = model.prefill(params, batch, shape.seq_len)
            else:
                cache, decode = _cache(model, shape, rows, kv_compressed)
                token = torch.empty((rows,), dtype=torch.int32, device=META)
                batch = {"token": token}
                with Count() as count:
                    logits, _ = decode(params, cache, token,
                                       shape.seq_len - 1)
            _check_io(cfg, shape.kind, params, batch, count.read, logits)
        coll = collectives(tp.counts_since(c0))
        held = {"params": _nbytes(params), "opt_state": _nbytes(opt),
                "inputs": _nbytes(batch) + _nbytes(cache)}
        differs = _differs(cfg, shape, mesh, cache)
    sizes = mesh_axes(mesh)
    row = {
        "arch": cfg.name, "shape": shape.name,
        "microbatches": n_micro if shape.kind == "train" else 0,
        "mesh": "x".join(str(v) for v in sizes.values()),
        "n_devices": int(np.prod(list(sizes.values()))),
        "lower_s": None, "compile_s": None,
        "param_bytes_global": param_bytes(whole),
        "flops": None, "bytes_accessed": None, "hlo_flops": None,
        "hlo_bytes": None, "seq_depth": None,
        "collectives": coll,
        **io,
        "temp_size_in_bytes": count.peak,
        "generated_code_size_in_bytes": None,
        "traced_flops": count.flops,
        "trace_s": time.perf_counter() - t0,
        "rank": {"coordinate": {a: mesh.get_local_rank(a) for a in sizes},
                 "differs": differs, "held_bytes": held},
        "not_measured": NOT_MEASURED,
        "scope": SCOPE,
    }
    if shape.kind == "train":
        row["dp_compressed"] = dp_collectives(whole)
    return row


def trace_cell(arch_name: str, shape_name: str, multi_pod: bool, *,
               kv_compressed: bool = False, fsdp: bool = True,
               remat: bool = True, microbatches: int | None = None,
               sp: bool = False) -> dict:
    """JAX's ``lower_cell``: the row of one cell of the production matrix.
    ``remat`` is taken for JAX's signature, where it is unused too (the
    models checkpoint every layer).  ``sp``: the sequence-parallel
    residual stream (``--sp``), each layer's input and output this rank's
    block of S/m positions."""
    del remat
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    if shape_name not in applicable_shapes(cfg):
        raise SystemExit(f"SKIP: {shape_name} not applicable to {arch_name} "
                         "(full-attention arch; see DESIGN.md)")
    ocfg = AdamWConfig(moment_dtype=MOMENT_DTYPE.get(cfg.name, "f32"))
    n_micro = microbatches if microbatches is not None else \
        MICROBATCHES.get(cfg.name, 1)
    acc = torch.bfloat16 if GRAD_ACC_DTYPE.get(cfg.name) == "bf16" \
        else torch.float32
    return trace(cfg, shape, abstract_mesh(*production_axes(multi_pod)),
                 ocfg, n_micro, acc, kv_compressed=kv_compressed, fsdp=fsdp,
                 sp=sp)


def run(arch: str, shape: str, multi_pod: bool, out: str | None = None,
        **kw) -> dict:
    info = trace_cell(arch, shape, multi_pod, **kw)
    print("=== collective bytes (per rank, the mesh's step) ===")
    print(info["collectives"])
    print("=== not measured ===")
    print(json.dumps(info["not_measured"], indent=1))
    if out:
        with open(out, "w") as f:
            json.dump(info, f, indent=1)
    print("=== summary ===")
    print(json.dumps({k: v for k, v in info.items()
                      if k not in ("collectives", "dp_compressed",
                                   "not_measured")}, indent=1))
    return info


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kv-compressed", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--mamba-chunked", action="store_true")
    args = ap.parse_args()
    if args.mamba_chunked:
        from repro_torch.models import ssm
        ssm.CHUNKED_SCAN = True
    run(args.arch, args.shape, args.multi_pod, args.out,
        kv_compressed=args.kv_compressed, fsdp=not args.no_fsdp,
        microbatches=args.microbatches, sp=args.sp)


if __name__ == "__main__":
    main()
