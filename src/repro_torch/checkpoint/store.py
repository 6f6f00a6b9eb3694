"""Fault-tolerant checkpointing with BDI-compressed streams (port of
``repro/checkpoint/store.py``).

The on-disk format is the JAX package's, byte for byte, so a checkpoint
written by either package loads in the other:

  * atomic — staged in ``<dir>/.tmp-<step>`` and published as
    ``<dir>/step_{step:010d}`` with one ``os.replace``;
  * verified — every tensor file ``{i:05d}.{codec}`` carries a SHA-256 in
    ``manifest.json``, checked on restore (``IOError`` on a mismatch);
  * compressed — each leaf's bytes go through the lossless BDI stream
    codec (``core/bdi_exact.compress_stream``) and are stored compressed
    only when that wins by ``ec_min_ratio`` (the EC-style gate).

Leaves are named as ``jax.tree_util.keystr`` names them and numbered in
``tree_flatten_with_path`` order, computed here without jax
(:func:`leaf_paths`): dict keys sorted, a key written ``['name']`` (its
``repr`` in brackets), a NamedTuple field ``.name``, a list or tuple
index ``[i]``; ``None`` is an empty subtree.

``bfloat16``, which numpy lacks, is written and read through an int16
view under the dtype string JAX writes, so no ``ml_dtypes`` is needed;
:func:`load_flat` returns such leaves as CPU bf16 tensors, every other
leaf as a numpy array.  Tensors on the card are copied to the host once per
leaf.  ``restore`` places each leaf on the device of the template leaf
it replaces or, given ``target_shardings`` (the elastic path,
``launch/elastic.restore_elastic``), on the mesh of its sharding as a
DTensor, whatever the layout of the job that saved it.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.core import bdi_exact as bx

_MANIFEST = "manifest.json"

_BF16 = "bfloat16"          # numpy has no bf16: it travels as int16 bits


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaf_paths(tree, prefix: str = "", is_leaf=None
               ) -> list[tuple[str, object]]:
    """``(keystr, leaf)`` pairs in ``jax.tree_util.tree_flatten_with_path``
    order; ``is_leaf(node)`` true stops the descent there, as JAX's
    ``is_leaf`` does (a tree of ``PartitionSpec`` tuples)."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}[{k!r}]", is_leaf)]
    if _is_namedtuple(tree):
        return [p for name, v in zip(tree._fields, tree)
                for p in leaf_paths(v, f"{prefix}.{name}", is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}[{i}]", is_leaf)]
    return [(prefix, tree)]


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`leaf_paths` order, by
    the next items of the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array and the dtype string to record."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()        # one copy off the card
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == _BF16:                     # an ml_dtypes array
        return arr.view(np.int16), _BF16
    return arr, str(arr.dtype)


def _decode(raw: bytes, e: dict):
    """File bytes -> numpy array, or a CPU tensor for bf16."""
    if e["dtype"] == _BF16:
        arr = np.frombuffer(raw, dtype=np.int16).reshape(e["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(e["dtype"])).reshape(e["shape"])


def _read(d: str, e: dict):
    with open(os.path.join(d, e["file"]), "rb") as f:
        blob = f.read()
    got = hashlib.sha256(blob).hexdigest()
    if got != e["sha256"]:
        raise IOError(f"checkpoint corruption in {e['file']}: "
                      f"sha mismatch ({got[:12]} != {e['sha256'][:12]})")
    raw = bx.decompress_stream(blob).tobytes() if e["codec"] == "bdi" \
        else blob
    return _decode(raw, e)


def _manifest(ckpt_dir: str, step: int | None) -> tuple[str, dict]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        return d, json.load(f)


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None,
         compress: bool = True, ec_min_ratio: float = 1.02) -> dict:
    """Save a tree of tensors or arrays; returns the manifest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    entries = []
    raw_total = comp_total = 0
    for i, (path, leaf) in enumerate(leaf_paths(tree)):
        arr, dtype = _host(leaf)
        raw = arr.tobytes()
        codec, blob = "raw", raw
        if compress and len(raw) >= 256:
            c = bx.compress_stream(raw)
            # EC-style decision: store compressed only if it wins
            if len(raw) / max(len(c), 1) >= ec_min_ratio:
                codec, blob = "bdi", c
        fname = f"{i:05d}.{codec}"
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(blob)
        entries.append({
            "path": path, "file": fname, "codec": codec,
            "shape": list(arr.shape), "dtype": dtype,
            "sha256": hashlib.sha256(blob).hexdigest(),
            "raw_bytes": len(raw), "stored_bytes": len(blob),
        })
        raw_total += len(raw)
        comp_total += len(blob)

    manifest = {
        "step": step,
        "entries": entries,
        "extra": extra or {},
        "raw_bytes": raw_total,
        "stored_bytes": comp_total,
        "compression_ratio": raw_total / max(comp_total, 1),
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    return manifest


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like, *, step: int | None = None,
            target_shardings=None):
    """Restore into the structure of ``tree_like``: each leaf becomes a
    tensor on the device of the template leaf it replaces (the CPU for a
    template leaf that is not a tensor).  ``target_shardings``: a tree of
    ``distributed.axes.NamedSharding`` of the same structure (JAX's
    elastic path); each leaf, read and checked against its SHA-256 as
    always, is then placed with ``distribute_tensor`` on its sharding's
    mesh and placements.  Returns ``(tree, manifest)``.
    """
    d, manifest = _manifest(ckpt_dir, step)
    by_path = {e["path"]: e for e in manifest["entries"]}
    flat = leaf_paths(tree_like)
    shardings = [s for _, s in leaf_paths(target_shardings)] \
        if target_shardings is not None else [None] * len(flat)
    if len(shardings) != len(flat):
        raise ValueError(f"target_shardings has {len(shardings)} leaves, "
                         f"the tree {len(flat)}")
    out = []
    for (key, like), shd in zip(flat, shardings):
        v = _read(d, by_path[key])
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(v.copy())
        if shd is not None:
            t = distribute_tensor(t.to(shd.mesh.device_type), shd.mesh,
                                  shd.placements)
        elif isinstance(like, torch.Tensor):
            t = t.to(like.device)
        out.append(t)
    return _rebuild(tree_like, iter(out)), manifest


def load_flat(ckpt_dir: str, *, step: int | None = None
              ) -> tuple[dict, dict]:
    """Restore a checkpoint saved from a flat ``{name: array}`` dict
    without a template (the engine-snapshot path).  Returns ``({name:
    array}, manifest)``; names are the dict keys the tree was saved with
    (a dict leaf's keystr is ``"['name']"``)."""
    d, manifest = _manifest(ckpt_dir, step)
    out = {}
    for e in manifest["entries"]:
        out[e["path"][2:-2]] = _read(d, e)      # "['name']" -> name
    return out, manifest


def persist(ckpt_dir: str, step: int, arrays: dict, meta: dict, *,
            kind: str, compress: bool = True) -> dict:
    """Persist a serving component (flat ``{name: array}`` + JSON meta)
    through :func:`save`; ``kind`` stamps the manifest so
    :func:`restore_component` refuses a checkpoint of another component."""
    return save(ckpt_dir, step, arrays,
                extra={"kind": kind, "meta": meta}, compress=compress)


def restore_component(ckpt_dir: str, *, kind: str, step: int | None = None
                      ) -> tuple[dict, dict, dict]:
    """Load a component persisted by :func:`persist`: ``(arrays, meta,
    manifest)``.  Raises ``ValueError`` when the kind stamp differs."""
    arrays, manifest = load_flat(ckpt_dir, step=step)
    extra = manifest["extra"]
    if extra.get("kind") != kind:
        raise ValueError(f"checkpoint kind mismatch: {extra.get('kind')!r} "
                         f"!= {kind!r}")
    return arrays, extra["meta"], manifest


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    """Retention policy: keep the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
