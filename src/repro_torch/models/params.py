"""Parameter trees: the bridge to and from the JAX package's pytrees, and
helpers.

A tree is nested dicts with tensor leaves: a model's params, or an
optimizer state (``{"step", "m", "v"}``, whose ``bdi8``/``q8`` moments
are dicts of tensors too).  :func:`from_numpy` takes a JAX tree as numpy
arrays (``jax.tree.map(np.asarray, tree)``, done by the caller — this
module imports neither jax nor ml_dtypes) and carries bf16 bit-exact
through a 16-bit integer view; :func:`to_numpy` goes back.
:func:`leaves` lists a tree's tensors in ``jax.tree.leaves`` order.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _tensor(a: np.ndarray) -> torch.Tensor:
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")          # jax hands out read-only views
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_numpy(tree: dict, device: str | torch.device = "cpu") -> dict:
    """Numpy-leaved params tree -> tensors on ``device``, bit for bit."""
    return {k: from_numpy(v, device) if isinstance(v, dict)
            else _tensor(np.asarray(v)).to(device) for k, v in tree.items()}


def to_numpy(tree: dict, bf16=None) -> dict:
    """Tensor tree -> numpy arrays on the host, bit for bit.  bf16 leaves
    come back as their int16 bits, viewed as ``bf16`` when the caller
    gives that numpy dtype (``ml_dtypes.bfloat16``)."""
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            a = t.view(torch.int16).numpy()
            return a if bf16 is None else a.view(bf16)
        return t.numpy()
    return {k: to_numpy(v, bf16) if isinstance(v, dict) else one(v)
            for k, v in tree.items()}


def leaves(tree: dict) -> list[torch.Tensor]:
    """The tensors of a tree in ``jax.tree.leaves`` order (dict keys
    sorted, depth first)."""
    return [leaf for k in sorted(tree)
            for leaf in (leaves(tree[k]) if isinstance(tree[k], dict)
                         else [tree[k]])]


def unflatten(tree: dict, flat) -> dict:
    """A tree of ``tree``'s structure whose leaves are ``flat``, in
    :func:`leaves` order."""
    return _build(tree, iter(flat))


def _build(t: dict, it) -> dict:
    # a module-level function: a nested one that calls itself is a
    # reference cycle, which would keep ``flat`` (a step's gradients)
    # alive until the collector runs
    return {k: _build(t[k], it) if isinstance(t[k], dict) else next(it)
            for k in sorted(t)}


def to_device(tree: dict, device: torch.device) -> dict:
    """Move every leaf to ``device`` (no copy for leaves already there)."""
    return tree_map(lambda t: t.to(device), tree)


def layer(blocks: dict, li: int) -> dict:
    """Layer ``li``'s params out of the stacked [L, ...] blocks (views)."""
    return tree_map(lambda t: t[li], blocks)


def unstack(blocks: dict) -> list[dict]:
    """The stacked [L, ...] blocks as L per-layer trees of views, split
    with one ``unbind`` a leaf (its backward stacks the layers' gradients
    into the leaf's gradient once)."""
    split = tree_map(lambda t: t.unbind(0), blocks)
    n = len(leaves(split)[0])
    return [tree_map(lambda ts, i=i: ts[i], split) for i in range(n)]


def _stack_into(dst: dict | None, src: dict, li: int, n: int) -> dict:
    """Copy one layer's params into stacked [n, ...] buffers (made on the
    first layer), so the peak is the stack plus one layer; a one-layer
    stack is a view of the layer (arctic's experts at one layer are 27
    GB)."""
    if dst is None:
        dst = {}
    for k, v in src.items():
        if isinstance(v, dict):
            dst[k] = _stack_into(dst.get(k), v, li, n)
        elif n == 1:
            dst[k] = v.unsqueeze(0)
        else:
            if k not in dst:
                dst[k] = torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                                     device=v.device)
            dst[k][li] = v
    return dst


def init_stacked(make_block: Callable[[], dict], n: int) -> dict:
    """``n`` blocks from ``make_block()``, made one after another (the
    generator's draws in layer order) and stacked along a leading [n, ...]
    axis, the layout JAX's ``vmap``-ed init gives."""
    blocks: dict | None = None
    for li in range(n):
        blocks = _stack_into(blocks, make_block(), li, n)
    return blocks
