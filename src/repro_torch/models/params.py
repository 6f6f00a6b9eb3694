"""Parameter trees: the bridge from the JAX package's pytree, and helpers.

A tree is nested dicts with tensor leaves.  :func:`from_numpy` takes the
JAX params as numpy arrays (``jax.tree.map(np.asarray, params)``, done by
the caller — this module imports neither jax nor ml_dtypes) and carries
bf16 bit-exact through a 16-bit integer view.
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


def to_device(tree: dict, device: torch.device) -> dict:
    """Move every leaf to ``device`` (no copy for leaves already there)."""
    return tree_map(lambda t: t.to(device), tree)


def layer(blocks: dict, li: int) -> dict:
    """Layer ``li``'s params out of the stacked [L, ...] blocks (views)."""
    return tree_map(lambda t: t[li], blocks)
