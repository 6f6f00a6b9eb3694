"""Leaves of nested NamedTuples of tensors: the port's pytrees.

Page pools and compressed pages are NamedTuples whose fields are tensors
or, for a composite codec (``adaptive``), further NamedTuples.  These
helpers walk them in ``jax.tree.leaves`` order — depth first, in field
order — so that checksums hash the leaves in the JAX package's order.
Written here rather than taken from ``torch.utils._pytree`` (a private
module) because two functions cover every use.
"""

from __future__ import annotations

from typing import Callable

import torch


def _is_node(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested NamedTuple, depth first in field order."""
    if _is_node(tree):
        return [leaf for field in tree for leaf in tree_leaves(field)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf by leaf over trees of one structure; returns a
    tree of that structure."""
    if _is_node(tree):
        return type(tree)(*(tree_map(fn, *fields)
                            for fields in zip(tree, *rest)))
    return fn(tree, *rest)
