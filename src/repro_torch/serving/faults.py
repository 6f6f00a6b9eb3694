"""Failure taxonomy and per-page checksums (port of part of
``repro/serving/faults.py``: ``FinishReason``, the two errors and
``page_checksums``; fault injection and the integrity checks are not
ported yet).

``page_checksums`` must equal the JAX function bit for bit on the same
pages, so that checksums written by one package verify in the other.  It
is a position-weighted byte sum in wrapping uint32; PyTorch's uint32
arithmetic is thin, so it runs in int64 masked to 32 bits, with the
multiplier split in 16-bit halves so no product leaves int64.
"""

from __future__ import annotations

import enum

import torch

from repro_torch.serving._tree import tree_leaves


class FinishReason(str, enum.Enum):
    """Terminal request outcomes (str-valued: ``== "eos"`` still works)."""
    EOS = "eos"                  # emitted the request's eos_id
    LENGTH = "length"            # reached max_new_tokens
    PREEMPTED = "preempted"      # CAMP-preempted past the requeue limit
    REJECTED = "rejected"        # bounded queue / overload admission reject
    DEADLINE = "deadline"        # TTFT or total deadline exceeded
    CORRUPTED = "corrupted-retries-exhausted"  # integrity retries exhausted

    def __str__(self) -> str:          # repr/str parity with plain strings
        return self.value


class PoolExhaustedError(RuntimeError):
    """Page reservation found nothing evictable (pool truly exhausted)."""


class SchedulerStalledError(RuntimeError):
    """The scheduler made no progress for ``stall_limit`` iterations."""


_MIX = 2654435761                      # Knuth multiplicative hash constant
_MASK = 0xFFFFFFFF


def _mul_mix(x: torch.Tensor) -> torch.Tensor:
    """(x * _MIX) mod 2^32 for int64 x in [0, 2^32), without overflow."""
    lo = x * (_MIX & 0xFFFF)
    hi = ((x * (_MIX >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def page_checksums(pg) -> torch.Tensor:
    """Position-weighted byte sum per page, wrapping uint32.

    ``pg`` is a (possibly nested) NamedTuple of page leaves leading with
    the page axis ``[n, ...]``; leaves hash in ``jax.tree.leaves`` order
    (depth first, field order), bytes little-endian (as JAX's
    ``bitcast_convert_type`` lays them out).  Returns int64 ``[n]``
    holding the uint32 values.
    """
    leaves = [lf for lf in tree_leaves(pg) if lf.numel()]
    n = leaves[0].shape[0]
    dev = leaves[0].device
    acc = torch.zeros(n, dtype=torch.int64, device=dev)
    for lf in leaves:
        b = lf.contiguous().view(torch.uint8).reshape(n, -1).to(torch.int64)
        w = _mul_mix(torch.arange(b.shape[1], dtype=torch.int64,
                                  device=dev)) + 1
        w = w & _MASK
        # each product < 2^40 and a row of them sums well inside int64
        acc = (acc + (b * w).sum(dim=1)) & _MASK
        acc = (_mul_mix(acc) + 1) & _MASK   # leaf order matters too
    return acc
