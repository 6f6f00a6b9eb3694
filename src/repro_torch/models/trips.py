"""Python loops whose trips a dry run counts without running them all.

JAX's ``lax.scan`` traces a loop body once and XLA's cost parser
multiplies it by the trip count (``repro/launch/dryrun.py``'s
``_parse_hlo``).  The port's scans are Python loops, so a trace of them
runs every trip: xLSTM's prefill at 32k tokens is 32,768 decode steps.
The loops whose trips grow with the sequence or the batch go through
:func:`steps` and :func:`stack`: Mamba's sequential scan and sLSTM's
scan (``ssm.py``), xLSTM's prefill (``xlstm.py``) and the microbatch
loop of ``launch/dryrun.build_train_step``.

Outside a dry run :func:`steps` is ``range(n)`` and :func:`stack` is
``torch.stack``: no op, launch or result changes.  Inside the dry run's
count (``launch/dryrun.Count``, which takes ``meta`` tensors only) a loop
of more than ``TRACED`` trips runs trips 0, 1 and n - 1, and trip 1
stands for trips 1 to n - 2: the count weights its operations by n - 2,
its backward's too, and what it leaves alive at the end of trip n - 1.
That is exact where every trip runs the same operations on the same
shapes, as in these loops.
"""

from __future__ import annotations

import contextlib
import threading

import torch

TRACED = 3
_state = threading.local()


def _counter():
    return getattr(_state, "counter", None)


def steps(n: int):
    """The trips of a loop of ``n``: ``range(n)``, or under a dry run's
    count the trips it traces (0, 1 and n - 1)."""
    counter = _counter()
    if counter is None or n <= TRACED:
        return range(n)
    return counter.loop(n)


def stack(ys: list, n: int, dim: int) -> torch.Tensor:
    """``torch.stack(ys, dim)`` of a loop of ``n`` trips.  Under a dry
    run's count ``ys`` holds the traced trips' outputs, and the result has
    ``n`` along ``dim`` all the same: trip 1's output stands for trips 1
    to n - 2 (one ``cat``, as the stack's one allocation)."""
    if len(ys) == n:
        return torch.stack(ys, dim)
    if _counter() is None or len(ys) != TRACED:
        raise ValueError(f"stack of {len(ys)} outputs for {n} trips")
    first, mid, last = (y.unsqueeze(dim) for y in ys)
    shape = list(mid.shape)
    shape[dim] = n - 2
    return torch.cat([first, mid.expand(shape), last], dim)


@contextlib.contextmanager
def counting(counter):
    """Route :func:`steps` of this thread to ``counter.loop``."""
    prev = _counter()
    _state.counter = counter
    try:
        yield counter
    finally:
        _state.counter = prev
