"""How the port's tests share one machine with each other under
pytest-xdist (``-n``), which runs several test files at once.

* PyTorch's intra-op threads: by default every worker's PyTorch starts as
  many threads as the machine has cores, and its OpenMP threads spin while
  they wait; six workers so oversubscribe the cores that an in-process
  CPU test runs tens of times slower beside them than alone (the port's
  ``train()`` restart test: 4 s alone, 187 s in a whole run).  Each worker
  takes its share of the cores instead (:func:`share_cores`, at import:
  every worker imports every test module while it collects).
"""

import os

import torch


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def share_cores() -> None:
    """Under pytest-xdist, PyTorch's intra-op threads of this worker: its
    share of the cores (at least one)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, _cores() // workers))


share_cores()
