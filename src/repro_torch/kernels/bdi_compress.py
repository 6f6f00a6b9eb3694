"""BDI single-base KV row codec: CUDA kernel launcher and plain version.

The kernel (``csrc/bdi_compress_kv.cu``) replaces the Pallas kernel
``repro/kernels/bdi_compress.py:116`` ``_bdi_compress_kv``.  Its plain
PyTorch version is :func:`bdi_compress_kv_ref` (``ref.compress_rows``);
the two are bit-exact.  The engine reaches either through
:func:`repro_torch.kernels.ops.compress_kv_pages`, which picks by device
and counts launches.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import compress_rows as bdi_compress_kv_ref  # noqa: F401


def bdi_compress_kv(x: torch.Tensor):
    """Launch the row codec on the card.

    x f32 [N, D], contiguous, on a CUDA device -> (deltas i8 [N, D],
    base f32 [N], scale f32 [N]), allocated here, on the current stream.
    """
    if x.device.type != "cuda":
        raise ValueError(f"bdi_compress_kv launches on CUDA, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("bdi_compress_kv takes contiguous f32 [N, D], got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, d = x.shape
    if d < 1:
        raise ValueError("bdi_compress_kv needs D >= 1")
    deltas = torch.empty((n, d), dtype=torch.int8, device=x.device)
    base = torch.empty(n, dtype=torch.float32, device=x.device)
    scale = torch.empty(n, dtype=torch.float32, device=x.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib.bdi_compress_kv(x.data_ptr(), deltas.data_ptr(),
                                     base.data_ptr(), scale.data_ptr(),
                                     n, d, stream), "bdi_compress_kv")
    return deltas, base, scale
