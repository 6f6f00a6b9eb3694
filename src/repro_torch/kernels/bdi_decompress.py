"""BDI tile decompressor: CUDA kernel launcher and its plain version.

The kernel (``csrc/bdi_decompress_tile.cu``) replaces the Pallas kernel
``repro/kernels/bdi_decompress.py:55`` ``_bdi_decompress``.  Its plain
PyTorch version is :func:`bdi_decompress_ref` (``ref.decompress_ref``);
the two are bit-exact.  Callers reach either through
:func:`repro_torch.kernels.ops.decompress`, which picks by device and
counts launches.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import PackedTiles
from .ref import decompress_ref as bdi_decompress_ref  # noqa: F401


def bdi_decompress(p: PackedTiles) -> torch.Tensor:
    """Launch the tile decompressor on the card.

    p: deltas i8 [N, T] (T a multiple of 8), base and scale f32 [N, 1],
    maskp u8 [N, T/8], enc unused; all contiguous on one CUDA device.
    Returns f32 [N, T], allocated here, on the current stream.
    """
    dev = p.deltas.device
    if dev.type != "cuda":
        raise ValueError(f"bdi_decompress launches on CUDA, got {dev}")
    if p.deltas.dim() != 2:
        raise ValueError(f"deltas must be [N, T], got "
                         f"{tuple(p.deltas.shape)}")
    n, t = p.deltas.shape
    if t < 8 or t % 8:
        raise ValueError(f"tile length {t} is not a multiple of 8")
    want = _build.check_tensor
    want(p.deltas, "deltas", torch.int8, (n, t), dev)
    want(p.base, "base", torch.float32, (n, 1), dev)
    want(p.scale, "scale", torch.float32, (n, 1), dev)
    want(p.maskp, "maskp", torch.uint8, (n, t // 8), dev)
    if p.deltas.data_ptr() % 4:
        raise ValueError("deltas must start 4-byte aligned")
    out = torch.empty((n, t), dtype=torch.float32, device=dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.bdi_decompress(
        p.deltas.data_ptr(), p.base.data_ptr(), p.scale.data_ptr(),
        p.maskp.data_ptr(), out.data_ptr(), n, t, stream), "bdi_decompress")
    return out
