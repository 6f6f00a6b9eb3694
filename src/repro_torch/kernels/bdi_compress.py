"""BDI compressors: CUDA kernel launchers and their plain versions.

* The single-base KV row codec (``csrc/bdi_compress_kv.cu``) replaces
  the Pallas kernel ``repro/kernels/bdi_compress.py:116``
  ``_bdi_compress_kv``; its plain version is :func:`bdi_compress_kv_ref`
  (``ref.compress_rows``).  The engine reaches either through
  :func:`repro_torch.kernels.ops.compress_kv_pages`.
* The two-base tile codec (``csrc/bdi_compress_tile.cu``) replaces
  ``repro/kernels/bdi_compress.py:151`` ``_bdi_compress``; its plain
  version is :func:`bdi_compress_ref` (``ref.compress_ref``).  Callers
  reach either through :func:`repro_torch.kernels.ops.compress`.

Kernel and plain version are bit-exact; the ``ops`` wrappers pick by
device and count launches.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import PackedTiles
from .ref import compress_ref as bdi_compress_ref  # noqa: F401
from .ref import compress_rows as bdi_compress_kv_ref  # noqa: F401

_MAX_TILE = 1024    # the generic instance stages a tile's mask bytes a warp


def edge_tiles(t: int) -> dict[str, torch.Tensor]:
    """One tile f32 [1, t] (t a multiple of 8, >= 8) per edge of the tile
    codec, on the CPU: what the kernel checks and the CPU tests run
    beside random tiles.  ``subnormal``, ``ratio0``, ``huge_overflow``,
    ``huge_alt``, ``wide`` and ``far_base`` have scales outside
    2^-12..2^12 or subnormal inputs."""
    g = torch.Generator().manual_seed(t)
    z = torch.zeros(t)
    tiles = {"zero": z.clone(), "neg_zero": torch.full((t,), -0.0),
             "constant": torch.full((t,), 3.25)}
    x = z.clone()
    x[0::2] = -0.0                      # ZERO, its base written as +0.0
    tiles["mixed_zero"] = x
    x = torch.full((t,), 4.5)
    x[0], x[1::2] = 4.0, 2.0            # exactly base/2: the zero base
    tiles["half_base"] = x
    x = z.clone()                       # scale 1 and .5 quotients
    x[0], x[1] = 100.0, -127.0
    x[2:7] = torch.tensor([2.5, -3.5, 0.5, -0.5, 126.5])
    tiles["halves"] = x
    x = z.clone()                       # subnormal residuals and ratio
    x[1:] = torch.linspace(-1.1e-38, 1.1e-38, t - 1)
    tiles["subnormal"] = x
    x = z.clone()
    x[1] = 1.4e-45                      # ratio 0: scale 2^-127
    tiles["ratio0"] = x
    x = torch.full((t,), -3e38)         # x - base overflows to inf
    x[1::2] = 3e38
    tiles["huge_overflow"] = x
    x = z.clone()
    x[1::2], x[2::2] = 1e38, -1e38
    tiles["huge_alt"] = x
    tiles["wide"] = torch.linspace(-5e5, 5e5, t)
    x = torch.linspace(0.0, 1e-3, t)    # the base far from the rest
    x[0] = -7.0
    tiles["far_base"] = x
    big = 50.0 + torch.randn(t, generator=g)
    x = torch.where(torch.rand(t, generator=g) < 0.5, big,
                    torch.randn(t, generator=g) * 1e-2)
    x[0] = big[0]
    tiles["sparse_cluster"] = x
    return {k: v[None, :].contiguous() for k, v in tiles.items()}


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


def bdi_compress(x: torch.Tensor) -> PackedTiles:
    """Launch the tile codec on the card.

    x f32 [N, T], contiguous, on a CUDA device, T a multiple of 8 up to
    1024 -> :class:`~.ref.PackedTiles` (deltas i8 [N, T], base and scale
    f32 [N, 1], maskp u8 [N, T/8], enc i32 [N, 1]), allocated here, on
    the current stream.  Inputs must be finite (the codec's contract).
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"bdi_compress launches on CUDA, got {dev}")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, T], got {tuple(x.shape)}")
    n, t = x.shape
    if t < 8 or t % 8 or t > _MAX_TILE:
        raise ValueError(f"tile length {t} is not a multiple of 8 in "
                         f"8..{_MAX_TILE}")
    _build.check_tensor(x, "x", torch.float32, (n, t), dev)
    out = PackedTiles(
        torch.empty((n, t), dtype=torch.int8, device=dev),
        torch.empty((n, 1), dtype=torch.float32, device=dev),
        torch.empty((n, 1), dtype=torch.float32, device=dev),
        torch.empty((n, t // 8), dtype=torch.uint8, device=dev),
        torch.empty((n, 1), dtype=torch.int32, device=dev))
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.bdi_compress(x.data_ptr(),
                                  *(o.data_ptr() for o in out), n, t,
                                  stream), "bdi_compress")
    return out
