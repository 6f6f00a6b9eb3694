"""GBDI multi-base KV page codec: CUDA launchers and plain versions.

The kernels ``csrc/gbdi_compress_kv.cu`` and ``csrc/gbdi_decompress_kv.cu``
replace the Pallas kernels ``repro/kernels/gbdi_codec.py:177``
``_gbdi_compress`` and ``:215`` ``_gbdi_decompress``.  Their plain
PyTorch versions are :func:`gbdi_compress_kv_ref` and
:func:`gbdi_decompress_kv_ref` (``ref.encode_pages_ref`` /
``ref.decode_pages_ref`` on the same row layout); kernel and plain
version are bit-exact.  The engine reaches either through
:func:`repro_torch.kernels.ops.gbdi_compress_kv_pages` and
:func:`~repro_torch.kernels.ops.gbdi_decompress_kv_pages`, which pick by
device and count launches.  Layout: one page is ``rows_per_page``
consecutive rows of ``x [pages * rows_per_page, D]``.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import K_BASES, decode_pages_ref, encode_pages_ref


def _pages(n: int, rows_per_page: int) -> int:
    if rows_per_page < 1 or n % rows_per_page:
        raise ValueError(f"{n} rows are not whole pages of {rows_per_page}")
    return n // rows_per_page


def edge_pages(rows: int, d: int) -> dict[str, torch.Tensor]:
    """Pages f32 [rows, d] (rows >= 8, d >= 8) at the codec's edges, on
    the CPU: what the kernel checks and the CPU tests run beside random
    pages.  ``span_inf`` makes base 0 a NaN (anchors +-3e38: the span
    overflows); ``huge``, ``subnormal`` and ``wide`` have scales outside
    2^-12..2^12."""
    g = torch.Generator().manual_seed(0)

    def rnd():
        return torch.randn((rows, d), generator=g)

    z = torch.zeros((rows, d))
    pages = {"zero": z.clone(), "constant": torch.full((rows, d), 3.25)}
    x = rnd()
    x[:, 0] = 1.5                                   # every anchor equal
    pages["span0"] = x
    # anchors 0..4 put the bases at {0, 1, 2, 4}; 0.5, 1.5 and 3.0 sit
    # exactly between two of them (first minimum wins)
    x = rnd() * 0.1
    x[:, 0] = torch.tensor([0.0, 4.0, 0.5, 1.5, 3.0]).repeat(rows)[:rows]
    pages["midpoints"] = x
    # all anchors 0; the wide row sets page scale 1/8, so rows within
    # 7/8 fit 4 bits beside it; the rest are zero runs
    x = z.clone()
    x[0, 1:] = torch.linspace(-8.0, 8.0, d - 1)
    x[1:rows // 2, 1:] = 0.3
    pages["widths"] = x
    x = z.clone()                                   # subnormal residuals
    x[:, 1:] = 1e-40
    x[1, 2] = -3e-39
    x[2, 1:] = 0.0
    x[2, 1] = 1.4e-45
    pages["subnormal"] = x
    x = z.clone()                                   # .5 quotients, scale 1
    x[0, 1] = 100.0
    x[1, 1:6] = torch.tensor([2.5, -3.5, 0.5, -0.5, 126.5])
    x[2, 1:4] = torch.tensor([1.5, -2.5, 6.5])
    pages["halves"] = x
    x = torch.where(rnd() > 0, 1e38, -1e38)         # huge, span finite
    pages["huge"] = x
    x = rnd()
    x[0, 0], x[1, 0] = 3e38, -3e38                  # span overflows to inf
    pages["span_inf"] = x
    pages["wide"] = torch.linspace(-5e5, 5e5, rows * d).view(rows, d)
    return pages


def gbdi_compress_kv_ref(x: torch.Tensor, rows_per_page: int):
    """Plain version of :func:`gbdi_compress_kv`, same shapes."""
    n, d = x.shape
    pages = _pages(n, rows_per_page)
    dd, bases, bid, sc, wid = encode_pages_ref(
        x.reshape(pages, rows_per_page, d))
    return dd.reshape(n, d), bases, bid.reshape(n), sc.reshape(n), \
        wid.reshape(n)


def gbdi_decompress_kv_ref(deltas, bases, bid, sc,
                           rows_per_page: int) -> torch.Tensor:
    """Plain version of :func:`gbdi_decompress_kv`, same shapes."""
    n, d = deltas.shape
    pages = _pages(n, rows_per_page)
    return decode_pages_ref(deltas.reshape(pages, rows_per_page, d), bases,
                            bid.reshape(pages, rows_per_page),
                            sc.reshape(pages, rows_per_page)).reshape(n, d)


def gbdi_compress_kv(x: torch.Tensor, rows_per_page: int):
    """Launch the page compressor on the card.

    x f32 [N, D], contiguous, on a CUDA device, N = pages * rows_per_page
    -> (deltas i8 [N, D], bases f32 [pages, 4], base id i8 [N], scale f32
    [N], width i8 [N]), allocated here, on the current stream.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"gbdi_compress_kv launches on CUDA, got {dev}")
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    n, d = x.shape
    pages = _pages(n, rows_per_page)
    _build.check_tensor(x, "x", torch.float32, (n, d), dev)
    deltas = torch.empty((n, d), dtype=torch.int8, device=dev)
    bases = torch.empty((pages, K_BASES), dtype=torch.float32, device=dev)
    bid = torch.empty(n, dtype=torch.int8, device=dev)
    scale = torch.empty(n, dtype=torch.float32, device=dev)
    wid = torch.empty(n, dtype=torch.int8, device=dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.gbdi_compress_kv(
        x.data_ptr(), deltas.data_ptr(), bases.data_ptr(), bid.data_ptr(),
        scale.data_ptr(), wid.data_ptr(), pages, rows_per_page, d, stream),
        "gbdi_compress_kv")
    return deltas, bases, bid, scale, wid


def gbdi_decompress_kv(deltas: torch.Tensor, bases: torch.Tensor,
                       bid: torch.Tensor, sc: torch.Tensor,
                       rows_per_page: int) -> torch.Tensor:
    """Launch the page decompressor on the card.

    deltas i8 [N, D], bases f32 [pages, 4], bid i8 [N], sc f32 [N], all
    contiguous on one CUDA device -> f32 [N, D], allocated here, on the
    current stream.
    """
    dev = deltas.device
    if dev.type != "cuda":
        raise ValueError(f"gbdi_decompress_kv launches on CUDA, got {dev}")
    if deltas.dim() != 2:
        raise ValueError(f"deltas must be [N, D], got {tuple(deltas.shape)}")
    n, d = deltas.shape
    pages = _pages(n, rows_per_page)
    want = _build.check_tensor
    want(deltas, "deltas", torch.int8, (n, d), dev)
    want(bases, "bases", torch.float32, (pages, K_BASES), dev)
    want(bid, "bid", torch.int8, (n,), dev)
    want(sc, "sc", torch.float32, (n,), dev)
    if d % 4 == 0 and deltas.data_ptr() % 4:
        raise ValueError("deltas must start 4-byte aligned")
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.gbdi_decompress_kv(
        deltas.data_ptr(), bases.data_ptr(), bid.data_ptr(), sc.data_ptr(),
        out.data_ptr(), pages, rows_per_page, d, stream),
        "gbdi_decompress_kv")
    return out
