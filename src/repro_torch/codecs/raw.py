"""Raw (uncompressed) codec — LCP's exception page, whole-page.

Port of ``repro/codecs/raw.py``.  Pages are stored verbatim in f32 (the
exact scratch values) and ``page_nbytes`` reports the model's bf16 raw
size, so the compression ratio is exactly 1.0.  Trivially ``lossless``:
prefill takes the identity attention.  No kernel: plain tensor copies on
every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import PageCodec, register


class RawKVPages(NamedTuple):
    k: torch.Tensor    # f32 [P, KVH, page, D]
    v: torch.Tensor


class RawCodec(PageCodec):
    name = "raw"
    lossless = True

    def init_pools(self, n_layers, n_pages, kvh, page, dh, device):
        shp = (n_layers, n_pages, kvh, page, dh)
        return RawKVPages(
            torch.zeros(shp, dtype=torch.float32, device=device),
            torch.zeros(shp, dtype=torch.float32, device=device))

    def compress_kv_pages(self, k, v):
        return RawKVPages(k.to(torch.float32), v.to(torch.float32))

    def decompress_pages(self, pages):
        return pages.k, pages.v

    def page_nbytes(self, pages) -> torch.Tensor:
        n, kvh, page, d = pages.k.shape
        return torch.full((n,), 2 * 2 * kvh * page * d, dtype=torch.int32,
                          device=pages.k.device)


RAW = register(RawCodec())
