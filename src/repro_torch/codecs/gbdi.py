"""GBDI codec: multi-base B+Delta with a per-row base id and width.

Port of ``repro/codecs/gbdi.py``.  Per page and side: K = 4 bases on a
dyadic lattice over the rows' first elements, per row a base id, a pow2
scale (the page's when the row fits 4 bits at it) and a width tag; int8
deltas.  Compression and decompression go through
:mod:`repro_torch.kernels.ops`: the CUDA kernels for CUDA tensors (the
publish path, the prefill canonical roundtrip and the decode gather all
reach them), the plain versions for CPU tensors; the bits are the same.

Byte accounting per side: K*4 bytes of bases + 2 bytes of packed row
metadata per row + data by width (0, ceil(D/2) or D bytes per row).
No fused attention kernel: the engine decodes through its gather-then-
decompress attention.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import K_BASES, GBDIKVPages

from .base import PageCodec, register


class GBDICodec(PageCodec):
    name = "gbdi"
    has_fused_fill = True          # CUDA compress/decompress pair

    def init_pools(self, n_layers, n_pages, kvh, page, dh, device):
        shp = (n_layers, n_pages, kvh, page)
        bshp = (n_layers, n_pages, K_BASES)

        def side():
            return (torch.zeros(shp + (dh,), dtype=torch.int8, device=device),
                    torch.zeros(bshp, dtype=torch.float32, device=device),
                    torch.zeros(shp, dtype=torch.int8, device=device),
                    torch.ones(shp, dtype=torch.float32, device=device),
                    torch.zeros(shp, dtype=torch.int8, device=device))

        return GBDIKVPages(*side(), *side())

    def compress_kv_pages(self, k, v):
        return ops.gbdi_compress_kv_pages(k, v)

    def decompress_pages(self, pages):
        # flatten any leading dims to one page axis, decode, restore
        lead = pages.kd.shape[:-3]
        flat = GBDIKVPages(*(a.reshape((-1,) + a.shape[len(lead):])
                             for a in pages))
        k, v = ops.gbdi_decompress_kv_pages(flat)
        return k.view(lead + k.shape[1:]), v.view(lead + v.shape[1:])

    def page_nbytes(self, pages) -> torch.Tensor:
        def side(wid, dh):
            rows = wid.shape[-2] * wid.shape[-1]
            data = torch.where(wid == 0, 0,
                               torch.where(wid == 1, (dh + 1) // 2, dh))
            return data.sum(dim=(-2, -1)) + K_BASES * 4 + 2 * rows

        return (side(pages.kwid, pages.kd.shape[-1])
                + side(pages.vwid, pages.vd.shape[-1])).to(torch.int32)


GBDI = register(GBDICodec())
