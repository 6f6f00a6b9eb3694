"""BDI page codec: the single-base B+Delta int8 row form (the default).

Port of ``repro/codecs/bdi.py``.  One row = one (head, token) vector;
base = the row's first element, scale = the power of two covering the
max residual, deltas int8.  Compression and decode attention go through
:mod:`repro_torch.kernels.ops`, which runs the CUDA kernels for CUDA
tensors (publish and the prefill canonical roundtrip both reach the
row-codec kernel) and the plain versions for CPU tensors; the codec's
bits are the same either way.

Byte accounting: each row costs 8 bytes of base+scale plus D delta bytes,
unless the row is all-zero (deltas 0 and base 0: metadata only).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref

from .base import PageCodec, register


class BDICodec(PageCodec):
    name = "bdi"
    has_fused_kernels = True       # row codec + decode attention in CUDA

    def init_pools(self, n_layers, n_pages, kvh, page, dh, device):
        shp = (n_layers, n_pages, kvh, page)

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return ref.CompressedKVPages(
            kd=z(shp + (dh,), torch.int8), kb=z(shp, torch.float32),
            ks=torch.ones(shp, dtype=torch.float32, device=device),
            vd=z(shp + (dh,), torch.int8), vb=z(shp, torch.float32),
            vs=torch.ones(shp, dtype=torch.float32, device=device))

    def compress_kv_pages(self, k, v):
        return ops.compress_kv_pages(k, v)

    def decompress_pages(self, pages):
        return (ref.dequant_pages(pages.kd, pages.kb, pages.ks),
                ref.dequant_pages(pages.vd, pages.vb, pages.vs))

    def page_nbytes(self, pages) -> torch.Tensor:
        def side(d, b):
            zero_row = (d == 0).all(dim=-1) & (b == 0.0)     # [n, K, page]
            data = torch.where(zero_row, 0, d.shape[-1])
            return data.sum(dim=(1, 2)) + 8 * d.shape[1] * d.shape[2]
        return (side(pages.kd, pages.kb)
                + side(pages.vd, pages.vb)).to(torch.int32)

    def paged_attention_tail(self, q, pages, page_table, lengths,
                             tail_k, tail_v, tail_len):
        return ops.paged_attention_tail(q, pages, page_table, lengths,
                                        tail_k, tail_v, tail_len)


BDI = register(BDICodec())
