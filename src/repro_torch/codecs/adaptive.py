"""Adaptive codec: per-page selection over every single codec.

Port of ``repro/codecs/adaptive.py``.  Publish compresses each page
under every member, keeps the smallest by ``page_nbytes`` (first
smallest wins: an explicit where-chain) and stores the winner's id as a
one-byte tag — the **first** leaf of the pool tree, so checksums cover
it.  Storage keeps every member's encoding; the accounting is the
winner's size plus the tag byte.

Member order is part of the format: ``bdi=0, zero=1, raw=2, gbdi=3,
fpc=4``.  On CUDA the bdi member's compression and the gbdi member's
compression and decompression run their kernels, so this path launches
the row codec and both GBDI kernels; decode goes through the engine's
gather-then-decompress attention (no fused kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import PageCodec, register
from .bdi import BDI
from .fpc import FPC
from .gbdi import GBDI
from .raw import RAW
from .zero import ZERO

MEMBER_NAMES = ("bdi", "zero", "raw", "gbdi", "fpc")
MEMBERS = (BDI, ZERO, RAW, GBDI, FPC)
TAG_NBYTES = 1


class AdaptiveKVPages(NamedTuple):
    """Tag leaf + one member page tree per codec; ``tag`` stays first."""
    tag: torch.Tensor      # uint8 [...] winning member id per page
    bdi: NamedTuple
    zero: NamedTuple
    raw: NamedTuple
    gbdi: NamedTuple
    fpc: NamedTuple


class AdaptiveCodec(PageCodec):
    name = "adaptive"
    ulp_stable_sizes = False       # min() over members includes fpc
    has_fused_fill = True          # members' page-fill kernels compose

    members = MEMBERS
    member_names = MEMBER_NAMES

    def init_pools(self, n_layers, n_pages, kvh, page, dh, device):
        return AdaptiveKVPages(
            torch.zeros((n_layers, n_pages), dtype=torch.uint8,
                        device=device),
            *(m.init_pools(n_layers, n_pages, kvh, page, dh, device)
              for m in self.members))

    def compress_kv_pages(self, k, v):
        cands = [m.compress_kv_pages(k, v) for m in self.members]
        sizes = [m.page_nbytes(c) for m, c in zip(self.members, cands)]
        best, tag = sizes[0], torch.zeros_like(sizes[0])
        for j in range(1, len(sizes)):
            better = sizes[j] < best
            tag = torch.where(better, j, tag)
            best = torch.where(better, sizes[j], best)
        return AdaptiveKVPages(tag.to(torch.uint8), *cands)

    def decompress_pages(self, pages):
        outs = [m.decompress_pages(c)
                for m, c in zip(self.members, pages[1:])]
        t = pages.tag.to(torch.int32)[..., None, None, None]
        k, v = outs[0]
        for j in range(1, len(outs)):
            k = torch.where(t == j, outs[j][0], k)
            v = torch.where(t == j, outs[j][1], v)
        return k, v

    def page_nbytes(self, pages) -> torch.Tensor:
        sizes = [m.page_nbytes(c) for m, c in zip(self.members, pages[1:])]
        t = pages.tag.to(torch.int32)
        out = sizes[0]
        for j in range(1, len(sizes)):
            out = torch.where(t == j, sizes[j], out)
        return (out + TAG_NBYTES).to(torch.int32)

    def page_tags(self, pages) -> torch.Tensor:
        return pages.tag.to(torch.int32)


ADAPTIVE = register(AdaptiveCodec())
