"""Zero/repeated-value codec (LCP's zero-page case).

Port of ``repro/codecs/zero.py``.  Per (head, token) row: a one-byte
class flag plus nothing (zero row), one f32 value (repeated-value row)
or the exact payload (exception row).  Byte accounting at the model's
bf16 width: 1, 1 + 4 or 1 + 2*D bytes per row.

``lossless`` as in JAX, with JAX's one exception kept on purpose: rows
compare by value (``x == first``), so a row of mixed ``+0.0``/``-0.0``
is a zero row and decodes to ``+0.0`` everywhere.  No kernel: plain
tensor ops on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import PageCodec, register

F_ZERO, F_REP, F_RAW = 0, 1, 2


class ZeroRepKVPages(NamedTuple):
    kf: torch.Tensor   # int8 [P, KVH, page] row class
    kc: torch.Tensor   # f32  [P, KVH, page] repeated value (0 unless F_REP)
    kx: torch.Tensor   # f32  [P, KVH, page, D] payload (0 unless F_RAW)
    vf: torch.Tensor
    vc: torch.Tensor
    vx: torch.Tensor


def _enc(x: torch.Tensor):
    x = x.to(torch.float32)
    first = x[..., 0]
    is_rep = (x == first[..., None]).all(dim=-1)     # incl. all-zero rows
    is_zero = is_rep & (first == 0.0)
    f = torch.where(is_zero, F_ZERO,
                    torch.where(is_rep, F_REP, F_RAW)).to(torch.int8)
    val = torch.where(is_rep & ~is_zero, first, 0.0)
    payload = torch.where((f == F_RAW)[..., None], x, 0.0)
    return f, val, payload


def _dec(f: torch.Tensor, val: torch.Tensor,
         payload: torch.Tensor) -> torch.Tensor:
    out = torch.where((f == F_REP)[..., None], val[..., None], payload)
    return torch.where((f == F_ZERO)[..., None], 0.0, out)


class ZeroRepCodec(PageCodec):
    name = "zero"
    lossless = True

    def init_pools(self, n_layers, n_pages, kvh, page, dh, device):
        shp = (n_layers, n_pages, kvh, page)

        def side():
            return (torch.zeros(shp, dtype=torch.int8, device=device),
                    torch.zeros(shp, dtype=torch.float32, device=device),
                    torch.zeros(shp + (dh,), dtype=torch.float32,
                                device=device))

        return ZeroRepKVPages(*side(), *side())

    def compress_kv_pages(self, k, v):
        return ZeroRepKVPages(*_enc(k), *_enc(v))

    def decompress_pages(self, pages):
        return (_dec(pages.kf, pages.kc, pages.kx),
                _dec(pages.vf, pages.vc, pages.vx))

    def page_nbytes(self, pages) -> torch.Tensor:
        d = pages.kx.shape[-1]

        def side(f):
            row = torch.where(f == F_ZERO, 1,
                              torch.where(f == F_REP, 1 + 4, 1 + 2 * d))
            return row.sum(dim=(1, 2))

        return (side(pages.kf) + side(pages.vf)).to(torch.int32)


ZERO = register(ZeroRepCodec())
