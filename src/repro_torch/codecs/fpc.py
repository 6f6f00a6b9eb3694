"""FPC codec: frequent-pattern coding over f32 words, lossless.

Port of ``repro/codecs/fpc.py``.  Every f32 word gets a 2-bit class from
its bit pattern:

  class 0  +0.0 word                        (prefix only)
  class 1  bit-equal repeat of the previous word along D (prefix only)
  class 2  bf16-exact word                  (prefix + top 16 bits)
  class 3  exception                        (prefix + the 32-bit word)

Storage is class-planar (class u8, top halves, exceptions f32, zero
where unused); ``page_nbytes`` counts the packed size.  Bits are read
through ``.view(torch.int32)``.  The top-half plane is **int16** holding
the bits JAX keeps in uint16: PyTorch's uint16 is a limited dtype (no
``index_put_`` or ``where`` on every device), and the byte view — so the
checksum — is the same.  Decoding rebuilds a class-2 word by placing the
int16 half above a zero half and viewing the pair as f32, so no shift
leaves the int16 range.  No kernel: plain tensor ops on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import PageCodec, register


class FPCKVPages(NamedTuple):
    """Per side: class plane u8 [..., KVH, page, D], class-2 top halves
    (int16 bits of JAX's uint16, 0 elsewhere), class-3 words (f32, 0
    elsewhere)."""
    kcls: torch.Tensor
    khi: torch.Tensor
    kexc: torch.Tensor
    vcls: torch.Tensor
    vhi: torch.Tensor
    vexc: torch.Tensor


def _encode_side(x: torch.Tensor):
    x = x.to(torch.float32)
    bits = x.view(torch.int32)
    is_zero = bits == 0                                   # +0.0 exactly
    is_rep = torch.cat([torch.zeros_like(is_zero[..., :1]),
                        bits[..., 1:] == bits[..., :-1]], dim=-1)
    is_bf16 = (bits & 0xFFFF) == 0                        # bf16-exact word
    cls = torch.where(is_zero, 0, torch.where(
        is_rep, 1, torch.where(is_bf16, 2, 3))).to(torch.uint8)
    # arithmetic shift: the top half sign-extended, exact in int16
    hi = torch.where(cls == 2, bits >> 16, 0).to(torch.int16)
    exc = torch.where(cls == 3, x, 0.0)
    return cls, hi, exc


def _decode_side(cls: torch.Tensor, hi: torch.Tensor,
                 exc: torch.Tensor) -> torch.Tensor:
    halves = torch.stack([torch.zeros_like(hi), hi], dim=-1)  # little-endian
    bfval = halves.view(torch.float32)[..., 0]
    explicit = torch.where(cls == 0, 0.0, torch.where(cls == 2, bfval, exc))
    # repeat chains carry the nearest explicit word forward along D;
    # position 0 is never class 1, so every repeat has a source
    idx = torch.arange(cls.shape[-1], device=cls.device).expand(cls.shape)
    src = torch.cummax(torch.where(cls == 1, -1, idx), dim=-1).values
    return torch.gather(explicit, -1, src)


class FPCCodec(PageCodec):
    name = "fpc"
    lossless = True                # bit-pattern coding, exact exceptions
    ulp_stable_sizes = False       # sizes read exact mantissa bits

    def init_pools(self, n_layers, n_pages, kvh, page, dh, device):
        shp = (n_layers, n_pages, kvh, page, dh)

        def z(dtype):
            return torch.zeros(shp, dtype=dtype, device=device)

        return FPCKVPages(z(torch.uint8), z(torch.int16), z(torch.float32),
                          z(torch.uint8), z(torch.int16), z(torch.float32))

    def compress_kv_pages(self, k, v):
        return FPCKVPages(*_encode_side(k), *_encode_side(v))

    def decompress_pages(self, pages):
        return (_decode_side(pages.kcls, pages.khi, pages.kexc),
                _decode_side(pages.vcls, pages.vhi, pages.vexc))

    def page_nbytes(self, pages) -> torch.Tensor:
        def side(cls):
            words = cls.shape[-3] * cls.shape[-2] * cls.shape[-1]
            pay = torch.where(cls == 2, 16, torch.where(cls == 3, 32, 0))
            return (pay.sum(dim=(-3, -2, -1)) + 2 * words + 7) // 8

        return (side(pages.kcls) + side(pages.vcls)).to(torch.int32)


FPC = register(FPCCodec())
