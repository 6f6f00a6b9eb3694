"""Plain PyTorch versions of the port's kernels (the port's oracles).

Ported from ``repro/kernels/ref.py`` and the jnp half of
``repro/kernels/gbdi_codec.py``.  The CUDA kernels must match these: the
BDI tile, row and GBDI page codecs bit for bit, decode attention within
an f32 tolerance.  The CPU tests hold these against the JAX functions;
``chip_smoke.py`` holds the kernels against these on the card.  Kernel
wrappers (:mod:`.ops`) run them only for CPU tensors.

The tile codec's mask is packed in bit planes (element j's bit is bit
``j // (T//8)`` of byte ``j % (T//8)``), the layout the TPU kernel
unpacks without a lane-crossing reshape; it is not
:func:`repro_torch.core.bdi_value.pack_mask`'s byte layout, which LCP
pages use.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import bdi_value as bv
from repro_torch.core.bdi_value import _pow2_scale

QMAX = 127.0


# ---------------------------------------------------------------------------
# Tile codec: two bases, bit-plane packed mask (repro/kernels/ref.py:21-68)
# ---------------------------------------------------------------------------

def pack_mask_bitplane(mask: torch.Tensor) -> torch.Tensor:
    """bool [..., T] -> uint8 [..., T//8]; element j -> byte j % W, bit
    j // W, with W = T // 8."""
    t = mask.shape[-1]
    if t % 8:
        raise ValueError(f"mask length {t} is not a multiple of 8")
    m = mask.reshape(*mask.shape[:-1], 8, t // 8).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=mask.device)
    weights = (torch.ones_like(shifts) << shifts)[:, None]
    return (m * weights).sum(dim=-2).to(torch.uint8)


def unpack_mask_bitplane(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., W] -> bool [..., 8 * W]."""
    w = packed.shape[-1]
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None, :] >> shifts[:, None]) & 1
    return bits.reshape(*packed.shape[:-1], 8 * w) > 0


class PackedTiles(NamedTuple):
    """Compressed tiles as the tile kernels read and write them."""
    deltas: torch.Tensor   # int8 [N, T]
    base: torch.Tensor     # f32 [N, 1]
    scale: torch.Tensor    # f32 [N, 1]
    maskp: torch.Tensor    # uint8 [N, T//8], bit-plane packed
    enc: torch.Tensor      # int32 [N, 1]: ENC_ZERO, ENC_REP or ENC_D8


def compress_ref(x: torch.Tensor) -> PackedTiles:
    """Plain version of the tile compressor: f32 tiles [N, T], T % 8 ==
    0 -> :class:`PackedTiles` (``bdi_value.compress_tiles`` with int8
    deltas)."""
    c = bv.compress_tiles(x, delta_dtype=torch.int8)
    return PackedTiles(c.deltas, c.base[:, None], c.scale[:, None],
                       pack_mask_bitplane(c.mask),
                       c.enc.to(torch.int32)[:, None])


def decompress_ref(p: PackedTiles) -> torch.Tensor:
    """Plain version of the tile decompressor -> f32 [N, T]: the masked
    FMA ``d * scale + mask * base``, the mask term a product as in JAX
    (it differs from a select on a base of +-inf or NaN)."""
    mask = unpack_mask_bitplane(p.maskp).to(torch.float32)
    return p.deltas.to(torch.float32) * p.scale + mask * p.base


# ---------------------------------------------------------------------------
# Single-base KV pages and decode attention
# ---------------------------------------------------------------------------

class CompressedKVPages(NamedTuple):
    """B+Delta (single-base) compressed KV page pool.

    Field order is the JAX package's: ``faults.page_checksums`` hashes
    the leaves in this order.
    """
    kd: torch.Tensor   # int8 [P, KVH, page, D]
    kb: torch.Tensor   # f32  [P, KVH, page]
    ks: torch.Tensor   # f32  [P, KVH, page]
    vd: torch.Tensor   # int8 [P, KVH, page, D]
    vb: torch.Tensor   # f32  [P, KVH, page]
    vs: torch.Tensor   # f32  [P, KVH, page]


def compress_rows(x: torch.Tensor):
    """Single-base row codec, f32 [..., D] -> (deltas i8 [..., D], base
    f32 [...], scale f32 [...]).  Base is the row's first element; deltas
    are ``clip(round_half_even(r / scale), -127, 127)``."""
    x = x.to(torch.float32)
    base = x[..., 0].contiguous()
    r = x - base[..., None]
    scale = _pow2_scale(r.abs().amax(dim=-1), QMAX)
    d = torch.clamp(torch.round(r / scale[..., None]), -QMAX, QMAX)
    return d.to(torch.int8), base, scale


def compress_kv_pages(k: torch.Tensor, v: torch.Tensor) -> CompressedKVPages:
    """k, v: f32 [P, KVH, page, D] -> single-base compressed pages."""
    return CompressedKVPages(*compress_rows(k), *compress_rows(v))


def dequant_pages(d: torch.Tensor, b: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    return d.to(torch.float32) * s[..., None] + b[..., None]


def _gather_dequant(pages: CompressedKVPages, page_table: torch.Tensor):
    """Gather pages through the table first, then dequantize only those:
    [B, PMAX] -> k, v f32 [B, KVH, PMAX * page, D]."""
    b_, pmax = page_table.shape
    _, kvh, page, d = pages.kd.shape
    pt = page_table.long()

    def one(dd, bb, ss):
        x = dequant_pages(dd[pt], bb[pt], ss[pt])       # [B, PMAX, KVH, pg, D]
        return x.movedim(2, 1).reshape(b_, kvh, pmax * page, d)

    return (one(pages.kd, pages.kb, pages.ks),
            one(pages.vd, pages.vb, pages.vs))


def softmax_attend(q, kg, vg, valid):
    """Dense decode attention: q f32 [B, KVH, G, D] over keys/values
    [B, KVH, T, D] where ``valid`` [B, T]."""
    d = q.shape[-1]
    scores = torch.einsum("bhgd,bhtd->bhgt", q, kg) / math.sqrt(d)
    scores = scores.masked_fill(~valid[:, None, None, :], -math.inf)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgt,bhtd->bhgd", w, vg)


def paged_attention_ref(q: torch.Tensor, pages: CompressedKVPages,
                        page_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over compressed pages only.

    q f32 [B, KVH, G, D]; page_table i32 [B, PMAX]; lengths i32 [B].
    Returns f32 [B, KVH, G, D].
    """
    kg, vg = _gather_dequant(pages, page_table)
    pos = torch.arange(kg.shape[2], device=q.device)
    return softmax_attend(q, kg, vg, pos[None, :] < lengths[:, None])


def paged_attention_tail_ref(q: torch.Tensor, pages: CompressedKVPages,
                             page_table: torch.Tensor, lengths: torch.Tensor,
                             tail_k: torch.Tensor, tail_v: torch.Tensor,
                             tail_len: torch.Tensor) -> torch.Tensor:
    """Decode attention over [compressed pages + f32 tail].

    q f32 [B, KVH, G, D]; tail_k/tail_v f32 [B, KVH, page, D]; tail_len
    i32 [B] counts valid tail slots; lengths i32 [B] counts page tokens.
    """
    kg, vg = _gather_dequant(pages, page_table)
    kg = torch.cat([kg, tail_k.to(torch.float32)], dim=2)
    vg = torch.cat([vg, tail_v.to(torch.float32)], dim=2)
    page = tail_k.shape[2]
    pos = torch.arange(kg.shape[2] - page, device=q.device)
    slot = torch.arange(page, device=q.device)
    valid = torch.cat([pos[None, :] < lengths[:, None],
                       slot[None, :] < tail_len[:, None]], dim=1)
    return softmax_attend(q, kg, vg, valid)


# ---------------------------------------------------------------------------
# GBDI: multi-base B+Delta pages (repro/kernels/gbdi_codec.py:47-148)
# ---------------------------------------------------------------------------

K_BASES = 4
Q4MAX = 7.0      # signed 4-bit delta range of width class 1


class GBDIKVPages(NamedTuple):
    """Multi-base compressed KV pages (pool: leading [L, P]; fresh: [n]).

    Per side: int8 deltas [..., KVH, page, D], f32 bases [..., K_BASES],
    int8 base id, f32 scale and int8 width tag [..., KVH, page] (0 zero
    run, 1 four-bit, 2 eight-bit).  Field order is the JAX package's.
    """
    kd: torch.Tensor
    kbs: torch.Tensor
    kbid: torch.Tensor
    ksc: torch.Tensor
    kwid: torch.Tensor
    vd: torch.Tensor
    vbs: torch.Tensor
    vbid: torch.Tensor
    vsc: torch.Tensor
    vwid: torch.Tensor


def encode_pages_ref(x: torch.Tensor):
    """Rows [n, R, D] f32, one page per leading index -> (deltas i8
    [n, R, D], bases f32 [n, K], base id i8 [n, R], scale f32 [n, R],
    width i8 [n, R]).

    Bases lie on the dyadic lattice ``amin + span * {0, 1/4, 1/2, 1}``
    over the rows' first elements (multiplying by a power of two is
    exact, so the kernel's separate multiply and add give these bits);
    each row takes the first nearest base (strict ``<`` chain); a row
    whose max residual fits 4 bits at the page's pow2 scale keeps that
    scale, else takes its own.  Reductions propagate NaN (a span that
    overflows to inf makes base 0 ``amin + inf * 0``, a NaN).
    """
    x = x.to(torch.float32)
    anchors = x[..., 0]                                   # [n, R]
    amin = anchors.amin(dim=-1, keepdim=True)
    amax = anchors.amax(dim=-1, keepdim=True)
    frac = torch.tensor([0.0, 0.25, 0.5, 1.0], device=x.device)
    bases = amin + (amax - amin) * frac                   # [n, K]
    dist = (anchors[..., None] - bases[:, None, :]).abs()  # [n, R, K]
    best = dist[..., 0]
    bid = torch.zeros_like(anchors, dtype=torch.int32)
    for j in range(1, K_BASES):
        better = dist[..., j] < best
        bid = torch.where(better, j, bid)
        best = torch.where(better, dist[..., j], best)
    base_row = torch.gather(bases, 1, bid.long())         # [n, R]
    r = x - base_row[..., None]
    maxr_row = r.abs().amax(dim=-1)                       # [n, R]
    ps = _pow2_scale(maxr_row.amax(dim=-1, keepdim=True), QMAX)
    fits4 = maxr_row <= Q4MAX * ps
    scale = torch.where(fits4, ps, _pow2_scale(maxr_row, QMAX))
    d = torch.clamp(torch.round(r / scale[..., None]), -QMAX, QMAX)
    nonzero = (d != 0).any(dim=-1)                        # NaN counts
    wid = torch.where(nonzero, torch.where(fits4, 1, 2), 0)
    return (d.to(torch.int8), bases, bid.to(torch.int8), scale,
            wid.to(torch.int8))


def decode_pages_ref(d: torch.Tensor, bases: torch.Tensor,
                     bid: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_pages_ref`: d i8 [n, R, D], bases f32
    [n, K], bid i8 [n, R], sc f32 [n, R] -> f32 [n, R, D].  A base id
    outside 0..K-1 reads base 0.0, as the JAX where-chain does."""
    base_row = torch.zeros_like(sc)
    for j in range(K_BASES):
        base_row = torch.where(bid == j, bases[:, j:j + 1], base_row)
    return d.to(torch.float32) * sc[..., None] + base_row[..., None]

