"""Linearly Compressed Pages (Chapter 5), port of ``repro/core/lcp.py``.

LCP compresses every line of a page to the same target size, so line
*i* sits at ``i * target_size``: one shift instead of a chain of
additions.  Lines that do not fit are exceptions, kept raw in a
per-page exception region and found through per-line metadata; a page
whose exception region overflows is stored uncompressed (the PTE c-bit
clear case).

Here the target-size region is an int8 delta tensor of static shape,
the metadata region holds per-line base, scale, encoding and packed
base mask (:mod:`.bdi_value`), and the exception region is a fixed pool
of raw f32 slots.  Plain tensor code, as the JAX module is plain jnp: it
runs on the device of its inputs and keeps the JAX package's bits
(``tests/test_torch_lcp.py``).  Counters and flags are 0-d tensors, so
nothing here waits for the device.

Overflow taxonomy (thesis §5.4.6): a type-1 overflow moves an updated
line that no longer fits into the exception region (``write_line``
returns the flag); a page overflow (exception region full) sets
``overflow``, and the page's owner must store it raw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import bdi_value as bv


class LCPPage(NamedTuple):
    """One linearly compressed page of n lines x line_len floats."""
    deltas: torch.Tensor    # int8 [n, L]      target-size region
    base: torch.Tensor      # f32 [n]          metadata region
    scale: torch.Tensor     # f32 [n]
    maskp: torch.Tensor     # uint8 [n, L//8]  packed zero-base mask
    enc: torch.Tensor       # int8 [n]         ENC_*; ENC_RAW lines in exc
    exc_idx: torch.Tensor   # int32 [n]        exception slot or -1
    exc: torch.Tensor       # f32 [E, L]       exception region
    n_exc: torch.Tensor     # int32 []         used exception slots
    overflow: torch.Tensor  # bool []          page overflow (c-bit clear)

    @property
    def n_lines(self) -> int:
        return self.deltas.shape[0]

    @property
    def line_len(self) -> int:
        return self.deltas.shape[1]

    @property
    def exc_slots(self) -> int:
        return self.exc.shape[0]


def compress_page(lines: torch.Tensor, exc_slots: int,
                  raw_rtol: float = 0.02) -> LCPPage:
    """Compress [n, L] float lines into one LCP page."""
    n, length = lines.shape
    c = bv.compress_tiles(lines, raw_rtol=raw_rtol)
    is_exc = c.enc == bv.ENC_RAW
    # exception slots in line order: a running count over the page
    slot = torch.cumsum(is_exc.to(torch.int32), 0, dtype=torch.int32) - 1
    exc_idx = torch.where(is_exc, slot, -1)
    n_exc = is_exc.sum(dtype=torch.int32)
    overflow = n_exc > exc_slots

    safe_idx = torch.clamp(exc_idx, 0, exc_slots - 1).long()
    # scatter-add: other lines add zeros (slots collide, on clipped
    # indices, only once the page has overflowed)
    exc = torch.zeros((exc_slots, length), dtype=torch.float32,
                      device=lines.device).index_add(
        0, safe_idx, torch.where(is_exc[:, None], lines.to(torch.float32),
                                 0.0))
    return LCPPage(c.deltas, c.base, c.scale, bv.pack_mask(c.mask), c.enc,
                   exc_idx, exc, n_exc, overflow)


def _dequant(p: LCPPage) -> torch.Tensor:
    mask = bv.unpack_mask(p.maskp).to(torch.float32)
    return (p.deltas.to(torch.float32) * p.scale[:, None]
            + mask * p.base[:, None])


def decompress_page(p: LCPPage) -> torch.Tensor:
    """Full-page decompression (exceptions restored exactly)."""
    approx = _dequant(p)
    from_exc = p.exc[torch.clamp(p.exc_idx, 0, p.exc_slots - 1).long()]
    return torch.where((p.exc_idx >= 0)[:, None], from_exc, approx)


def read_line(p: LCPPage, i) -> torch.Tensor:
    """Random access to line *i* (an int or a 0-d integer tensor): the
    LCP O(1) address computation.  One gather into the target-size
    region plus the metadata-directed exception override; no prefix sum
    over the sizes of the lines before it (§5.1.1)."""
    d = p.deltas[i].to(torch.float32)
    mask = bv.unpack_mask(p.maskp[i]).to(torch.float32)
    approx = d * p.scale[i] + mask * p.base[i]
    exc_line = p.exc[torch.clamp(p.exc_idx[i], 0, p.exc_slots - 1)]
    return torch.where(p.exc_idx[i] >= 0, exc_line, approx)


def _set(t: torch.Tensor, i, v) -> torch.Tensor:
    out = t.clone()
    out[i] = v
    return out


def write_line(p: LCPPage, i, line: torch.Tensor,
               raw_rtol: float = 0.02) -> tuple[LCPPage, torch.Tensor]:
    """Update line *i*; returns (page', type1_overflow).

    A line that no longer fits the compressed budget moves to the
    exception region (type-1 overflow); if the region is full the page's
    ``overflow`` flag rises (its owner re-stores it uncompressed).
    """
    line = line.to(torch.float32)[None, :]
    c = bv.compress_tiles(line, raw_rtol=raw_rtol)
    needs_exc = c.enc[0] == bv.ENC_RAW
    had_exc = p.exc_idx[i] >= 0

    # a slot: the line's old one, else the next free one
    new_slot = torch.where(had_exc, p.exc_idx[i], p.n_exc)
    type1 = needs_exc & ~had_exc
    n_exc = p.n_exc + type1.to(torch.int32)
    page_overflow = p.overflow | (n_exc > p.exc_slots)

    safe_slot = torch.clamp(new_slot, 0, p.exc_slots - 1)
    exc = torch.where(needs_exc, _set(p.exc, safe_slot, line[0]), p.exc)
    # a slot freed by an exception -> compressed update is reclaimed by
    # recompaction, off the critical path (as §5.4.6 does)
    exc_idx = _set(p.exc_idx, i, torch.where(needs_exc, new_slot, -1))

    return LCPPage(
        deltas=_set(p.deltas, i, c.deltas[0]),
        base=_set(p.base, i, c.base[0]),
        scale=_set(p.scale, i, c.scale[0]),
        maskp=_set(p.maskp, i, bv.pack_mask(c.mask)[0]),
        enc=_set(p.enc, i, c.enc[0]),
        exc_idx=exc_idx, exc=exc, n_exc=n_exc, overflow=page_overflow,
    ), type1


def recompact_page(p: LCPPage, raw_rtol: float = 0.02) -> LCPPage:
    """Rebuild the page from its logical contents (frees dead slots)."""
    return compress_page(decompress_page(p), p.exc_slots, raw_rtol)


# ---------------------------------------------------------------------------
# Size accounting (thesis Figures 5.8/5.9)
# ---------------------------------------------------------------------------

def page_nbytes(p: LCPPage, elem_bytes: int = 2) -> torch.Tensor:
    """Physical bytes of the page (data + metadata + exceptions), int32.

    The uncompressed page costs n*L*elem_bytes; an overflowed page counts
    as raw.
    """
    n, length = p.deltas.shape
    data = n * length                       # int8 target-size region
    meta = n * (4 + 1 + 1 + length // 8)    # base + scale-exp + enc + mask
    compressed = (data + meta) + (p.n_exc * (length * 4)).to(torch.int32)
    raw = n * length * elem_bytes
    return torch.where(p.overflow, raw,
                       torch.clamp(compressed, max=raw)).to(torch.int32)


def page_compression_ratio(p: LCPPage, elem_bytes: int = 2) -> torch.Tensor:
    n, length = p.deltas.shape
    nbytes = page_nbytes(p, elem_bytes).to(torch.float32)
    # a tensor numerator: PyTorch's number / tensor multiplies by the
    # reciprocal, one ULP off the true quotient
    return torch.full_like(nbytes, n * length * elem_bytes) / nbytes
