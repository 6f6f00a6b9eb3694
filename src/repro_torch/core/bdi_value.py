"""Value-space BDI tile codec (port of ``repro/core/bdi_value.py``).

The thesis' BDI mechanism — one arbitrary base (the line's first value),
one implicit zero base, narrow per-element deltas and a per-element mask
choosing the base — lifted to float values:

    x_hat[i] = delta[i] * scale + mask[i] * base        (one masked FMA)

``scale`` is the power of two covering the largest residual in the delta
width (int8 or int16), so quantization is an exponent shift.  Encodings
{ZERO, REP, D8, D16, RAW} mirror the thesis' Table 3.2; RAW tiles are
exceptions that the LCP page layout (:mod:`.lcp`) keeps exactly.  Error
bound: |x - x_hat| <= scale/2 elementwise (0 for ZERO and REP tiles).

Plain tensor code: it runs on the device of its inputs, and gives the
JAX package's bits on the same f32 inputs (held against it on the CPU by
``tests/test_torch_tile_codec.py``).  The tile kernels' plain versions
(``kernels/ref.py`` ``compress_ref``/``decompress_ref``) are built on it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 128

ENC_ZERO = 0
ENC_REP = 1
ENC_D8 = 2
ENC_D16 = 3
ENC_RAW = 7
ENC_NAMES = {ENC_ZERO: "zero", ENC_REP: "rep", ENC_D8: "d8",
             ENC_D16: "d16", ENC_RAW: "raw"}


class CompressedTiles(NamedTuple):
    """Columnar compressed tiles; all tensors share leading tile dims."""
    deltas: torch.Tensor   # int8 or int16 [..., T]
    base: torch.Tensor     # f32 [...]
    scale: torch.Tensor    # f32 power of two [...]
    mask: torch.Tensor     # bool [..., T]; True: the tile's base, False: zero
    enc: torch.Tensor      # int8 [...]


def _pow2_scale(maxres: torch.Tensor, qmax: float) -> torch.Tensor:
    """Smallest power of two s with maxres/s <= qmax, from the exponent
    bits of ``maxres / qmax`` (rounded up when the mantissa is nonzero);
    1.0 where maxres is 0.

    ``2^e`` is built from its bits, not with ``exp2``: e = -127 (a ratio
    that underflowed to 0) is the subnormal 2^-127, which PyTorch's CUDA
    ``exp2`` does not return, and e = 128 is inf.  So the plain version
    gives the same bits on every device, and the kernels mirror it.  The
    divisor is a tensor on purpose: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can land one ULP off the
    true quotient and move ``e`` at exact powers of two.
    """
    ratio = (maxres / torch.full_like(maxres, qmax)).to(torch.float32)
    bits = ratio.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127              # floor(log2(ratio))
    e = e + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    s = torch.where(e >= -126, (e + 127) << 23,
                    torch.full_like(e, 1 << 22)).view(torch.float32)
    return torch.where(maxres > 0, s, torch.ones_like(s))


def compress_tiles(x: torch.Tensor, *, delta_dtype=torch.int8,
                   raw_rtol: float | None = None) -> CompressedTiles:
    """Compress float tiles laid out as [..., T].

    ``raw_rtol``: if given, tiles whose error bound exceeds ``raw_rtol *
    max|tile|`` are tagged ENC_RAW; the caller (the LCP page writer) must
    keep their exact payload.
    """
    x = x.to(torch.float32)
    qmax = 127.0 if delta_dtype == torch.int8 else 32767.0

    base = x[..., 0]
    r_base = x - base[..., None]
    mask = r_base.abs() < x.abs()           # the nearer base wins (strict)
    r = torch.where(mask, r_base, x)
    scale = _pow2_scale(r.abs().amax(dim=-1), qmax)
    deltas = torch.clamp(torch.round(r / scale[..., None]), -qmax, qmax)
    deltas = deltas.to(delta_dtype)

    maxabs = x.abs().amax(dim=-1)
    is_zero = maxabs == 0
    is_rep = (x == base[..., None]).all(dim=-1) & ~is_zero

    enc_q = ENC_D8 if delta_dtype == torch.int8 else ENC_D16
    enc = torch.full(base.shape, enc_q, dtype=torch.int8, device=x.device)
    if raw_rtol is not None:
        enc = torch.where(scale * 0.5 > raw_rtol * maxabs,
                          torch.full_like(enc, ENC_RAW), enc)
    enc = torch.where(is_rep, torch.full_like(enc, ENC_REP), enc)
    enc = torch.where(is_zero, torch.full_like(enc, ENC_ZERO), enc)

    # ZERO and REP tiles canonical, so decompression is one unconditional
    # FMA: deltas 0, mask all False (ZERO) or all True (REP), base +0.0
    # for ZERO (a row of mixed +-0.0 included)
    zero, rep = (enc == ENC_ZERO)[..., None], (enc == ENC_REP)[..., None]
    deltas = deltas.masked_fill(zero | rep, 0)
    mask = (mask | rep) & ~zero
    base = torch.where(enc == ENC_ZERO, torch.zeros_like(base), base)
    return CompressedTiles(deltas, base, scale, mask, enc)


def decompress_tiles(c: CompressedTiles,
                     dtype=torch.float32) -> torch.Tensor:
    """The thesis' decompressor, lifted: one masked vector FMA."""
    out = (c.deltas.to(torch.float32) * c.scale[..., None]
           + c.mask.to(torch.float32) * c.base[..., None])
    return out.to(dtype)


def error_bound(c: CompressedTiles) -> torch.Tensor:
    """Elementwise abs-error bound per tile (0 for exact encodings)."""
    exact = (c.enc == ENC_ZERO) | (c.enc == ENC_REP)
    return torch.where(exact, torch.zeros_like(c.scale), 0.5 * c.scale)


# ---------------------------------------------------------------------------
# Size accounting (base, scale and mask are the metadata region)
# ---------------------------------------------------------------------------

def tile_size_bytes(enc: torch.Tensor, tile: int,
                    elem_bytes: int = 2) -> torch.Tensor:
    """Compressed bytes per tile, int32: ZERO 0; REP 4 (base); D8 5 +
    T/8 + T; D16 5 + T/8 + 2T; RAW T * elem_bytes.  The 5 is an f32 base
    and an int8 scale exponent; T/8 the packed mask."""
    meta = 5 + tile // 8
    sizes = torch.full(enc.shape, tile * elem_bytes, dtype=torch.int32,
                       device=enc.device)
    for code, size in ((ENC_ZERO, 0), (ENC_REP, 4), (ENC_D8, meta + tile),
                       (ENC_D16, meta + 2 * tile)):
        sizes = torch.where(enc == code, torch.full_like(sizes, size), sizes)
    return sizes


def compression_ratio(c: CompressedTiles, elem_bytes: int = 2
                      ) -> torch.Tensor:
    """Raw bytes over compressed bytes, an f32 scalar tensor."""
    tile = c.deltas.shape[-1]
    sizes = tile_size_bytes(c.enc, tile, elem_bytes)
    raw = torch.tensor(float(c.enc.numel() * tile * elem_bytes),
                       dtype=torch.float32, device=c.enc.device)
    return raw / torch.clamp(sizes.sum().to(torch.float32), min=1.0)


# ---------------------------------------------------------------------------
# Mask packing (for storage formats where the bitmask lives in HBM)
# ---------------------------------------------------------------------------

def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool [..., T] -> uint8 [..., T//8], little-endian within a byte:
    element j is bit j % 8 of byte j // 8."""
    t = mask.shape[-1]
    if t % 8:
        raise ValueError(f"mask length {t} is not a multiple of 8")
    m = mask.reshape(*mask.shape[:-1], t // 8, 8).to(torch.uint8)
    weights = torch.ones(8, dtype=torch.uint8, device=mask.device) << \
        torch.arange(8, dtype=torch.uint8, device=mask.device)
    return (m * weights).sum(dim=-1).to(torch.uint8)


def unpack_mask(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., T//8] -> bool [..., T]."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8) > 0


# ---------------------------------------------------------------------------
# Tensor <-> tile folding
# ---------------------------------------------------------------------------

def fold_to_tiles(x: torch.Tensor,
                  tile: int = TILE) -> tuple[torch.Tensor, int]:
    """Flatten to [n_tiles, tile], zero-padding the tail; returns (tiles,
    n) with n the element count."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % tile
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, tile), n


def unfold_from_tiles(tiles: torch.Tensor, n: int, shape) -> torch.Tensor:
    return tiles.reshape(-1)[:n].reshape(shape)


def compress_tensor(x: torch.Tensor, tile: int = TILE,
                    **kw) -> tuple[CompressedTiles, int]:
    tiles, n = fold_to_tiles(x, tile)
    return compress_tiles(tiles, **kw), n


def decompress_tensor(c: CompressedTiles, n: int, shape,
                      dtype=torch.float32) -> torch.Tensor:
    return unfold_from_tiles(decompress_tiles(c, dtype), n, shape)
