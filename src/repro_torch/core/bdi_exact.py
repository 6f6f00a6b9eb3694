"""Lossless Base-Delta-Immediate (BDI) codec — paper-faithful (Chapter 3).

Implements the exact Table 3.2 encoding set over fixed-size "cache lines"
(default 64 bytes), with the two-step BDI algorithm of Section 3.5.1:

  Step 1: for a fixed delta width d, try to compress every k-byte element
          against the *implicit zero base* (the "Immediate" part).
  Step 2: the first element that fails Step 1 becomes the arbitrary base B
          (the paper's "first value as base" rule, Section 3.3.2); remaining
          elements must compress as (v - B) in d bytes.

Decompression is the paper's masked vector add: v_i = delta_i + mask_i * B,
with deltas sign-extended from d bytes (Figure 3.10 + "BDI Design Specifics").

Also implements single-/multi-base B+Delta (Sections 3.3, 3.4.1) used for the
Figure 3.6 number-of-bases sweep, and a real byte-stream serialization used by
the checkpoint substrate.

Sizes follow Table 3.2 (metadata — the 4-bit encoding and the zero-base
bitmask — lives in the tag store per Section 3.7 and is *not* counted in the
compressed size, matching the paper's effective-compression-ratio accounting;
the serialized stream format *does* count it, and we report both).

Everything is vectorized numpy over [n_lines, line_bytes] uint8 arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LINE_BYTES = 64

# ---------------------------------------------------------------------------
# Encoding table (Table 3.2). Sizes are for the configured line size.
# code 0b0000 Zeros, 0b0001 Rep8, then (k, d) pairs, 0b1111 uncompressed.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Encoding:
    name: str
    code: int
    base: int    # base size k in bytes (0 for zeros/rep/uncompressed special)
    delta: int   # delta size d in bytes

    def compressed_size(self, line_bytes: int) -> int:
        if self.name == "zeros":
            return 1
        if self.name == "rep8":
            return 8
        if self.name == "uncompressed":
            return line_bytes
        n = line_bytes // self.base
        return self.base + n * self.delta


ENC_ZEROS = Encoding("zeros", 0b0000, 0, 0)
ENC_REP8 = Encoding("rep8", 0b0001, 8, 0)
ENC_B8D1 = Encoding("b8d1", 0b0010, 8, 1)
ENC_B8D2 = Encoding("b8d2", 0b0011, 8, 2)
ENC_B8D4 = Encoding("b8d4", 0b0100, 8, 4)
ENC_B4D1 = Encoding("b4d1", 0b0101, 4, 1)
ENC_B4D2 = Encoding("b4d2", 0b0110, 4, 2)
ENC_B2D1 = Encoding("b2d1", 0b0111, 2, 1)
ENC_RAW = Encoding("uncompressed", 0b1111, 0, 0)

BASE_DELTA_ENCODINGS = (ENC_B8D1, ENC_B8D2, ENC_B8D4, ENC_B4D1, ENC_B4D2,
                        ENC_B2D1)
ALL_ENCODINGS = (ENC_ZEROS, ENC_REP8) + BASE_DELTA_ENCODINGS + (ENC_RAW,)
ENCODING_BY_CODE = {e.code: e for e in ALL_ENCODINGS}

_SIGNED_DT = {2: np.dtype("<i2"), 4: np.dtype("<i4"), 8: np.dtype("<i8")}


def line_elements(lines: np.ndarray, k: int) -> np.ndarray:
    """View [n, line_bytes] uint8 lines as [n, line_bytes//k] signed ints."""
    if lines.dtype != np.uint8 or lines.ndim != 2:
        raise ValueError("lines must be [n, line_bytes] uint8")
    return np.ascontiguousarray(lines).view(_SIGNED_DT[k])


def _fits(v: np.ndarray, d: int) -> np.ndarray:
    """Does each signed element sign-extend from its low d bytes?

    This is the hardware check of Figure 3.9 (high bytes all-0 or all-1 and
    consistent with the sign of the low part).
    """
    bits = 8 * d
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    return (v >= lo) & (v <= hi)


# ---------------------------------------------------------------------------
# Per-line size / encoding oracles (vectorized)
# ---------------------------------------------------------------------------

def zero_lines_mask(lines: np.ndarray) -> np.ndarray:
    return ~lines.any(axis=1)


def rep8_lines_mask(lines: np.ndarray) -> np.ndarray:
    el = line_elements(lines, 8)
    return (el == el[:, :1]).all(axis=1)


def _bdi_fit_mask(el: np.ndarray, d: int) -> tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """Two-step BDI fit for one (k, d) pair.

    Returns (ok[n], base[n], zero_mask[n, m]) where zero_mask marks elements
    compressed against the implicit zero base (Step 1).
    """
    with np.errstate(over="ignore"):
        zfit = _fits(el, d)                          # Step 1: immediates
        all_z = zfit.all(axis=1)
        # Step 2 base: first element NOT fitting the zero base.
        first_nz = np.argmax(~zfit, axis=1)          # 0 if all fit
        base = np.take_along_axis(el, first_nz[:, None], axis=1)[:, 0]
        base = np.where(all_z, 0, base)              # degenerate: no base used
        diff = el - base[:, None]                    # wraps, like hardware
        bfit = _fits(diff, d)
        ok = (zfit | bfit).all(axis=1)
    return ok, base, zfit


def _bplusdelta_fit_mask(el: np.ndarray, d: int) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """Single-arbitrary-base B+Delta fit (first value as base)."""
    with np.errstate(over="ignore"):
        base = el[:, 0]
        diff = el - base[:, None]
        ok = _fits(diff, d).all(axis=1)
    return ok, base


def bdi_encode_choice(lines: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pick the best Table-3.2 encoding per line.

    Returns (codes[n] uint8, sizes[n] int32). Matches the compressor-unit
    selection logic (Figure 3.8): all units run "in parallel", smallest
    compressed size wins.
    """
    n, line_bytes = lines.shape
    sizes = np.full(n, line_bytes, dtype=np.int32)
    codes = np.full(n, ENC_RAW.code, dtype=np.uint8)

    def consider(mask: np.ndarray, enc: Encoding) -> None:
        nonlocal sizes, codes
        s = enc.compressed_size(line_bytes)
        take = mask & (s < sizes)
        sizes = np.where(take, s, sizes)
        codes = np.where(take, enc.code, codes)

    # Evaluate in *increasing size* order so ties keep the simpler encoding.
    cands: list[tuple[np.ndarray, Encoding]] = []
    cands.append((zero_lines_mask(lines), ENC_ZEROS))
    cands.append((rep8_lines_mask(lines), ENC_REP8))
    for enc in BASE_DELTA_ENCODINGS:
        el = line_elements(lines, enc.base)
        ok, _, _ = _bdi_fit_mask(el, enc.delta)
        cands.append((ok, enc))
    for mask, enc in sorted(cands, key=lambda t: t[1].compressed_size(line_bytes)):
        consider(mask, enc)
    return codes, sizes


def bdi_sizes(lines: np.ndarray) -> np.ndarray:
    return bdi_encode_choice(lines)[1]


def bplusdelta_sizes(lines: np.ndarray, n_bases: int = 1) -> np.ndarray:
    """B+Delta with up to ``n_bases`` *arbitrary* bases (greedy, Sec 3.4.1).

    ``n_bases == 0`` reduces to zero/repeated-value compression only (the "0"
    bar of Figure 3.6). All variants keep the zero/rep special cases, per the
    paper's footnote 6 ("We assume this optimization for all bars").
    """
    n, line_bytes = lines.shape
    sizes = np.full(n, line_bytes, dtype=np.int32)
    # zero / repeated special cases
    sizes = np.where(zero_lines_mask(lines), np.minimum(sizes, 1), sizes)
    sizes = np.where(rep8_lines_mask(lines), np.minimum(sizes, 8), sizes)
    if n_bases == 0:
        return sizes
    for enc in BASE_DELTA_ENCODINGS:
        el = line_elements(lines, enc.base)
        m = el.shape[1]
        assigned = np.zeros_like(el, dtype=bool)
        used = np.zeros(n, dtype=np.int32)
        with np.errstate(over="ignore"):
            for _ in range(n_bases):
                remaining = ~assigned
                any_rem = remaining.any(axis=1)
                first = np.argmax(remaining, axis=1)
                base = np.take_along_axis(el, first[:, None], axis=1)[:, 0]
                fit = _fits(el - base[:, None], enc.delta) & remaining
                fit &= any_rem[:, None]
                assigned |= fit
                used += any_rem.astype(np.int32)
        ok = assigned.all(axis=1)
        # size: one k-byte slot per base used + d bytes per element
        s = used * enc.base + m * enc.delta
        sizes = np.where(ok, np.minimum(sizes, s.astype(np.int32)), sizes)
    return sizes


def effective_ratio(sizes: np.ndarray, line_bytes: int = LINE_BYTES,
                    segment_bytes: int = 1, tag_ratio_cap: float = 2.0) -> float:
    """Paper's effective compression ratio (Sec 3.7).

    Compressed lines occupy whole ``segment_bytes`` segments; the number of
    tags (2x in the evaluated design) caps how many logical lines the data
    store can address, hence ``tag_ratio_cap``.
    """
    seg = np.maximum(1, np.ceil(sizes / segment_bytes)) * segment_bytes
    raw = sizes.shape[0] * line_bytes / float(seg.sum())
    return float(min(raw, tag_ratio_cap)) if tag_ratio_cap else float(raw)


# ---------------------------------------------------------------------------
# Real compression / decompression (bit-exact round trip)
# ---------------------------------------------------------------------------

def _sign_extend(raw: np.ndarray, d: int) -> np.ndarray:
    """Sign-extend [n, m, d]-byte little-endian groups to int64 [n, m]."""
    out = np.zeros(raw.shape[:2], dtype=np.uint64)
    for i in range(d):
        out |= raw[:, :, i].astype(np.uint64) << np.uint64(8 * i)
    if d == 8:
        return out.view(np.int64)
    bits = 8 * d
    sign = np.uint64(1 << (bits - 1))
    return ((out ^ sign) - sign).view(np.int64)


def _take_low_bytes(v: np.ndarray, d: int) -> np.ndarray:
    """[n, m] int64 -> [n, m, d] little-endian low bytes."""
    n, m = v.shape
    out = np.empty((n, m, d), dtype=np.uint8)
    u = v.astype(np.uint64)
    for i in range(d):
        out[:, :, i] = ((u >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8)
    return out


@dataclass
class CompressedLines:
    """Columnar compressed representation of a batch of lines."""
    line_bytes: int
    codes: np.ndarray        # [n] uint8 encoding code
    bases: np.ndarray        # [n] int64 arbitrary base (0 where unused)
    masks: np.ndarray        # [n, 32] bool zero-base mask (True => use base B)
    deltas: np.ndarray       # [n, 32] int64 per-element delta (sign-extended)
    raw: np.ndarray          # [n_raw, line_bytes] uint8 payload of raw lines
    raw_index: np.ndarray    # [n] int32 index into raw (-1 if compressed)

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    def paper_sizes(self) -> np.ndarray:
        lb = self.line_bytes
        return np.array([ENCODING_BY_CODE[int(c)].compressed_size(lb)
                         for c in self.codes], dtype=np.int32)

    def stream_nbytes(self) -> int:
        """Serialized size including all metadata (enc byte + bitmask)."""
        total = 0
        for c in self.codes:
            enc = ENCODING_BY_CODE[int(c)]
            total += 1  # encoding byte
            if enc.name == "zeros":
                continue
            if enc.name == "rep8":
                total += 8
            elif enc.name == "uncompressed":
                total += self.line_bytes
            else:
                m = self.line_bytes // enc.base
                total += (m + 7) // 8           # zero-base bitmask
                total += enc.base + m * enc.delta
        return total


def bdi_compress(lines: np.ndarray) -> CompressedLines:
    """Compress lines with the best BDI encoding (vectorized)."""
    n, line_bytes = lines.shape
    codes, _ = bdi_encode_choice(lines)
    bases = np.zeros(n, dtype=np.int64)
    masks = np.zeros((n, 32), dtype=bool)
    deltas = np.zeros((n, 32), dtype=np.int64)
    raw_index = np.full(n, -1, dtype=np.int32)

    for enc in BASE_DELTA_ENCODINGS:
        sel = codes == enc.code
        if not sel.any():
            continue
        el = line_elements(lines[sel], enc.base)
        ok, base, zfit = _bdi_fit_mask(el, enc.delta)
        assert ok.all()
        m = el.shape[1]
        with np.errstate(over="ignore"):
            d = np.where(zfit, el, el - base[:, None])
        bases[sel] = base
        masks_sel = np.zeros((el.shape[0], 32), dtype=bool)
        masks_sel[:, :m] = ~zfit
        masks[sel] = masks_sel
        del_sel = np.zeros((el.shape[0], 32), dtype=np.int64)
        del_sel[:, :m] = d
        deltas[sel] = del_sel

    rep_sel = codes == ENC_REP8.code
    if rep_sel.any():
        bases[rep_sel] = line_elements(lines[rep_sel], 8)[:, 0]

    raw_sel = codes == ENC_RAW.code
    raw = lines[raw_sel].copy()
    raw_index[raw_sel] = np.arange(raw.shape[0], dtype=np.int32)
    return CompressedLines(line_bytes, codes, bases, masks, deltas, raw,
                           raw_index)


def bdi_decompress(c: CompressedLines) -> np.ndarray:
    """Masked vector add decompression (Figure 3.10)."""
    n, lb = c.n, c.line_bytes
    out = np.zeros((n, lb), dtype=np.uint8)
    for enc in BASE_DELTA_ENCODINGS:
        sel = c.codes == enc.code
        if not sel.any():
            continue
        m = lb // enc.base
        with np.errstate(over="ignore"):
            # THE paper decompressor: v = delta + mask * base (one vector op).
            v = (c.deltas[sel, :m]
                 + c.masks[sel, :m] * c.bases[sel, None])
        k = enc.base
        dt = _SIGNED_DT[k]
        out[sel] = v.astype(dt).view(np.uint8).reshape(sel.sum(), lb)
    rep_sel = c.codes == ENC_REP8.code
    if rep_sel.any():
        v = np.repeat(c.bases[rep_sel, None], lb // 8, axis=1)
        out[rep_sel] = v.astype("<i8").view(np.uint8).reshape(rep_sel.sum(), lb)
    raw_sel = c.codes == ENC_RAW.code
    if raw_sel.any():
        out[raw_sel] = c.raw[c.raw_index[raw_sel]]
    return out


# ---------------------------------------------------------------------------
# Byte-stream serialization (used by the checkpoint substrate)
# ---------------------------------------------------------------------------

_STREAM_MAGIC = b"BDI1"


def compress_stream(data: bytes | np.ndarray,
                    line_bytes: int = LINE_BYTES) -> bytes:
    """Serialize an arbitrary byte buffer as BDI-compressed lines.

    Layout: magic | u64 payload_len | per-line records
    (enc byte, then encoding-dependent payload; see CompressedLines).
    """
    buf = np.frombuffer(data.tobytes() if isinstance(data, np.ndarray) else data,
                        dtype=np.uint8)
    orig_len = buf.size
    pad = (-orig_len) % line_bytes
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, dtype=np.uint8)])
    lines = buf.reshape(-1, line_bytes)
    c = bdi_compress(lines)

    parts: list[bytes] = [_STREAM_MAGIC,
                          np.uint64(orig_len).tobytes(),
                          np.uint32(line_bytes).tobytes(),
                          np.uint32(c.n).tobytes(),
                          c.codes.tobytes()]
    # Columnar payload: group by encoding for fast vectorized packing.
    for enc in BASE_DELTA_ENCODINGS:
        sel = c.codes == enc.code
        cnt = int(sel.sum())
        if cnt == 0:
            continue
        m = line_bytes // enc.base
        mask_bits = np.packbits(c.masks[sel, :m], axis=1)
        base_b = c.bases[sel].astype("<i8").view(np.uint8).reshape(cnt, 8)
        delta_b = _take_low_bytes(c.deltas[sel, :m], enc.delta).reshape(cnt, -1)
        parts += [mask_bits.tobytes(), base_b[:, :enc.base].tobytes(),
                  delta_b.tobytes()]
    rep_sel = c.codes == ENC_REP8.code
    if rep_sel.any():
        parts.append(c.bases[rep_sel].astype("<i8").tobytes())
    if c.raw.size:
        parts.append(c.raw.tobytes())
    return b"".join(parts)


def decompress_stream(blob: bytes) -> np.ndarray:
    """Inverse of :func:`compress_stream`; returns uint8 array."""
    if blob[:4] != _STREAM_MAGIC:
        raise ValueError("bad BDI stream magic")
    off = 4
    orig_len = int(np.frombuffer(blob, np.uint64, 1, off)[0]); off += 8
    line_bytes = int(np.frombuffer(blob, np.uint32, 1, off)[0]); off += 4
    n = int(np.frombuffer(blob, np.uint32, 1, off)[0]); off += 4
    codes = np.frombuffer(blob, np.uint8, n, off).copy(); off += n

    bases = np.zeros(n, dtype=np.int64)
    masks = np.zeros((n, 32), dtype=bool)
    deltas = np.zeros((n, 32), dtype=np.int64)
    raw_index = np.full(n, -1, dtype=np.int32)

    for enc in BASE_DELTA_ENCODINGS:
        sel = codes == enc.code
        cnt = int(sel.sum())
        if cnt == 0:
            continue
        m = line_bytes // enc.base
        mb = (m + 7) // 8
        mask_bits = np.frombuffer(blob, np.uint8, cnt * mb, off)\
            .reshape(cnt, mb); off += cnt * mb
        msel = np.unpackbits(mask_bits, axis=1)[:, :m].astype(bool)
        base_b = np.zeros((cnt, 8), dtype=np.uint8)
        base_b[:, :enc.base] = np.frombuffer(
            blob, np.uint8, cnt * enc.base, off).reshape(cnt, enc.base)
        off += cnt * enc.base
        base = _sign_extend(base_b[:, None, :enc.base], enc.base)[:, 0]
        delta_b = np.frombuffer(blob, np.uint8, cnt * m * enc.delta, off)\
            .reshape(cnt, m, enc.delta); off += cnt * m * enc.delta
        d = _sign_extend(delta_b, enc.delta)
        bases[sel] = base
        tmp = np.zeros((cnt, 32), dtype=bool); tmp[:, :m] = msel
        masks[sel] = tmp
        tmp2 = np.zeros((cnt, 32), dtype=np.int64); tmp2[:, :m] = d
        deltas[sel] = tmp2

    rep_sel = codes == ENC_REP8.code
    cnt = int(rep_sel.sum())
    if cnt:
        bases[rep_sel] = np.frombuffer(blob, "<i8", cnt, off); off += cnt * 8

    raw_sel = codes == ENC_RAW.code
    cnt = int(raw_sel.sum())
    raw = np.frombuffer(blob, np.uint8, cnt * line_bytes, off)\
        .reshape(cnt, line_bytes).copy() if cnt else \
        np.zeros((0, line_bytes), dtype=np.uint8)
    off += cnt * line_bytes
    raw_index[raw_sel] = np.arange(cnt, dtype=np.int32)

    c = CompressedLines(line_bytes, codes, bases, masks, deltas, raw, raw_index)
    out = bdi_decompress(c).reshape(-1)
    return out[:orig_len]
