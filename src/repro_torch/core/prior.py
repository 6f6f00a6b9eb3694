"""Prior-work compression baselines the thesis compares against (Sec 3.6).

* ZCA  [Dusser+,  ICS'09]  — zero-content augmented cache: only all-zero
  lines compress (to ~nothing; we account 1 byte to keep ratios finite).
* FVC  [Yang+, MICRO'00]   — frequent value compression: profile the top-N
  frequent 32-bit words; frequent words encode in ceil(log2(N+1)) bits.
* FPC  [Alameldeen+Wood, ISCA'04] — per-32-bit-word pattern compression with
  3-bit prefixes and zero-run support.

These are *size oracles* (the paper evaluates ratios/miss-rates, and so do
we); bit-exact codecs are unnecessary for the claims being reproduced.
"""

from __future__ import annotations

import numpy as np

from .bdi_exact import LINE_BYTES, zero_lines_mask


# ---------------------------------------------------------------------------
# ZCA
# ---------------------------------------------------------------------------

def zca_sizes(lines: np.ndarray) -> np.ndarray:
    n, line_bytes = lines.shape
    sizes = np.full(n, line_bytes, dtype=np.int32)
    return np.where(zero_lines_mask(lines), 1, sizes)


# ---------------------------------------------------------------------------
# FVC
# ---------------------------------------------------------------------------

def fvc_profile(lines: np.ndarray, n_values: int = 7) -> np.ndarray:
    """Static profiling pass (paper Sec 3.7: '100k instructions')."""
    words = np.ascontiguousarray(lines).view("<u4").reshape(-1)
    vals, counts = np.unique(words, return_counts=True)
    top = vals[np.argsort(counts)[::-1][:n_values]]
    return top.astype("<u4")


def fvc_sizes(lines: np.ndarray, frequent: np.ndarray) -> np.ndarray:
    """FVC size: per 32-bit word, 3-bit code if frequent else 3+32 bits."""
    n, line_bytes = lines.shape
    words = np.ascontiguousarray(lines).view("<u4")     # [n, m]
    m = words.shape[1]
    freq = np.isin(words, frequent)
    bits = m * 3 + (~freq).sum(axis=1) * 32
    sizes = np.ceil(bits / 8).astype(np.int32)
    return np.minimum(sizes, line_bytes)


# ---------------------------------------------------------------------------
# FPC
# ---------------------------------------------------------------------------

def _se_fits(vals: np.ndarray, bits: int) -> np.ndarray:
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return (vals >= lo) & (vals <= hi)


def fpc_sizes(lines: np.ndarray) -> np.ndarray:
    """FPC per-word pattern sizes (data bits + 3-bit prefix per word).

    Patterns (per the ISCA'04 table): zero word (run-length encoded, 3-bit
    run count shared across up to 8 zero words), 4-bit SE, 8-bit SE, 16-bit
    SE, 16-bit padded (low half zero), two-halfword-byte-SE, repeated bytes,
    uncompressed.
    """
    n, line_bytes = lines.shape
    w = np.ascontiguousarray(lines).view("<i4").astype(np.int64)  # [n, m]
    m = w.shape[1]

    data_bits = np.full((n, m), 32, dtype=np.int64)

    def upd(mask, bits):
        nonlocal data_bits
        data_bits = np.where(mask, np.minimum(data_bits, bits), data_bits)

    upd(_se_fits(w, 4), 4)
    upd(_se_fits(w, 8), 8)
    upd(_se_fits(w, 16), 16)
    upd((w & 0xFFFF) == 0, 16)                       # halfword padded w/ zeros
    lo16 = ((w & 0xFFFF) ^ 0x8000) - 0x8000
    hi16 = (((w >> 16) & 0xFFFF) ^ 0x8000) - 0x8000
    upd(_se_fits(lo16, 8) & _se_fits(hi16, 8), 16)   # two byte-SE halfwords
    b = w.astype("<i4").view(np.uint8).reshape(n, m, 4)
    upd((b == b[:, :, :1]).all(axis=2), 8)           # repeated bytes

    is_zero = w == 0
    # zero-run: each maximal run of z zero-words costs one 3+3-bit token per
    # ceil(z/8); non-zero words cost 3-bit prefix + data bits.
    nz_bits = np.where(is_zero, 0, data_bits + 3).sum(axis=1)
    # count zero runs vectorized: starts of runs
    starts = is_zero & ~np.pad(is_zero, ((0, 0), (1, 0)))[:, :m]
    run_tokens = starts.sum(axis=1)  # approx: one token per run (runs < 8 here)
    total_bits = nz_bits + run_tokens * 6
    sizes = np.ceil(total_bits / 8).astype(np.int32)
    return np.minimum(np.maximum(sizes, 1), line_bytes)


# ---------------------------------------------------------------------------
# Convenience: size table across all algorithms
# ---------------------------------------------------------------------------

def all_algorithm_sizes(lines: np.ndarray) -> dict[str, np.ndarray]:
    from . import bdi_exact as bx
    freq = fvc_profile(lines)
    return {
        "zca": zca_sizes(lines),
        "fvc": fvc_sizes(lines, freq),
        "fpc": fpc_sizes(lines),
        "bplusdelta": bx.bplusdelta_sizes(lines, n_bases=1),
        "bplusdelta2": bx.bplusdelta_sizes(lines, n_bases=2),
        "bdi": bx.bdi_sizes(lines),
    }
