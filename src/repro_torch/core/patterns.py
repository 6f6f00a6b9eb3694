"""Synthetic cache-line pattern generators matching the thesis' taxonomy.

Chapter 3 (Section 3.2) identifies the compressible-pattern families found in
real workloads: Zeros, Repeated Values, Narrow Values, and other Low-Dynamic-
Range (LDR) data (pointer tables, low-gradient images).  Figure 3.1 reports
the population mix over SPEC CPU2006 + TPC-H + Apache (~43% of lines fall in
some compressible class).  We reproduce the paper's compression-ratio claims
on synthetic line populations drawn from these generators, and on real DNN
tensor data elsewhere.

All generators return uint8 arrays of shape [n, line_bytes] (little-endian
packed words), deterministic in the provided seed.
"""

from __future__ import annotations

import numpy as np

LINE_BYTES = 64

__all__ = [
    "zeros_lines",
    "repeated_lines",
    "narrow_lines",
    "ldr_lines",
    "pointer_table_lines",
    "mixed_two_range_lines",
    "random_lines",
    "thesis_mix",
    "PATTERN_GENERATORS",
]


def _pack(words: np.ndarray, width: int) -> np.ndarray:
    """Pack integer words (n, line_bytes // width) into uint8 lines."""
    dt = {1: "<u1", 2: "<u2", 4: "<u4", 8: "<u8"}[width]
    arr = words.astype(dt, copy=False)
    return arr.view(np.uint8).reshape(arr.shape[0], -1)


def zeros_lines(n: int, seed: int = 0, line_bytes: int = LINE_BYTES) -> np.ndarray:
    """All-zero lines (NULL pointers, fresh allocations, sparse matrices)."""
    del seed
    return np.zeros((n, line_bytes), dtype=np.uint8)


def repeated_lines(n: int, seed: int = 0, width: int = 8,
                   line_bytes: int = LINE_BYTES) -> np.ndarray:
    """One value repeated across the line (common array initialisers)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2 ** (8 * width) - 1, size=(n, 1), dtype=np.uint64)
    words = np.repeat(vals, line_bytes // width, axis=1)
    return _pack(words, width)


def narrow_lines(n: int, seed: int = 0, width: int = 4, value_bits: int = 7,
                 line_bytes: int = LINE_BYTES) -> np.ndarray:
    """Small values stored in over-provisioned data types (Sec 3.2)."""
    rng = np.random.default_rng(seed)
    lo = -(2 ** (value_bits - 1))
    hi = 2 ** (value_bits - 1)
    vals = rng.integers(lo, hi, size=(n, line_bytes // width), dtype=np.int64)
    # Two's-complement into unsigned container of the target width.
    vals = vals & ((1 << (8 * width)) - 1)
    return _pack(vals.astype(np.uint64), width)


def ldr_lines(n: int, seed: int = 0, width: int = 8, delta_bits: int = 7,
              line_bytes: int = LINE_BYTES) -> np.ndarray:
    """Low-dynamic-range lines: large base + small spread (h264ref, Fig 3.3)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1 << 20, 1 << 40, size=(n, 1), dtype=np.uint64)
    lo = -(2 ** (delta_bits - 1))
    hi = 2 ** (delta_bits - 1)
    deltas = rng.integers(lo, hi, size=(n, line_bytes // width), dtype=np.int64)
    words = (base.astype(np.int64) + deltas).astype(np.uint64)
    return _pack(words, width)


def pointer_table_lines(n: int, seed: int = 0,
                        line_bytes: int = LINE_BYTES) -> np.ndarray:
    """Nearby pointers in one line (perlbench example, Fig 3.4).

    8-byte pointers into the same memory region: 2-byte dynamic range.
    """
    return ldr_lines(n, seed=seed, width=8, delta_bits=15, line_bytes=line_bytes)


def mixed_two_range_lines(n: int, seed: int = 0,
                          line_bytes: int = LINE_BYTES) -> np.ndarray:
    """The mcf example (Fig 3.5): pointers mixed with small integers.

    Needs *two* bases (one of them zero) — the motivating case for BDI over
    single-base B+Delta.
    """
    rng = np.random.default_rng(seed)
    nw = line_bytes // 4
    base = rng.integers(1 << 24, 1 << 31, size=(n, 1), dtype=np.int64)
    deltas = rng.integers(-128, 128, size=(n, nw), dtype=np.int64)
    words = base + deltas
    # Roughly half the slots hold small immediates instead of pointers.
    imm_mask = rng.random((n, nw)) < 0.5
    imms = rng.integers(-100, 128, size=(n, nw), dtype=np.int64)
    words = np.where(imm_mask, imms, words) & 0xFFFFFFFF
    return _pack(words.astype(np.uint64), 4)


def random_lines(n: int, seed: int = 0,
                 line_bytes: int = LINE_BYTES) -> np.ndarray:
    """Incompressible high-entropy lines (encrypted / already-compressed)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, line_bytes), dtype=np.uint8)


PATTERN_GENERATORS = {
    "zeros": zeros_lines,
    "repeated": repeated_lines,
    "narrow": narrow_lines,
    "ldr": ldr_lines,
    "pointer_table": pointer_table_lines,
    "mixed_two_range": mixed_two_range_lines,
    "random": random_lines,
}

# Population mix approximating Figure 3.1 ("43% of lines compressible"):
# zero 20%, repeated 10%, narrow 5%, other-LDR 8% -> 43%; remainder random.
THESIS_MIX = {
    "zeros": 0.20,
    "repeated": 0.10,
    "narrow": 0.05,
    "ldr": 0.04,
    "pointer_table": 0.02,
    "mixed_two_range": 0.02,
    "random": 0.57,
}


def thesis_mix(n: int, seed: int = 0, mix: dict[str, float] | None = None,
               line_bytes: int = LINE_BYTES) -> np.ndarray:
    """Draw a shuffled population of lines following the Figure 3.1 mix."""
    mix = dict(THESIS_MIX if mix is None else mix)
    total = sum(mix.values())
    chunks = []
    remaining = n
    items = sorted(mix.items())
    for i, (name, frac) in enumerate(items):
        cnt = remaining if i == len(items) - 1 else int(round(n * frac / total))
        cnt = min(cnt, remaining)
        if cnt > 0:
            chunks.append(PATTERN_GENERATORS[name](cnt, seed=seed + i,
                                                   line_bytes=line_bytes))
        remaining -= cnt
    lines = np.concatenate(chunks, axis=0)
    rng = np.random.default_rng(seed + 12345)
    rng.shuffle(lines, axis=0)
    return lines
