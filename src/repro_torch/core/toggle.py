"""Toggle-aware bandwidth compression (Chapter 6): EC + Metadata Consolidation.

Compression increases the *bit toggle count* (0<->1 transitions between
consecutive flits on a link), raising dynamic transfer energy — the problem
the thesis discovered for GPU bandwidth compression (Fig 6.2).  This module:

  * counts toggles of byte streams at flit granularity (Sec 6.5.1/6.5.2);
  * implements **Energy Control (EC)**: per-block decision to send the
    compressed or raw form by comparing toggle-energy cost against
    bandwidth-energy benefit (Sec 6.4.2, Fig 6.6);
  * implements **Metadata Consolidation (MC)**: group per-line BDI metadata
    into one header region to restore value alignment (Sec 6.4.3);
  * models **DBI** (data bus inversion) for the DRAM-bus comparison (6.5.3).

In the framework, the same EC decision shape gates the compressed-collective
path (distributed/compress_comm.py): buckets whose measured compressibility
does not beat the threshold ship raw.
"""

from __future__ import annotations

import numpy as np

from . import bdi_exact as bx

FLIT_BYTES = 16  # on-chip interconnect flit (Sec 2.2)


def _to_bits(stream: np.ndarray | bytes, flit_bytes: int) -> np.ndarray:
    buf = np.frombuffer(bytes(stream), dtype=np.uint8) \
        if not isinstance(stream, np.ndarray) else stream.astype(np.uint8)
    pad = (-buf.size) % flit_bytes
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    return np.unpackbits(buf.reshape(-1, flit_bytes), axis=1)


def toggle_count(stream: np.ndarray | bytes,
                 flit_bytes: int = FLIT_BYTES) -> int:
    """Number of bit transitions between consecutive flits on the wire."""
    bits = _to_bits(stream, flit_bytes)
    if bits.shape[0] < 2:
        return 0
    return int((bits[1:] ^ bits[:-1]).sum())


def dbi_toggle_count(stream: np.ndarray | bytes,
                     flit_bytes: int = FLIT_BYTES,
                     lane_bytes: int = 1) -> int:
    """Toggles with per-lane Data Bus Inversion (invert if >half toggle)."""
    bits = _to_bits(stream, flit_bytes)
    n, w = bits.shape
    lanes = bits.reshape(n, w // (8 * lane_bytes), 8 * lane_bytes)
    prev = lanes[0]
    total = 0
    for i in range(1, n):
        cur = lanes[i]
        t = (cur ^ prev).sum(axis=1)
        inv = t > (8 * lane_bytes) // 2
        t = np.where(inv, 8 * lane_bytes - t + 1, t)  # +1: DBI signal wire
        total += int(t.sum())
        prev = np.where(inv[:, None], 1 - cur, cur)
    return total


# ---------------------------------------------------------------------------
# Serialization layouts: interleaved (naive) vs Metadata Consolidation
# ---------------------------------------------------------------------------

def serialize_interleaved(c: bx.CompressedLines) -> bytes:
    """Per-line [enc | mask | base | deltas] records (metadata interleaved)."""
    parts: list[bytes] = []
    for i in range(c.n):
        enc = bx.ENCODING_BY_CODE[int(c.codes[i])]
        parts.append(bytes([enc.code]))
        if enc.name == "zeros":
            continue
        if enc.name == "rep8":
            parts.append(int(c.bases[i]).to_bytes(8, "little", signed=True))
        elif enc.name == "uncompressed":
            parts.append(c.raw[c.raw_index[i]].tobytes())
        else:
            m = c.line_bytes // enc.base
            parts.append(np.packbits(c.masks[i, :m]).tobytes())
            parts.append((int(c.bases[i]) & ((1 << (8 * enc.base)) - 1))
                         .to_bytes(enc.base, "little"))
            lo = bx._take_low_bytes(c.deltas[i:i + 1, :m], enc.delta)
            parts.append(lo.tobytes())
    return b"".join(parts)


def serialize_consolidated(c: bx.CompressedLines) -> bytes:
    """Metadata Consolidation (Sec 6.4.3): one header region up front
    (all enc codes + all masks), then aligned payload regions."""
    head: list[bytes] = [c.codes.tobytes()]
    masks: list[bytes] = []
    payload: list[bytes] = []
    for i in range(c.n):
        enc = bx.ENCODING_BY_CODE[int(c.codes[i])]
        if enc.name == "zeros":
            continue
        if enc.name == "rep8":
            payload.append(int(c.bases[i]).to_bytes(8, "little", signed=True))
        elif enc.name == "uncompressed":
            payload.append(c.raw[c.raw_index[i]].tobytes())
        else:
            m = c.line_bytes // enc.base
            masks.append(np.packbits(c.masks[i, :m]).tobytes())
            payload.append((int(c.bases[i]) & ((1 << (8 * enc.base)) - 1))
                           .to_bytes(enc.base, "little"))
            lo = bx._take_low_bytes(c.deltas[i:i + 1, :m], enc.delta)
            payload.append(lo.tobytes())
    return b"".join(head + masks + payload)


# ---------------------------------------------------------------------------
# Energy Control (Sec 6.4.2)
# ---------------------------------------------------------------------------

def ec_decision(raw: bytes, comp: bytes, *,
                e_toggle: float = 1.0, e_byte: float = 8.0,
                flit_bytes: int = FLIT_BYTES) -> bool:
    """True => send compressed.  Compare the toggle-energy increase against
    the byte-transfer energy saved (the Figure 6.6 decision function):

        compress  iff  dToggles * E_toggle  <=  dBytes * E_byte
    """
    if len(comp) >= len(raw):
        return False
    d_toggles = toggle_count(comp, flit_bytes) - toggle_count(raw, flit_bytes)
    d_bytes = len(raw) - len(comp)
    return d_toggles * e_toggle <= d_bytes * e_byte


def ec_stream(lines: np.ndarray, *, block_lines: int = 4,
              consolidated: bool = True,
              e_toggle: float = 1.0, e_byte: float = 8.0,
              flit_bytes: int = FLIT_BYTES) -> dict:
    """Apply EC per block of lines; returns wire stats for all variants.

    Reproduces the Chapter 6 pipeline end to end: compress (BDI), count
    toggles, gate per block with EC, compare raw / compressed / EC streams.
    """
    ser = serialize_consolidated if consolidated else serialize_interleaved
    out_raw, out_comp, out_ec = [], [], []
    n_compressed = 0
    n_blocks = 0
    for i in range(0, lines.shape[0], block_lines):
        blk = lines[i:i + block_lines]
        raw = blk.tobytes()
        comp = ser(bx.bdi_compress(blk))
        out_raw.append(raw)
        out_comp.append(comp)
        use = ec_decision(raw, comp, e_toggle=e_toggle, e_byte=e_byte,
                          flit_bytes=flit_bytes)
        out_ec.append(comp if use else raw)
        n_compressed += use
        n_blocks += 1
    raw_b, comp_b, ec_b = (b"".join(x) for x in (out_raw, out_comp, out_ec))
    return {
        "raw_bytes": len(raw_b), "comp_bytes": len(comp_b),
        "ec_bytes": len(ec_b),
        "raw_toggles": toggle_count(raw_b, flit_bytes),
        "comp_toggles": toggle_count(comp_b, flit_bytes),
        "ec_toggles": toggle_count(ec_b, flit_bytes),
        "ec_compressed_frac": n_compressed / max(n_blocks, 1),
        "comp_ratio": len(raw_b) / max(len(comp_b), 1),
        "ec_ratio": len(raw_b) / max(len(ec_b), 1),
    }
