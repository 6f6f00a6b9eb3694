"""Decode attention over BDI pages, with or without an f32 tail: CUDA
launchers and their plain versions.

One kernel body (``csrc/paged_attention_tail.cu``) replaces the Pallas
kernels ``repro/kernels/paged_attention.py:211``
``_paged_attention_tail`` (entry point :func:`paged_attention_tail`)
and ``:153`` ``_paged_attention`` (:func:`paged_attention`, no tail).
It splits the rows (flash-decoding): a warp takes a slot of up to 16
rows, a page being :func:`slots_per_page` slots, a split
4 slots, the tail's slots splits of their own after the pages', and a
grid row a group of query heads (G*D over 1024 takes several); each
split writes its unnormalised softmax state to a scratch buffer
``[B*KVH, n_split, G, D+2]`` that this module allocates; a combine pass
in the same C call merges the splits in index order, in chunks with a
running max, so the result is the same bits at every launch.  The split
count comes from PMAX, not from ``lengths`` (that would sync with the
host).  The launch is bound by the bytes it reads, ``B*KVH*(len +
tail)*(2D + 16)``.  It takes every shape the JAX kernels take: any G, D
and page (D 16, 32, 64 and 128 with instances of their own, any other
multiple of 4 up to 256 the generic one, any other D a plain body over
byte rows) and any PMAX; ``_check`` raises ``ValueError`` only for a
shape no kernel can take (G, D or page below 1).  Their
plain PyTorch versions are :func:`paged_attention_tail_ref` and
:func:`paged_attention_ref`; they agree within an f32 tolerance (sums
in another order, q scaled before rather than after the dot).  Callers
reach either through :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import CompressedKVPages
from .ref import paged_attention_ref, paged_attention_tail_ref  # noqa: F401

WARP_ROWS = 16           # rows a warp takes: a slot
SPLIT_SLOTS = 4          # slots a split (4 warps)


def shape_ok(g: int, d: int, page: int, pmax: int) -> bool:
    """Whether any kernel can take the shape: G, D and page of at least
    one row and PMAX of at least 0 (``shape_ok`` in the CUDA source)."""
    return g >= 1 and d >= 1 and page >= 1 and pmax >= 0


def slots_per_page(page: int) -> int:
    """16-row slots of a page: ceil(page / 16) rounded up to a power of
    two (a slot's page and row are shifts of its index), the last ones
    partial or empty where 16 does not divide the page."""
    n = 1
    while WARP_ROWS * n < page:
        n *= 2
    return n


def n_split(pmax: int, tail: bool, page: int) -> int:
    """Splits of one (sequence, kv head): ceil(PMAX * slots a page / 4),
    plus ceil(slots a page / 4) for the tail."""
    sps = slots_per_page(page)
    return -(-pmax * sps // SPLIT_SLOTS) + (-(-sps // SPLIT_SLOTS)
                                            if tail else 0)


def _check(q: torch.Tensor, pages: CompressedKVPages,
           page_table: torch.Tensor, lengths: torch.Tensor, name: str):
    """Validate the shared arguments; returns (b, kvh, g, d, page, pmax)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} launches on CUDA, got {dev}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, KVH, G, D], got {tuple(q.shape)}")
    b, kvh, g, d = q.shape
    n_pages, _, page, _ = pages.kd.shape
    pmax = page_table.shape[-1]
    if not shape_ok(g, d, page, pmax):
        raise ValueError(f"{name}: no kernel takes G={g} D={d} "
                         f"page={page} PMAX={pmax}")
    f32, i32 = torch.float32, torch.int32
    want = _build.check_tensor
    want(q, "q", f32, (b, kvh, g, d), dev)
    for field in ("kd", "vd"):
        want(getattr(pages, field), field, torch.int8,
             (n_pages, kvh, page, d), dev)
        _aligned(getattr(pages, field), field)
    for field in ("kb", "ks", "vb", "vs"):
        want(getattr(pages, field), field, f32, (n_pages, kvh, page), dev)
    want(page_table, "page_table", i32, (b, pmax), dev)
    want(lengths, "lengths", i32, (b,), dev)
    return b, kvh, g, d, page, pmax


def _aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")


def _page_ptrs(q, pages: CompressedKVPages, page_table, lengths):
    return (q.data_ptr(), pages.kd.data_ptr(), pages.kb.data_ptr(),
            pages.ks.data_ptr(), pages.vd.data_ptr(), pages.vb.data_ptr(),
            pages.vs.data_ptr(), page_table.data_ptr(), lengths.data_ptr())


def _scratch(b, kvh, g, d, splits, dev) -> torch.Tensor:
    return torch.empty((b * kvh, splits, g, d + 2), dtype=torch.float32,
                       device=dev)


def paged_attention_tail(q: torch.Tensor, pages: CompressedKVPages,
                         page_table: torch.Tensor, lengths: torch.Tensor,
                         tail_k: torch.Tensor, tail_v: torch.Tensor,
                         tail_len: torch.Tensor) -> torch.Tensor:
    """Launch decode attention over pages + tail on the card.

    q f32 [B, KVH, G, D]; pages: kd/vd i8 [P, KVH, page, D], kb/ks/vb/vs
    f32 [P, KVH, page]; page_table i32 [B, PMAX]; lengths i32 [B] tokens
    in pages; tail_k/tail_v f32 [B, KVH, page, D]; tail_len i32 [B].
    Returns f32 [B, KVH, G, D], allocated here, on the current stream.
    Page ids and lengths are not range-checked (that would sync).
    """
    b, kvh, g, d, page, pmax = _check(q, pages, page_table, lengths,
                                      "paged_attention_tail")
    dev = q.device
    want = _build.check_tensor
    want(tail_k, "tail_k", torch.float32, (b, kvh, page, d), dev)
    want(tail_v, "tail_v", torch.float32, (b, kvh, page, d), dev)
    want(tail_len, "tail_len", torch.int32, (b,), dev)
    _aligned(tail_k, "tail_k")
    _aligned(tail_v, "tail_v")
    splits = n_split(pmax, True, page)
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=dev)
    scratch = _scratch(b, kvh, g, d, splits, dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.paged_attention_tail(
        *_page_ptrs(q, pages, page_table, lengths), tail_k.data_ptr(),
        tail_v.data_ptr(), tail_len.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, kvh, g, d, page, pmax, splits, stream),
        "paged_attention_tail")
    return out


def paged_attention(q: torch.Tensor, pages: CompressedKVPages,
                    page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Launch decode attention over pages only on the card; shapes as
    :func:`paged_attention_tail` without the tail.  A sequence with
    ``lengths[b] == 0`` gets NaN (0/0), as in JAX and the plain version.
    """
    b, kvh, g, d, page, pmax = _check(q, pages, page_table, lengths,
                                      "paged_attention")
    splits = n_split(pmax, False, page)
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=q.device)
    scratch = _scratch(b, kvh, g, d, splits, q.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(lib.paged_attention(
        *_page_ptrs(q, pages, page_table, lengths), out.data_ptr(),
        scratch.data_ptr(), b, kvh, g, d, page, pmax, splits, stream),
        "paged_attention")
    return out
