"""Decode attention over BDI pages, with or without an f32 tail: CUDA
launchers and their plain versions.

One kernel body (``csrc/paged_attention_tail.cu``) replaces the Pallas
kernels ``repro/kernels/paged_attention.py:211``
``_paged_attention_tail`` (entry point :func:`paged_attention_tail`)
and ``:153`` ``_paged_attention`` (:func:`paged_attention`, no tail).
It splits the pages (flash-decoding): one block per (sequence, kv head)
and split of :func:`split_pages` page-table entries (a warp takes 16
rows: a page, or half of one over 16 rows), the tail a split of its
own, each writing its unnormalised softmax state to a scratch buffer
``[B*KVH, n_split, G, D+2]`` that this module allocates; a combine pass
in the same C call merges the splits in index order, so the result is
the same bits at every launch.  The split count comes from PMAX, not
from ``lengths`` (that would sync with the host).  The launch is bound
by the bytes it reads, ``B*KVH*(len + tail)*(2D + 16)``.  It takes the
shapes :func:`takes` names (D a multiple of 4 up to 256, with its own
instances at 16, 32, 64 and 128; pages of 4 to 32 rows in steps of 4;
G*D up to ``MAX_GD``); ``_check`` raises ``ValueError`` for any other,
and ``PagedKVEngine`` refuses such a shape at construction.  Their
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

WARP_ROWS = 16           # rows a warp takes: a page, or half of one
MAX_D = 256              # and a multiple of 4 (4-byte loads of int8 rows)
MAX_PAGE = 2 * WARP_ROWS  # and a multiple of 4 (P.V takes 4 keys a step)
MAX_SPLITS = 6000        # the combine keeps 8 bytes a split in shared memory
MAX_GD = 1024            # a lane keeps G*D / 128 x 4 accumulators


def takes(g: int, d: int, page: int) -> bool:
    """Whether the kernel takes G query heads a kv head, head width D and
    pages of ``page`` rows (``shape_ok`` in the CUDA source)."""
    return (d % 4 == 0 and 4 <= d <= MAX_D and page % 4 == 0
            and 4 <= page <= MAX_PAGE and g >= 1 and g * d <= MAX_GD)


def refusal(name: str, g: int, d: int, page: int) -> str:
    """The message for a shape :func:`takes` refuses."""
    return (f"{name} takes D a multiple of 4 up to {MAX_D}, page a "
            f"multiple of 4 from 4 to {MAX_PAGE} and G*D up to {MAX_GD}; "
            f"got G={g} D={d} page={page}")


def split_pages(page: int) -> int:
    """Page-table entries a split takes: 4 (a warp each), or 2 when a
    page is over ``WARP_ROWS`` rows (two warps each)."""
    return 4 if page <= WARP_ROWS else 2


def n_split(pmax: int, tail: bool, page: int) -> int:
    """Splits of one (sequence, kv head): ceil(PMAX / split_pages), plus
    the tail."""
    return -(-pmax // split_pages(page)) + int(tail)


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
    if not takes(g, d, page):
        raise ValueError(refusal(name, g, d, page))
    if n_split(pmax, True, page) > MAX_SPLITS:
        raise ValueError(f"PMAX = {pmax} gives more than {MAX_SPLITS} "
                         f"splits")
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
