"""Decode attention over BDI pages, with or without an f32 tail: CUDA
launchers and their plain versions.

One kernel body (``csrc/paged_attention_tail.cu``) replaces the Pallas
kernels ``repro/kernels/paged_attention.py:211``
``_paged_attention_tail`` (entry point :func:`paged_attention_tail`)
and ``:153`` ``_paged_attention`` (:func:`paged_attention`, no tail).
Their plain PyTorch versions are :func:`paged_attention_tail_ref` and
:func:`paged_attention_ref`; they agree within an f32 tolerance (sums
in another order, q scaled before rather than after the dot).  Callers
reach either through :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import CompressedKVPages
from .ref import paged_attention_ref, paged_attention_tail_ref  # noqa: F401

_MAX_GD = 2048      # the kernel keeps G*D / 128 accumulators per thread


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
    if g * d > _MAX_GD:
        raise ValueError(f"G*D = {g * d} exceeds the kernel's {_MAX_GD}")
    f32, i32 = torch.float32, torch.int32
    want = _build.check_tensor
    want(q, "q", f32, (b, kvh, g, d), dev)
    for field in ("kd", "vd"):
        want(getattr(pages, field), field, torch.int8,
             (n_pages, kvh, page, d), dev)
    for field in ("kb", "ks", "vb", "vs"):
        want(getattr(pages, field), field, f32, (n_pages, kvh, page), dev)
    want(page_table, "page_table", i32, (b, pmax), dev)
    want(lengths, "lengths", i32, (b,), dev)
    return b, kvh, g, d, page, pmax


def _page_ptrs(q, pages: CompressedKVPages, page_table, lengths):
    return (q.data_ptr(), pages.kd.data_ptr(), pages.kb.data_ptr(),
            pages.ks.data_ptr(), pages.vd.data_ptr(), pages.vb.data_ptr(),
            pages.vs.data_ptr(), page_table.data_ptr(), lengths.data_ptr())


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
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.paged_attention_tail(
        *_page_ptrs(q, pages, page_table, lengths), tail_k.data_ptr(),
        tail_v.data_ptr(), tail_len.data_ptr(), out.data_ptr(), b, kvh, g,
        d, page, pmax, stream), "paged_attention_tail")
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
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=q.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(lib.paged_attention(
        *_page_ptrs(q, pages, page_table, lengths), out.data_ptr(), b, kvh,
        g, d, page, pmax, stream), "paged_attention")
    return out
