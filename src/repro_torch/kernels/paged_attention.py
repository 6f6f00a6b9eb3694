"""Decode attention over BDI pages + f32 tail: CUDA launcher, plain version.

The kernel (``csrc/paged_attention_tail.cu``) replaces the Pallas kernel
``repro/kernels/paged_attention.py:211`` ``_paged_attention_tail``.  Its
plain PyTorch version is :func:`paged_attention_tail_ref`
(``ref.paged_attention_tail_ref``); they agree within an f32 tolerance
(sums in another order, q scaled before rather than after the dot).
The engine reaches either through
:func:`repro_torch.kernels.ops.paged_attention_tail`.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import CompressedKVPages
from .ref import paged_attention_tail_ref  # noqa: F401

_MAX_GD = 2048      # the kernel keeps G*D / 128 accumulators per thread


def paged_attention_tail(q: torch.Tensor, pages: CompressedKVPages,
                         page_table: torch.Tensor, lengths: torch.Tensor,
                         tail_k: torch.Tensor, tail_v: torch.Tensor,
                         tail_len: torch.Tensor) -> torch.Tensor:
    """Launch decode attention on the card.

    q f32 [B, KVH, G, D]; pages: kd/vd i8 [P, KVH, page, D], kb/ks/vb/vs
    f32 [P, KVH, page]; page_table i32 [B, PMAX]; lengths i32 [B] tokens
    in pages; tail_k/tail_v f32 [B, KVH, page, D]; tail_len i32 [B].
    Returns f32 [B, KVH, G, D], allocated here, on the current stream.
    Page ids and lengths are not range-checked (that would sync).
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_tail launches on CUDA, got {dev}")
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
    for name in ("kd", "vd"):
        want(getattr(pages, name), name, torch.int8,
             (n_pages, kvh, page, d), dev)
    for name in ("kb", "ks", "vb", "vs"):
        want(getattr(pages, name), name, f32, (n_pages, kvh, page), dev)
    want(page_table, "page_table", i32, (b, pmax), dev)
    want(lengths, "lengths", i32, (b,), dev)
    want(tail_k, "tail_k", f32, (b, kvh, page, d), dev)
    want(tail_v, "tail_v", f32, (b, kvh, page, d), dev)
    want(tail_len, "tail_len", i32, (b,), dev)
    out = torch.empty((b, kvh, g, d), dtype=f32, device=dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.paged_attention_tail(
        q.data_ptr(), pages.kd.data_ptr(), pages.kb.data_ptr(),
        pages.ks.data_ptr(), pages.vd.data_ptr(), pages.vb.data_ptr(),
        pages.vs.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        tail_k.data_ptr(), tail_v.data_ptr(), tail_len.data_ptr(),
        out.data_ptr(), b, kvh, g, d, page, pmax, stream),
        "paged_attention_tail")
    return out
