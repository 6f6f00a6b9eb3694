"""Kernel wrappers: pick the backend by the tensor's device, count launches.

A CUDA tensor goes to the hand-written kernel (or the launcher raises);
a CPU tensor goes to the plain PyTorch version.  There is no other
switch and no fallback.  ``LAUNCHES`` counts kernel launches made through
these wrappers — the engine's only route to the kernels — so a run can
show that its main path went through them.  Calling a launcher directly
(as a kernel-vs-plain comparison does) does not count.
"""

from __future__ import annotations

import torch

from . import bdi_compress, paged_attention, ref

LAUNCHES = {"bdi_compress_kv": 0, "paged_attention_tail": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def compress_kv_pages(k: torch.Tensor,
                      v: torch.Tensor) -> ref.CompressedKVPages:
    """k, v f32 [P, KVH, page, D] -> single-base compressed pages.

    On CUDA: one row-codec launch each for K and V, bit-exact with
    :func:`ref.compress_kv_pages`, which runs for CPU tensors.
    """
    if not _on_cuda(k):
        return ref.compress_kv_pages(k, v)
    p, kvh, page, d = k.shape

    def enc(x):
        rows = x.to(torch.float32).reshape(-1, d).contiguous()
        deltas, base, scale = bdi_compress.bdi_compress_kv(rows)
        LAUNCHES["bdi_compress_kv"] += 1
        return (deltas.view(p, kvh, page, d), base.view(p, kvh, page),
                scale.view(p, kvh, page))

    return ref.CompressedKVPages(*enc(k), *enc(v))


def paged_attention_tail(q: torch.Tensor, pages: ref.CompressedKVPages,
                         page_table: torch.Tensor, lengths: torch.Tensor,
                         tail_k: torch.Tensor, tail_v: torch.Tensor,
                         tail_len: torch.Tensor) -> torch.Tensor:
    """Decode attention over [compressed pages + f32 tail]; see
    :func:`ref.paged_attention_tail_ref` for shapes."""
    if not _on_cuda(q):
        return ref.paged_attention_tail_ref(q, pages, page_table, lengths,
                                            tail_k, tail_v, tail_len)
    out = paged_attention.paged_attention_tail(q, pages, page_table, lengths,
                                               tail_k, tail_v, tail_len)
    LAUNCHES["paged_attention_tail"] += 1
    return out
