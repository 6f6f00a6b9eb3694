"""Kernel wrappers: pick the backend by the tensor's device, count launches.

A CUDA tensor goes to the hand-written kernel (or the launcher raises);
a CPU tensor goes to the plain PyTorch version.  There is no other
switch and no fallback.  ``LAUNCHES`` counts kernel launches made
through these wrappers — the only route to the kernels of the engine
and of the tile codec's callers — so a run can show that its path went
through them.  Calling a launcher directly (as a kernel-vs-plain
comparison does) does not count.
"""

from __future__ import annotations

import torch

from repro_torch.core import bdi_value as bv

from . import bdi_compress, bdi_decompress, gbdi_codec, ref
from . import paged_attention as attention

LAUNCHES = {"bdi_compress_kv": 0, "paged_attention_tail": 0,
            "gbdi_compress_kv": 0, "gbdi_decompress_kv": 0,
            "bdi_compress": 0, "bdi_decompress": 0, "paged_attention": 0}


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
    out = attention.paged_attention_tail(q, pages, page_table, lengths,
                                         tail_k, tail_v, tail_len)
    LAUNCHES["paged_attention_tail"] += 1
    return out


def gbdi_compress_kv_pages(k: torch.Tensor,
                           v: torch.Tensor) -> ref.GBDIKVPages:
    """k, v f32 [P, KVH, page, D] -> GBDI pages (one page = KVH * page
    rows).  On CUDA: one compressor launch each for K and V, bit-exact
    with the plain version, which runs for CPU tensors."""
    p, kvh, page, d = k.shape
    cuda = _on_cuda(k)

    def enc(x):
        rows = x.to(torch.float32).reshape(-1, d)
        if cuda:
            out = gbdi_codec.gbdi_compress_kv(rows.contiguous(), kvh * page)
            LAUNCHES["gbdi_compress_kv"] += 1
        else:
            out = gbdi_codec.gbdi_compress_kv_ref(rows, kvh * page)
        dd, bases, bid, sc, wid = out
        return (dd.view(p, kvh, page, d), bases, bid.view(p, kvh, page),
                sc.view(p, kvh, page), wid.view(p, kvh, page))

    return ref.GBDIKVPages(*enc(k), *enc(v))


def gbdi_decompress_kv_pages(pages: ref.GBDIKVPages
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """GBDI pages, leaves leading [P] -> f32 K, V [P, KVH, page, D].  On
    CUDA: one decompressor launch per side; the plain version for CPU
    tensors."""
    p, kvh, page, d = pages.kd.shape
    cuda = _on_cuda(pages.kd)

    def dec(dd, bases, bid, sc):
        args = (dd.reshape(-1, d).contiguous(), bases.contiguous(),
                bid.reshape(-1).contiguous(), sc.reshape(-1).contiguous(),
                kvh * page)
        if cuda:
            out = gbdi_codec.gbdi_decompress_kv(*args)
            LAUNCHES["gbdi_decompress_kv"] += 1
        else:
            out = gbdi_codec.gbdi_decompress_kv_ref(*args)
        return out.view(p, kvh, page, d)

    return (dec(pages.kd, pages.kbs, pages.kbid, pages.ksc),
            dec(pages.vd, pages.vbs, pages.vbid, pages.vsc))


def compress(x: torch.Tensor) -> ref.PackedTiles:
    """Compress tiles [N, T] (any float dtype, taken as f32; T a multiple
    of 8) with the two-base tile codec.  On CUDA one kernel launch, up
    to T = 1024, bit-exact with :func:`ref.compress_ref`, which runs for
    CPU tensors.  No padding: the kernel takes any N."""
    x = x.to(torch.float32)
    if not _on_cuda(x):
        return ref.compress_ref(x)
    out = bdi_compress.bdi_compress(x.contiguous())
    LAUNCHES["bdi_compress"] += 1
    return out


def decompress(p: ref.PackedTiles) -> torch.Tensor:
    """PackedTiles -> f32 [N, T], the masked FMA.  Every tile carries a
    valid scale (1.0 where its max residual is 0), so nothing is patched
    here; ``enc`` is not read and may be None.  On CUDA one kernel
    launch; :func:`ref.decompress_ref` for CPU tensors."""
    if not _on_cuda(p.deltas):
        return ref.decompress_ref(p)
    out = bdi_decompress.bdi_decompress(
        ref.PackedTiles(*(t if t is None else t.contiguous() for t in p)))
    LAUNCHES["bdi_decompress"] += 1
    return out


def paged_attention(q: torch.Tensor, pages: ref.CompressedKVPages,
                    page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over compressed pages only; see
    :func:`ref.paged_attention_ref` for shapes."""
    if not _on_cuda(q):
        return ref.paged_attention_ref(q, pages, page_table, lengths)
    out = attention.paged_attention(q, pages, page_table, lengths)
    LAUNCHES["paged_attention"] += 1
    return out


def roundtrip_tensor(x: torch.Tensor, tile: int = bv.TILE) -> torch.Tensor:
    """Compress then decompress a tensor of any shape through the tile
    codec (folded into ``tile``-wide tiles, the tail zero-padded);
    returns x's shape and dtype."""
    tiles, n = bv.fold_to_tiles(x, tile)
    out = decompress(compress(tiles))
    return bv.unfold_from_tiles(out, n, x.shape).to(x.dtype)
