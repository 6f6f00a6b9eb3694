"""Canonical-prefix attention.

Port of ``repro/serving/prefix_cache.py:84-186``, the lossless-codec
``identity`` path included.

Cross-request page sharing is only sound if a page's content is a pure
function of the token prefix it covers.  The engine guarantees this with
one attention rule in prefill: a query at position ``p`` attends
**canonical** K/V (the codec round trip of the exact values — what
decode reads from the pool) for every completed earlier page, and
**exact** f32 K/V inside its own partial page.

The prefix cache itself (``PrefixCache``, ``SIPRetention``) is not
ported yet; these helpers are what chunked prefill needs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.codecs import PageCodec


def _roundtrip_window(kw: torch.Tensor, vw: torch.Tensor, page: int,
                      codec: PageCodec) -> tuple[torch.Tensor, torch.Tensor]:
    """Codec-roundtrip [R, W, K, D] scratch windows page-wise."""
    r, w, kvh, d = kw.shape

    def to_pages(x):      # [R, W, K, D] -> [R * W/page, K, page, D]
        return x.reshape(r * (w // page), page, kvh, d).transpose(1, 2)

    kr, vr = codec.canonical_roundtrip(to_pages(kw), to_pages(vw))

    def back(x):
        return x.transpose(1, 2).reshape(r, w, kvh, d)

    return back(kr), back(vr)


def canonical_update(kscr: torch.Tensor, vscr: torch.Tensor,
                     kcan: torch.Tensor, vcan: torch.Tensor,
                     offs: torch.Tensor, page: int, width: int,
                     codec: PageCodec) -> None:
    """Refresh, in place, the canonical view of the pages a chunk touched.

    kscr/vscr f32 [R, T, K, D] exact scratch; kcan/vcan its canonical
    view; offs i64 [R] each row's chunk start; ``width`` the window span
    (chunk width + one page, so it covers a leading partial page too).
    Only the window is round-tripped: earlier pages' canonical values are
    already resident, and the codec is not assumed idempotent.  Values
    for pages the chunk left incomplete are garbage, but attention reads
    canonical values only for pages strictly before a query's own.
    The JAX version returns new arrays; here ``kcan``/``vcan`` are
    updated in place (index_put_), as the JAX engine donates them.
    """
    r, t = kscr.shape[:2]
    wstart = torch.clamp((offs // page) * page, max=t - width)
    idx = wstart[:, None] + torch.arange(width, device=kscr.device)
    rows = torch.arange(r, device=kscr.device)[:, None]
    kr, vr = _roundtrip_window(kscr[rows, idx], vscr[rows, idx], page,
                               codec)
    kcan[rows, idx] = kr
    vcan[rows, idx] = vr


def prefix_chunk_attention(q: torch.Tensor, qpos: torch.Tensor,
                           kscr: torch.Tensor, vscr: torch.Tensor,
                           kcan: torch.Tensor, vcan: torch.Tensor,
                           page: int, *, identity: bool = False
                           ) -> torch.Tensor:
    """Causal chunk attention under the canonical-prefix contract.

    q f32 [R, C, K, G, D]; qpos [R, C] absolute positions; kscr/vscr the
    exact scratch [R, T, K, D]; kcan/vcan its canonical view.  Each query
    reads canonical K/V for keys in strictly earlier pages and exact K/V
    for keys inside its own page (``kpos <= qpos``); the rest is masked
    and contributes exact zeros, so scratch padding is invisible.
    Returns f32 [R, C, K, G, D].

    ``identity=True`` is the lossless-codec path: canonical == exact, so
    one causal mask over the exact scratch replaces the two regions and
    the second einsum pair goes (kcan/vcan are not read; the engine
    passes a zero-length view).
    """
    d = q.shape[-1]
    t = kscr.shape[1]
    kpos = torch.arange(t, device=q.device)
    scale = 1.0 / math.sqrt(d)
    s_e = torch.einsum("rckgd,rtkd->rckgt", q, kscr) * scale
    if identity:
        m = (kpos[None, None, :] <= qpos[:, :, None])[:, :, None, None, :]
        w = torch.softmax(torch.where(m, s_e, -math.inf), dim=-1)
        return torch.einsum("rckgt,rtkd->rckgd", torch.where(m, w, 0.0), vscr)
    kpage = kpos // page                                # [T]
    qpage = qpos // page                                # [R, C]
    m_can = (kpage[None, None, :] < qpage[:, :, None])[:, :, None, None, :]
    m_own = ((kpage[None, None, :] == qpage[:, :, None])
             & (kpos[None, None, :] <= qpos[:, :, None]))[:, :, None, None, :]
    s_c = torch.einsum("rckgd,rtkd->rckgt", q, kcan) * scale
    sc = torch.where(m_can, s_c, torch.where(m_own, s_e, -math.inf))
    w = torch.softmax(sc, dim=-1)
    return (torch.einsum("rckgt,rtkd->rckgd", torch.where(m_can, w, 0.0), vcan)
            + torch.einsum("rckgt,rtkd->rckgd", torch.where(m_own, w, 0.0),
                           vscr))
