"""The :class:`PageCodec` protocol + registry.

Port of ``repro/codecs/base.py``.

The serving engine touches compressed KV pages only through a codec:

  * ``init_pools``           — allocate the page pools on a device (a
    NamedTuple whose leaves lead with ``[n_layers, n_pages]``);
  * ``compress_kv_pages``    — exact f32 page blocks -> compressed pages
    (the batched page-fill path);
  * ``decompress_pages``     — the inverse;
  * ``page_nbytes``          — per-page compressed byte counts, computed
    on the pages' device: the numbers CAMP preemption values read;
  * ``canonical_roundtrip``  — compress-then-decompress, the function the
    canonical-prefix contract is defined against
    (``serving/prefix_cache.py``);
  * ``paged_attention_tail`` — decode attention over [compressed pages +
    f32 tail], read in compressed form, for a codec with
    ``has_fused_kernels`` (bdi); the engine decodes every other codec
    through its gather-then-decompress attention;
  * ``page_tags``            — per-page member ids of a composite codec.

A ``lossless`` codec (roundtrip == identity, bit for bit) lets prefill
skip the canonical roundtrip.  Which kernels run is decided by the
tensors' device (:mod:`repro_torch.kernels.ops`), never by a flag; the
flags match the JAX codecs' so either package reads the same codec.

Codecs register one singleton under a short name; ``REPRO_CODEC`` picks
the default.
"""

from __future__ import annotations

import os

import torch

from repro_torch.serving._tree import tree_leaves


class PageCodec:
    """Interface every page codec implements (see the module docstring).

    KV page blocks are f32 ``[n, KVH, page, D]``; pool leaves lead with
    ``[n_layers, n_pages]``.  Methods work on whatever device their
    inputs are on; instances are stateless singletons.
    """

    name: str = "?"
    #: roundtrip == identity bit for bit: prefill attends the exact
    #: scratch and the canonical view shrinks to zero length
    lossless: bool = False
    #: ships a fused decode-attention kernel (``paged_attention_tail``)
    has_fused_kernels: bool = False
    #: ships a page-fill kernel but no fused attention (gbdi, adaptive)
    has_fused_fill: bool = False
    #: ``page_nbytes`` is invariant to sub-ULP noise in the KV input;
    #: False where sizes read exact bit patterns (fpc, adaptive), so two
    #: engines whose decode-tail K/V agree to the token, not the bit, may
    #: report a few bytes apart per page
    ulp_stable_sizes: bool = True

    def init_pools(self, n_layers: int, n_pages: int, kvh: int, page: int,
                   dh: int, device: torch.device):
        """Zero-state page pools, leaves [L, P, ...] on ``device``."""
        raise NotImplementedError

    def compress_kv_pages(self, k: torch.Tensor, v: torch.Tensor):
        """f32 [n, KVH, page, D] x2 -> compressed pages, leaves [n, ...]."""
        raise NotImplementedError

    def decompress_pages(self, pages) -> tuple[torch.Tensor, torch.Tensor]:
        """Compressed pages -> (k, v) f32 [..., KVH, page, D]; any
        leading dims (decode gathers [S, PMAX]-leading pages)."""
        raise NotImplementedError

    def page_nbytes(self, pages) -> torch.Tensor:
        """Per-page compressed byte counts, i32 [n], on the pages' device."""
        raise NotImplementedError

    def paged_attention_tail(self, q, pages, page_table, lengths,
                             tail_k, tail_v, tail_len) -> torch.Tensor:
        """Decode attention over [compressed pages + f32 tail]."""
        raise NotImplementedError

    def page_tags(self, pages) -> torch.Tensor:
        """Per-page codec-id tags, i32 [n]: 0 for a single codec; a
        composite returns each page's member id."""
        first = tree_leaves(pages)[0]
        return torch.zeros(first.shape[0], dtype=torch.int32,
                           device=first.device)

    def canonical_roundtrip(self, k: torch.Tensor, v: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """compress-then-decompress of [n, KVH, page, D] blocks."""
        return self.decompress_pages(self.compress_kv_pages(k, v))

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<PageCodec {self.name}>"


_REGISTRY: dict[str, PageCodec] = {}


def register(codec: PageCodec) -> PageCodec:
    """Register a codec singleton under ``codec.name`` (idempotent for the
    same instance; a second instance under one name is an error)."""
    prev = _REGISTRY.get(codec.name)
    if prev is not None and prev is not codec:
        raise ValueError(f"codec name {codec.name!r} already registered")
    _REGISTRY[codec.name] = codec
    return codec


def available() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str) -> PageCodec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown page codec {name!r}; available: "
                       f"{', '.join(available())}") from None


def default_name() -> str:
    """Default codec name: ``REPRO_CODEC`` env var, else ``bdi``."""
    return os.environ.get("REPRO_CODEC", "").strip().lower() or "bdi"


def resolve(spec: str | PageCodec | None = None) -> PageCodec:
    """``None`` -> the ``REPRO_CODEC``/bdi default; a name -> registry
    lookup; an instance -> itself."""
    if spec is None:
        name = default_name()
        try:
            return get(name)
        except KeyError:
            raise KeyError(
                f"REPRO_CODEC={name!r} names an unknown page codec; "
                f"registered codecs: {', '.join(available())}") from None
    if isinstance(spec, str):
        return get(spec)
    if not isinstance(spec, PageCodec):
        raise TypeError(f"not a PageCodec: {spec!r}")
    return spec
