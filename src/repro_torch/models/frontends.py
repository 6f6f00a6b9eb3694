"""Modality frontend stubs and batch construction per (arch, shape) (port
of ``repro/models/frontends.py``).

The [audio] and [vlm] configs specify the transformer backbone only: the
modality frontend is a stub that hands over precomputed embeddings.

  * vlm: ``embeds`` [B, n_frontend_embeds, D] patch embeddings prepended
    to the token sequence (total length == shape.seq_len);
  * audio: ``enc_embeds`` [B, S_enc, D] frame embeddings feeding the
    encoder; the decoder sees tokens.  For decode shapes the decoder KV
    length is seq_len and the encoder memory ENC_LEN_DECODE frames.

Two entry points with the same tree: ``batch_struct`` (tensors on the
``meta`` device, where JAX returns ``ShapeDtypeStruct``s: shapes and
dtypes, no data) and ``make_batch`` (random tensors from a generator).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig

ENC_LEN_DECODE = 4096


def token_len(cfg: ArchConfig, seq_len: int) -> int:
    """Token positions of a sequence of ``seq_len``: a vision frontend's
    embeddings take the first ``n_frontend_embeds``."""
    return seq_len - (cfg.n_frontend_embeds if cfg.frontend == "vision" else 0)


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The training/prefill batch tree, as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, token_len(cfg, s)), torch.int32),
             "targets": _meta((b, s), torch.int32),
             "loss_mask": _meta((b, s), torch.float32)}
    if cfg.frontend == "vision":
        batch["embeds"] = _meta((b, cfg.n_frontend_embeds, cfg.d_model),
                                torch.bfloat16)
    if cfg.is_encdec:
        batch["enc_embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        batch["tokens"] = _meta((b, s), torch.int32)
    return batch


def decode_struct(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Decode-step inputs (the cache comes from the model's init_cache)."""
    return {"token": _meta((shape.global_batch,), torch.int32),
            "t": _meta((), torch.int32)}


def make_batch(cfg: ArchConfig, shape: ShapeConfig, gen: torch.Generator,
               device: torch.device | str = "cpu") -> dict:
    """A random batch matching :func:`batch_struct`, drawn from ``gen`` (a
    generator on ``device``)."""
    b, s = shape.global_batch, shape.seq_len

    def ints(n):
        return torch.randint(0, cfg.vocab, (b, n), generator=gen,
                             device=device, dtype=torch.int32)

    def frames(n):
        return (torch.randn((b, n, cfg.d_model), generator=gen,
                            device=device) * 0.02).to(torch.bfloat16)
    batch = {"tokens": ints(token_len(cfg, s)), "targets": ints(s),
             "loss_mask": torch.ones((b, s), dtype=torch.float32,
                                     device=device)}
    if cfg.frontend == "vision":
        batch["embeds"] = frames(cfg.n_frontend_embeds)
        # no next-token loss on image positions
        batch["loss_mask"][:, :cfg.n_frontend_embeds] = 0.0
    if cfg.is_encdec:
        batch["enc_embeds"] = frames(s)
        batch["tokens"] = ints(s)
    return batch


def enc_len_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Encoder memory length for encoder-decoder decode shapes."""
    if shape.is_decode:
        return min(ENC_LEN_DECODE, shape.seq_len)
    return shape.seq_len
