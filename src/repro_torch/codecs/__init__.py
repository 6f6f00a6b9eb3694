"""Pluggable KV page codecs for the port's serving engine.

Registered instances (importing this package registers them all):

  * ``bdi``      — single-base B+Delta int8 rows; CUDA row codec and
    fused decode attention (the default);
  * ``zero``     — zero/repeated-value rows with exact exceptions
    (lossless);
  * ``raw``      — verbatim pages, ratio 1.0 (lossless);
  * ``gbdi``     — multi-base B+Delta, CUDA compress/decompress pair;
  * ``fpc``      — frequent-pattern coding of f32 words (lossless);
  * ``adaptive`` — per-page smallest of the five, with a one-byte tag.

``REPRO_CODEC`` picks the process-wide default.
"""

from .adaptive import ADAPTIVE, AdaptiveCodec
from .base import (PageCodec, available, default_name, get, register,
                   resolve)
from .bdi import BDI, BDICodec
from .fpc import FPC, FPCCodec
from .gbdi import GBDI, GBDICodec
from .raw import RAW, RawCodec
from .zero import ZERO, ZeroRepCodec

__all__ = [
    "PageCodec", "available", "default_name", "get", "register", "resolve",
    "ADAPTIVE", "AdaptiveCodec", "BDI", "BDICodec", "FPC", "FPCCodec",
    "GBDI", "GBDICodec", "RAW", "RawCodec", "ZERO", "ZeroRepCodec",
]
