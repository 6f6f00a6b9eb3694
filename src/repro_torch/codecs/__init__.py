"""Pluggable KV page codecs for the port's serving engine.

Registered instances (importing this package registers them):

  * ``bdi`` — single-base B+Delta int8 rows with CUDA kernels (the
    default).

``REPRO_CODEC`` picks the process-wide default.
"""

from .base import (PageCodec, available, default_name, get, register,
                   resolve)
from .bdi import BDI, BDICodec

__all__ = ["PageCodec", "available", "default_name", "get", "register",
           "resolve", "BDI", "BDICodec"]
