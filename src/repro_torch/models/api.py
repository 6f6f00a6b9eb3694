"""Uniform model API, dispatched by architecture family (port of
``repro/models/api.py``).

Every family exposes:
  init(gen, device) -> params
  forward(params, batch) -> logits
  loss(params, batch) -> scalar
  init_cache(batch_size, max_len, ...) -> cache (``enc_len=`` for the
      encoder-decoder)
  prefill(params, batch, max_len) -> (last_logits, cache)
  decode_step(params, cache, token [B], t) -> (logits [B, V], cache)

Encoder-decoder configs go to ``encdec``, ssm to ``xlstm``, hybrid to
``hybrid`` and the rest to ``transformer``, which refuses an attention
kind it does not take.  Under a mesh whose ``model`` or ``data`` axis
is larger than one, every function refuses a config or mesh that tensor
and data parallelism do not lay out (``distributed/tp.check_layout``:
widths that the port would cut elsewhere than JAX's rule table does; a
``pod`` axis is one more data axis); each family's ``init_cache`` gives this rank's blocks of
the cache as ``sharding.cache_specs`` cuts it.
"""

from __future__ import annotations

import functools
from types import ModuleType
from typing import Callable, NamedTuple

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tp

from . import encdec, hybrid, transformer, xlstm


class ModelAPI(NamedTuple):
    cfg: ArchConfig
    init: Callable
    forward: Callable
    loss: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def family_module(cfg: ArchConfig) -> ModuleType:
    """The module that models ``cfg``; raises for a config none takes."""
    if cfg.is_encdec:
        return encdec
    if cfg.family == "ssm":
        return xlstm
    if cfg.family == "hybrid":
        return hybrid
    transformer.check_family(cfg)        # dense | moe | vlm
    return transformer


def get_model(cfg: ArchConfig) -> ModelAPI:
    mod = family_module(cfg)

    def bind(fname):
        fn = getattr(mod, fname)

        @functools.wraps(fn)
        def call(*args, **kw):
            tp.check_layout(cfg)
            return fn(cfg, *args, **kw)
        return call

    return ModelAPI(cfg=cfg, init=bind("init_params"),
                    forward=bind("forward"), loss=bind("loss_fn"),
                    init_cache=bind("init_cache"), prefill=bind("prefill"),
                    decode_step=bind("decode_step"))
