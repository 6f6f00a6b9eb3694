"""Uniform model API (port of ``repro/models/api.py``).

The decoder-only transformer family (dense, moe, vlm; GQA or MLA)
exposes:
  init(gen, device) -> params
  forward(params, batch) -> logits
  loss(params, batch) -> scalar
  init_cache(batch_size, max_len) -> cache
  prefill(params, batch, max_len) -> (last_logits, cache)
  decode_step(params, cache, token [B], t) -> (logits [B, V], cache)

Every other family (ssm, hybrid, encoder-decoder) raises.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

from repro_torch.configs.base import ArchConfig

from . import transformer


class ModelAPI(NamedTuple):
    cfg: ArchConfig
    init: Callable
    forward: Callable
    loss: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def get_model(cfg: ArchConfig) -> ModelAPI:
    transformer.check_family(cfg)

    def bind(fn):
        return functools.partial(fn, cfg)

    return ModelAPI(cfg=cfg, init=bind(transformer.init_params),
                    forward=bind(transformer.forward),
                    loss=bind(transformer.loss_fn),
                    init_cache=bind(transformer.init_cache),
                    prefill=bind(transformer.prefill),
                    decode_step=bind(transformer.decode_step))
