"""Uniform model API (port of ``repro/models/api.py``).

The dense GQA family exposes:
  init(gen, device) -> params
  forward(params, batch) -> logits
  loss(params, batch) -> scalar

Every other family raises, and the decode entry points (``init_cache``,
``prefill``, ``decode_step``) are not ported yet: the serving engine
(``serving/engine.py``) is the port's decode path.
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


def get_model(cfg: ArchConfig) -> ModelAPI:
    if not transformer.is_dense(cfg):
        raise ValueError(f"{cfg.name}: only dense GQA models are ported")

    def bind(fn):
        return functools.partial(fn, cfg)

    return ModelAPI(cfg=cfg, init=bind(transformer.init_params),
                    forward=bind(transformer.forward),
                    loss=bind(transformer.loss_fn))
