"""Architecture registry: --arch <id> resolution."""
from __future__ import annotations

from .arctic_480b import CONFIG as _arctic
from .base import ArchConfig, SHAPES, ShapeConfig, applicable_shapes
from .deepseek_v2_lite_16b import CONFIG as _dsv2
from .gemma3_27b import CONFIG as _gemma3
from .hymba_1_5b import CONFIG as _hymba
from .internvl2_76b import CONFIG as _internvl
from .qwen2_5_14b import CONFIG as _qwen
from .seamless_m4t_large_v2 import CONFIG as _seamless
from .xlstm_350m import CONFIG as _xlstm
from .yi_6b import CONFIG as _yi6
from .yi_9b import CONFIG as _yi9

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    _dsv2, _arctic, _xlstm, _yi9, _qwen, _gemma3, _yi6, _internvl, _hymba,
    _seamless,
]}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    # tolerate smoke suffix / underscore variants
    key = name.replace("_", "-").removesuffix("-smoke")
    if key in ARCHS:
        return ARCHS[key]
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
