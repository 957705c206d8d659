"""Architecture registry: the ten configs of the reference and their
smoke twins (port of ``src/repro/configs/registry.py``)."""

from __future__ import annotations

from typing import Dict

from . import (
    deepseek_moe_16b,
    granite_20b,
    granite_34b,
    granite_moe_1b_a400m,
    llava_next_34b,
    mamba2_130m,
    qwen2_5_14b,
    seamless_m4t_large_v2,
    yi_34b,
    zamba2_1_2b,
)
from .base import ModelConfig, reduced

_MODULES = [
    deepseek_moe_16b,
    granite_moe_1b_a400m,
    granite_20b,
    granite_34b,
    qwen2_5_14b,
    yi_34b,
    zamba2_1_2b,
    llava_next_34b,
    mamba2_130m,
    seamless_m4t_large_v2,
]

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get(name: str, smoke: bool = False) -> ModelConfig:
    base = name[:-6] if name.endswith("-smoke") else name
    cfg = ARCHS[base]
    return reduced(cfg) if (smoke or name.endswith("-smoke")) else cfg


def names():
    return sorted(ARCHS)
