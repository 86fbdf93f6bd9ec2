"""Architecture registry of the port (the torch counterpart of
``repro/configs/__init__.py``): ``get_config(arch, variant)`` resolves an
``--arch`` id to its ``ModelConfig``, published widths (``"full"``) or the
reduced smoke variant. The config files are plain data, copied from the
reference; ``shapes`` holds the dry run's input shapes, with meta-device
input specs."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

from . import (codeqwen1p5_7b, deepseek_v3_671b, gemma2_27b, internvl2_26b,
               mamba2_2p7b, moonshot_v1_16b_a3b, qwen2_7b,
               seamless_m4t_medium, starcoder2_15b, zamba2_1p2b)
from .shapes import SHAPES, ShapeSpec, applicable, input_specs

_MODULES = {
    "internvl2-26b": internvl2_26b,
    "zamba2-1.2b": zamba2_1p2b,
    "qwen2-7b": qwen2_7b,
    "gemma2-27b": gemma2_27b,
    "codeqwen1.5-7b": codeqwen1p5_7b,
    "starcoder2-15b": starcoder2_15b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "mamba2-2.7b": mamba2_2p7b,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, variant: str = "full", **overrides) -> ModelConfig:
    cfg = getattr(_MODULES[arch], variant)()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = ["ARCHS", "ModelConfig", "get_config", "SHAPES", "ShapeSpec", "applicable",
           "input_specs"]
