"""Architecture registry: ``get_config(arch_id)`` for every assigned arch.

Each module defines ``CONFIG``; ids use dashes (CLI: ``--arch yi-6b``).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..config import ModelConfig, ShapeConfig, SHAPES, smoke_config  # noqa: F401

_MODULES = {
    "paligemma-3b": "paligemma_3b",
    "yi-6b": "yi_6b",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen2.5-32b": "qwen2_5_32b",
    "gemma-7b": "gemma_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "whisper-large-v3": "whisper_large_v3",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "xlstm-350m": "xlstm_350m",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


#: shape cells skipped per arch (reasons in DESIGN.md section 4):
#: long_500k needs a sub-quadratic path - only the SSM/hybrid archs run it.
def applicable_shapes(arch: str) -> List[str]:
    cfg = get_config(arch)
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("hybrid", "ssm"):
        shapes.append("long_500k")
    return shapes
