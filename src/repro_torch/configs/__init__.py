"""Architecture registry: ``get_config(name)`` / ``list_archs()``.

Each module defines ``CONFIG`` (the exact assigned architecture),
``smoke_config()`` (a reduced same-family config for CPU tests) and
shares the shape cells in :mod:`repro_torch.configs.shapes`.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "mamba2_1p3b",
    "qwen1p5_4b",
    "qwen3_14b",
    "phi3_medium_14b",
    "gemma3_27b",
    "moonshot_v1_16b_a3b",
    "llama4_scout_17b_16e",
    "recurrentgemma_2b",
    "chameleon_34b",
    "whisper_tiny",
]

# canonical ids from the assignment -> module names
ALIASES: Dict[str, str] = {
    "mamba2-1.3b": "mamba2_1p3b",
    "qwen1.5-4b": "qwen1p5_4b",
    "qwen3-14b": "qwen3_14b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma3-27b": "gemma3_27b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_16e",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "chameleon-34b": "chameleon_34b",
    "whisper-tiny": "whisper_tiny",
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, production: bool = False) -> ModelConfig:
    """``production=True`` applies mesh-driven padding (heads/vocab)."""
    cfg = _module(name).CONFIG
    if production:
        import dataclasses
        cfg = dataclasses.replace(cfg, pad_heads_multiple=16,
                                  pad_vocab_multiple=256)
    return cfg


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def list_archs() -> List[str]:
    return list(ALIASES)
