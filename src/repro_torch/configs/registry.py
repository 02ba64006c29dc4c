"""Architecture registry of the port: the dense configs it can run.

Each ``<arch>.py`` here is a copy of the JAX package's config module:
``CONFIG`` (the published config) and ``REDUCED`` (same family, tiny dims,
for the CPU tests).  The port runs the dense family only; the other archs
of the JAX registry wait for ROADMAP A8 (MoE, Mamba, xLSTM layers) and
raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from ..models.config import ModelConfig

ARCH_IDS: Tuple[str, ...] = (
    "qwen3-32b",
    "internlm2-1.8b",
    "mistral-nemo-12b",
    "granite-8b",
)

#: archs of the JAX registry whose layers are not ported yet
NOT_PORTED: Tuple[str, ...] = (
    "xlstm-350m",
    "hubert-xlarge",
    "llava-next-34b",
    "jamba-1.5-large-398b",
    "qwen2-moe-a2.7b",
    "granite-moe-3b-a800m",
)

_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "internlm2-1.8b": "internlm2_1_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "granite-8b": "granite_8b",
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not a dense model; its layers are not ported yet "
            "(ROADMAP A8)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"{__package__}.{_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
