"""Architecture registry of the port: the decoder configs it can run.

Each ``<arch>.py`` here is a copy of the JAX package's config module:
``CONFIG`` (the published config) and ``REDUCED`` (same family, tiny dims,
for the CPU tests).  The port runs the dense, MoE, hybrid (Mamba +
attention) and xLSTM families; the encoder (``hubert-xlarge``) and VLM
(``llava-next-34b``) archs of the JAX registry wait for their input paths
(ROADMAP A8c) and raise ``NotImplementedError`` here.
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
    "xlstm-350m",
    "jamba-1.5-large-398b",
    "qwen2-moe-a2.7b",
    "granite-moe-3b-a800m",
)

#: archs of the JAX registry whose input paths are not ported yet
NOT_PORTED: Tuple[str, ...] = (
    "hubert-xlarge",
    "llava-next-34b",
)

_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "internlm2-1.8b": "internlm2_1_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "granite-8b": "granite_8b",
    "xlstm-350m": "xlstm_350m",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-3b-a800m": "granite_moe_3b",
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} needs the encoder / VLM input paths (input_embeds, "
            "patch_embeds), which are not ported yet (ROADMAP A8c)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"{__package__}.{_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
