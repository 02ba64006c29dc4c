"""Architecture registry of the port: the 10 archs + reduced smoke variants.

Each ``<arch>.py`` here is a copy of the JAX package's config module:
``CONFIG`` (the published config) and ``REDUCED`` (same family, tiny dims,
for the CPU tests).  The port runs every family of the JAX registry:
dense, MoE, hybrid (Mamba + attention), xLSTM, the encoder
(``hubert-xlarge``, frame embeddings in, no decode) and the VLM
(``llava-next-34b``, patch embeddings over the first positions).  The
shape set and the cell table below are copies of the JAX registry's.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from ..models.config import ModelConfig

ARCH_IDS: Tuple[str, ...] = (
    "qwen3-32b",
    "internlm2-1.8b",
    "mistral-nemo-12b",
    "granite-8b",
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
    "xlstm-350m": "xlstm_350m",
    "hubert-xlarge": "hubert_xlarge",
    "llava-next-34b": "llava_next_34b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-3b-a800m": "granite_moe_3b",
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"{__package__}.{_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG


# ---------------------------------------------------------------------------
# input shapes (assigned shape set for the LM family)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# archs with sub-quadratic paths that run long_500k
SUBQUADRATIC = {"xlstm-350m", "jamba-1.5-large-398b"}
ENCODER_ONLY = {"hubert-xlarge"}


def cell_status(arch: str, shape: str) -> Optional[str]:
    """None = runnable; otherwise the documented skip reason."""
    s = SHAPES[shape]
    if arch in ENCODER_ONLY and s.kind == "decode":
        return "encoder-only: no decode step"
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return "pure full attention: quadratic at 500k"
    return None


def all_cells() -> List[Tuple[str, str, Optional[str]]]:
    return [(a, s, cell_status(a, s)) for a in ARCH_IDS for s in SHAPES]
