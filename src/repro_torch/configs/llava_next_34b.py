"""llava-next-34b [hf:llava-hf/llava-v1.6 family; VLM, anyres tiling].

Backbone (Yi-34B-like): 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, head_dim=128.  The vision tower is a STUB: ``input_specs``
provides precomputed patch embeddings (anyres: base + 4 tiles x 576 = 2880
patches) injected at the sequence prefix.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, n_patches=2880, rope_theta=5_000_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, name="llava-next-34b-reduced", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, n_patches=16)
