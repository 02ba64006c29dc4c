"""qwen3-32b [hf:Qwen/Qwen3-8B family; dense GQA + qk-norm].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, head_dim=128.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen3-32b-reduced", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=256, vocab=512)
