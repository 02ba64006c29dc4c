"""internlm2-1.8b [arXiv:2403.17297; dense GQA].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544, head_dim=128.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92544, rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, name="internlm2-1.8b-reduced", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=256, vocab=512)
