"""granite-moe-3b-a800m [hf:ibm-granite family; 40 experts top-8].

32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
head_dim=64.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
)

REDUCED = dataclasses.replace(
    CONFIG, name="granite-moe-3b-a800m-reduced", n_layers=2, d_model=96,
    n_heads=4, n_kv_heads=2, head_dim=24, d_ff=64, vocab=512,
    n_experts=8, top_k=4)
