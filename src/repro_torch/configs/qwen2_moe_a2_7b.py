"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; 60 routed top-4 + 4 shared].

24L d_model=2048 16H (kv=16) d_ff=1408 (per expert) vocab=151936,
head_dim=128.  Shared-expert intermediate = 4x1408 = 5632, sigmoid-gated.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=151936,
    n_experts=60, top_k=4, n_shared_experts=4,
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen2-moe-a2.7b-reduced", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=64, vocab=512,
    n_experts=8, top_k=4, n_shared_experts=2)
