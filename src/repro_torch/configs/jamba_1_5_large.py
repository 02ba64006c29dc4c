"""jamba-1.5-large-398b [arXiv:2403.19887; hybrid Mamba+attn 1:7, MoE 16e].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, head_dim=128.
Attention on 1 of every 8 layers (offset 4); MoE (16 experts, top-2) on every
other layer.  Mamba: d_state=16, d_conv=4, expand=2.
"""
import dataclasses

from ..models.config import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)

REDUCED = dataclasses.replace(
    CONFIG, name="jamba-1.5-large-398b-reduced", n_layers=8, d_model=128,
    n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
    n_experts=4, top_k=2)
