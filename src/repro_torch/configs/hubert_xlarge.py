"""hubert-xlarge [arXiv:2106.07447; encoder-only audio, w2v2 arch].

48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (cluster targets),
head_dim=80.  The conv waveform frontend is a STUB: ``input_specs`` provides
precomputed frame embeddings (B, S, d_model).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504, causal=False, rope_theta=10_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, name="hubert-xlarge-reduced", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=256, vocab=64)
