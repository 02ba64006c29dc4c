"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407; dense GQA, 128k ctx].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, name="mistral-nemo-12b-reduced", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab=512)
