"""xlstm-350m [arXiv:2405.04517; sLSTM + mLSTM blocks].

24L d_model=1024 4H vocab=50304, d_ff=0 (mLSTM blocks carry their own 2x
up-projection).  sLSTM every 6th layer (the paper's [7:1]-style interleave).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="xlstm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab=50304, slstm_every=6,
)

REDUCED = dataclasses.replace(
    CONFIG, name="xlstm-350m-reduced", n_layers=6, d_model=64, n_heads=2,
    n_kv_heads=2, head_dim=32, vocab=512, slstm_every=6)
