"""Models of the port: configs, specs, seeded numpy init (and its
streaming twin on the card), the full-sequence forward and training loss,
prefill, chunked prefill and dense / paged decode for every family of the
JAX package's ``models`` (dense, MoE, hybrid, xLSTM, encoder, VLM)."""
from .common import Spec, count_params, init_params_numpy
from .config import MambaConfig, ModelConfig, RunConfig
from .convert import init_params_on_device, params_from_numpy
from .model import (Model, block_period, cross_entropy, decode_state_logical,
                    decode_state_shapes, init_decode_state, model_specs,
                    n_superblocks, padded_vocab)
