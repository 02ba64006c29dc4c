"""Dense decoder models of the port: configs, specs, seeded numpy init,
prefill and dense / paged decode (the JAX package's ``models`` for the
dense family)."""
from .common import Spec, count_params, init_params_numpy
from .config import MambaConfig, ModelConfig, RunConfig
from .convert import params_from_numpy
from .model import (Model, init_decode_state, model_specs, n_superblocks,
                    padded_vocab)
