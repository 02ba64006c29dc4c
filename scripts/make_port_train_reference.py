"""Write the JAX reference the port's training is held to on the card.

Trains two models of the JAX package at their reduced sizes (the JAX
reference has to run on a CPU) with its ``Trainer``, ``DataPipeline`` and
AdamW: ``internlm2-1.8b`` (dense, token batches) and ``hubert-xlarge``
(the encoder: frame embeddings in, 8 % of positions masked for the loss,
two microbatches), each in f32 compute with ``remat="full"``, from the
PyTorch port's seeded numpy init
(``repro_torch.models.common.init_params_numpy``, seed 0: ``jax.random``
streams cannot be drawn on a machine without JAX, numpy's can), 4 steps
with a checkpoint every 2.

It records into ``tests/data/port_train_reference.json``, per model: the
run's configuration, the first values of a few weight leaves (a digest of
the numpy stream), and every step's loss, MoE aux loss and gradient norm.

``chip_smoke.py`` (phase T0) holds the port's ``Trainer`` on the card to
this file, ``tests/test_torch_train.py`` the port's on the CPU; its slow
lane regenerates the file and compares.  The port itself never imports
this script.  About half a minute on one core.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/make_port_train_reference.py
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data import DataPipeline, PipelineConfig  # noqa: E402
from repro.models import Model, RunConfig  # noqa: E402
from repro.optim import OptConfig, init_opt  # noqa: E402
from repro.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models.common import init_params_numpy  # noqa: E402
from repro_torch.models.config import RunConfig as PortRunConfig  # noqa: E402
from repro_torch.models.model import model_specs  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "tests", "data",
                           "port_train_reference.json")
#: model -> (run config, pipeline config, weight leaves of the digest)
MODELS = {
    "internlm2-1.8b": (
        dict(compute_dtype="float32", attn_q_chunk=32, attn_kv_chunk=32,
             microbatches=1),
        dict(batch=4, seq=64, seed=5),
        ("embed", "lm_head", "blocks/pos0/attn/wq[1]")),
    "hubert-xlarge": (
        dict(compute_dtype="float32", attn_q_chunk=32, attn_kv_chunk=32,
             microbatches=2),
        dict(batch=4, seq=64, seed=6),
        ("embed", "lm_head", "blocks/pos0/mlp/w_down[1]")),
}
OPT = dict(kind="adamw", lr=1e-3, warmup_steps=1, total_steps=100)
TRAINER = dict(total_steps=4, ckpt_every=2, log_every=1)
WEIGHT_SEED = 0
DIGEST_N = 4


def leaf(tree, name: str):
    path, _, idx = name.partition("[")
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node[int(idx[:-1])] if idx else node


class _NumpyInitTrainer(Trainer):
    """The JAX ``Trainer`` with its first parameters handed in (the port's
    seeded numpy init) instead of drawn by ``jax.random``."""

    def __init__(self, *args, params, **kw):
        super().__init__(*args, **kw)
        self._params = params

    def init_state(self, seed: int = 0):
        params = jax.tree.map(jnp.asarray, self._params)
        return params, init_opt(self.opt_cfg, params), 0


def model_reference(arch: str):
    run, pipe, leaves = MODELS[arch]
    cfg = get_config(arch, reduced=True)
    params = init_params_numpy(
        model_specs(port_config(arch, reduced=True), PortRunConfig(**run)),
        seed=WEIGHT_SEED)
    digest = {name: [float(x) for x in
                     np.asarray(leaf(params, name)).reshape(-1)[:DIGEST_N]]
              for name in leaves}
    pipeline = DataPipeline(cfg, PipelineConfig(**pipe))
    with tempfile.TemporaryDirectory() as d:
        trainer = _NumpyInitTrainer(
            Model(cfg, RunConfig(**run)), OptConfig(**OPT),
            TrainerConfig(ckpt_dir=d, **TRAINER), pipeline, params=params)
        out = trainer.run()
        trainer.ckpt.wait()
    pipeline.close()
    return dict(arch=arch, reduced=True, run_config=run, pipeline=pipe,
                weight_seed=WEIGHT_SEED, weight_digest=digest,
                steps=[dict(step=int(m["step"]), loss=float(m["loss"]),
                            aux=float(m["aux"]),
                            grad_norm=float(m["grad_norm"]))
                       for m in out["metrics"]])


def reference():
    return dict(
        source="JAX Trainer + DataPipeline + AdamW at the configs' reduced "
               "sizes, f32 compute, remat full, from the port's numpy init; "
               "scripts/make_port_train_reference.py",
        opt=OPT, trainer=TRAINER,
        models={arch: model_reference(arch) for arch in MODELS})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    t0 = time.time()
    ref = reference()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    for arch, rec in ref["models"].items():
        print(f"{arch}: losses {[s['loss'] for s in rec['steps']]}")
    print(f"wrote {args.out} in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
