"""Write the JAX reference the port's MoE, hybrid and xLSTM serving is held
to on the card.

Builds three models of the JAX package at their reduced sizes (the JAX
reference has to run on a CPU): ``qwen2-moe-a2.7b`` (MoE with shared
experts), ``jamba-1.5-large-398b`` (Mamba + attention + MoE, period 8) and
``xlstm-350m`` (mLSTM + sLSTM, no attention), each with the PyTorch port's
seeded numpy init (``repro_torch.models.common.init_params_numpy``, seed 0:
``jax.random`` streams cannot be drawn on a machine without JAX, numpy's
can).  Each serves three requests (23, 41 and 57 prompt tokens from
``numpy.random.default_rng(17)``, 4 new tokens each) through the JAX
package's ``ServingEngine`` with ``RunConfig(compute_dtype="float32",
scan_chunk=16)`` (so that prompts span several scan chunks, the last one
padded), Pallas in interpret mode, and ``EngineConfig(page_size=8,
num_pages=64, max_batch=2, max_seq=128)``: the third request reuses a batch
slot, whose recurrent state its prefill must overwrite.

It records into ``tests/data/port_family_reference.json``, per model and in
the layout of ``tests/data/port_serve_reference.json``: the first values
of a few weight leaves (a digest of the numpy stream), the requests and
their generated tokens, Algorithm 3's classes ``K``, the descriptor counts,
and for every generated token (the prefill's and each decode step's) the
top-8 logit ids and values and the logits at every 7th vocabulary id.

``chip_smoke.py`` (phase M1) holds the port's engine on the card to this
file, ``tests/test_torch_families.py`` the port's engine on the CPU; its
slow lane regenerates the file and compares.  The port itself never
imports this script.  About a minute on one core.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/make_port_family_reference.py
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import Model, RunConfig  # noqa: E402
from repro.serve import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models.common import init_params_numpy  # noqa: E402
from repro_torch.models.config import RunConfig as PortRunConfig  # noqa: E402
from repro_torch.models.model import model_specs  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "tests", "data",
                           "port_family_reference.json")
#: model -> weight leaves whose first values are kept as a digest of the
#: draw (``[i]`` = superblock i of a stacked leaf)
MODELS = {
    "qwen2-moe-a2.7b": ("embed", "lm_head", "blocks/pos0/attn/wq[1]",
                        "blocks/pos0/moe/w_gate[0]",
                        "blocks/pos0/moe/shared/gate[1]"),
    "jamba-1.5-large-398b": ("embed", "blocks/pos4/attn/wk[0]",
                             "blocks/pos1/mamba/x_proj[0]",
                             "blocks/pos3/moe/w_down[0]",
                             "blocks/pos6/mlp/w_up[0]"),
    "xlstm-350m": ("embed", "blocks/pos0/slstm/r_z[0]",
                   "blocks/pos3/mlstm/wq[0]", "blocks/pos5/mlstm/w_f[0]"),
}
RUN_CONFIG = dict(compute_dtype="float32", scan_chunk=16)
WEIGHT_SEED = 0
PROMPT_SEED = 17
PROMPT_LENS = (23, 41, 57)
MAX_NEW = 4
ENGINE = dict(page_size=8, num_pages=64, max_batch=2, max_seq=128)
TOPK = 8
SAMPLE_STRIDE = 7
DIGEST_N = 4


def prompts(vocab: int):
    rng = np.random.default_rng(PROMPT_SEED)
    return [[int(t) for t in rng.integers(0, vocab, size=n)]
            for n in PROMPT_LENS]


def leaf(tree, name: str):
    path, _, idx = name.partition("[")
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node[int(idx[:-1])] if idx else node


def logit_record(row: np.ndarray, vocab: int):
    """Top-8 ids and logits of one f32 logit row, and its strided sample."""
    row = np.asarray(row, np.float32)[:vocab]
    top = np.argsort(-row, kind="stable")[:TOPK]
    return dict(top_ids=[int(i) for i in top],
                top_logits=[float(row[i]) for i in top],
                sample=[float(x) for x in row[::SAMPLE_STRIDE]])


class _DecodeTap:
    """Stands in for the engine's model and records the logits row of every
    running request at every decode step, keyed by (request, token
    index)."""

    def __init__(self, model, engine, vocab, out):
        self._model, self._engine, self._vocab = model, engine, vocab
        self._out = out

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step_paged(self, *args, **kw):
        logits, state = self._model.decode_step_paged(*args, **kw)
        rows = np.asarray(logits[:, 0], np.float32)
        for rid in self._engine.running:
            req = self._engine.requests[rid]
            self._out[(rid, len(req.generated))] = logit_record(
                rows[self._engine.sched.slot_of(rid)], self._vocab)
        return logits, state


def model_reference(arch: str):
    cfg = get_config(arch, reduced=True)
    specs = model_specs(port_config(arch, reduced=True),
                        PortRunConfig(**RUN_CONFIG))
    params = init_params_numpy(specs, seed=WEIGHT_SEED)
    digest = {name: [float(x) for x in
                     np.asarray(leaf(params, name)).reshape(-1)[:DIGEST_N]]
              for name in MODELS[arch]}
    model = Model(cfg, RunConfig(**RUN_CONFIG))
    jparams = jax.tree.map(jnp.asarray, params)
    engine = ServingEngine(model, jparams,
                           EngineConfig(**ENGINE, interpret=True))
    steps = {}
    engine.model = _DecodeTap(model, engine, cfg.vocab, steps)
    reqs = prompts(cfg.vocab)
    for p in reqs:
        engine.add_request(p, max_new_tokens=MAX_NEW)
    metrics = engine.run_to_completion()
    prefill = jax.jit(model.prefill)
    for rid, p in enumerate(reqs):
        lg, _ = prefill(jparams, jnp.asarray([p], jnp.int32))
        steps[(rid, 0)] = logit_record(np.asarray(lg[0, -1]), cfg.vocab)
    return dict(
        arch=arch, reduced=True, compute_dtype=RUN_CONFIG["compute_dtype"],
        run_config=RUN_CONFIG, weight_seed=WEIGHT_SEED, engine=ENGINE,
        sample_stride=SAMPLE_STRIDE, weight_digest=digest,
        requests=[dict(prompt=p, max_new_tokens=MAX_NEW,
                       generated=[int(t) for t in
                                  engine.requests[rid].generated])
                  for rid, p in enumerate(reqs)],
        K=[int(k) for k in metrics["K"]],
        engine_steps=int(metrics["steps"]),
        stalled=int(metrics["stalled"]),
        dma_descriptors=int(metrics["dma_descriptors"]),
        dma_descriptors_page_granular=int(
            metrics["dma_descriptors_page_granular"]),
        descriptor_reduction=float(metrics["descriptor_reduction"]),
        logits=[dict(request=rid, index=idx, **rec)
                for (rid, idx), rec in sorted(steps.items())])


def reference():
    return dict(
        source="JAX ServingEngine at the configs' reduced sizes, "
               "RunConfig(compute_dtype='float32', scan_chunk=16), Pallas "
               "interpret mode; scripts/make_port_family_reference.py",
        prompt_seed=PROMPT_SEED, topk=TOPK,
        models={arch: model_reference(arch) for arch in MODELS})


def dumps(obj, indent: str = "") -> str:
    """JSON of the fixture with one line per leaf list and per logits
    record (``json.dump(indent=1)`` would give one line per number)."""
    if isinstance(obj, dict) and any(isinstance(v, (dict, list))
                                     for v in obj.values()):
        inner = indent + " "
        return "{\n" + ",\n".join(
            f"{inner}{json.dumps(k)}: {dumps(v, inner)}"
            for k, v in obj.items()) + "\n" + indent + "}"
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        inner = indent + " "
        return "[\n" + ",\n".join(inner + json.dumps(v) for v in obj) \
            + "\n" + indent + "]"
    return json.dumps(obj)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    t0 = time.time()
    ref = reference()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(dumps(ref) + "\n")
    for arch, rec in ref["models"].items():
        print(f"{arch}: K={rec['K']}, reduction "
              f"{rec['descriptor_reduction']:.3f}, tokens "
              f"{[r['generated'] for r in rec['requests']]}")
    print(f"wrote {args.out} in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
