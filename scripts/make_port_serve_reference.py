"""Write the JAX reference the port's paged serving path is held to at full
width.

Builds InternLM2-1.8B at its published width (24 layers, d_model 2048, 16
heads over 8 KV heads, head_dim 128, d_ff 8192, vocab 92,544) with the
PyTorch port's seeded numpy init (``repro_torch.models.common.
init_params_numpy``, seed 0) — ``jax.random`` streams cannot be drawn on a
machine without JAX, numpy's can — and serves two requests (37 and 53
prompt tokens from ``numpy.random.default_rng(7)``, 4 new tokens each)
through the JAX package's ``ServingEngine`` with
``RunConfig(compute_dtype="float32")``, Pallas in interpret mode, and
``EngineConfig(page_size=16, num_pages=64, max_batch=2, max_seq=128)``.

It records into ``tests/data/port_serve_reference.json``: the first values
of a few weight leaves (a digest of the numpy stream), the requests and
their generated tokens, Algorithm 3's classes ``K``, the descriptor
counts, and for every generated token (the prefill's and each decode
step's) the top-8 logit ids and values and the logits at every 257th
vocabulary id.

``chip_smoke.py`` holds the port's engine on the card to this file;
``tests/test_torch_serve.py`` (slow lane) regenerates it and compares.
The port itself never imports this script.  Peak memory ≈ 13 GB (the f32
weights in numpy and in JAX); about 40 s on 8 cores.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/make_port_serve_reference.py
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
from repro_torch.models.common import init_params_numpy  # noqa: E402
from repro_torch.models.model import model_specs  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models.config import RunConfig as PortRunConfig  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "port_serve_reference.json")
ARCH = "internlm2-1.8b"
WEIGHT_SEED = 0
PROMPT_SEED = 7
PROMPT_LENS = (37, 53)
MAX_NEW = 4
ENGINE = dict(page_size=16, num_pages=64, max_batch=2, max_seq=128)
TOPK = 8
SAMPLE_STRIDE = 257
#: weight leaves whose first values are kept as a digest of the draw
#: (``[i]`` = layer i of a stacked leaf)
DIGEST_LEAVES = ("embed", "lm_head", "blocks/pos0/attn/wq[0]",
                 "blocks/pos0/attn/wq[23]", "blocks/pos0/mlp/w_down[11]")
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


def weight_digest(tree):
    return {name: [float(x) for x in
                   np.asarray(leaf(tree, name)).reshape(-1)[:DIGEST_N]]
            for name in DIGEST_LEAVES}


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


def reference():
    cfg = get_config(ARCH)
    port_cfg = port_config(ARCH)
    rc = RunConfig(compute_dtype="float32")
    specs = model_specs(port_cfg, PortRunConfig(compute_dtype="float32"))
    t0 = time.time()
    params = init_params_numpy(specs, seed=WEIGHT_SEED)
    t_draw = time.time() - t0
    digest = weight_digest(params)
    # hand the leaves to JAX one by one, dropping each numpy copy
    jparams = {}
    stack = [(params, jparams)]
    while stack:
        src, dst = stack.pop()
        for k in list(src):
            if isinstance(src[k], dict):
                dst[k] = {}
                stack.append((src[k], dst[k]))
            else:
                dst[k] = jnp.asarray(src.pop(k))
    del params
    model = Model(cfg, rc)
    engine = ServingEngine(model, jparams, EngineConfig(**ENGINE,
                                                        interpret=True))
    steps = {}
    engine.model = _DecodeTap(model, engine, cfg.vocab, steps)
    reqs = prompts(cfg.vocab)
    for p in reqs:
        engine.add_request(p, max_new_tokens=MAX_NEW)
    t1 = time.time()
    metrics = engine.run_to_completion()
    t_serve = time.time() - t1
    prefill = jax.jit(model.prefill)
    for rid, p in enumerate(reqs):
        lg, _ = prefill(jparams, jnp.asarray([p], jnp.int32))
        steps[(rid, 0)] = logit_record(np.asarray(lg[0, -1]), cfg.vocab)
    out = dict(
        source="JAX ServingEngine, RunConfig(compute_dtype='float32'), "
               "Pallas interpret mode; scripts/make_port_serve_reference.py",
        arch=ARCH, weight_seed=WEIGHT_SEED, prompt_seed=PROMPT_SEED,
        compute_dtype="float32", engine=ENGINE, topk=TOPK,
        sample_stride=SAMPLE_STRIDE, weight_digest=digest,
        requests=[dict(prompt=p, max_new_tokens=MAX_NEW,
                       generated=[int(t) for t in
                                  engine.requests[rid].generated])
                  for rid, p in enumerate(reqs)],
        K=[int(k) for k in metrics["K"]],
        engine_steps=int(metrics["steps"]),
        dma_descriptors=int(metrics["dma_descriptors"]),
        dma_descriptors_page_granular=int(
            metrics["dma_descriptors_page_granular"]),
        descriptor_reduction=float(metrics["descriptor_reduction"]),
        logits=[dict(request=rid, index=idx, **rec)
                for (rid, idx), rec in sorted(steps.items())])
    return out, dict(draw_s=t_draw, serve_s=t_serve)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    t0 = time.time()
    ref, secs = reference()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}: K={ref['K']}, reduction "
          f"{ref['descriptor_reduction']:.3f}, tokens "
          f"{[r['generated'] for r in ref['requests']]} "
          f"(draw {secs['draw_s']:.1f} s, serve {secs['serve_s']:.1f} s, "
          f"total {time.time() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
