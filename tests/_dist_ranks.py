"""Rank-side work of ``tests/test_torch_distributed.py``: the port on
``gloo`` ranks on the CPU.

Each ``ranks_*`` function runs in every rank of a spawn
(:func:`start` / :func:`join`), one thread per rank, and rank 0 writes what the test
compares (numpy arrays) with ``torch.save``.  This module imports
neither JAX nor the JAX package, so a rank starts in the time it takes
to import torch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import shutil

import numpy as np
import torch

CHUNKS = dict(attn_q_chunk=32, attn_kv_chunk=32, scan_chunk=16,
              compute_dtype="float32")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_CASES = {          # name: (arch, microbatches, batch, seq)
    "internlm2-1.8b": ("internlm2-1.8b", 1, 8, 32),
    "hubert-xlarge": ("hubert-xlarge", 2, 8, 32),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", 1, 4, 32),
    "internlm2-6-heads": ("internlm2-1.8b", 1, 8, 32),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", 1, 4, 32),
    "xlstm-350m": ("xlstm-350m", 1, 4, 32),
}
# the optimizer of each case's tensor-parallel step: Adafactor where
# AdamW's first step, g / (|g| + eps), blows f32 rounding up past the
# comparison's 1e-6 (the encoder, the Mamba hybrid and the xLSTM)
TP_KINDS = {"hubert-xlarge": "adafactor", "jamba-1.5-large-398b": "adafactor",
            "xlstm-350m": "adafactor"}
# the reduced config's fields a case replaces: 6 heads of 32 (q_dim 192)
# split over 4 model ranks by q_dim (48 columns: a head and a half each)
OVERRIDES = {"internlm2-6-heads": dict(n_heads=6, n_kv_heads=2)}
COLLECTIVE_TIMEOUT_S = 60
# the cached passes on a mesh: prefill and prefill_chunked (2 chunks) of
# a prompt of SEQ tokens under "default", then STEPS greedy decode steps
# under "decode" from the prefill's state (positions 10 .. 17 of 24 cross
# from one model rank's part of the sequence to the next at tp 2 and 4)
CACHE_ARCHS = ("internlm2-1.8b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b",
               "xlstm-350m", "llava-next-34b")
CACHE = dict(batch=2, seq=10, max_seq=24, steps=8, chunks=2)
# the cached passes' decode under "decode_long" on (2,2) (the sequence
# split over "data", the head dimension over "model"), from the prefill's
# state under "default": an attention model and the Mamba hybrid
LONG_ARCHS = ("internlm2-1.8b", "jamba-1.5-large-398b")


def start(fn, world: int, tmp: str, *args):
    """``fn(rank, world, tmp, *args)`` on ``world`` spawned ranks; returns
    at once (:func:`join` waits for them)."""
    import torch.multiprocessing as mp
    return mp.spawn(fn, args=(world, tmp) + args, nprocs=world, join=False)


def join(ctx, timeout: float = 240.0) -> None:
    """Wait for the ranks of :func:`start` within ``timeout`` seconds;
    ranks still running then are killed and the spawn fails."""
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while not ctx.join(timeout=1.0):
            if datetime.datetime.now() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def spawn(fn, world: int, tmp: str, *args, timeout: float = 240.0) -> None:
    join(start(fn, world, tmp, *args), timeout)


def init(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'rdzv')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def done() -> None:
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def save(tmp: str, name: str, obj) -> None:
    import torch.distributed as dist
    if dist.get_rank() == 0:
        torch.save(obj, os.path.join(tmp, f"{name}.pt"))


def tree_numpy(tree) -> dict:
    """``{path: numpy}`` of a tree's leaves, DTensors gathered whole."""
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.distributed.sharding import gather
    out = {}
    for path, x in leaf_paths(tree):
        x = gather(x)
        out[path] = (x.view(torch.int16).numpy().copy()
                     if x.dtype == torch.bfloat16 else x.numpy().copy())
    return out


def train_setup(name: str, kind: str):
    """(model, opt config, numpy weights, numpy global batch) of a train
    case (the parent builds the same from the same seeds)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, _batch_at
    from repro_torch.models import Model, RunConfig
    from repro_torch.optim import OptConfig
    arch, micro, batch, seq = TRAIN_CASES[name]
    cfg = dataclasses.replace(get_config(arch, True),
                              **OVERRIDES.get(name, {}))
    model = Model(cfg, RunConfig(microbatches=micro, **CHUNKS))
    batch = _batch_at(model.cfg, PipelineConfig(batch=batch, seq=seq), 3)
    return model, OptConfig(kind=kind, **OPT), model.init_numpy(0), batch


@contextlib.contextmanager
def probe():
    """Records, while it is open, what the model computes on: the query
    heads, MLP and expert hidden widths and logits' vocabulary widths it
    sees, each recurrent mixer's channels (``"mixer"``: (kind, width))
    (sets), the experts every call routes to (``"routes"``), and the
    leaves sharded over "model" that ``Model.local_params`` gathers whole
    for the compute (``"model_gathers"``, read off ``GATHERS``; the
    optimizer's own gathers are not counted)."""
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as M
    from repro_torch.models import model as TM
    from repro_torch.models import moe as MoE
    from repro_torch.models import xlstm as X
    rec = {"q_heads": set(), "mlp": set(), "expert": set(), "vocab": set(),
           "mixer": set(), "routes": []}
    saved = [(L, "attention_qkv"), (L, "mlp"), (MoE, "mlp"),
             (MoE, "moe_experts"), (MoE, "route"),
             (TP, "vocab_parallel_nll"), (M, "mamba_layer"),
             (X, "mlstm_layer"), (X, "slstm_layer")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    orig = {name: fn for _, name, fn in saved}
    rec["model_gathers"] = 0
    local_params = TM.Model.local_params

    def counted(self, params):
        g0 = S.GATHERS["model"]
        try:
            return local_params(self, params)
        finally:
            rec["model_gathers"] += S.GATHERS["model"] - g0

    def attention_qkv(*a, **k):
        q, kk, v = orig["attention_qkv"](*a, **k)
        rec["q_heads"].add(q.shape[2])
        return q, kk, v

    def mlp(p, *a, **k):
        rec["mlp"].add(p["w_down"].shape[-2])
        return orig["mlp"](p, *a, **k)

    def moe_experts(cfg, rc, p, *a, **k):
        rec["expert"].add(p["w_down"].shape[-2])
        return orig["moe_experts"](cfg, rc, p, *a, **k)

    def route(*a, **k):
        out = orig["route"](*a, **k)
        rec["routes"].append(out[1].numpy().copy())
        return out

    def nll(logits, *a, **k):
        rec["vocab"].add(logits.shape[-1])
        return orig["vocab_parallel_nll"](logits, *a, **k)

    def mixer(kind, out):
        def layer(cfg, p, *a, **k):
            rec["mixer"].add((kind, p[out].shape[0]))
            return orig[f"{kind}_layer"](cfg, p, *a, **k)
        return layer

    new = {"attention_qkv": attention_qkv, "mlp": mlp,
           "moe_experts": moe_experts, "route": route,
           "vocab_parallel_nll": nll,
           "mamba_layer": mixer("mamba", "out_proj"),
           "mlstm_layer": mixer("mlstm", "down_proj"),
           "slstm_layer": mixer("slstm", "out_proj")}
    for mod, name, _ in saved:
        setattr(mod, name, new[name])
    TM.Model.local_params = counted
    try:
        yield rec
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        TM.Model.local_params = local_params


def sharded_step(name: str, kind: str, mesh, record: bool = False):
    """One sharded train step at step 1 → (metrics, new params) as
    numpy, the batch drawn by ``DataPipeline(shardings=...)`` under the
    activation rules (each rank's rows as a DTensor); ``record``: and
    every rank's :func:`probe` of the step, with its mesh coordinate."""
    from repro_torch.data import DataPipeline, PipelineConfig
    from repro_torch.distributed.sharding import (ACT_RULES, Sharding,
                                                  logical_to_placements,
                                                  param_sharding)
    from repro_torch.models import params_from_numpy
    from repro_torch.models.common import logical_tree, spec_shapes
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import (batch_logical_axes,
                                              make_batch_shapes)
    from repro_torch.train.trainer import opt_sharding, shard_state
    model, oc, P, _ = train_setup(name, kind)
    _, _, batch, seq = TRAIN_CASES[name]
    specs = model.specs()
    psh = param_sharding(logical_tree(specs), spec_shapes(specs), mesh)
    params, opt = shard_state(oc, params_from_numpy(P, device="cpu"), psh,
                              opt_sharding(model, oc, mesh))
    lg = batch_logical_axes(model.cfg)
    shapes = make_batch_shapes(model.cfg, batch, seq)
    bsh = {k: Sharding(mesh, logical_to_placements(
        lg[k], mesh, ACT_RULES["default"], shapes[k][0])) for k in lg}
    pipe = DataPipeline(model.cfg, PipelineConfig(batch=batch, seq=seq),
                        device="cpu", start_step=3, shardings=bsh)
    try:
        b = next(pipe)
    finally:
        pipe.close()
    step = make_train_step(model, oc, psh)
    with probe() if record else contextlib.nullcontext({}) as rec:
        new_p, _, met = step(params, opt, b, 1)
    out = {k: float(v) for k, v in met.items()}, tree_numpy(new_p)
    if not record:
        return out
    import torch.distributed as dist
    rec["coordinate"] = tuple(mesh.get_coordinate())
    probes = [None] * dist.get_world_size()
    dist.all_gather_object(probes, rec)
    return out + (probes,)


def tp_forward(mesh, tmp: str) -> None:
    """``Model.forward`` of the reduced InternLM2 on ``mesh`` from its
    parameters as DTensors placed by the rules: every rank's logits, and
    what each rank computed on (:func:`probe`)."""
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import leaf_paths, rebuild
    from repro_torch.distributed.sharding import param_sharding, shard_local
    from repro_torch.models import params_from_numpy
    from repro_torch.models.common import logical_tree, spec_shapes
    model, _, P, b = train_setup("internlm2-1.8b", "adamw")
    model = dataclasses.replace(model, mesh=mesh)
    specs = model.specs()
    psh = dict(leaf_paths(param_sharding(logical_tree(specs),
                                         spec_shapes(specs), mesh)))
    full = params_from_numpy(P, device="cpu")
    params = rebuild(full, {p: shard_local(x, psh[p])
                            for p, x in leaf_paths(full)})
    with torch.no_grad(), probe() as rec:
        logits, _ = model.forward(params, torch.from_numpy(b["tokens"]))
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (logits.numpy(), rec))
    save(tmp, "tp_forward", got)


def cache_setup(arch: str):
    """(model, numpy weights, prompt tokens [B, S]) of a cached-pass case
    (the parent builds the same from the same seeds)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, RunConfig
    model = Model(get_config(arch, True), RunConfig(**CHUNKS))
    toks = np.random.default_rng(5).integers(
        0, model.cfg.vocab, (CACHE["batch"], CACHE["seq"]))
    return model, model.init_numpy(0), toks


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next tokens [B, 1] of logits [B, S, V]: the last position's
    argmax."""
    return logits[:, -1:].argmax(-1)


def _state_record(state) -> dict:
    """``{path: (placements, this rank's shape, the whole leaf)}`` of a
    DTensor decode state (every rank gathers, rank 0's copy is kept)."""
    from repro_torch.checkpoint.checkpointer import leaf_paths
    return {path: (tuple(x.placements), tuple(x.to_local().shape),
                   x.full_tensor().numpy().copy())
            for path, x in leaf_paths(state)}


def cached_passes(arch: str, mesh, decode_rules: str = "decode") -> dict:
    """The cached passes (``CACHE``) of a reduced model on ``mesh`` from
    DTensor weights placed by the rules, each rank on its rows of the
    batch: prefill and prefill_chunked under ``"default"`` (no chunked
    prefill but under ``"decode"``), then greedy ``decode_step``s under
    ``decode_rules`` from the prefill's state (placed under "default":
    redistributed on entry) and the weights' local shards
    (``Model.local_params`` once), each rank on its rows of the batch
    under ``decode_rules``.  Every rank's logits and tokens, rank 0's
    record of each state, and what each rank computed on
    (:func:`probe`)."""
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import leaf_paths, rebuild
    from repro_torch.distributed.sharding import (axes_index, batch_axes,
                                                  param_sharding,
                                                  shard_local)
    from repro_torch.models import params_from_numpy
    from repro_torch.models.common import logical_tree, spec_shapes
    from repro_torch.train.train_step import make_serve_step
    model, P, toks = cache_setup(arch)
    specs = model.specs()
    psh = dict(leaf_paths(param_sharding(logical_tree(specs),
                                         spec_shapes(specs), mesh)))
    full = params_from_numpy(P, device="cpu")
    params = rebuild(full, {p: shard_local(x, psh[p])
                            for p, x in leaf_paths(full)})
    idx, n = axes_index(mesh, batch_axes(mesh, "default"))
    b = CACHE["batch"] // n
    tokens = torch.from_numpy(toks[idx * b:(idx + 1) * b])
    pre = dataclasses.replace(model, mesh=mesh, act_rules="default")
    dec = dataclasses.replace(model, mesh=mesh, act_rules=decode_rules)
    mine, out = {}, {}
    with torch.no_grad(), probe() as rec:
        logits, st = pre.prefill(params, tokens, max_seq=CACHE["max_seq"])
        mine["prefill"] = logits.numpy()
        out["prefill"] = _state_record(st)
        if decode_rules == "decode":
            lc, sc = pre.prefill_chunked(params, tokens,
                                         n_chunks=CACHE["chunks"],
                                         max_seq=CACHE["max_seq"])
            mine["chunked"] = lc.numpy()
            out["chunked"] = _state_record(sc)
            del sc
        # the decode's rows of the global batch's greedy tokens
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (idx, greedy(logits).numpy()))
        nxt = np.concatenate([t for _, t in sorted(dict(every).items())])
        idx, n = axes_index(mesh, batch_axes(mesh, decode_rules))
        b = CACHE["batch"] // n
        nxt, steps = torch.from_numpy(nxt[idx * b:(idx + 1) * b]), []
        local = dec.local_params(params)      # once, as a server would
        serve_step = make_serve_step(dec)
        for step in range(CACHE["steps"]):
            kv_len = torch.full((b,), CACHE["seq"] + step)
            lg, st = serve_step(local, st, nxt, kv_len)
            steps.append((nxt.numpy(), lg.numpy()))
            nxt = greedy(lg)
        mine["decode"] = steps
        out["decode"] = _state_record(st)
    rec["coordinate"] = tuple(mesh.get_coordinate())
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, (mine, rec))
    out["ranks"] = ranks
    return out


MIXERS = {"mamba": "jamba-1.5-large-398b", "mlstm": "xlstm-350m",
          "slstm": "xlstm-350m"}


def tp_mixers_f64(mesh) -> dict:
    """Each recurrent mixer (Mamba, mLSTM, sLSTM of the reduced configs) in
    float64 on the model ranks of ``mesh``, from its leaves' model shards
    as the rules place them, forward from a state and backward: every
    rank's output, new state and the gradients of its shards and of the
    input, for the test to hold to the whole layer (in f64 the only
    difference is the order of sums: ~1e-15)."""
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (local_slices,
                                                  model_group,
                                                  param_sharding,
                                                  shard_local)
    from repro_torch.models import mamba as M
    from repro_torch.models import xlstm as X
    from repro_torch.models.common import logical_tree, spec_shapes
    mg = model_group(mesh)
    out = {}
    for kind, arch in MIXERS.items():
        cfg = get_config(arch, True)
        specs = {"mamba": M.mamba_specs, "mlstm": X.mlstm_specs,
                 "slstm": X.slstm_specs}[kind](cfg)
        psh = dict(leaf_paths(param_sharding(logical_tree(specs),
                                             spec_shapes(specs), mesh)))
        rng = np.random.default_rng(11)
        full = {p: rng.standard_normal(sp.shape) * 0.05
                for p, sp in leaf_paths(specs)}
        x = rng.standard_normal((2, 7, cfg.d_model))
        r = rng.standard_normal((2, 7, cfg.d_model))
        st = tp_mixer_state(kind, cfg, rng)
        leaves = {p: shard_local(torch.from_numpy(a), psh[p]).to_local()
                  .clone().requires_grad_(True) for p, a in full.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        state = tp_state_slice(kind, st, mg)
        layer = {"mamba": M.mamba_layer, "mlstm": X.mlstm_layer,
                 "slstm": X.slstm_layer}[kind]
        y, new = layer(cfg, leaves, xt, scan_chunk=4, state=state,
                       return_state=True, mg=mg)
        (y * torch.from_numpy(r)).sum().backward()
        out[kind] = dict(
            full=full, x=x, r=r, state=st, y=y.detach().numpy(),
            new=[a.detach().numpy() for a in new],
            grads={p: t.grad.numpy() for p, t in leaves.items()},
            slices={p: local_slices(full[p].shape, psh[p]) for p in leaves},
            gx=xt.grad.numpy())
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, (mg.rank, out))
    return dict(ranks=ranks)


def tp_mixer_state(kind, cfg, rng) -> tuple:
    """A random float64 state of a reduced mixer (batch 2), whole."""
    d = cfg.d_model
    if kind == "mamba":
        d_in = cfg.mamba.expand * d
        return (rng.standard_normal((2, cfg.mamba.d_conv - 1, d_in)),
                rng.standard_normal((2, d_in, cfg.mamba.d_state)))
    if kind == "mlstm":
        H, dh = cfg.n_heads, 2 * d // cfg.n_heads
        return (rng.standard_normal((2, 3, 2 * d)),
                rng.standard_normal((2, H, dh, dh)) * 0.1,
                rng.standard_normal((2, H, dh)) * 0.1,
                rng.standard_normal((2, H)))
    return tuple(rng.standard_normal((2, d)) for _ in range(4))


#: each mixer state's leaves, in the order of its tuple
STATE_KEYS = {"mamba": ("conv", "ssm"), "mlstm": ("conv", "C", "n", "m"),
              "slstm": ("c", "n", "m", "h")}


def state_dims(kind: str) -> tuple:
    """The dimension of each of a mixer state's leaves that holds its
    channels or heads (``model.STATE_SPLIT_DIM``)."""
    from repro_torch.models.model import STATE_SPLIT_DIM
    return tuple(STATE_SPLIT_DIM[k] for k in STATE_KEYS[kind])


def tp_state_slice(kind, st, mg):
    """The model rank's channels or heads of a whole mixer state."""
    from repro_torch.models import xlstm as X
    parts = []
    for a, dim in zip(st, state_dims(kind)):
        w = a.shape[dim] // mg.size
        parts.append(torch.from_numpy(a).narrow(dim, mg.rank * w, w))
    if kind == "mamba":
        return tuple(parts)
    return (X.MLSTMState if kind == "mlstm" else X.SLSTMState)(*parts)


def tp_operators(mesh, tmp: str) -> None:
    """Each tensor-parallel operator forward and backward on the model
    ranks of ``mesh``, from inputs every rank draws alike: every rank's
    outputs and gradients (the test holds them to the plain ops)."""
    import torch.distributed as dist
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import model_group
    mg = model_group(mesh)
    n, r = mg.size, mg.rank
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    parts = rng.standard_normal((n, 3, 5)).astype(np.float32)
    up = rng.standard_normal((3, 5 * n)).astype(np.float32)
    table = rng.standard_normal((4 * n, 6)).astype(np.float32)
    tokens = rng.integers(0, 4 * n, (2, 7))
    up_e = rng.standard_normal((2, 7, 6)).astype(np.float32)
    z = (rng.standard_normal((2, 9, 8 * n)) * 3).astype(np.float32)
    labels = rng.integers(0, 8 * n, (2, 9))
    out = {}

    def leaf(a):
        return torch.from_numpy(a.copy()).requires_grad_(True)

    a = leaf(x)
    y = TP.copy_to_model(a, mg) * torch.from_numpy(parts[r])
    y.sum().backward()
    out["copy_to_model"] = (y.detach().numpy(), a.grad.numpy())
    a = leaf(parts[r])
    y = TP.reduce_from_model(a, mg)
    (y * torch.from_numpy(x)).sum().backward()
    out["reduce_from_model"] = (y.detach().numpy(), a.grad.numpy())
    a = leaf(parts[r])
    y = TP.gather_from_model(a, mg)
    (y * torch.from_numpy(up)).sum().backward()
    out["gather_from_model"] = (y.detach().numpy(), a.grad.numpy())
    a = leaf(table[4 * r:4 * (r + 1)])
    y = TP.vocab_parallel_embed(a, torch.from_numpy(tokens), mg)
    (y * torch.from_numpy(up_e)).sum().backward()
    out["vocab_parallel_embed"] = (y.detach().numpy(), a.grad.numpy())
    a = leaf(z[..., 8 * r:8 * (r + 1)])
    y = TP.vocab_parallel_nll(a, torch.from_numpy(labels), mg, 8 * r)
    y.mean().backward()
    out["vocab_parallel_nll"] = (y.detach().numpy(), a.grad.numpy())
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (r, out))
    save(tmp, "tp_ops", dict(ranks=got, n=n, x=x, parts=parts, up=up,
                             table=table, tokens=tokens, up_e=up_e, z=z,
                             labels=labels))


def make_trainer(name, kind, mesh, ckpt_dir, total, fail_at=None,
                 fail_rank=0):
    """A sharded ``Trainer`` of a train case on ``mesh``, a checkpoint
    every 2 steps; with ``fail_at`` the hook raises on ``fail_rank``
    alone."""
    import torch.distributed as dist
    from repro_torch.data import DataPipeline, PipelineConfig
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.models.common import logical_tree, spec_shapes
    from repro_torch.optim import OptConfig
    from repro_torch.train import SimulatedFailure, Trainer, TrainerConfig
    model, _, _, _ = train_setup(name, kind)
    _, _, batch, seq = TRAIN_CASES[name]
    specs = model.specs()
    psh = param_sharding(logical_tree(specs), spec_shapes(specs), mesh)
    hook = None
    if fail_at is not None:
        def hook(step):
            if step == fail_at and dist.get_rank() == fail_rank:
                raise SimulatedFailure(f"injected at {step}")
    pipe = DataPipeline(model.cfg, PipelineConfig(batch=batch, seq=seq),
                        device="cpu")
    oc = OptConfig(kind=kind, lr=1e-3, warmup_steps=1, total_steps=100)
    return Trainer(model, oc, TrainerConfig(
        ckpt_dir=ckpt_dir, total_steps=total, ckpt_every=2, log_every=1,
        keep=1), pipe, failure_hook=hook, param_shardings=psh,
        device="cpu")


# ---------------------------------------------------------------------------
# the spawns
# ---------------------------------------------------------------------------

def ranks_four(rank: int, world: int, tmp: str) -> None:
    """4 ranks: sharded steps on (2,2), (4,1) and (1,4) per optimizer
    kind; tensor-parallel steps of the encoder, the MoE model, the Mamba
    hybrid and the xLSTM on (2,2) and of a 6-head model on (1,4); the
    forward and each tensor-parallel operator on (1,4); the cached passes
    on (2,2) and (1,4), and under "decode_long" on (2,2); a Trainer through a one-rank failure and its
    resume, checkpointed for the elastic restores; EF all-reduce; GPipe;
    split-sequence decode."""
    import torch.distributed as dist
    from repro_torch.distributed.grad_compress import (_dequant, _quant,
                                                       ef_allreduce)
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.sharding import (Sharding, shard_local)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.layers import decode_attention
    from repro_torch.train import SimulatedFailure
    from torch.distributed.tensor import Shard
    init(rank, world, tmp)

    steps = {}
    for shape in ((2, 2), (4, 1), (1, 4)):
        mesh = make_test_mesh(shape, device_type="cpu")
        for kind in ("adamw", "adamw8bit", "adafactor"):
            steps[(shape, kind)] = sharded_step(
                "internlm2-1.8b", kind, mesh, record=kind == "adamw")
    save(tmp, "steps", steps)

    # tensor-parallel steps: the encoder and the MoE model on (2,2), the
    # 6-head model (attention gathered whole) on (1,4)
    mesh = make_test_mesh((2, 2), device_type="cpu")
    tp = {((2, 2), name): sharded_step(name, TP_KINDS.get(name, "adamw"),
                                       mesh, record=True)
          for name in ("hubert-xlarge", "qwen2-moe-a2.7b",
                       "jamba-1.5-large-398b", "xlstm-350m")}
    mesh = make_test_mesh((1, 4), device_type="cpu")
    tp[((1, 4), "internlm2-6-heads")] = sharded_step(
        "internlm2-6-heads", "adamw", mesh, record=True)
    save(tmp, "tp4", tp)
    tp_forward(mesh, tmp)
    tp_operators(mesh, tmp)

    # the cached passes on (2,2) and (1,4), and "decode_long" on (2,2)
    cached = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_test_mesh(shape, device_type="cpu")
        for arch in CACHE_ARCHS:
            cached[(shape, arch)] = cached_passes(arch, mesh)
    mesh = make_test_mesh((2, 2), device_type="cpu")
    for arch in LONG_ARCHS:
        cached[((2, 2), arch, "decode_long")] = cached_passes(
            arch, mesh, "decode_long")
    save(tmp, "cached4", cached)

    # a Trainer on (2,2): straight, then a failure on rank 0 alone at
    # step 3 and a resume from the step-2 checkpoint
    mesh = make_test_mesh((2, 2), device_type="cpu")
    root = os.path.join(tmp, "ckpt")
    out = {}
    straight = make_trainer("internlm2-1.8b", "adamw8bit", mesh,
                            os.path.join(root, "straight"), 5)
    res = straight.run()
    straight.pipeline.close()
    out["straight"] = ([(m["step"], m["loss"], m["grad_norm"])
                        for m in res["metrics"]], tree_numpy(res["params"]),
                       tree_numpy(res["opt"]))
    failing = make_trainer("internlm2-1.8b", "adamw8bit", mesh,
                           os.path.join(root, "resumed"), 5, fail_at=3)
    try:
        failing.run()
        raised = False
    except SimulatedFailure:
        raised = True
    failing.ckpt.wait()
    failing.pipeline.close()
    out["failing"] = (raised, failing.ckpt.latest_step(),
                      [m["step"] for m in failing.metrics_log])
    resumed = make_trainer("internlm2-1.8b", "adamw8bit", mesh,
                           os.path.join(root, "resumed"), 5)
    res = resumed.run()
    resumed.pipeline.close()
    out["resumed"] = ([(m["step"], m["loss"], m["grad_norm"])
                       for m in res["metrics"]], tree_numpy(res["params"]),
                      tree_numpy(res["opt"]))
    save(tmp, "trainer", out)
    if rank == 0:        # the checkpoint the elastic restores read
        shutil.copytree(os.path.join(root, "straight"),
                        os.path.join(tmp, "ckpt4"))

    # with_logical_constraint: a replicated DTensor of [batch, seq, embed]
    # activations redistributed to the rules' placements on (2,2)
    from repro_torch.distributed.sharding import with_logical_constraint
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = make_test_mesh((2, 2), device_type="cpu")
    x = torch.arange(8 * 3 * 4, dtype=torch.float32).reshape(8, 3, 4)
    y = with_logical_constraint(
        distribute_tensor(x, mesh, (Replicate(), Replicate())),
        ("batch", "seq", "embed"), mesh)
    save(tmp, "constraint", dict(placements=tuple(y.placements),
                                 local=y.to_local().numpy(),
                                 full=y.full_tensor().numpy()))

    # EF all-reduce over 4 data ranks
    mesh = make_test_mesh((4,), ("data",), device_type="cpu")
    rng = np.random.default_rng(100 + rank)
    g = torch.from_numpy(rng.standard_normal((1, 4, 333)).astype(np.float32))
    r = torch.from_numpy(
        (rng.standard_normal((1, 4, 333)) * 0.01).astype(np.float32))
    mean, new_r = ef_allreduce({"g": g}, {"g": r}, mesh, "data")
    q, s = _quant(g[0] + r[0])
    mine = dict(g=g.numpy(), r=r.numpy(), mean=mean["g"].numpy(),
                new_r=new_r["g"].numpy(), q=q.numpy(), s=s.numpy(),
                deq=_dequant(q, s, g[0].shape).numpy())
    gathered = [None] * world
    dist.all_gather_object(gathered, mine)
    save(tmp, "ef", gathered)

    # GPipe: 4 stages ("pod"), 8 microbatches of 2 x 16
    mesh = make_test_mesh((4,), ("pod",), device_type="cpu")
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((4, 16, 16)) * 0.3)
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((8, 2, 16)).astype(np.float32))
    ws = shard_local(w, Sharding(mesh, (Shard(0),)))
    got = pipeline_forward(mesh, "pod", lambda w_s, xb: torch.tanh(xb @ w_s),
                           ws, x)
    save(tmp, "pipeline", dict(w=w.numpy(), x=x.numpy(), out=got.numpy()))

    # decode attention, the KV sequence split over 4 data ranks
    mesh = make_test_mesh((4,), ("data",), device_type="cpu")
    rng = np.random.default_rng(0)
    B, S, H, KVH, D = 1, 64, 4, 2, 16
    qa = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    ka = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    va = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    sh = Sharding(mesh, (Shard(1),))
    out = decode_attention(torch.from_numpy(qa),
                           shard_local(torch.from_numpy(ka), sh),
                           shard_local(torch.from_numpy(va), sh),
                           torch.tensor([50]))
    save(tmp, "decode", dict(q=qa, k=ka, v=va, out=out.numpy()))
    done()


def ranks_two(rank: int, world: int, tmp: str) -> None:
    """2 ranks on (2,1): the masked encoder in 2 microbatches and the MoE
    model's balance loss, one sharded step each; the 4-rank checkpoint
    restored onto this mesh; on (1,2), tensor-parallel steps of the
    encoder, the MoE model, the Mamba hybrid and the xLSTM, the cached
    passes, and each recurrent mixer in float64."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.launch.mesh import make_test_mesh
    init(rank, world, tmp)
    mesh = make_test_mesh((2, 1), device_type="cpu")
    steps = {name: sharded_step(name, "adamw", mesh)
             for name in ("hubert-xlarge", "qwen2-moe-a2.7b")}
    save(tmp, "steps2", steps)

    tr = make_trainer("internlm2-1.8b", "adamw8bit", mesh,
                      os.path.join(tmp, f"unused{rank}"), 5)
    tr.pipeline.close()
    params0, opt0 = tr._abstract_state()
    tree, extras = Checkpointer(os.path.join(tmp, "ckpt4")).restore(
        target={"params": params0, "opt": opt0}, device="cpu",
        shardings={"params": tr.param_shardings, "opt": tr.opt_shardings})
    kinds = {p: is_dtensor(x) for p, x in leaf_paths(tree)}
    save(tmp, "restore2", dict(params=tree_numpy(tree["params"]),
                               opt=tree_numpy(tree["opt"]),
                               step=extras["step"], dtensor=kinds))

    # tensor-parallel steps over 2 model ranks: Jamba's Mamba and the
    # xLSTM's mLSTM / sLSTM mixers on their shards too
    mesh = make_test_mesh((1, 2), device_type="cpu")
    save(tmp, "tp2", {((1, 2), name): sharded_step(
        name, TP_KINDS.get(name, "adamw"), mesh, record=True)
                      for name in ("hubert-xlarge", "qwen2-moe-a2.7b",
                                   "jamba-1.5-large-398b", "xlstm-350m")})
    save(tmp, "cached2", {((1, 2), arch): cached_passes(arch, mesh)
                          for arch in CACHE_ARCHS})
    save(tmp, "mixers_f64", tp_mixers_f64(mesh))
    done()


def ranks_eight(rank: int, world: int, tmp: str) -> None:
    """8 ranks: the sharded step on (2,4), (4,2) and (8,1) per optimizer
    kind (the slow full grid)."""
    from repro_torch.launch.mesh import make_test_mesh
    init(rank, world, tmp)
    steps = {}
    for shape in ((2, 4), (4, 2), (8, 1)):
        mesh = make_test_mesh(shape, device_type="cpu")
        for kind in ("adamw", "adamw8bit", "adafactor"):
            steps[(shape, kind)] = sharded_step("internlm2-1.8b", kind, mesh)
    save(tmp, "steps8", steps)
    done()
