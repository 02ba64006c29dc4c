"""Rank-side work of ``tests/test_torch_distributed.py``: the port on
``gloo`` ranks on the CPU.

Each ``ranks_*`` function runs in every rank of a spawn
(:func:`start` / :func:`join`), one thread per rank, and rank 0 writes what the test
compares (numpy arrays) with ``torch.save``.  This module imports
neither JAX nor the JAX package, so a rank starts in the time it takes
to import torch.
"""
from __future__ import annotations

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
}
COLLECTIVE_TIMEOUT_S = 60


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
    model = Model(get_config(arch, True),
                  RunConfig(microbatches=micro, **CHUNKS))
    batch = _batch_at(model.cfg, PipelineConfig(batch=batch, seq=seq), 3)
    return model, OptConfig(kind=kind, **OPT), model.init_numpy(0), batch


def sharded_step(name: str, kind: str, mesh):
    """One sharded train step at step 1 → (metrics, new params) as
    numpy, the batch drawn by ``DataPipeline(shardings=...)`` under the
    activation rules (each rank's rows as a DTensor)."""
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
    new_p, _, met = make_train_step(model, oc, psh)(params, opt, b, 1)
    return {k: float(v) for k, v in met.items()}, tree_numpy(new_p)


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
    """4 ranks: sharded steps on (2,2) and (4,1) per optimizer kind; a
    Trainer through a one-rank failure and its resume, checkpointed for
    the elastic restores; EF all-reduce; GPipe; split-sequence decode."""
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
    for shape in ((2, 2), (4, 1)):
        mesh = make_test_mesh(shape, device_type="cpu")
        for kind in ("adamw", "adamw8bit", "adafactor"):
            steps[(shape, kind)] = sharded_step("internlm2-1.8b", kind, mesh)
    save(tmp, "steps", steps)

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
    restored onto this mesh."""
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
