"""Fault-tolerant training loop.

The port of the JAX package's ``train/trainer.py``:

* **checkpoint/restart** — async atomic checkpoints every ``ckpt_every``
  steps (params, opt state, data-pipeline state, step); ``Trainer.run``
  auto-resumes from the newest complete checkpoint, so a killed process
  loses at most ``ckpt_every`` steps;
* **straggler watchdog** — per-step wall times feed an EWMA; a step slower
  than ``straggler_factor`` times the EWMA is recorded in
  ``straggler_steps`` (the first step, which pays the warm-up, never
  seeds it);
* **failure injection** — ``failure_hook(step)`` raising
  ``SimulatedFailure`` exercises the crash/restore path.

Parameters are drawn by the model's seeded init (``Model.init_on_device``)
on ``device`` (the card unless ``"cpu"`` is asked for) and restored there.
Where the last periodic checkpoint was of step ``total_steps``, the
closing save of the same step waits for it instead of writing the same
files again.

``param_shardings`` (a tree of ``Sharding`` over one ``DeviceMesh``, e.g.
``distributed.sharding.param_sharding`` of the model's logical axes)
makes the run data-parallel over the mesh's ranks, each rank running the
same ``Trainer``:

* parameters and optimizer state are DTensors, placed by
  ``param_shardings`` and by the rules ``RunConfig.rules`` give
  ``opt_logical``'s axes; every rank draws the same whole parameter tree
  and keeps its shards, and initialises the optimizer state one leaf at a
  time, keeping its shards of each (:func:`shard_state`);
* the step is :func:`.train_step.make_train_step`'s sharded step
  (data-parallel over the data axes, tensor-parallel over "model");
* checkpoints gather on every rank and rank 0 writes them
  (``Checkpointer(group=WORLD)``), and ``try_restore`` restores *onto*
  the shardings, each rank reading its slices, whatever world size
  wrote them (the JAX trainer restores whole arrays and leaves the
  placement to ``jit``; the port places them explicitly);
* a ``failure_hook`` that raises ``SimulatedFailure`` on any rank stops
  every rank at that step: the ranks agree on it by an all-reduce before
  each step, since a rank that went on alone would wait forever in the
  step's collectives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from .._device import resolve_device
from ..checkpoint.checkpointer import Checkpointer, leaf_paths, rebuild
from ..data.pipeline import DataPipeline
from ..distributed.sharding import param_sharding, shard_local
from ..models.common import logical_tree, spec_shapes, tree_map
from ..models.model import Model
from ..optim.optimizer import OptConfig, abstract_opt, init_opt, opt_logical
from .train_step import make_train_step, mesh_of

PyTree = Any


class SimulatedFailure(RuntimeError):
    pass


def opt_sharding(model: Model, opt_cfg: OptConfig, mesh) -> PyTree:
    """The optimizer state's ``Sharding`` tree on ``mesh``: ``opt_logical``'s
    axes and ``abstract_opt``'s shapes under ``RunConfig.rules``."""
    specs = model.specs()
    return param_sharding(
        opt_logical(opt_cfg, logical_tree(specs)),
        abstract_opt(opt_cfg, spec_shapes(specs, model.rc.param_dtype)),
        mesh, model.rc.rules)


def shard_state(opt_cfg: OptConfig, params: PyTree, param_shardings: PyTree,
                opt_shardings: PyTree):
    """(params, opt state) as DTensors from whole parameters that every
    rank holds alike: one leaf at a time, its whole optimizer state is
    initialised and each tensor's local shard copied out."""
    p_sh = dict(leaf_paths(param_shardings))
    o_sh = dict(leaf_paths(opt_shardings))
    new_p, new_o = {}, {}
    for path, leaf in leaf_paths(params):
        for opath, x in leaf_paths(init_opt(opt_cfg, {"x": leaf})):
            key = f"{opath.rsplit('/', 1)[0]}/{path}"
            new_o[key] = shard_local(x, o_sh[key])
        new_p[path] = shard_local(leaf, p_sh[path])
    meta = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                          device="meta"), params)
    return rebuild(params, new_p), rebuild(init_opt(opt_cfg, meta), new_o)


@dataclasses.dataclass
class TrainerConfig:
    # no default: a run resumes from whatever checkpoints this directory
    # holds, so each run names its own
    ckpt_dir: str
    total_steps: int = 100
    ckpt_every: int = 20
    keep: int = 2
    log_every: int = 10
    straggler_factor: float = 3.0


class Trainer:
    def __init__(self, model: Model, opt_cfg: OptConfig, tc: TrainerConfig,
                 pipeline: DataPipeline,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 param_shardings: Optional[PyTree] = None, device="cuda"):
        self.model = model
        self.opt_cfg = opt_cfg
        self.tc = tc
        self.pipeline = pipeline
        self.failure_hook = failure_hook
        self.device = resolve_device(device)
        self.param_shardings = param_shardings
        self.opt_shardings = None
        group = None
        if param_shardings is not None:
            import torch.distributed as dist
            mesh = mesh_of(param_shardings)
            if mesh.device_type != self.device.type:
                raise ValueError(f"the mesh is on {mesh.device_type}, the "
                                 f"trainer on {self.device.type}")
            self.opt_shardings = opt_sharding(model, opt_cfg, mesh)
            group = dist.group.WORLD
        self.ckpt = Checkpointer(tc.ckpt_dir, keep=tc.keep, group=group)
        self.train_step = make_train_step(model, opt_cfg, param_shardings)
        self.metrics_log: list = []
        self.straggler_steps: list = []

    # ------------------------------------------------------------------
    def _abstract_state(self):
        """(params, opt state) as meta tensors: the structure, no
        storage."""
        params = spec_shapes(self.model.specs(), self.model.rc.param_dtype)
        return params, init_opt(self.opt_cfg, params)

    def init_state(self, seed: int = 0):
        params = self.model.init_on_device(seed, self.device)
        if self.param_shardings is None:
            return params, init_opt(self.opt_cfg, params), 0
        return (*shard_state(self.opt_cfg, params, self.param_shardings,
                             self.opt_shardings), 0)

    def try_restore(self):
        step = self.ckpt.latest_step()
        if step is None:
            return None
        params0, opt0 = self._abstract_state()
        shardings = None
        if self.param_shardings is not None:
            shardings = {"params": self.param_shardings,
                         "opt": self.opt_shardings}
        tree, extras = self.ckpt.restore(
            step, target={"params": params0, "opt": opt0},
            device=self.device, shardings=shardings)
        self.pipeline.restore(extras["pipeline"])
        return tree["params"], tree["opt"], int(extras["step"])

    def _check_failure(self, step: int) -> None:
        """Run ``failure_hook``; sharded, stop every rank if any failed."""
        if self.param_shardings is None:
            if self.failure_hook is not None:
                self.failure_hook(step)
            return
        import torch.distributed as dist
        err = None
        try:
            if self.failure_hook is not None:
                self.failure_hook(step)
        except SimulatedFailure as e:
            err = e
        flag = torch.tensor([0 if err is None else 1], dtype=torch.int32,
                            device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if err is not None:
            raise err
        if int(flag.item()):
            raise SimulatedFailure(f"another rank failed at step {step}")

    def _save(self, step: int, params, opt_state, blocking=False) -> None:
        self.ckpt.save(step, {"params": params, "opt": opt_state},
                       extras={"step": step,
                               "pipeline": self.pipeline.state()},
                       blocking=blocking)

    # ------------------------------------------------------------------
    def run(self, seed: int = 0) -> Dict[str, Any]:
        restored = self.try_restore()
        if restored is not None:
            params, opt_state, start = restored
        else:
            params, opt_state, start = self.init_state(seed)
            self.pipeline.restore({"step": start})

        ewma: Optional[float] = None
        executed = 0
        saved = None
        for step in range(start, self.tc.total_steps):
            self._check_failure(step)
            batch = next(self.pipeline)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch, step)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            executed += 1
            if executed == 1:
                pass          # the first step pays the warm-up
            elif ewma is None:
                ewma = dt
            else:
                if dt > self.tc.straggler_factor * ewma:
                    self.straggler_steps.append((step, dt, ewma))
                ewma = 0.9 * ewma + 0.1 * dt
            if step % self.tc.log_every == 0 or step == self.tc.total_steps - 1:
                self.metrics_log.append(dict(step=step, time=dt, **metrics))
            if (step + 1) % self.tc.ckpt_every == 0:
                self._save(step + 1, params, opt_state)
                saved = step + 1
        if saved == self.tc.total_steps:
            self.ckpt.wait()
        else:
            self._save(self.tc.total_steps, params, opt_state, blocking=True)
        return {"params": params, "opt": opt_state,
                "metrics": self.metrics_log,
                "stragglers": self.straggler_steps}
