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
Sharding (the JAX ``param_shardings`` and elastic restore onto another
mesh) is the port's distributed slice (ROADMAP A12): ``param_shardings``
must be ``None``.  Where the last periodic checkpoint was of step
``total_steps``, the closing save of the same step waits for it instead of
writing the same files again.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from .._device import resolve_device
from ..checkpoint.checkpointer import Checkpointer
from ..data.pipeline import DataPipeline
from ..models.common import _walk
from ..models.model import Model, torch_dtype
from ..optim.optimizer import OptConfig, init_opt
from .train_step import make_train_step

PyTree = Any


class SimulatedFailure(RuntimeError):
    pass


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
        if param_shardings is not None:
            raise NotImplementedError(
                "param_shardings: sharded training is not ported yet "
                "(ROADMAP A12); pass None")
        self.model = model
        self.opt_cfg = opt_cfg
        self.tc = tc
        self.pipeline = pipeline
        self.failure_hook = failure_hook
        self.device = resolve_device(device)
        self.ckpt = Checkpointer(tc.ckpt_dir, keep=tc.keep)
        self.train_step = make_train_step(model, opt_cfg)
        self.metrics_log: list = []
        self.straggler_steps: list = []

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        params = self.model.init_on_device(seed, self.device)
        return params, init_opt(self.opt_cfg, params), 0

    def try_restore(self):
        step = self.ckpt.latest_step()
        if step is None:
            return None
        # the structure, with no storage: meta tensors of the specs
        pdt = self.model.rc.param_dtype
        params0 = _walk(self.model.specs(), lambda _, s: torch.empty(
            s.shape, dtype=torch_dtype(s.dtype or pdt), device="meta"))
        target = {"params": params0, "opt": init_opt(self.opt_cfg, params0)}
        tree, extras = self.ckpt.restore(step, target=target,
                                         device=self.device)
        self.pipeline.restore(extras["pipeline"])
        return tree["params"], tree["opt"], int(extras["step"])

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
            if self.failure_hook is not None:
                self.failure_hook(step)
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
