"""Deterministic synthetic data pipeline with prefetch.

The port of the JAX package's ``data/pipeline.py``.  Batch contents are a
pure function of (step, seed): :func:`_batch_at` is the reference's numpy,
copied, so both packages draw the same batches element for element, and
the whole pipeline state in a checkpoint is one integer.  A background
thread keeps ``prefetch`` numpy batches ahead; :meth:`DataPipeline.__next__`
copies the next one to the pipeline's device (the JAX ``device_put``).
With ``shardings`` (a ``Sharding`` per batch key) each rank draws the
whole global batch, as every process draws the same ``(step, seed)``
batch, and keeps only its slice, as a DTensor: no communication.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..distributed.sharding import from_local, local_slices
from ..models.config import ModelConfig


@dataclasses.dataclass
class PipelineConfig:
    batch: int
    seq: int
    seed: int = 0
    prefetch: int = 2


def _batch_at(cfg: ModelConfig, pc: PipelineConfig, step: int
              ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(np.uint64(pc.seed * 1_000_003 + step))
    B, S, V = pc.batch, pc.seq, cfg.vocab
    if cfg.family == "encoder":
        return {
            "input_embeds": rng.standard_normal(
                (B, S, cfg.d_model), dtype=np.float32) * 0.02,
            "labels": rng.integers(0, V, (B, S), dtype=np.int32),
            "mask": (rng.random((B, S)) < 0.08).astype(np.float32),
        }
    tokens = rng.integers(0, V, (B, S), dtype=np.int32)
    out = {"tokens": tokens,
           "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), dtype=np.float32) * 0.02
    return out


class DataPipeline:
    """Iterator over batches on ``device`` (the card unless ``"cpu"`` is
    asked for) with background prefetch; :meth:`close` stops the
    thread.  ``shardings``: ``{key: Sharding}`` (module docstring)."""

    def __init__(self, cfg: ModelConfig, pc: PipelineConfig, device="cuda",
                 start_step: int = 0, shardings: Optional[dict] = None):
        self.cfg, self.pc = cfg, pc
        self.device = resolve_device(device)
        self.shardings = shardings
        self.step = start_step
        self._thread = None
        self._start(start_step)

    def _start(self, step: int) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=max(self.pc.prefetch,
                                                         1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer,
                                        args=(step, self._q, self._stop),
                                        daemon=True)
        self._thread.start()

    def _producer(self, step: int, q: "queue.Queue",
                  stop: threading.Event) -> None:
        while not stop.is_set():
            batch = _batch_at(self.cfg, self.pc, step)
            while not stop.is_set():
                try:
                    q.put((step, batch), timeout=0.5)
                    step += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        while True:
            step, batch = self._q.get()
            if step == self.step:
                break
            # stale batch from before a restore(); drop it
        self.step += 1
        if self.shardings is None:
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in batch.items()}
        return {k: from_local(torch.from_numpy(np.ascontiguousarray(
            v[local_slices(v.shape, self.shardings[k])])).to(self.device),
            self.shardings[k], v.shape) for k, v in batch.items()}

    # --- checkpointable state -------------------------------------------
    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    def restore(self, state: Dict[str, int]) -> None:
        """Continue from ``state["step"]``; the prefetch thread restarts
        there (so a step before the prefetched ones is drawn again)."""
        self.close()
        self.step = int(state["step"])
        self._start(self.step)

    def close(self) -> None:
        """Stop the prefetch thread and wait for it."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=30)
            self._thread = None
