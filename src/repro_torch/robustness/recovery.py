"""Recovery policies: how the runtimes turn injected faults into finished
work.

The port of the JAX package's ``robustness/recovery.py``: the same event
order, the same draws from the plan's generator and the same report keys.
Four policies, each owned by the layer that can act on it:

* **retry-with-backoff** (:func:`retry_with_backoff`) — transient faults;
  generic wrapper used by harnesses around flaky effectful calls.
* **batch bisection** — lives in
  :func:`repro_torch.core.sweep._run_batch_resilient`: a batch whose
  kernel launch fails is launched again in halves, and a single cell that
  fails every launch runs on the pure-python oracle (bit-exact by
  construction); only the oracle raising propagates.  There is no second
  backend to retry on, as the reference's XLA rung: on the card the plain
  torch version would hide the kernel.
* **quarantine-and-recompute** —
  :meth:`repro_torch.serve.engine.ServingEngine.quarantine_pages` preempts
  the owners of corrupted KV pages through the recompute path (generated
  tokens kept) and retires the pages; ``run_sweep`` quarantines corrupt
  cache files and recomputes, surfacing ``cache_quarantined`` in its
  stats.
* **checkpoint-resume** — :meth:`ServingEngine.snapshot` / ``restore``;
  :func:`run_engine_with_recovery` below drives a full serve under a
  :class:`~repro_torch.robustness.faults.FaultPlan`, restarting a
  "crashed" engine from its latest checkpoint.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .faults import (EngineCrash, FaultPlan, KVCorruption, PageLoss,
                     corrupt_kv_pages)


class RecoveryError(RuntimeError):
    """A fault the recovery policies could NOT absorb.  Raised instead of
    returning partial results: the chaos contract is recover exactly or
    fail loudly, never diverge silently."""


def retry_with_backoff(fn: Callable, *, retries: int = 3,
                       base_delay: float = 0.0,
                       retry_on: Tuple = (Exception,),
                       sleep: Callable[[float], None] = time.sleep):
    """Call ``fn()`` up to ``retries + 1`` times with exponential backoff
    (``base_delay * 2^attempt``; 0 keeps tests instant).  The last failure
    propagates unchanged."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on:
            if attempt == retries:
                raise
            if base_delay:
                sleep(base_delay * (2 ** attempt))


def run_engine_with_recovery(make_engine: Callable,
                             requests: Sequence[Tuple[List[int], int]],
                             plan: Optional[FaultPlan],
                             ckpt_dir: str,
                             max_steps: int = 256,
                             snapshot_every: int = 1) -> Tuple[Dict, Dict]:
    """Drive a :class:`ServingEngine` to completion under a fault plan.

    ``make_engine()`` builds a fresh engine from fixed (model, params,
    config) — the "process" that crash events kill.  Per engine step the
    harness fires the plan's events due at that step:

    * :class:`KVCorruption` — garbage live pages with
      :func:`~repro_torch.robustness.faults.corrupt_kv_pages`, then recover via
      ``engine.quarantine_pages`` (owners recompute-preempted, pages
      retired);
    * :class:`PageLoss` — retire free pages directly (owned pages are
      skipped: losing them is the KVCorruption path);
    * :class:`EngineCrash` — discard the engine object and ``restore`` a
      fresh one from the latest snapshot; steps since that snapshot replay
      deterministically.

    Each event fires once.  Returns ``(outputs, report)`` where
    ``outputs[rid]`` is the full generated token list.  Raises
    :class:`RecoveryError` when ``max_steps`` expires with work still
    pending — a stall is a loud failure, never a truncated answer.
    """
    plan = plan or FaultPlan(seed=0)
    rng = np.random.default_rng(plan.seed)
    eng = make_engine()
    for prompt, max_new in requests:
        eng.add_request(list(prompt), max_new_tokens=max_new)

    crash_due = {e.step for e in plan.of(EngineCrash)}
    corrupt_due: Dict[int, List[KVCorruption]] = {}
    for e in plan.of(KVCorruption):
        corrupt_due.setdefault(e.step, []).append(e)
    loss_due: Dict[int, List[PageLoss]] = {}
    for e in plan.of(PageLoss):
        loss_due.setdefault(e.step, []).append(e)

    report = dict(crashes=0, restarts=0, kv_corrupted=0, preempted=0,
                  pages_lost=0, steps=0)
    eng.snapshot(ckpt_dir, step=0)
    for _ in range(max_steps):
        more = eng.step()
        step = int(eng.metrics["steps"])
        for e in corrupt_due.pop(step, []):
            live = sorted({p for a in eng.allocator.seqs.values()
                           for p in a.pages})
            if not live:
                continue
            k = min(e.n_pages, len(live))
            bad = [int(p) for p in rng.choice(live, size=k, replace=False)]
            corrupt_kv_pages(eng, bad)
            owners = eng.quarantine_pages(bad)
            report["kv_corrupted"] += len(bad)
            report["preempted"] += len(owners)
        for e in loss_due.pop(step, []):
            cand = [int(p) for p in rng.integers(0, eng.ec.num_pages,
                                                 size=e.n_pages)]
            report["pages_lost"] += len(eng.allocator.retire_pages(cand))
        if step % snapshot_every == 0:
            eng.snapshot(ckpt_dir, step=step)
        if step in crash_due:
            crash_due.discard(step)
            report["crashes"] += 1
            eng = make_engine()          # the old process is gone
            eng.restore(ckpt_dir)
            report["restarts"] += 1
            continue
        if not more and not eng.sched.has_work:
            break
    report["steps"] = int(eng.metrics["steps"])
    if eng.sched.has_work:
        raise RecoveryError(
            f"engine stalled after {max_steps} harness steps with "
            f"{len(eng.waiting)} waiting / {len(eng.running)} running")
    outputs = {rid: list(req.generated) for rid, req in eng.requests.items()}
    report["metrics"] = dict(eng.metrics)
    return outputs, report
