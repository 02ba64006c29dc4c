"""Model-free scheduling core of the serving engine — a copy of the JAX
package's ``serve/scheduler.py`` (no model, no framework).

:class:`KVScheduler` owns everything about request scheduling that does NOT
require a model: the FCFS waiting queue, the running set, stable batch-slot
assignment, KV-capacity admission control against a
:class:`~repro_torch.kvcache.allocator.PagedKVAllocator`, and vLLM-style
preempt-youngest-and-requeue under pool exhaustion.

It exists so the same policy code drives two consumers:

* :class:`repro_torch.serve.engine.ServingEngine` — real decode: the
  engine keeps token state and kernels, the scheduler keeps
  queues/slots/pages;
* :mod:`repro_torch.scenarios.workload` — scenario recording: the
  KV-churn scenarios replay admission/extend/preempt/free
  cycles against the buddy allocator to harvest mixed-contiguity block
  tables and access traces without instantiating a model.

Splitting it out also fixes a latent bug in the original inlined admission
loop: a preempted victim was pushed to the *front* of the waiting queue
before the admitted request was popped from it, so the ``popleft`` removed
the victim (losing it forever) and left the admitted request queued twice.
``admit`` now removes the admitted request by identity.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from ..kvcache.allocator import PagedKVAllocator

OnEvent = Optional[Callable[[int], None]]


class KVScheduler:
    """Queues, batch slots, and KV-capacity admission over an allocator.

    Requests are opaque integer ids; per-request page needs are supplied by
    the caller at admission time (``need_pages(rid)``), so the scheduler
    works for both token-level engines and page-level scenario drivers.
    """

    def __init__(self, allocator: PagedKVAllocator, max_batch: int,
                 event_tap: Optional[Callable[[str, int], None]] = None):
        self.allocator = allocator
        self.max_batch = max_batch
        self.waiting: Deque[int] = deque()
        self.running: List[int] = []
        self.slots: Dict[int, int] = {}            # rid → stable batch slot
        self._free_slots: List[int] = list(range(max_batch))
        self.preemptions = 0
        #: optional ``tap(kind, rid)`` observer fired on every scheduling
        #: action that changes the KV mapping ("admit" — after the slot is
        #: assigned and pages are held; "preempt"/"release" — after the
        #: pages are freed).  The dynamic-scenario recorder uses it to turn
        #: serving churn into a ``MappingEvent`` stream
        #: (``repro_torch.core.page_table``); the real engine runs untapped
        #: by default.
        self.event_tap = event_tap

    def _tap(self, kind: str, rid: int) -> None:
        if self.event_tap is not None:
            self.event_tap(kind, rid)

    # ------------------------------------------------------------------
    def enqueue(self, rid: int, front: bool = False) -> None:
        if front:
            self.waiting.appendleft(rid)
        else:
            self.waiting.append(rid)

    def admit(self, need_pages: Callable[[int], int],
              on_admit: OnEvent = None, on_preempt: OnEvent = None
              ) -> List[int]:
        """FCFS admission with KV-capacity control (ServingEngine policy).

        Walks the waiting queue head; when the pool cannot serve the head
        request, preempts the youngest running request (recompute-style) if
        more than one is running, then retries once.  ``on_admit(rid)`` fires
        after the slot is assigned; ``on_preempt(rid)`` while the victim
        still holds its pages (so callers can snapshot recompute state),
        before it is requeued at the front of the queue (a preempted request
        is re-admitted with priority).
        """
        admitted: List[int] = []
        preempted_now: set = set()
        while self.waiting and len(self.running) < self.max_batch:
            rid = self.waiting[0]
            if rid in preempted_now:
                break    # admitting it again would just thrash the pool
            if self.allocator.allocate(rid, need_pages(rid)) is None:
                # pool exhausted: preempt the youngest running request
                # (vLLM-style recompute preemption) if that frees enough
                if len(self.running) > 1:
                    victim = self.running[-1]
                    self.preempt(victim, on_preempt)
                    preempted_now.add(victim)
                    if self.allocator.allocate(rid, need_pages(rid)) is None:
                        break
                else:
                    break
            # the preempted victim now sits at waiting[0]; remove the
            # admitted request by identity, not by position
            self.waiting.remove(rid)
            self.running.append(rid)
            self.slots[rid] = self._free_slots.pop(0)
            admitted.append(rid)
            self._tap("admit", rid)
            if on_admit is not None:
                on_admit(rid)
        return admitted

    def preempt(self, rid: int, on_preempt: OnEvent = None) -> None:
        """Free ``rid``'s pages and requeue it at the front of the queue."""
        if on_preempt is not None:
            on_preempt(rid)          # rid still holds its pages here
        self.running.remove(rid)
        self._free_slots.insert(0, self.slots.pop(rid))
        self.allocator.free(rid)
        self.preemptions += 1
        self.waiting.appendleft(rid)
        self._tap("preempt", rid)

    def release(self, rid: int) -> None:
        """A finished request: recycle its slot and pages."""
        self.running.remove(rid)
        self._free_slots.append(self.slots.pop(rid))
        self.allocator.free(rid)
        self._tap("release", rid)

    # ------------------------------------------------------------------
    def snapshot_state(self) -> Dict:
        """Queues/slots/counters as a JSON-serializable dict (the allocator
        snapshots its own page state separately)."""
        return dict(waiting=list(self.waiting), running=list(self.running),
                    slots={str(r): s for r, s in self.slots.items()},
                    free_slots=list(self._free_slots),
                    preemptions=self.preemptions)

    def restore_state(self, snap: Dict) -> None:
        self.waiting = deque(int(r) for r in snap["waiting"])
        self.running = [int(r) for r in snap["running"]]
        self.slots = {int(r): int(s) for r, s in snap["slots"].items()}
        self._free_slots = [int(s) for s in snap["free_slots"]]
        self.preemptions = int(snap["preemptions"])

    # ------------------------------------------------------------------
    def slot_of(self, rid: int) -> int:
        return self.slots[rid]

    @property
    def has_work(self) -> bool:
        return bool(self.running or self.waiting)
