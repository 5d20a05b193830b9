"""Slot-level continuous-batching scheduler (a copy of
``repro.serve.scheduler``, which the port may not import).

The engine owns a fixed number of decode *slots* (the decode batch
dimension).  The scheduler owns everything about which request occupies
which slot:

- a FIFO queue of pending :class:`ServeRequest`;
- admission: a request enters a free slot only when the paged cache can
  reserve its full token budget (prompt + ``max_new_tokens``), via
  ``PagedKVCache.admit`` — so an admitted request can never stall on cache
  space mid-decode;
- stop conditions: per-request ``max_new_tokens`` and optional ``eos_id``;
- mid-decode refill: a slot freed by a finishing request is re-admitted on
  the very next step without draining the rest of the batch.

The scheduler is pure host-side bookkeeping — it never touches device
arrays — which keeps it trivially testable and backend-agnostic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ServeRequest:
    """One generation request (prompt tokens live host-side as a list)."""
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    rid: int = -1
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def budget_tokens(self) -> int:
        """Worst-case cache rows this request can ever occupy."""
        return len(self.prompt) + self.max_new_tokens

    def record(self, tok: int) -> bool:
        """Append one generated token; returns True if the request is done."""
        self.out_tokens.append(tok)
        if self.eos_id is not None and tok == self.eos_id:
            self.done = True
        elif len(self.out_tokens) >= self.max_new_tokens:
            self.done = True
        return self.done


@dataclasses.dataclass
class SchedulerStats:
    n_admitted: int = 0
    n_finished: int = 0
    n_refills: int = 0        # admissions into a slot mid-decode
    n_deferred: int = 0       # admission attempts bounced by the cache
    peak_active: int = 0


class Scheduler:
    def __init__(self, slots: int):
        self.slots = slots
        self.queue: list[ServeRequest] = []
        self.active: list[Optional[ServeRequest]] = [None] * slots
        self.stats = SchedulerStats()
        self._next_rid = 0
        self._steps = 0

    def submit(self, req: ServeRequest) -> int:
        req.rid = self._next_rid
        self._next_rid += 1
        self.queue.append(req)
        return req.rid

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.active)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def fill(self, admit) -> list[tuple[int, ServeRequest]]:
        """Move queued requests into free slots.

        ``admit(slot, req) -> bool`` is the cache's budget reservation; a
        False bounce leaves the request at the head of the queue (FIFO is
        preserved — we stop at the first bounce rather than searching for a
        smaller request, to avoid starving long prompts).  Returns the
        ``(slot, request)`` pairs placed this call.
        """
        placed = []
        for slot in self.free_slots():
            if not self.queue:
                break
            req = self.queue[0]
            if not admit(slot, req):
                self.stats.n_deferred += 1
                break
            self.queue.pop(0)
            self.active[slot] = req
            self.stats.n_admitted += 1
            if self._steps > 0:
                self.stats.n_refills += 1
            placed.append((slot, req))
        self.stats.peak_active = max(self.stats.peak_active, self.n_active)
        return placed

    def step_tokens(self, toks) -> list[int]:
        """Record one sampled token per slot; returns slots that finished.

        ``toks`` is indexable per slot (host ints).  Finished requests are
        detached from their slot (the caller releases the cache slot and
        then calls :meth:`fill` to refill).
        """
        self._steps += 1
        finished = []
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            if req.record(int(toks[slot])):
                self.stats.n_finished += 1
                self.active[slot] = None
                finished.append(slot)
        return finished
