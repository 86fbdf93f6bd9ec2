"""Admission queue for the continuous-batching engine (the torch
counterpart of ``repro/serve/batching/scheduler.py``).

Pure host-side data structure: the engine owns capacity (slots, pages) and
expresses it through the ``can_admit`` callback; the scheduler owns ORDER.

* ``fifo`` — strict arrival order;
* ``priority`` — lowest ``Request.priority`` first, arrival order within a
  tier (stable: a later submit never overtakes an equal-priority earlier one).

Admission stops at the first deferred request (head-of-line blocking): a
blocked head is never overtaken, which is what makes the no-drop /
no-duplicate / no-starvation invariants easy to state and test
(the reference's tests/serve/test_scheduler.py; tests/test_torch_serve.py
holds the port to the same call sequences).
"""
from __future__ import annotations

import heapq
from typing import Callable, Iterable

from .request import Request

#: ``can_admit`` verdicts.
ADMIT = "admit"
DEFER = "defer"     # not now (capacity); keep at the head
REJECT = "reject"   # never (e.g. prompt + budget exceeds max_len); drop


class Scheduler:
    def __init__(self, mode: str = "fifo"):
        if mode not in ("fifo", "priority"):
            raise ValueError(f"scheduler mode must be fifo|priority, got {mode!r}")
        self.mode = mode
        self._heap: list[tuple] = []
        self._seq = 0
        self._queued_ids: set[int] = set()

    def __len__(self) -> int:
        return len(self._heap)

    def submit(self, req: Request) -> None:
        if req.request_id in self._queued_ids:
            raise ValueError(f"request {req.request_id} already queued")
        key = ((req.priority, self._seq) if self.mode == "priority"
               else (self._seq,))
        heapq.heappush(self._heap, (key, req))
        self._seq += 1
        self._queued_ids.add(req.request_id)

    def queued_ids(self) -> Iterable[int]:
        return frozenset(self._queued_ids)

    def _pop(self) -> Request:
        _, req = heapq.heappop(self._heap)
        self._queued_ids.discard(req.request_id)
        return req

    def drain(self, now: float,
              can_admit: Callable[[Request], str]) -> tuple[list, list, list]:
        """One admission pass -> (admitted, expired, rejected).

        Visits requests in scheduling order. Deadline-expired requests are
        culled without consulting capacity; ``can_admit`` then admits,
        rejects permanently, or defers — the first deferral ends the pass
        with the head intact.
        """
        admitted: list[Request] = []
        expired: list[Request] = []
        rejected: list[Request] = []
        while self._heap:
            head: Request = self._heap[0][1]
            if head.deadline is not None and now > head.deadline:
                expired.append(self._pop())
                continue
            verdict = can_admit(head)
            if verdict == ADMIT:
                admitted.append(self._pop())
            elif verdict == REJECT:
                rejected.append(self._pop())
            elif verdict == DEFER:
                break
            else:
                raise ValueError(f"can_admit returned {verdict!r}")
        return admitted, expired, rejected
