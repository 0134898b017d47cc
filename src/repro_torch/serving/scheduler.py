"""Serving-side scheduling: peer selection, quorum, continuous batching.

* ``select_peers``: deadline-aware peer choice (paper objective O1 /
  Sec. IV-F) — rank peers by predicted L_edge + L_comm (Eq. 8-9 terms)
  and take the k that fit the L_max deadline.  Inputs: (n,) predicted
  latencies; output: (n,) bool mask of chosen peers.
* ``ContinuousBatcher``: fixed-slot decode batching — requests stream into
  free slots, finished slots free immediately (vLLM-style iteration-level
  scheduling, shaped for the batched TPU decode step whose batch dim is
  static).  Drives the ``InferenceEngine.serve`` lifecycle documented in
  docs/RUNTIME.md: admit -> prefill slot -> scanned decode chunk ->
  retire at stop token / max_new.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def select_peers(pred_latency: np.ndarray, k: int, l_max: float,
                 available: np.ndarray | None = None,
                 health: object | None = None) -> np.ndarray:
    """pred_latency (n,) predicted per-peer response time -> bool mask of
    up-to-k chosen peers whose prediction fits the deadline.

    ``health`` (optional ``faults.HealthRegistry``) refines selection:
    unhealthy peers are excluded until their next half-open recovery
    probe (``health.available()``), and a peer's observed EWMA latency
    replaces the static prediction where one has been recorded — a
    chronically slow peer stops being chosen even while nominally up."""
    n = len(pred_latency)
    if available is None:
        available = np.ones((n,), bool)
    if health is not None:
        available = available & health.available()
        ewma = np.asarray(health.ewma, float)
        pred_latency = np.where(np.isnan(ewma), pred_latency, ewma)
    order = np.argsort(pred_latency)
    chosen = np.zeros((n,), bool)
    taken = 0
    for j in order:
        if taken >= k:
            break
        if available[j] and pred_latency[j] <= l_max:
            chosen[j] = True
            taken += 1
    return chosen


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list                 # new-span tokens (the WHOLE prompt when
    max_new: int                 # state is None; only the new turn with one)
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # warm-cache session handle (serving/engine.py::SessionState): admission
    # splices the live cache into the slot and continuation-prefills only
    # ``prompt`` instead of re-absorbing the whole conversation.  On a
    # paged engine, MANY queued requests may carry the SAME absorbed handle
    # — each admission is a refcounted block-table copy off it (COW tail),
    # fanning one prefilled prefix out across slots.
    state: object | None = None
    # hand back this request's SessionState at retirement (multi-turn serve)
    return_state: bool = False
    # admission ordering (multi-tenant serve): earliest deadline first,
    # then lowest priority value; FIFO among equals.  deadline_ms is an
    # absolute caller-defined clock (only compared between requests).
    priority: int = 0
    deadline_ms: float | None = None
    # set True when the scheduler gave up on the request (deadline expired
    # mid-queue/mid-decode, or famine shed) — it retires with whatever it
    # had; the gateway's cloud path is the recourse for shed work.
    shed: bool = False
    # full-conversation prompt for a warm request: if its session handle
    # is lost (eviction, slot failure), serve() transparently re-admits it
    # COLD from this prompt instead of failing the request.
    cold_prompt: list | None = None


class ContinuousBatcher:
    """Iteration-level scheduler over a fixed number of decode slots.

    Admission is deadline/priority-aware: the queue is drained earliest-
    ``deadline_ms`` first (requests without a deadline sort last), ties
    broken by ascending ``priority`` and then submit order — a tight-
    deadline request submitted late preempts the queue for the next free
    slot (it never preempts a request already decoding in a slot)."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.slots: list[Request | None] = [None] * n_slots
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        # failure-domain accounting (see docs/RUNTIME.md "Failure
        # semantics"): expired = deadline passed, shed = famine overflow,
        # requeued = slot died mid-decode and the request went back in line.
        self.counters = {"expired": 0, "shed": 0, "requeued": 0}

    def submit(self, req: Request):
        self.queue.append(req)

    @staticmethod
    def _urgency(r: Request) -> tuple:
        return (r.deadline_ms if r.deadline_ms is not None else float("inf"),
                r.priority)

    def admit(self, fits=None) -> list[int]:
        """Fill free slots from the queue in earliest-deadline-then-priority
        order; returns newly admitted slot ids.  ``fits`` (optional
        predicate) lets the cache pool veto admissions that cannot get
        blocks yet — vetoed requests stay queued, in order, and are retried
        once retirements free resources."""
        admitted = []
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                self.queue.sort(key=self._urgency)    # stable: FIFO ties
                j = next((jj for jj, r in enumerate(self.queue)
                          if fits is None or fits(r)), None)
                if j is None:
                    break
                self.slots[i] = self.queue.pop(j)
                admitted.append(i)
        return admitted

    def active_mask(self) -> np.ndarray:
        return np.array([s is not None and not s.done for s in self.slots])

    def active(self) -> list[tuple[int, Request]]:
        """(slot id, request) pairs currently decoding."""
        return [(i, s) for i, s in enumerate(self.slots)
                if s is not None and not s.done]

    def drain_finished(self) -> list[Request]:
        """Pop and return requests finished since the last drain."""
        out, self.finished = self.finished, []
        return out

    def record_tokens(self, tokens: np.ndarray, stop_token: int | None = None):
        """tokens (n_slots,) newest token per slot; retire finished requests."""
        for i, s in enumerate(self.slots):
            if s is None or s.done:
                continue
            t = int(tokens[i])
            s.generated.append(t)
            if len(s.generated) >= s.max_new or (stop_token is not None
                                                 and t == stop_token):
                s.done = True
                self.finished.append(s)
                self.slots[i] = None

    def expire(self, now_ms: float) -> list[tuple[int | None, Request]]:
        """Retire requests whose ``deadline_ms`` has passed at ``now_ms``.

        Queued requests are dropped before ever taking a slot; active
        requests are retired mid-decode with whatever tokens they have
        (slot freed immediately).  Both come back marked ``shed=True``
        through ``drain_finished``.  Returns ``(slot_id | None, request)``
        pairs so the engine can release pool resources of active
        casualties (queued ones hold none)."""
        out: list[tuple[int | None, Request]] = []
        for j in range(len(self.queue) - 1, -1, -1):
            r = self.queue[j]
            if r.deadline_ms is not None and r.deadline_ms < now_ms:
                self.queue.pop(j)
                out.append((None, r))
        for i, s in enumerate(self.slots):
            if (s is not None and not s.done and s.deadline_ms is not None
                    and s.deadline_ms < now_ms):
                out.append((i, s))
                self.slots[i] = None
        for _, r in out:
            r.done = True
            r.shed = True
            self.finished.append(r)
            self.counters["expired"] += 1
        return out

    def shed_one(self) -> Request | None:
        """Drop the least-urgent queued request (famine overflow control):
        latest deadline, then highest priority value, then latest arrival.
        It retires ``shed=True`` with no tokens — the caller decides the
        recourse (the gateway reroutes shed work to the cloud path)."""
        if not self.queue:
            return None
        j = max(range(len(self.queue)),
                key=lambda jj: (self._urgency(self.queue[jj]), jj))
        r = self.queue.pop(j)
        r.done = True
        r.shed = True
        self.finished.append(r)
        self.counters["shed"] += 1
        return r

    def requeue(self, i: int) -> Request | None:
        """Put slot ``i``'s request back in the queue (slot failure):
        decode progress is lost, but a still-valid warm handle means
        re-admission costs one continuation prefill, not a full one."""
        r = self.slots[i]
        if r is None:
            return None
        self.slots[i] = None
        r.generated = []
        r.done = False
        self.queue.append(r)
        self.counters["requeued"] += 1
        return r

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)
