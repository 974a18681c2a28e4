"""Bounded multi-producer ingest queue for the node serving pipeline.

A node serving heavy traffic receives work from many sources at once —
gossip attestation batches, blocks, clock ticks — but fork choice and
the state transition are SINGLE-WRITER by contract (every store/proto
mutation happens on one apply loop; see node/service.py).  This module
is the boundary between the two worlds:

* **multi-producer** — any number of threads call ``put``; the append is
  lock-guarded and strictly FIFO across producers, so causal enqueue
  order (a block enqueued before the votes for it) is preserved as apply
  order;
* **bounded** — the queue holds at most ``cap`` items; a ``put`` into a
  full queue BLOCKS (back-pressure, the production behavior: a node
  sheds load by slowing its gossip readers, not by growing without
  bound).  Blocked puts and the seconds spent blocked are counted;
* **single-consumer** — ``get`` hands items to the apply loop one at a
  time; ``drain`` pulls EVERYTHING admissible in one lock acquisition
  and wakes every blocked producer with a single ``notify_all`` (the
  micro-batcher's entry point); ``close`` lets producers
  finish a run (drained queue + closed == end of stream).

Every item carries a timeline causality link allocated at enqueue time:
the producer's ``node/enqueue`` span and the apply loop's ``node/apply``
span share it, so a Perfetto load of the trace shows the producer →
apply-loop handoff as a cross-thread flow arrow (the same mechanism the
stf pipeline uses for host → dispatch-worker edges).

The deque itself (``_items``) is analyzer-registered (CC01 "node ingest
queue"): only this module may mutate it — with one sanctioned exception,
the apply loop's failure re-queue (``requeue_front``), which is also
owner API.  The ``node.enqueue`` fault probe fires BEFORE the append, so
an injected enqueue failure leaves the queue exactly as it was
(tests/test_torch_node.py).

Counters are module-wide like the stf/forkchoice engines' (one process
may run several queues; the counters read as node-level activity); the
live depth gauge reads through a weakref to the most recently
constructed queue so the telemetry provider never keeps a dead queue
alive.
"""
from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import NamedTuple, Optional

from consensus_specs_tpu_torch import faults
from consensus_specs_tpu_torch.telemetry import timeline

DEFAULT_CAP = 1024

# probed BEFORE the deque append: a dying enqueue must leave the queue
# untouched (the producer retries or drops; nothing half-lands)
_SITE_ENQUEUE = faults.site("node.enqueue")

stats = {
    "enqueued": 0,
    "dequeued": 0,
    "requeued": 0,        # items put back at the head by a failed apply
    "requeue_overflow": 0,  # re-queues that found the queue already full
    "requeue_attempts_max": 0,  # deepest per-item retry count observed
    "blocked_puts": 0,    # puts that found the queue full
    "blocked_s": 0.0,     # seconds producers spent in back-pressure waits
    "depth_max": 0,
    "closed": 0,
    "producers": {},      # thread name -> items enqueued
}

_LIVE: Optional[weakref.ref] = None  # most recent queue, for the depth gauge

# guards EVERY mutation of the module-wide stats: queues update under
# their own instance locks, so two live queues (one process may run
# several) would otherwise race the read-modify-writes, and the
# telemetry bus snapshots from arbitrary threads — a dict resize
# mid-copy would raise in the provider
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in stats:
            if isinstance(stats[k], dict):
                stats[k] = {}
            else:
                stats[k] = 0.0 if isinstance(stats[k], float) else 0


class WorkItem(NamedTuple):
    """One unit of ingest work: ``kind`` is ``"tick"`` / ``"block"`` /
    ``"attestations"`` / ``"attester_slashing"``, ``payload`` the
    handler input, ``link`` the timeline causality id minted at enqueue
    (None with the timeline off), ``producer`` the enqueuing thread's
    name (the admission gate's peer-scoring identity), and
    ``attempts`` the number of failed applies so far (incremented by
    ``requeue_front``; the apply loop's retry cap consumes it), and
    ``readmit`` marking an item that already passed the admission dedup
    check once (a crash-path re-queue must skip it, or the item's own
    seen-key would judge the retry a duplicate)."""

    kind: str
    payload: object
    link: Optional[int]
    producer: str = ""
    attempts: int = 0
    readmit: bool = False


class IngestQueue:
    """Bounded FIFO work queue: N producers, one apply-loop consumer."""

    def __init__(self, cap: int = DEFAULT_CAP):
        if cap < 1:
            raise ValueError(f"queue cap must be >= 1, got {cap}")
        self._cap = cap
        self._items = collections.deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        global _LIVE
        _LIVE = weakref.ref(self)

    # -- producer side -------------------------------------------------------

    def put(self, kind: str, payload, timeout: Optional[float] = None) -> None:
        """Enqueue one item, blocking while the queue is full
        (back-pressure).  Raises ``RuntimeError`` on a closed queue and
        ``TimeoutError`` when ``timeout`` elapses before space frees —
        a producer must never silently drop work."""
        _SITE_ENQUEUE()
        link = timeline.next_link() if timeline.enabled() else None
        with timeline.span("node/enqueue", link=link, kind=kind):
            with self._not_full:
                if len(self._items) >= self._cap:
                    with _STATS_LOCK:
                        stats["blocked_puts"] += 1
                    t0 = time.perf_counter()
                    deadline = None if timeout is None else t0 + timeout
                    try:
                        while (len(self._items) >= self._cap
                               and not self._closed):
                            remaining = (None if deadline is None
                                         else deadline - time.perf_counter())
                            if remaining is not None and remaining <= 0:
                                raise TimeoutError(
                                    f"ingest queue full (cap {self._cap}) "
                                    f"for {timeout}s")
                            self._not_full.wait(remaining)
                    finally:
                        with _STATS_LOCK:
                            stats["blocked_s"] += time.perf_counter() - t0
                if self._closed:
                    raise RuntimeError("put into a closed ingest queue")
                name = threading.current_thread().name
                self._items.append(WorkItem(kind, payload, link, name))
                depth = len(self._items)
                with _STATS_LOCK:
                    stats["enqueued"] += 1
                    if depth > stats["depth_max"]:
                        stats["depth_max"] = depth
                    stats["producers"][name] = \
                        stats["producers"].get(name, 0) + 1
                self._not_empty.notify()

    def try_put(self, kind: str, payload) -> bool:
        """Non-blocking enqueue: True when the item landed, False when
        the queue sits at cap — the caller turns to useful work
        (admission-side aggregation, node/admission.py) instead of
        blocking, so a False does NOT count as a blocked put.  Raises
        ``RuntimeError`` on a closed queue exactly like ``put``."""
        _SITE_ENQUEUE()
        link = timeline.next_link() if timeline.enabled() else None
        name = threading.current_thread().name
        with self._lock:
            if self._closed:
                raise RuntimeError("put into a closed ingest queue")
            if len(self._items) >= self._cap:
                return False
            self._items.append(WorkItem(kind, payload, link, name))
            depth = len(self._items)
            with _STATS_LOCK:
                stats["enqueued"] += 1
                if depth > stats["depth_max"]:
                    stats["depth_max"] = depth
                stats["producers"][name] = \
                    stats["producers"].get(name, 0) + 1
            self._not_empty.notify()
        if link is not None:
            # the handoff edge for Perfetto: emitted after the lock so
            # the timeline ring is never touched under the queue lock
            with timeline.span("node/enqueue", link=link, kind=kind):
                pass
        return True

    def close(self) -> None:
        """End of stream: no further puts; ``get`` returns None once the
        backlog drains.  Blocked producers wake and see the close."""
        with self._lock:
            self._closed = True
            with _STATS_LOCK:
                stats["closed"] += 1
            self._not_empty.notify_all()
            self._not_full.notify_all()

    # -- consumer side (the single-writer apply loop) ------------------------

    def get(self, timeout: Optional[float] = None) -> Optional[WorkItem]:
        """Dequeue the oldest item, blocking while the queue is empty.
        Returns None when the queue is closed AND drained (end of
        stream), or on timeout."""
        with self._not_empty:
            deadline = (None if timeout is None
                        else time.perf_counter() + timeout)
            while not self._items:
                if self._closed:
                    return None
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    return None
                self._not_empty.wait(remaining)
            item = self._items.popleft()
            with _STATS_LOCK:
                stats["dequeued"] += 1
            self._not_full.notify()
            return item

    def drain(self, timeout: Optional[float] = None,
              max_items: Optional[int] = None):
        """Bulk dequeue: ONE lock acquisition pulls every queued item (up
        to ``max_items``), then wakes EVERY blocked producer with a
        single ``notify_all`` — a batch removal frees many slots, and the
        per-item ``notify`` of ``get`` would leave all but one producer
        sleeping on a queue with room.  Blocks like
        ``get`` while the queue is empty; ``timeout=0`` (or negative) is
        the opportunistic non-blocking probe — the timeout bounds the
        WAIT, never the work, so a zero-timeout drain of a non-empty
        queue still returns the whole backlog.  Returns None when the
        queue is closed AND drained (end of stream) or on timeout, else
        a non-empty list in FIFO order.  ``max_items <= 0`` is a request
        for nothing: ``[]`` immediately, never a wait, never a consume —
        the degenerate bound a caller's batch arithmetic can reach
        (tests/test_torch_node.py pins it harmless)."""
        if max_items is not None and max_items <= 0:
            return []
        with self._not_empty:
            deadline = (None if timeout is None
                        else time.perf_counter() + timeout)
            while not self._items:
                if self._closed:
                    return None
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    return None
                self._not_empty.wait(remaining)
            if max_items is None or max_items >= len(self._items):
                batch = list(self._items)
                self._items.clear()
            else:
                batch = [self._items.popleft() for _ in range(max_items)]
            with _STATS_LOCK:
                stats["dequeued"] += len(batch)
            self._not_full.notify_all()
            return batch

    def requeue_front(self, item: WorkItem,
                      count_attempt: bool = True) -> WorkItem:
        """Put a failed item back at the HEAD of the queue (apply-loop
        failure contract: the item that broke stays next in line, so a
        retried loop resumes exactly where it stopped — nothing is lost,
        nothing is reordered).  Owner API: only the apply loop calls it,
        for an item it just dequeued plus that item's pending cascade
        followups on a crash — so the momentary cap overshoot is bounded
        by one in-flight item and its followups, and ``requeue_overflow``
        makes every overshoot visible instead of silent.  With
        ``count_attempt`` (the failure path) the item comes back with
        ``attempts`` incremented — the count the apply loop's retry cap
        consumes; crash-path re-queues pass False, a
        kill is not a poison signal.  Returns the copy that landed."""
        retried = item._replace(
            attempts=item.attempts + (1 if count_attempt else 0))
        with self._lock:
            if len(self._items) >= self._cap:
                with _STATS_LOCK:
                    stats["requeue_overflow"] += 1
            self._items.appendleft(retried)
            with _STATS_LOCK:
                stats["requeued"] += 1
                if retried.attempts > stats["requeue_attempts_max"]:
                    stats["requeue_attempts_max"] = retried.attempts
            self._not_empty.notify()
        return retried

    # -- introspection -------------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def cap(self) -> int:
        return self._cap

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed


def snapshot() -> dict:
    """Queue counters + the live queue's depth gauge (telemetry bus)."""
    with _STATS_LOCK:
        out = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in stats.items()}
    live = _LIVE() if _LIVE is not None else None
    out["depth"] = live.depth() if live is not None else None
    out["cap"] = live.cap if live is not None else None
    return out
