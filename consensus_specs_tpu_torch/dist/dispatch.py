"""Chunk dispatch over the fabric: deterministic assignment,
deadline/retry/hedge re-dispatch, and the degradation ladder.

Port of ``consensus_specs_tpu/dist/dispatch.py``, the same logic with
the port's fault, telemetry and tracing registries.

``run_tasks`` drives one batch of task chunks to completion:

* **initial assignment** is deterministic round-robin over the live
  workers (chunk i -> worker i mod W) — under zero faults every run of
  the same batch lands the same chunks on the same processes;
* **re-dispatch**: a dead worker (EOF, corrupt frame, heartbeat
  timeout), an ``ok=False`` reply, or a blown per-task deadline sends the
  chunk to a surviving worker with exponential deadline backoff
  (``deadline_s * 2**(attempts-1)``) — counted in ``redispatched_chunks``;
* **hedging**: a chunk in flight past ``hedge_s`` gets ONE duplicate
  dispatch to a second worker (counted in ``hedged_tasks``, NOT in
  ``redispatched_chunks`` — a hedge is a latency bet, not a failure);
  first valid reply wins, late copies are discarded by task id
  (``duplicate_replies``);
* **give-up**: a chunk past ``max_attempts``, or zero surviving workers,
  raises ``FabricDown`` — which the ``FabricExecutor`` ladder catches.

Because every workload merges its chunks in FIXED chunk-index order
(dist/workloads.py), re-dispatch and hedging cannot change the result:
verdicts and roots are bit-identical to the in-process twin at every
failure schedule, and the chaos suite asserts exactly that.

``FabricExecutor`` is the degradation ladder, mirroring
``stf/verify.py``/``stf/engine.py``: a fabric failure falls back to the
caller's in-process twin (serving never halts), ``BREAKER_THRESHOLD``
consecutive failures open a breaker that demotes subsequent runs
straight to in-process, and every ``BREAKER_PROBE_INTERVAL``-th demoted
run probes the fabric again (respawning dead workers first) — a
successful probe closes the breaker and the fabric takes back over.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Set, Tuple

from consensus_specs_tpu_torch import faults, telemetry, tracing
from consensus_specs_tpu_torch.dist.fabric import (
    Event,
    Fabric,
    FabricUnavailable,
    WorkerHandle,
)
from consensus_specs_tpu_torch.telemetry import recorder

# the coordinator-side dispatch seam: probed before each task send, so an
# injected error models the coordinator losing a worker's channel at the
# moment of assignment
_SITE_DISPATCH = faults.site("dist.dispatch")

# same shape as stf/engine.py's fast-path breaker: N consecutive fabric
# failures demote to in-process, every INTERVAL-th demoted run is a
# recovery probe
BREAKER_THRESHOLD = 3
BREAKER_PROBE_INTERVAL = 8

stats = {
    "tasks": 0,
    "dispatched": 0,
    "replies": 0,
    "duplicate_replies": 0,
    "redispatched_chunks": 0,
    "hedged_tasks": 0,
    "deadline_timeouts": 0,
    "heartbeat_timeouts": 0,
    "worker_losses": 0,
    "error_replies": 0,
    "fabric_runs": 0,
    "fallback_runs": 0,
    "breaker_trips": 0,
    "breaker_probes": 0,
    "recoveries": 0,
    "breaker_state": "closed",
}

# dispatch counters are read by the telemetry bus from arbitrary threads
# while the event loop mutates them
_STATS_LOCK = threading.Lock()

_RUN_SEQ = [0]  # task-id nonce: a straggler reply from a finished run
#                 must never collide with the next run's ids


def reset_stats() -> None:
    with _STATS_LOCK:
        for k, v in stats.items():
            if isinstance(v, int):
                stats[k] = 0
        stats["breaker_state"] = "closed"


def _bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        stats[key] += n


class FabricDown(RuntimeError):
    """The batch cannot complete on the fabric (no survivors, or a chunk
    exhausted ``max_attempts``): the executor's ladder demotes the run to
    the in-process twin."""


class TaskSpec(NamedTuple):
    """One chunk: ``kind`` routes to a worker handler, ``meta`` is small
    JSON routing state, ``body`` the bulk payload."""

    kind: str
    meta: dict
    body: bytes


class _Pending:
    """In-flight bookkeeping for one task chunk."""

    __slots__ = ("id", "index", "spec", "attempts", "sent_at", "deadline",
                 "hedged", "workers")

    def __init__(self, task_id: str, index: int, spec: TaskSpec):
        self.id = task_id
        self.index = index
        self.spec = spec
        self.attempts = 0
        self.sent_at = 0.0
        self.deadline = float("inf")
        self.hedged = False
        self.workers: Set[str] = set()  # procs holding a live copy


class _DispatchRun:
    """One ``run_tasks`` batch: the in-flight table + event loop."""

    def __init__(self, fabric: Fabric, tasks: List[TaskSpec],
                 deadline_s: float, hedge_s: Optional[float],
                 max_attempts: int, heartbeat_timeout_s: Optional[float]):
        _RUN_SEQ[0] += 1
        self.fabric = fabric
        self.deadline_s = deadline_s
        self.hedge_s = hedge_s
        self.max_attempts = max_attempts
        self.heartbeat_timeout_s = heartbeat_timeout_s
        # the in-flight task table: id -> _Pending, the structure every
        # re-dispatch decision routes through (declared in the
        # concurrency registry; single-threaded by construction — only
        # the dispatch loop touches it, reader threads communicate
        # through the fabric event queue)
        self._inflight: Dict[str, _Pending] = {
            f"r{_RUN_SEQ[0]}.t{i}": _Pending(f"r{_RUN_SEQ[0]}.t{i}", i, t)
            for i, t in enumerate(tasks)}
        self._results: Dict[int, Tuple[dict, bytes]] = {}
        self._done: Set[str] = set()
        self._n = len(tasks)
        self._rr = 0  # round-robin cursor for re-dispatch targets

    # -- worker selection ----------------------------------------------------

    def _pick_worker(self, exclude: Set[str]) -> WorkerHandle:
        alive = self.fabric.alive_workers()
        if not alive:
            raise FabricDown("no surviving workers")
        pool = [w for w in alive if w.name not in exclude] or alive
        self._rr += 1
        return pool[self._rr % len(pool)]

    # -- sending -------------------------------------------------------------

    def _send(self, pending: _Pending, worker: WorkerHandle) -> None:
        """Dispatch one copy of a chunk.  A send failure (injected or
        real) loses the WORKER, not the chunk: the loss event re-routes
        everything that worker held, this chunk included."""
        pending.attempts += 1
        pending.sent_at = time.monotonic()
        pending.deadline = (pending.sent_at
                            + self.deadline_s * 2 ** (pending.attempts - 1))
        pending.workers.add(worker.name)
        meta = dict(pending.spec.meta, id=pending.id, kind=pending.spec.kind)
        try:
            _SITE_DISPATCH()
            worker.send("task", meta, pending.spec.body)
        except (faults.InjectedFault, FabricUnavailable):
            self.fabric.mark_lost(worker, "dispatch-failure")
            return
        _bump("dispatched")

    def _redispatch(self, pending: _Pending, reason: str,
                    exclude: Set[str]) -> None:
        if pending.attempts >= self.max_attempts:
            raise FabricDown(
                f"chunk {pending.index} exhausted {self.max_attempts} "
                f"attempts (last: {reason})")
        _bump("redispatched_chunks")
        tracing.count("dist.redispatched_chunk")
        recorder.record("dist_redispatch", index=pending.index,
                        reason=reason, attempt=pending.attempts + 1)
        self._send(pending, self._pick_worker(exclude))

    # -- event handling ------------------------------------------------------

    def _on_reply(self, ev: Event) -> None:
        task_id = ev.meta.get("id")
        pending = self._inflight.get(task_id)
        if pending is None or task_id in self._done:
            # a late copy of an already-settled chunk (hedge loser, or a
            # straggler from a previous run): first valid reply won
            _bump("duplicate_replies")
            return
        if not ev.meta.get("ok"):
            _bump("error_replies")
            pending.workers.discard(ev.proc)
            if not pending.workers:
                self._redispatch(pending, "error-reply", {ev.proc})
            return
        _bump("replies")
        self._results[pending.index] = (ev.meta, ev.body)
        self._done.add(task_id)
        del self._inflight[task_id]
        w = self.fabric.worker(ev.proc)
        if w is not None:
            w.tasks_done += 1

    def _on_lost(self, ev: Event) -> None:
        """A worker died: every chunk whose ONLY live copy it held goes
        back out to a survivor."""
        w = self.fabric.worker(ev.proc)
        if w is not None and w in self.fabric.alive_workers():
            # a stale loss event from a retired incarnation (the worker
            # has since respawned): mark_lost orders alive=False before
            # the event, so alive-now proves the event predates this run
            return
        _bump("worker_losses")
        for pending in list(self._inflight.values()):
            if ev.proc in pending.workers:
                pending.workers.discard(ev.proc)
                if not pending.workers:
                    self._redispatch(pending, f"worker-lost:{ev.meta.get('reason')}",
                                     {ev.proc})

    # -- periodic health ticks -----------------------------------------------

    def _check_heartbeats(self, now: float) -> None:
        if self.heartbeat_timeout_s is None:
            return
        for w in self.fabric.alive_workers():
            with self.fabric._events_cond:
                age = now - w.last_beat
            if age > self.heartbeat_timeout_s:
                _bump("heartbeat_timeouts")
                self.fabric.mark_lost(w, "heartbeat-timeout")

    def _check_deadlines(self, now: float) -> None:
        for pending in list(self._inflight.values()):
            if pending.id in self._done:
                continue
            if now > pending.deadline:
                _bump("deadline_timeouts")
                self._redispatch(pending, "deadline", set(pending.workers))
            elif (self.hedge_s is not None and not pending.hedged
                  and now - pending.sent_at > self.hedge_s
                  and len(self.fabric.alive_workers()) > 1):
                # the straggler bet: one duplicate on a second worker,
                # whichever replies first wins — not a failure, so it
                # does NOT count as a re-dispatched chunk
                pending.hedged = True
                _bump("hedged_tasks")
                tracing.count("dist.hedged_task")
                self._send(pending, self._pick_worker(set(pending.workers)))

    # -- the loop ------------------------------------------------------------

    def run(self) -> List[Tuple[dict, bytes]]:
        _bump("tasks", self._n)
        workers = self.fabric.alive_workers()
        if not workers:
            raise FabricDown("no live workers at dispatch")
        order = sorted(self._inflight.values(), key=lambda p: p.index)
        for pending in order:
            # deterministic initial assignment: chunk i -> worker i mod W
            self._send(pending, workers[pending.index % len(workers)])
        while len(self._results) < self._n:
            ev = self.fabric.next_event(timeout=0.05)
            if ev is not None:
                if ev.kind == "reply":
                    self._on_reply(ev)
                elif ev.kind == "lost":
                    self._on_lost(ev)
                # hello frames are lifecycle noise at this layer
            now = time.monotonic()
            self._check_heartbeats(now)
            self._check_deadlines(now)
        return [self._results[i] for i in range(self._n)]


def run_tasks(fabric: Fabric, tasks: List[TaskSpec],
              deadline_s: float = 30.0, hedge_s: Optional[float] = None,
              max_attempts: int = 4,
              heartbeat_timeout_s: Optional[float] = None
              ) -> List[Tuple[dict, bytes]]:
    """Drive ``tasks`` to completion over ``fabric``; returns one
    ``(meta, body)`` per task IN TASK ORDER.  Raises ``FabricDown`` when
    the batch cannot complete (the executor ladder's cue)."""
    return _DispatchRun(fabric, tasks, deadline_s, hedge_s, max_attempts,
                        heartbeat_timeout_s).run()


# -- the degradation ladder ----------------------------------------------------

_DEGRADE_WARNED = False


class FabricExecutor:
    """Run work on the fabric with the in-process twin as the floor.

    ``run(fabric_fn, inprocess_fn)`` returns ``(value, mode)`` where mode
    is ``"fabric"`` or ``"inprocess"`` — the caller's result is the same
    either way (bit-identical twins), only the execution domain moves.
    Serving NEVER halts on a fabric failure."""

    def __init__(self, fabric: Fabric):
        self.fabric = fabric
        self._breaker = {"consecutive_errors": 0, "open": False,
                         "since_skipped": 0}

    def run(self, fabric_fn: Callable[[Fabric], object],
            inprocess_fn: Callable[[], object]) -> Tuple[object, str]:
        if self._allows_attempt():
            try:
                # recovery probes re-enter here after the breaker opened
                # on dead workers: respawn empty slots first so the probe
                # tests a repaired fabric, not the corpse that tripped it
                if not self.fabric.ensure_workers():
                    raise FabricUnavailable("no workers after respawn")
                value = fabric_fn(self.fabric)
            except Exception as exc:
                self._note_error(exc)
            else:
                self._note_success()
                _bump("fabric_runs")
                return value, "fabric"
        _bump("fallback_runs")
        tracing.count("dist.fallback_run")
        return inprocess_fn(), "inprocess"

    # breaker mechanics: stf/engine.py's shape, per-executor state,
    # module-level counters
    def _allows_attempt(self) -> bool:
        if not self._breaker["open"]:
            return True
        self._breaker["since_skipped"] += 1
        if self._breaker["since_skipped"] % BREAKER_PROBE_INTERVAL == 0:
            _bump("breaker_probes")
            tracing.count("dist.breaker_probe")
            recorder.record("dist_breaker_probe")
            return True
        return False

    def _note_success(self) -> None:
        self._breaker["consecutive_errors"] = 0
        if self._breaker["open"]:
            self._breaker["open"] = False
            self._breaker["since_skipped"] = 0
            _bump("recoveries")
            with _STATS_LOCK:
                stats["breaker_state"] = "closed"
            tracing.count("dist.breaker_closed")
            recorder.record("dist_breaker_close")

    def _note_error(self, exc: BaseException) -> None:
        global _DEGRADE_WARNED
        tracing.count("dist.fabric_error")
        recorder.record("dist_fabric_degraded",
                        error=f"{type(exc).__name__}: {exc}"[:300])
        if not _DEGRADE_WARNED:
            _DEGRADE_WARNED = True
            warnings.warn(
                "dist fabric degraded to in-process execution: "
                f"{type(exc).__name__}: {exc}", RuntimeWarning,
                stacklevel=3)
        self._breaker["consecutive_errors"] += 1
        if self._breaker["open"]:
            self._breaker["since_skipped"] = 0
            recorder.record("dist_breaker_probe_failed")
            return
        if self._breaker["consecutive_errors"] >= BREAKER_THRESHOLD:
            self._breaker["open"] = True
            self._breaker["since_skipped"] = 0
            _bump("breaker_trips")
            with _STATS_LOCK:
                stats["breaker_state"] = "open"
            tracing.count("dist.breaker_tripped")
            recorder.record(
                "dist_breaker_open",
                consecutive_errors=self._breaker["consecutive_errors"])

    @property
    def breaker_open(self) -> bool:
        return self._breaker["open"]


def snapshot() -> dict:
    """Dispatch counters (telemetry bus)."""
    with _STATS_LOCK:
        return dict(stats)


telemetry.register_provider("dist.dispatch", snapshot, replace=True)
