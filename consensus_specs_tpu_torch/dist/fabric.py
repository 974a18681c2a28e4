"""Worker lifecycle for the dist fabric: spawn, channel threads,
heartbeat bookkeeping, loss detection.

Port of ``consensus_specs_tpu/dist/fabric.py``.  The workers run
``python -m consensus_specs_tpu_torch.dist.worker``, started by
``Popen`` (never ``fork``, so a coordinator that already holds a CUDA
context is safe), and the fabric's ``device`` reaches them through
``CSTPU_DIST_DEVICE``: None is the CUDA card in each worker, which raises
on a host without one.  Each handle records its worker's seconds from
spawn to hello (``hello_s``).

A ``Fabric`` owns N worker subprocesses (``dist/worker.py``), each with
two coordinator-side daemon threads:

* a **sender** (``WorkerHandle._send_loop``) draining that worker's
  outbound queue onto its stdin — dispatch never blocks on a full pipe;
* a **reader** (``Fabric._read_loop``) pulling digest-framed messages off
  its stdout: heartbeats update the worker's liveness stamp, replies land
  on the fabric-wide event queue, and ANY channel damage (EOF, torn
  frame, digest mismatch) marks the worker lost — a detected miss the
  dispatcher re-routes around, never garbage.

Fault seams (coordinator-side, ``proc0`` under an active fabric scope):

* ``dist.spawn``     — before each worker launch (error = spawn failure:
  the fabric continues on survivors, or reports itself down);
* ``dist.reply``     — a value probe over a reply frame's raw envelope
  bytes (corrupt = wire bit-rot: the digest check catches it and the
  worker is demoted to lost);
* ``dist.heartbeat`` — before a received beat lands (error = the beat is
  dropped, so a sticky rule starves liveness past the deadline — the
  heartbeat-timeout chaos model).

The active fault plan ships to every worker via ``CSTPU_FAULTS`` in the
spawn env, and ``CSTPU_DIST_PROC`` gives each process its scope — so one
schedule string drives coordinated cross-process chaos
(``site@nth=kind@procK``, faults.py).

While a fabric is alive the coordinator wears scope ``proc0``
(``faults.set_process_scope``); ``close()`` restores None so unscoped
test plans behave identically outside fabric extents.
"""
from __future__ import annotations

import collections
import os
import subprocess
import sys
import threading
import time
from typing import List, NamedTuple, Optional

from consensus_specs_tpu_torch import faults, telemetry
from consensus_specs_tpu_torch.dist import codec
from consensus_specs_tpu_torch.persist import atomic

_SITE_SPAWN = faults.site("dist.spawn")
_SITE_REPLY = faults.site("dist.reply")
_SITE_HEARTBEAT = faults.site("dist.heartbeat")

DEFAULT_HEARTBEAT_S = 0.25

stats = {
    "spawned": 0,
    "spawn_failures": 0,
    "respawns": 0,
    "frames_sent": 0,
    "frames_received": 0,
    "bytes_sent": 0,       # frame bodies (task payloads) written to workers
    "bytes_received": 0,   # envelopes read from workers
    "heartbeats": 0,
    "heartbeats_dropped": 0,
    "corrupt_replies": 0,
    "channel_losses": 0,   # EOF / torn frame / send failure
    "workers_lost": 0,
}

# module-wide counters mutated from sender/reader threads and snapshotted
# by the telemetry bus from arbitrary threads — same discipline as
# node/ingest.py's _STATS_LOCK
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in stats:
            stats[k] = 0


def _bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        stats[key] += n


class Event(NamedTuple):
    """One item on the fabric event queue: ``kind`` is ``"hello"`` /
    ``"reply"`` / ``"lost"``, ``proc`` the worker's scope name."""

    kind: str
    proc: str
    meta: dict
    body: bytes


class FabricUnavailable(RuntimeError):
    """No live workers: the caller's ladder demotes to in-process."""


class WorkerHandle:
    """One worker subprocess + its coordinator-side channel state.

    ``last_beat`` and ``alive`` are written by the reader thread and read
    by the dispatch loop — every touch under the owning fabric's event
    condition (the one lock that orders loss against replies)."""

    def __init__(self, index: int, fabric: "Fabric"):
        self.index = index
        self.name = f"proc{index}"
        self._fabric = fabric
        self.popen: Optional[subprocess.Popen] = None
        self.alive = False
        self.last_beat = 0.0
        self.tasks_done = 0
        # this incarnation's spawn stamp, and its seconds from spawn to
        # the worker's hello frame (None until the hello lands)
        self.spawned_at = 0.0
        self.hello_s: Optional[float] = None
        # outbound frame queue, drained by the sender thread; None is the
        # shutdown sentinel
        self._outbound: collections.deque = collections.deque()
        self._out_cond = threading.Condition()
        self._sender: Optional[threading.Thread] = None
        self._reader: Optional[threading.Thread] = None

    def send(self, kind: str, meta: dict, body: bytes = b"") -> None:
        """Queue one frame for this worker (non-blocking; the sender
        thread owns the actual pipe write).  Raises on a dead worker so
        the dispatcher re-routes immediately instead of queuing into a
        void."""
        with self._fabric._events_cond:
            ok = self.alive
        if not ok:
            raise FabricUnavailable(f"{self.name} is not alive")
        with self._out_cond:
            self._outbound.append((kind, meta, body))
            self._out_cond.notify_all()

    def _send_loop(self, popen, outbound) -> None:
        """Sender thread: outbound queue -> worker stdin.  A write
        failure is a channel loss (the worker died mid-read); the fabric
        re-routes its chunks.  ``popen``/``outbound`` are THIS
        incarnation's — a respawn replaces both, so a stale sender can
        neither steal the new incarnation's frames nor demote it."""
        while True:
            with self._out_cond:
                while not outbound:
                    self._out_cond.wait()
                item = outbound.popleft()
            if item is None:
                return
            kind, meta, body = item
            try:
                codec.write_frame(popen.stdin, kind, meta, body)
            except Exception:
                if self._fabric.mark_lost(self, "send", popen=popen):
                    _bump("channel_losses")
                return
            _bump("frames_sent")
            _bump("bytes_sent", len(body))

    def _stop_sender(self) -> None:
        with self._out_cond:
            self._outbound.append(None)
            self._out_cond.notify_all()

    def _reset_outbound(self) -> None:
        """New incarnation: retire the previous sender (if any) and
        install a fresh outbound queue — undelivered frames belonged to
        a dead process, the dispatcher re-routes them."""
        if self._sender is not None and self._sender.is_alive():
            self._stop_sender()
        with self._out_cond:
            self._outbound = collections.deque()

    def _start_sender(self, popen) -> None:
        self._sender = threading.Thread(
            target=self._send_loop, args=(popen, self._outbound),
            name=f"dist-sender-{self.name}", daemon=True)
        self._sender.start()


class Fabric:
    """N supervised worker subprocesses behind one event queue."""

    def __init__(self, n_workers: int = 2,
                 heartbeat_interval: float = DEFAULT_HEARTBEAT_S,
                 env: Optional[dict] = None, device=None):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.n_workers = n_workers
        self.heartbeat_interval = heartbeat_interval
        # the workers' device: None is the CUDA card in each worker
        self.device = device
        self._env_extra = dict(env or {})
        self._workers: List[WorkerHandle] = [
            WorkerHandle(i + 1, self) for i in range(n_workers)]
        # the fabric-wide event queue: reader threads append, the
        # dispatch loop pops; worker alive/last_beat ride the same lock
        self._events: collections.deque = collections.deque()
        self._events_cond = threading.Condition()
        self._started = False
        self._outer_scope: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Fabric":
        """Spawn every worker slot.  Spawn failures leave slots dead (the
        fabric runs on survivors); ZERO survivors raises
        ``FabricUnavailable`` — the caller's ladder takes over."""
        self._outer_scope = faults.process_scope()
        faults.set_process_scope("proc0")
        self._started = True
        for w in self._workers:
            self._spawn(w)
        if not self.alive_workers():
            # leave scope armed for ensure_workers() respawn probes; the
            # caller decides whether to close() or retry
            raise FabricUnavailable(
                f"0 of {self.n_workers} workers spawned")
        return self

    def __enter__(self) -> "Fabric":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def ensure_workers(self) -> int:
        """Respawn dead slots (recovery probes re-enter here after a
        breaker trip); returns the live count."""
        for w in self._workers:
            with self._events_cond:
                ok = w.alive
            if not ok:
                if self._spawn(w):
                    _bump("respawns")
        return len(self.alive_workers())

    def _spawn(self, w: WorkerHandle) -> bool:
        try:
            _SITE_SPAWN()
            popen = subprocess.Popen(
                [sys.executable, "-m", "consensus_specs_tpu_torch.dist.worker"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                env=self._worker_env(w))
        except (faults.InjectedFault, OSError) as exc:
            _bump("spawn_failures")
            telemetry.recorder.record(
                "dist_spawn_failed", proc=w.name,
                error=f"{type(exc).__name__}: {exc}"[:200])
            return False
        w._reset_outbound()
        with self._events_cond:
            w.popen = popen
            w.alive = True
            w.last_beat = w.spawned_at = time.monotonic()
            w.hello_s = None
        _bump("spawned")
        w._start_sender(popen)
        w._reader = threading.Thread(
            target=self._read_loop, args=(w, popen),
            name=f"dist-reader-{w.name}", daemon=True)
        w._reader.start()
        return True

    def _worker_env(self, w: WorkerHandle) -> dict:
        """The worker's env: process scope, the ACTIVE fault plan (scoped
        chaos crosses the boundary verbatim), the fabric's device, and
        the repo on PYTHONPATH so ``-m`` resolves from any cwd."""
        env = dict(os.environ)
        env.update(self._env_extra)
        env["CSTPU_DIST_PROC"] = w.name
        env["CSTPU_DIST_HEARTBEAT_S"] = str(self.heartbeat_interval)
        if self.device is None:
            env.pop("CSTPU_DIST_DEVICE", None)
        else:
            env["CSTPU_DIST_DEVICE"] = str(self.device)
        plan = faults.active_plan()
        if plan is not None:
            env["CSTPU_FAULTS"] = faults.plan_to_env(plan)
        else:
            env.pop("CSTPU_FAULTS", None)
        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        return env

    def close(self) -> None:
        """Shut every worker down (best-effort shutdown frame, then kill)
        and restore the process scope the fabric found."""
        for w in self._workers:
            try:
                w.send("shutdown", {})
            except FabricUnavailable:
                pass
            w._stop_sender()
        # a clean shutdown is not a loss: demote every slot BEFORE the
        # workers exit, so a reader seeing the shutdown EOF finds the
        # slot already dead and mark_lost stays a no-op (otherwise every
        # close() would count phantom workers_lost/channel_losses)
        with self._events_cond:
            for w in self._workers:
                w.alive = False
        deadline = time.monotonic() + 2.0
        for w in self._workers:
            if w.popen is not None:
                try:
                    w.popen.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    w.popen.kill()
                    w.popen.wait()
        if self._started:
            faults.set_process_scope(self._outer_scope)
            self._started = False

    # -- channel supervision -------------------------------------------------

    def mark_lost(self, w: WorkerHandle, reason: str,
                  popen=None) -> bool:
        """Demote a worker to lost (idempotent) and wake the dispatch
        loop with a ``lost`` event: its in-flight chunks re-dispatch to
        survivors.  The process is killed — a half-dead worker must not
        keep writing frames.  Channel threads pass the ``popen`` they
        were serving: a stale thread reporting EOF on a RETIRED
        incarnation must not demote the respawned one.  Returns True
        only on the live->lost transition (callers count channel losses
        off it, so a clean-shutdown EOF is not a phantom loss)."""
        with self._events_cond:
            if popen is not None and w.popen is not popen:
                return False  # a previous incarnation's thread winding down
            if not w.alive:
                return False
            w.alive = False
            self._events.append(Event("lost", w.name, {"reason": reason}, b""))
            self._events_cond.notify_all()
        _bump("workers_lost")
        telemetry.recorder.record("dist_worker_lost", proc=w.name,
                                  reason=reason)
        if w.popen is not None:
            try:
                w.popen.kill()
            except OSError:
                pass
        return True

    def _read_loop(self, w: WorkerHandle, popen) -> None:
        """Reader thread: worker stdout -> event queue.  EOF, torn
        frames, and digest mismatches all land in the same place: the
        worker is lost, never a source of garbage.  Bound to ONE
        incarnation (``popen``) so a retired reader's EOF cannot demote
        a respawned worker."""
        stream = popen.stdout
        while True:
            try:
                env = codec.read_envelope(stream)
            except atomic.ArtifactError:
                if self.mark_lost(w, "torn-frame", popen=popen):
                    _bump("channel_losses")
                return
            if env is None:
                if self.mark_lost(w, "eof", popen=popen):
                    _bump("channel_losses")
                return
            try:
                kind, meta, body = codec.parse_envelope(env)
                if kind == "reply" and faults.active_plan() is not None:
                    # the wire-damage probe: under an armed plan, route
                    # the raw envelope through dist.reply so a `corrupt`
                    # rule flips a byte the way bit rot would — then the
                    # digest check decides, exactly like persist.read
                    kind, meta, body = codec.parse_envelope(_SITE_REPLY(env))
            except (faults.InjectedFault, atomic.ArtifactError):
                _bump("corrupt_replies")
                self.mark_lost(w, "corrupt-reply", popen=popen)
                return
            _bump("frames_received")
            _bump("bytes_received", len(env))
            if kind == "heartbeat":
                try:
                    _SITE_HEARTBEAT()
                except faults.InjectedFault:
                    _bump("heartbeats_dropped")
                    continue
                with self._events_cond:
                    w.last_beat = time.monotonic()
                _bump("heartbeats")
                continue
            with self._events_cond:
                if kind == "hello":
                    w.hello_s = time.monotonic() - w.spawned_at
                self._events.append(Event(kind, w.name, meta, body))
                self._events_cond.notify_all()

    # -- the dispatch loop's surface -----------------------------------------

    def alive_workers(self) -> List[WorkerHandle]:
        with self._events_cond:
            return [w for w in self._workers if w.alive]

    def worker(self, proc: str) -> Optional[WorkerHandle]:
        for w in self._workers:
            if w.name == proc:
                return w
        return None

    def next_event(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Pop the oldest event, waiting up to ``timeout``; None on
        timeout (the dispatch loop's health-check tick)."""
        with self._events_cond:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while not self._events:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                self._events_cond.wait(remaining)
            return self._events.popleft()


def snapshot() -> dict:
    """Fabric channel counters (telemetry bus)."""
    with _STATS_LOCK:
        return dict(stats)


telemetry.register_provider("dist.fabric", snapshot, replace=True)
