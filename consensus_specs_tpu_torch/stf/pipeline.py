"""Cross-block overlapped signature verification.

Port of ``consensus_specs_tpu/stf/pipeline.py``.  The reference's
environment switch ``CSTPU_PIPELINE`` is the module attribute ``ENABLED``
here (on by default); its window depth is the engine's constant
``_WINDOW_DEPTH`` (2, the reference's default), not a switch.  Only the
native pairing work of a batch runs on the dispatch worker; every torch
device operation stays on the calling thread.

The serial engine strictly alternates host work and native work: block
N's pairing batch settles on the (GIL-releasing, internally thread-
pooled) native backend while the host waits, then the host runs block
N+1's phases while the native pool idles — at 400k validators roughly
half of every block's wall time each way.  This module overlaps them:
the engine dispatches block N's *materialized* signature batch here and
keeps going; while the batch runs on the dispatch thread, the host
executes block N+1's phases (slot_roots merkle, attestation plan
resolution, participation/balance apply).  Block N's verdict is awaited
only when block N+1's host phases are done — by which point it is
usually already settled, so the await is (near) free and the native
seconds disappear behind host seconds (``overlap_s``).

Shape and bounds:

* **one dispatch worker** — batches execute on a single daemon thread,
  so the in-flight queue is bounded at the window's depth + 1 (the
  speculated blocks' batches plus the current block's, newer ones
  queuing behind the oldest) and every ``stf.verify`` counter keeps a
  single writer per key (no locks on the hot path).  The native call
  parallelizes internally; a second dispatch thread would only contend
  the pool.  The window is two blocks deep — one extra block of host
  slack absorbs the per-block jitter a depth-1 window leaks as await
  time.
* **speculation never leaks** — the engine holds each block's cache
  transaction open until its verdict lands (stf/staging.py), and the
  verified-triple memo commit stays deferred through the transaction,
  so a speculated batch that fails (or a fault anywhere in the window)
  drains the pipeline, rolls both blocks' inserts back, and replays the
  failing block through the literal spec — the same bisection naming
  the same original entry (stf/engine.py owns that orchestration).
* **opt-out** — ``ENABLED = False`` restores the serial engine path;
  results are byte-identical either way (pinned by
  tests/test_torch_stf_engine.py, pipeline on and off).

Fault seams: ``stf.pipeline.dispatch`` fires on the host
before a batch is submitted (a dying dispatch must fail into the
block's own rollback), ``stf.pipeline.drain`` fires on the host at
await time (a dying drain must resolve like a failed verdict — rollback
and literal replay, caches coherent).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

from consensus_specs_tpu_torch import faults, telemetry, tracing
from consensus_specs_tpu_torch.telemetry import timeline

from . import verify

# the pipeline gate, read per call so tests can flip it
ENABLED = True

_SITE_DISPATCH = faults.site("stf.pipeline.dispatch")
_SITE_DRAIN = faults.site("stf.pipeline.drain")

_EXECUTOR: Optional[ThreadPoolExecutor] = None

# the bounded in-flight queue: handles dispatched but not yet drained,
# in dispatch order (FIFO; depth <= 2 by the engine's speculation
# window).  Only this module mutates it.
_INFLIGHT: List["SigBatchHandle"] = []

stats = {
    "dispatched": 0,
    "drained": 0,
    "cancelled": 0,     # handles discarded unconsumed by a pipeline drain
    "drains": 0,        # pipeline drain events (failure/ineligible-block)
    "drain_reasons": {},  # reason -> count (the recorder holds the order)
    "depth_max": 0,
    "overlap_s": 0.0,   # native seconds hidden behind host work
    "await_s": 0.0,     # native seconds the host actually waited for
    "worker_s": 0.0,    # total batch wall seconds on the dispatch thread
}


def reset_stats() -> None:
    for k in stats:
        if isinstance(stats[k], dict):
            stats[k] = {}
        else:
            stats[k] = 0.0 if isinstance(stats[k], float) else 0


def _executor() -> ThreadPoolExecutor:
    global _EXECUTOR
    if _EXECUTOR is None:
        _EXECUTOR = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="cstpu-sigpipe")
    return _EXECUTOR


class SigBatchHandle:
    """One in-flight signature batch: the future plus enough accounting
    to attribute its wall time as overlapped or awaited."""

    __slots__ = ("future", "entries", "link", "t_dispatch", "worker_span",
                 "_done")

    def __init__(self, entries, link=None):
        self.entries = entries
        self.link = link  # the block's causality-link id (timeline)
        self.t_dispatch = time.perf_counter()
        self.worker_span = [0.0, 0.0]  # [start, end], written by the worker
        self._done = False
        self.future = _executor().submit(self._run)

    def _run(self):
        span = self.worker_span
        span[0] = time.perf_counter()
        # the worker's span carries the dispatching block's link, so the
        # Chrome-trace export draws the cross-thread edge host phases →
        # native verify
        sid = timeline.begin("native/verify", link=self.link,
                             entries=len(self.entries))
        try:
            return verify.first_invalid(self.entries)
        finally:
            timeline.end(sid)
            span[1] = time.perf_counter()


def dispatch(entries: Sequence[verify.SigEntry],
             link=None) -> SigBatchHandle:
    """Submit a materialized batch to the dispatch worker.  Entries must
    be fully materialized (affine buffers built) — the worker touches
    pure data plus the native call, never the geometry caches.  The
    sig-batch tracing counts land HERE (host side; ``verify.settle``
    emits them on the serial path), keeping the worker tracing-free and
    the counters alive pipeline ON or OFF.  ``link`` is the dispatching
    block's timeline causality id (None with the timeline off)."""
    _SITE_DISPATCH()
    tracing.count("stf.sig_batch")
    tracing.count("stf.sig_batch.entries", len(entries))
    handle = SigBatchHandle(list(entries), link=link)
    _INFLIGHT.append(handle)
    stats["dispatched"] += 1
    stats["depth_max"] = max(stats["depth_max"], len(_INFLIGHT))
    return handle


def wait(handle: SigBatchHandle) -> Optional[int]:
    """Block until ``handle``'s batch settles; returns the first-invalid
    index (None = all verified) or re-raises the worker's exception
    (InjectedFault and friends resolve on the host, into the engine's
    replay contract).  The drain probe fires BEFORE the verdict is
    consumed, so an injected drain failure leaves an unconsumed verdict
    for the registry-coherence contract to clean up."""
    _SITE_DRAIN()
    t0 = time.perf_counter()
    try:
        result = handle.future.result()
    finally:
        _consume(handle, time.perf_counter() - t0)
    return result


def _consume(handle: SigBatchHandle, awaited_s: float) -> None:
    if handle._done:
        return
    handle._done = True
    if handle in _INFLIGHT:
        _INFLIGHT.remove(handle)
    worker_s = max(0.0, handle.worker_span[1] - handle.worker_span[0])
    stats["drained"] += 1
    stats["await_s"] += awaited_s
    stats["worker_s"] += worker_s
    stats["overlap_s"] += max(0.0, worker_s - awaited_s)


def discard(handle: Optional[SigBatchHandle]) -> None:
    """Drain one handle without consuming its verdict (the block it
    belongs to is being rolled back): await completion — a native call
    cannot be interrupted mid-pairing — and swallow the outcome.  Only
    WORKER failures are swallowed (Exception); a host-side interrupt
    raised while waiting (KeyboardInterrupt/SystemExit) propagates."""
    if handle is None or handle._done:
        return
    t0 = time.perf_counter()
    # a queued, not-yet-started batch is cancelled for free (failure
    # recovery must not serialize behind seconds of doomed pairing work);
    # a running one is awaited — native calls can't be interrupted
    if not handle.future.cancel():
        try:
            handle.future.result()
        except Exception:
            pass  # the block is rolling back either way
    _consume(handle, time.perf_counter() - t0)
    stats["cancelled"] += 1


def note_drain(reason: str) -> None:
    """Count one pipeline drain event, attributed per reason (the
    flight recorder's ``pipeline_drain`` events hold the ordering)."""
    stats["drains"] += 1
    reasons = stats["drain_reasons"]
    reasons[reason] = reasons.get(reason, 0) + 1


def _telemetry_provider() -> dict:
    total = stats["worker_s"]
    return {
        **{k: v for k, v in stats.items() if k != "drain_reasons"},
        "drain_reasons": dict(stats["drain_reasons"]),
        "depth": len(_INFLIGHT),
        "overlap_ratio": (round(stats["overlap_s"] / total, 3)
                          if total > 0 else None),
        "enabled": ENABLED,
    }


telemetry.register_provider("stf.pipeline", _telemetry_provider,
                            replace=True)
