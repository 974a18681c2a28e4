"""Causal trace timeline: a bounded ring of wall-clock span EVENTS
(layer 3 of the observability stack).

The flight recorder answers "what happened, in what order"; the metrics
layer answers "how much, in total".  Neither can show *where wall-clock
goes across threads* — the overlapped pipeline runs block N's native pairing
on a dispatch thread while block N+1's host phases run on the main
thread, and proving (or debugging) that overlap needs begin/end events
with thread identity, not aggregate sums.  This module keeps them:

    {"ph": "B", "sid": 17, "name": "host/operations", "t": 3.14,
     "tid": 140244..., "tname": "MainThread", "link": 5, "slot": 34}
    {"ph": "E", "sid": 17, "t": 3.19, "status": "ok"}

* ``begin(name, link=..., **fields)`` / ``end(sid, status=...)`` append
  paired events; ``span(...)`` is the context-manager form (begin/end in
  a ``finally`` — the shape OB01's unclosed-span check enforces for raw
  ``begin`` callers).  DISABLED (the default) every entry point costs one
  module-global load and a truth check — the block path stays
  unmeasurable (pinned by the overhead microbench in
  tests/telemetry/test_timeline.py, the recorder's discipline).
* ``link`` is the explicit CAUSALITY edge: the engine allocates one id
  per block (``next_link()``) and threads it through host phases →
  pipeline dispatch → the worker's native-verify span → the await/drain,
  so a Perfetto load draws the block's flow across threads.  A drained
  speculation's events are marked ``status="cancelled"``
  (``cancel_link``) — the timeline never claims rolled-back work settled.
* the ring is bounded (``CSTPU_TIMELINE_CAP``, default 65536 events) and
  lock-guarded; eviction is counted in ``dropped`` like the recorder's.
* ``dump_chrome_trace(path)`` exports the Chrome trace-event JSON
  (Perfetto / chrome://tracing loadable): one "X" complete event per
  matched begin/end pair on its thread's track, flow arrows ("s"/"f")
  per causality link, thread-name metadata, instants for point events.

Activation: ``CSTPU_TIMELINE=1`` at import, or ``enable()``/``disable()``.
The clock is injectable (``set_clock``) so export tests are
deterministic.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Deque, Optional

DEFAULT_CAP = 65536  # events; a span is two (begin + end)

_LOCK = threading.Lock()
_ENABLED = False
_clock = time.perf_counter


def _env_cap() -> int:
    """The env-configured ring bound, validated like the recorder's — a
    malformed or non-positive value falls back to the default instead of
    making the package unimportable."""
    raw = os.environ.get("CSTPU_TIMELINE_CAP", "")
    try:
        cap = int(raw)
    except ValueError:
        return DEFAULT_CAP
    return cap if cap >= 2 else DEFAULT_CAP


_CAP = _env_cap()
_EVENTS: Deque[dict] = collections.deque(maxlen=_CAP)
_SEQ = 0       # span ids (begin events)
_INSTANTS = 0  # point events (counted separately: not spans)
_LINKS = 0     # causality-link ids (one per block in the engine)
_DROPPED = 0


def enabled() -> bool:
    return _ENABLED


def enable(cap: Optional[int] = None) -> None:
    """Switch timeline recording on, optionally re-bounding the ring (a
    new cap drops the existing events — bounds are structural)."""
    global _ENABLED, _CAP, _EVENTS
    with _LOCK:
        if cap is not None and int(cap) != _CAP:
            if cap < 2:
                raise ValueError(f"timeline cap must be >= 2, got {cap}")
            _CAP = int(cap)
            _EVENTS = collections.deque(maxlen=_CAP)
        _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Drop the events and zero the counters (cap + enablement keep)."""
    global _SEQ, _INSTANTS, _LINKS, _DROPPED
    with _LOCK:
        _EVENTS.clear()
        _SEQ = 0
        _INSTANTS = 0
        _LINKS = 0
        _DROPPED = 0


def set_clock(fn=None) -> None:
    """Swap the timestamp source (tests: a deterministic fake clock);
    ``set_clock()`` restores ``time.perf_counter``."""
    global _clock
    _clock = fn if fn is not None else time.perf_counter


def next_link() -> int:
    """A fresh causality-link id (the engine allocates one per block and
    threads it through every span that belongs to that block's flow)."""
    global _LINKS
    with _LOCK:
        _LINKS += 1
        return _LINKS


def _append(event: dict) -> None:
    global _DROPPED
    if len(_EVENTS) == _CAP:
        _DROPPED += 1
    _EVENTS.append(event)


def begin(name: str, link: Optional[int] = None, **fields) -> int:
    """Open a span: returns its id (0 when disabled — ``end(0)`` is a
    no-op, so gated callers need no second check).  Raw ``begin`` callers
    outside telemetry/ must close the span in a ``finally`` (or hand the
    id to an owner object) — OB01's unclosed-span check enforces it."""
    if not _ENABLED:
        return 0
    global _SEQ
    t = _clock()
    thread = threading.current_thread()
    with _LOCK:
        _SEQ += 1
        sid = _SEQ
        event = {"ph": "B", "sid": sid, "name": name, "t": t,
                 "tid": thread.ident, "tname": thread.name}
        if link is not None:
            event["link"] = link
        if fields:
            event.update(fields)
        _append(event)
    return sid


def end(sid: int, status: str = "ok") -> None:
    """Close span ``sid`` (no-op for 0/None — the disabled-path id)."""
    if not _ENABLED or not sid:
        return
    t = _clock()
    with _LOCK:
        _append({"ph": "E", "sid": sid, "t": t,
                 "tid": threading.get_ident(), "status": status})


def instant(name: str, link: Optional[int] = None, **fields) -> None:
    """A point event (drain/commit markers) on the calling thread —
    counted separately from spans (no begin/end pair, no span id)."""
    if not _ENABLED:
        return
    global _INSTANTS
    t = _clock()
    thread = threading.current_thread()
    with _LOCK:
        _INSTANTS += 1
        event = {"ph": "i", "name": name, "t": t,
                 "tid": thread.ident, "tname": thread.name}
        if link is not None:
            event["link"] = link
        if fields:
            event.update(fields)
        _append(event)


@contextlib.contextmanager
def span(name: str, link: Optional[int] = None, **fields):
    """Context-manager span: begin/end with the end in a ``finally``, so
    every exit path (including exceptions) closes the span."""
    sid = begin(name, link=link, **fields)
    try:
        yield
    finally:
        end(sid)


def cancel_link(link: Optional[int]) -> None:
    """Mark every ring event carrying ``link`` as cancelled — the
    engine's unwind path calls this for a rolled-back block, so a
    Perfetto read never mistakes drained host work for settled work.
    One ring pass under the lock (failure paths only — the hot path
    never cancels)."""
    cancel_links((link,) if link is not None else ())


def cancel_links(links) -> None:
    """``cancel_link`` for a whole drained window in ONE ring pass — a
    deep-window drain marks every rolled-back speculation without
    re-scanning the ring (and re-blocking the dispatch worker's appends)
    per block."""
    if not _ENABLED:
        return
    wanted = {l for l in links if l is not None}
    if not wanted:
        return
    with _LOCK:
        for event in _EVENTS:
            if event.get("link") in wanted:
                event["status"] = "cancelled"


def events() -> list:
    """The ring's events oldest-first, as copies."""
    with _LOCK:
        return [dict(e) for e in _EVENTS]


def stats() -> dict:
    """Ring health for the telemetry bus (and the soak flatness sample):
    enabled flag, bound, fill, spans begun, instants, links issued,
    events shed."""
    with _LOCK:
        return {"enabled": _ENABLED, "cap": _CAP, "events": len(_EVENTS),
                "spans": _SEQ, "instants": _INSTANTS, "links": _LINKS,
                "dropped": _DROPPED}


# -- Chrome trace-event export -------------------------------------------------


def dump_chrome_trace(path: Optional[str] = None) -> dict:
    """The timeline as Chrome trace-event JSON (load in Perfetto or
    chrome://tracing): matched begin/end pairs become "X" complete events
    on their begin-thread's track, causality links become flow arrows
    ("s"/"f" with ``bp: "e"``), point events become instants, and every
    thread gets a name row.  Unclosed spans export with ``status:
    "open"`` and a duration up to the newest timestamp seen — a dump
    mid-flight still shows where time was going.  Timestamps are
    microseconds relative to the earliest ring event (Chrome's unit).
    Safe to call with recording disabled (exports whatever the ring
    holds); written atomically when ``path`` is given."""
    ring = events()
    meta_fields = ("ph", "sid", "name", "t", "tid", "tname", "status")
    spans_out, instants, opens = [], [], {}
    t_max = max((e["t"] for e in ring), default=0.0)
    for e in ring:
        if e["ph"] == "B":
            opens[e["sid"]] = e
        elif e["ph"] == "E":
            b = opens.pop(e["sid"], None)
            if b is not None:  # begin may have been evicted: skip orphan
                spans_out.append((b, e["t"],
                                  b.get("status", e.get("status", "ok"))))
        else:
            instants.append(e)
    for b in opens.values():
        spans_out.append((b, t_max, b.get("status", "open")))
    spans_out.sort(key=lambda s: (s[0]["t"], s[0]["sid"]))

    t0 = min((e["t"] for e in ring), default=0.0)

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    trace, links, thread_names = [], {}, {}
    for b, t_end, status in spans_out:
        args = {k: v for k, v in b.items() if k not in meta_fields}
        args["status"] = status
        trace.append({"name": b["name"], "cat": "cstpu", "ph": "X",
                      "ts": us(b["t"]),
                      "dur": max(0.0, round((t_end - b["t"]) * 1e6, 3)),
                      "pid": 0, "tid": b["tid"], "args": args})
        thread_names.setdefault(b["tid"], b.get("tname"))
        if "link" in b:
            links.setdefault(b["link"], []).append(b)
    for e in instants:
        args = {k: v for k, v in e.items() if k not in meta_fields}
        trace.append({"name": e["name"], "cat": "cstpu", "ph": "i",
                      "ts": us(e["t"]), "pid": 0, "tid": e["tid"],
                      "s": "t", "args": args})
        thread_names.setdefault(e["tid"], e.get("tname"))
        if "link" in e:
            links.setdefault(e["link"], []).append(e)
    # flow arrows: the link's first event starts the flow, every later
    # event on the SAME link receives it (bp="e": bind to enclosing slice)
    for link in sorted(links):
        chain = sorted(links[link], key=lambda e: (e["t"], e.get("sid", 0)))
        first = chain[0]
        trace.append({"name": "block-flow", "cat": "cstpu.flow", "ph": "s",
                      "id": int(link), "ts": us(first["t"]), "pid": 0,
                      "tid": first["tid"]})
        for e in chain[1:]:
            trace.append({"name": "block-flow", "cat": "cstpu.flow",
                          "ph": "f", "bp": "e", "id": int(link),
                          "ts": us(e["t"]), "pid": 0, "tid": e["tid"]})
    for tid in sorted(t for t in thread_names if t is not None):
        trace.append({"name": "thread_name", "ph": "M", "pid": 0,
                      "tid": tid,
                      "args": {"name": thread_names[tid] or f"thread-{tid}"}})
    payload = {"displayTimeUnit": "ms", "traceEvents": trace}
    if path:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        # durable-io: a Chrome-trace JSON export for Perfetto, rewritten
        # per dump — a viewer input, not an integrity-checked artifact
        os.replace(tmp, path)
    return payload


if os.environ.get("CSTPU_TIMELINE") == "1":
    _ENABLED = True
