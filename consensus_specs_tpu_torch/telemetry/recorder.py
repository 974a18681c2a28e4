"""Per-block flight recorder: a bounded ring buffer of structured events
(layer 2).

The engines already *count* everything (breaker trips, replay reasons,
cache hits), but counters answer "how many", never "in what order" — and
a post-mortem is an ordering question: did the breaker open before or
after the native backend degraded?  Which block's rollback preceded the
cache-coherence miss?  The recorder keeps the last-N structured events:

    {"seq": 17, "t": 3.1415, "kind": "breaker_open", ...fields}

* ``record(kind, **fields)`` appends; DISABLED (the default) it costs one
  module-global load and a truth check — the hot path stays unmeasurable.
  Enabled, the append is lock-guarded (the native pool and ``parallel/``
  paths can record concurrently) and the ring is bounded: the oldest
  event falls off and ``dropped`` counts it, so a month-long soak holds
  exactly ``cap`` events;
* ``timeline()`` returns copies (callers can never mutate ring state);
* ``dump(reason)`` materializes the post-mortem: the reason, the
  timeline, and (optionally) a full ``telemetry.snapshot()``, written as
  JSON when given a path — failures carry their own flight data.

Producers emit through the module-level ``record``; the ring itself
(``_EVENTS``) is analyzer-registered (CC01 "flight-recorder ring") and
OB01 enforces that commit-class events are never recorded inside a still
open block transaction (a rolled-back block must not log a commit that
never happened).

Activation: ``enable()``/``disable()``, or ``CSTPU_FLIGHT_RECORDER=1``
at import; ``CSTPU_FLIGHT_RECORDER_CAP`` overrides the default 512-event
bound.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Deque, Optional

DEFAULT_CAP = 512

_LOCK = threading.Lock()
_ENABLED = False


def _env_cap() -> int:
    """The env-configured ring bound, validated like ``enable(cap=...)``
    would — a malformed or non-positive value falls back to the default
    instead of making the whole package unimportable (or silently
    zero-length, dropping every post-mortem event)."""
    raw = os.environ.get("CSTPU_FLIGHT_RECORDER_CAP", "")
    try:
        cap = int(raw)
    except ValueError:
        return DEFAULT_CAP
    return cap if cap >= 1 else DEFAULT_CAP


_CAP = _env_cap()
_EVENTS: Deque[dict] = collections.deque(maxlen=_CAP)
_SEQ = 0
_DROPPED = 0


def enabled() -> bool:
    return _ENABLED


def enable(cap: Optional[int] = None) -> None:
    """Switch recording on, optionally re-bounding the ring (a new cap
    drops the existing timeline — bounds are structural, not advisory)."""
    global _ENABLED, _CAP, _EVENTS
    with _LOCK:
        if cap is not None and int(cap) != _CAP:
            if cap < 1:
                raise ValueError(f"ring cap must be >= 1, got {cap}")
            _CAP = int(cap)
            _EVENTS = collections.deque(maxlen=_CAP)
        _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Drop the timeline and zero the counters (cap + enablement keep)."""
    global _SEQ, _DROPPED
    with _LOCK:
        _EVENTS.clear()
        _SEQ = 0
        _DROPPED = 0


def record(kind: str, **fields) -> None:
    """Append one structured event.  Near-zero cost when disabled; when
    enabled, fields must be JSON-able (ints/floats/strings/bools/small
    dicts) — the recorder never coerces, a dump would fail loudly."""
    if not _ENABLED:
        return
    global _SEQ, _DROPPED
    with _LOCK:
        _SEQ += 1
        if len(_EVENTS) == _CAP:
            _DROPPED += 1
        event = {"seq": _SEQ, "t": round(time.perf_counter(), 6),
                 "kind": kind}
        if fields:
            event.update(fields)
        _EVENTS.append(event)


def timeline() -> list:
    """The ring's events oldest-first, as copies."""
    with _LOCK:
        return [dict(e) for e in _EVENTS]


def stats() -> dict:
    """Ring health for the telemetry bus: enabled flag, bound, fill,
    total events seen, events shed past the bound."""
    with _LOCK:
        return {"enabled": _ENABLED, "cap": _CAP, "events": len(_EVENTS),
                "total": _SEQ, "dropped": _DROPPED}


def dump(reason: str, path: Optional[str] = None,
         with_snapshot: bool = True) -> dict:
    """The post-mortem payload: reason + last-N timeline (+ the full
    telemetry snapshot unless opted out), written as JSON when ``path``
    is given.  Safe to call with recording disabled (the timeline is
    whatever the ring holds)."""
    payload = {"reason": reason, "recorder": stats(), "events": timeline()}
    if with_snapshot:
        from . import registry

        payload["snapshot"] = registry.snapshot()
    if path:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
        # durable-io: a human-readable post-mortem report, rewritten per
        # dump — not an integrity-checked artifact (no digest by design)
        os.replace(tmp, path)
    return payload


if os.environ.get("CSTPU_FLIGHT_RECORDER") == "1":
    _ENABLED = True
