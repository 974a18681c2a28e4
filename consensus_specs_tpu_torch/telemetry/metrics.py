"""Thread-safe spans + counters: the measurement core of the telemetry
subsystem (layer 1's substrate).

This is the engine room behind the legacy ``tracing`` facade — same API,
same report shape, two hardening changes the facade alone could not make:

* **thread safety** — the native pairing pool and the ``parallel/`` code
  paths can increment counters concurrently; the old bare ``defaultdict``
  increment raced (two threads could both read-modify-write the same
  slot and lose one increment).  All span/counter mutation now happens
  under one module lock, and the span nesting stack is *thread-local* so
  two threads timing unrelated work can never interleave their key paths;
* **re-entrant spec instrumentation** — ``instrument_spec`` marks its
  wrappers with a self-referencing attribute and checks IDENTITY, not a
  boolean flag.  A spec rebuild that rebinds ``process_*`` globals (the
  builder's kernel substitution, bench's ``__wrapped__`` unwrap idiom)
  silently dropped instrumentation before, and a stale copied flag
  (``functools.wraps`` copies ``__dict__``) made re-instrumentation skip
  the very functions that needed re-wrapping.  Now a function is only
  "already instrumented" if it IS a wrapper this module created, so
  calling ``instrument_spec`` again after any rebuild re-wraps exactly
  the fresh functions.

Disabled (the default), ``span``/``count`` cost one module-global load
and a truth check — nothing to measure in a phase breakdown.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

from . import timeline

_enabled = False
_LOCK = threading.Lock()
_spans: Dict[str, list] = {}  # name -> [count, total_s]
_counters: Dict[str, int] = {}
_tls = threading.local()  # per-thread span nesting stack


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    with _LOCK:
        _spans.clear()
        _counters.clear()
    _tls.stack = []


def enabled() -> bool:
    return _enabled


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


@contextlib.contextmanager
def span(name: str):
    """Nested wall-time span; keys are '/'-joined paths.  Nesting is
    per-thread: concurrent spans from different threads each build their
    own path, and the aggregate mutation is lock-guarded.

    Every span site doubles as a causal-timeline emitter:
    with ``CSTPU_TIMELINE`` armed, the same begin/end lands as paired
    timeline events — existing ``tracing.span`` callsites feed the
    Chrome-trace export without touching a line of producer code.  The
    nesting stack builds the same '/'-joined key either way, so a span's
    exported name is identical whether the metrics layer is on or the
    timeline alone is.  Both layers disabled, the cost stays two
    module-global loads and a truth check."""
    tl = timeline.enabled()
    if not _enabled and not tl:
        yield
        return
    stack = _stack()
    stack.append(name)
    key = "/".join(stack)
    sid = timeline.begin(key) if tl else 0
    t0 = time.perf_counter() if _enabled else 0.0
    try:
        yield
    finally:
        if _enabled:
            dt = time.perf_counter() - t0
            with _LOCK:
                rec = _spans.get(key)
                if rec is None:
                    rec = _spans[key] = [0, 0.0]
                rec[0] += 1
                rec[1] += dt
        timeline.end(sid)
        stack.pop()


def count(name: str, n: int = 1) -> None:
    if _enabled:
        with _LOCK:
            _counters[name] = _counters.get(name, 0) + n


def report() -> dict:
    """{'spans': {path: {'count', 'total_s'}}, 'counters': {...}}"""
    with _LOCK:
        return {
            "spans": {
                k: {"count": v[0], "total_s": round(v[1], 6)}
                for k, v in sorted(_spans.items())
            },
            "counters": dict(sorted(_counters.items())),
        }


# --- spec instrumentation ----------------------------------------------------

_INSTRUMENT_PREFIXES = ("process_", "state_transition", "verify_block_signature")


def _wrap(name: str, fn):
    def traced(*args, **kw):
        if not _enabled:
            return fn(*args, **kw)
        with span(name):
            return fn(*args, **kw)

    traced.__name__ = getattr(fn, "__name__", name)
    traced.__wrapped__ = fn
    return traced


def _is_own_wrapper(fn) -> bool:
    """True only for a wrapper THIS module created: the marker is a
    self-reference, so an attribute merely copied onto another function
    (``functools.wraps`` copies ``__dict__``) fails the identity check
    and the function gets (re-)wrapped honestly."""
    return getattr(fn, "_tracing_self", None) is fn


def instrument_spec(spec, prefixes=_INSTRUMENT_PREFIXES) -> int:
    """Wrap a compiled spec module's transition functions with spans.

    Idempotent AND re-entrant: returns the number of functions newly
    instrumented this call.  After a spec rebuild rebinds some globals
    (kernel substitution, ``__wrapped__`` unwrapping), calling this again
    re-wraps exactly the functions that lost their wrapper."""
    g = spec.__dict__
    n = 0
    for name, fn in list(g.items()):
        if not callable(fn) or not name.startswith(tuple(prefixes)):
            continue
        if _is_own_wrapper(fn):
            continue
        wrapped = _wrap(name, fn)
        wrapped._tracing_self = wrapped
        g[name] = wrapped
        n += 1
    return n
