"""Metrics registry/bus: one schema-stable snapshot over every stats
producer (layer 1).

Before this module, phase timings and health counters lived in five
uncoordinated dicts — ``stf.engine.stats``, ``stf.verify.stats``, the
native ``h2c_cache_stats`` export, the fork-choice engine, the faults
harness — and anything that wanted "the system's state right now" had to
know every one of them.  Now each producer registers a named **snapshot
provider** (a zero-arg callable returning a JSON-able tree) at import
time, and ``snapshot()`` returns one tree over all of them:

    {"schema": 1, "providers": {"stf.engine": {...}, "tracing": {...}}}

Contracts:

* providers must return a FRESH JSON-able structure (``snapshot()``
  deep-copies defensively, so aliasing a live dict is survivable but
  wasteful);
* a provider that raises is isolated: its subtree becomes
  ``{"error": repr(exc)}`` and every other provider still reports —
  telemetry must never take down the thing it observes;
* names are dotted paths mirroring the owning module; duplicate
  registration raises unless ``replace=True`` (module-level
  registrations pass it so re-imports stay safe);
* registration/lookup is lock-guarded — providers register from module
  import while the native pool may be mid-snapshot elsewhere.

The registry itself is analyzer-registered (CC01 "telemetry provider
registry"): inserts happen only through ``register_provider`` here.
"""
from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, Tuple

SCHEMA_VERSION = 1

_LOCK = threading.Lock()
_PROVIDERS: Dict[str, Callable[[], dict]] = {}


def register_provider(name: str, fn: Callable[[], dict],
                      replace: bool = False) -> None:
    """Register ``fn`` as the snapshot provider for ``name`` (a dotted
    path mirroring the owning module).  Duplicates raise unless
    ``replace=True``."""
    if not name or not callable(fn):
        raise ValueError(f"provider needs a name and a callable, got "
                         f"{name!r}/{fn!r}")
    with _LOCK:
        if name in _PROVIDERS and not replace:
            raise ValueError(f"duplicate telemetry provider {name!r}")
        _PROVIDERS[name] = fn


def unregister_provider(name: str) -> None:
    """Drop one provider (tests; a subsystem shutting down)."""
    with _LOCK:
        _PROVIDERS.pop(name, None)


def providers() -> Tuple[str, ...]:
    """Sorted names of every registered provider."""
    with _LOCK:
        return tuple(sorted(_PROVIDERS))


def reset() -> None:
    """Drop every provider (test isolation only — production providers
    re-register at module import)."""
    with _LOCK:
        _PROVIDERS.clear()


def snapshot() -> dict:
    """One schema-stable tree over every registered provider.  Provider
    order is sorted-by-name; a failing provider contributes an
    ``{"error": ...}`` subtree instead of killing the snapshot."""
    with _LOCK:
        items = sorted(_PROVIDERS.items())
    tree: dict = {}
    for name, fn in items:
        try:
            tree[name] = copy.deepcopy(fn())
        except Exception as exc:  # isolation: observation must not wound
            tree[name] = {"error": repr(exc)[:200]}
    return {"schema": SCHEMA_VERSION, "providers": tree}
