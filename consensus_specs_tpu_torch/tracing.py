"""Tracing + metrics facade (SURVEY §5: the wall-time observability the
reference lacks; essential here because performance is a deliverable).

The implementation lives in
``consensus_specs_tpu_torch.telemetry.metrics`` — this module is the stable
legacy surface every existing callsite (and tests/test_tracing.py) keeps
using, byte-compatible:

* **Spans** — nested wall-time measurements.  ``span(name)`` is a
  context manager; ``instrument_spec(spec)`` wraps every ``process_*``
  and ``state_transition`` function of a compiled spec module so a whole
  transition self-profiles per phase.  Disabled (default) the wrapper is
  a single attribute check.  New underneath: mutation is lock-guarded
  (the native pool / ``parallel/`` paths increment concurrently), span
  nesting is per-thread, and ``instrument_spec`` is re-entrant after
  spec rebuilds (identity-marked wrappers, not copyable flags).
* **Counters** — monotonically increasing named counters
  (``count(name)``), e.g. BLS verifications, cache hits.

Snapshot everything with ``report()``; reset with ``reset()``.  The
report also rides the telemetry bus as the ``"tracing"`` provider
(``telemetry.snapshot()``), next to every other stats producer.
"""
from __future__ import annotations

from consensus_specs_tpu_torch.telemetry.metrics import (  # noqa: F401
    _INSTRUMENT_PREFIXES,
    count,
    disable,
    enable,
    enabled,
    instrument_spec,
    report,
    reset,
    span,
)

__all__ = [
    "count", "disable", "enable", "enabled", "instrument_spec", "report",
    "reset", "span",
]
