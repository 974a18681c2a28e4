"""Unified telemetry subsystem (SURVEY §5's wall-time
observability, grown from ``tracing.py`` into three cooperating layers):

* **metrics** — thread-safe spans/counters + re-entrant spec
  instrumentation (the legacy ``consensus_specs_tpu_torch.tracing`` module is
  now a thin facade over this layer, byte-compatible for every existing
  callsite);
* **registry** — the metrics bus: every stats producer (stf engine,
  signature settlement, attestation plan cache, resident column store,
  fork-choice engine, faults harness, native counter exports, the
  recorder itself) registers a named snapshot provider, and
  ``snapshot()`` returns one schema-stable tree;
* **recorder** — the per-block flight recorder: a bounded ring of
  structured events (block fast/replayed + reason, breaker transitions,
  degradation, cache commit/rollback, plan/h2c hit deltas, fork-choice
  handler activity) that costs nothing disabled and ``dump()``s a JSON
  post-mortem on failure.

* **timeline + histograms** — the causal trace timeline: a
  bounded ring of begin/end span events with thread identity and
  explicit causality links (block seq → dispatch → native verify →
  drain/commit), ``CSTPU_TIMELINE``-gated and exportable as Chrome
  trace-event JSON (``telemetry.timeline.dump_chrome_trace``); and
  fixed-bucket log2 latency histograms with p50/p90/p99 per phase
  (``telemetry.histogram``), both on the bus.

Layer 4, the soak-endurance harness, lives in ``telemetry.soak`` (run
via ``make soak``) and consumes the others: long seeded walks under
fault schedules with breaker-recovery/cache-coherence/memory-flatness
asserts and a ``SOAK.json`` timeline artifact.

Import contract: this package imports nothing from ``stf``/``forkchoice``
(producers import *us* and register providers at their import); the few
built-in providers below reach into other modules only through
``sys.modules`` probes or deliberately cheap imports, so ``snapshot()``
never drags a subsystem into the process as a side effect.
"""
from __future__ import annotations

import sys

from . import histogram, metrics, recorder, registry, timeline
from .recorder import record
from .registry import register_provider, snapshot

__all__ = [
    "histogram", "metrics", "recorder", "record", "register_provider",
    "registry", "snapshot", "timeline",
]


# -- built-in providers -------------------------------------------------------

def _tracing_provider() -> dict:
    """Spans + counters of the metrics layer (the legacy report shape)."""
    return metrics.report()


def _native_provider() -> dict:
    """Native BLS counter exports — the bounded hash_to_g2 cache that
    fronts the batch verifier's message hashing.  Probed via sys.modules
    so a snapshot never *loads* the native library as a side effect."""
    native = sys.modules.get("consensus_specs_tpu_torch.crypto.bls.native")
    if native is None:
        return {"loaded": False}
    return {"loaded": True, "h2c": native.h2c_cache_stats()}


def _faults_provider() -> dict:
    """Fault-injection activity: whether a plan is armed, what fired."""
    from consensus_specs_tpu_torch import faults

    plan = faults.active_plan()
    out = {"sites_registered": len(faults.registry()),
           "plan_active": plan is not None}
    if plan is not None:
        out["fired"] = [list(f) for f in plan.fired]
        out["hits"] = dict(plan.hits)
    return out


register_provider("tracing", _tracing_provider, replace=True)
register_provider("native.bls", _native_provider, replace=True)
register_provider("faults", _faults_provider, replace=True)
register_provider("flight_recorder", recorder.stats, replace=True)
# the causal-timeline ring's health and the per-phase latency
# distributions ride the same bus as every other producer
register_provider("timeline", timeline.stats, replace=True)
register_provider("histograms", histogram.snapshot, replace=True)
