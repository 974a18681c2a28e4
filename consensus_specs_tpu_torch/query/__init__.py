"""Historical-state query subsystem.

The checkpoint store alone is write-only: artifacts existed to survive
crashes.  This package turns it into the node's READ path and its
universal cold-start path:

* ``coldstart.restore_or_build`` — checkpoint-sync under every cold
  start: bench/soak/firehose state builds route through a snapshot
  artifact (root-deduped subtree decode, byte-identical post-state
  asserted once per artifact) instead of genesis replay
  (``CSTPU_NO_CHECKPOINT_SYNC=1`` forces the literal path);
* ``streamproof`` — an offset index over the ``encode_tree`` stream
  plus a Merkle-proof walker that emits sibling hashes along a
  generalized-index path straight off the mmap'd artifact, without
  materializing the state;
* ``engine.QueryEngine`` — state-at-root, per-validator balance/status,
  head/vote summaries, and single-validator proofs served off store
  artifacts, exposed on the ``Node`` beside the apply loop;
* ``resident`` — the bounded materialized-state cache: cold window
  states spill (the artifact is the source of truth) and re-fault
  lazily through the same read path, so soaks hold flat RSS;
* ``harness`` — the concurrent query-load harness ("query-reader"
  threads) running against the live firehose.

One module-wide ``stats`` dict feeds the ``query`` telemetry provider
(proof cache hits, faults-in, spill/refault counters, cold-start
counters); live cache size/cap gauges ride a weakref to the most recent
engine, the ``persist`` provider's spelling, so soak's cap-flatness
sweep picks every new cache up unchanged.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

from consensus_specs_tpu_torch import telemetry

stats = {
    "queries_served": 0,        # successfully answered engine queries
    "queries_unserved": 0,      # no artifact yet / exhausted candidates
    "proofs_served": 0,
    "proof_cache_hits": 0,
    "proof_cache_misses": 0,
    "artifact_loads": 0,        # artifact indexes parsed (mmap + section walk)
    "artifact_corrupt": 0,      # artifacts the ENGINE handed to the ladder
    "faults_in": 0,             # queries that absorbed an injected/IO fault
    "state_materializations": 0,  # full window decodes feeding the resident set
    "spills": 0,                # resident states dropped back to the store
    "refaults": 0,              # resident misses re-decoded off the artifact
    "coldstart_restores": 0,    # cold starts served from a snapshot artifact
    "coldstart_builds": 0,      # literal builds (miss, opt-out, or corrupt)
    "coldstart_writes": 0,      # snapshot artifacts written after a build
    "coldstart_corrupt": 0,     # snapshot artifacts quarantined at restore
}

# most recent engine, for the size/cap gauges (the persist provider's
# weakref idiom — a dead engine reports empty, never stale)
_LIVE_ENGINE: Optional[weakref.ref] = None
_LIVE_LOCK = threading.Lock()


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def _set_live_engine(engine) -> None:
    global _LIVE_ENGINE
    with _LIVE_LOCK:
        _LIVE_ENGINE = weakref.ref(engine)


def _telemetry_provider() -> dict:
    out = dict(stats)
    with _LIVE_LOCK:
        live = _LIVE_ENGINE() if _LIVE_ENGINE is not None else None
    gauges = live.cache_gauges() if live is not None else {}
    out.update(gauges)
    return out


telemetry.register_provider("query", _telemetry_provider, replace=True)
