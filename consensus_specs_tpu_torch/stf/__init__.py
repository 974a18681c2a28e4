"""Batched block-path transition engine, phase0 and altair lineages.

``apply_signed_blocks(spec, state, signed_blocks)`` replays signed blocks
with one BLS multi-pairing per block (cross-block triple dedup), whole-
block vectorized attestation application, and resident-routed per-slot
roots — pinned to byte-identical post-states and identical failure
behavior vs the literal ``spec.state_transition``.

Layers:

* ``attestations`` — committee/attester resolution off the cached shuffle
  permutation, and the attestation-plan memo the epoch scans probe;
* ``verify``       — per-block signature batch: preflattened
  ``BatchFastAggregateVerify`` entries, verified-triple memo, bisection;
* ``sync``         — altair-lineage sync aggregates: seat rows memoized
  per sync period, the signature folded into the block batch, rewards as
  net per-validator deltas;
* ``slot_roots``   — spec-identical ``process_slots`` with dirty bulk
  balance subtrees reduced on the spec's device (K2 on CUDA);
* ``columns``      — root-keyed resident validator-state columns and the
  once-per-version device buffers of the epoch kernels' inputs;
* ``staging``      — the block cache transaction those memos record into;
* ``pipeline``     — cross-block overlapped verification: block N's
  native pairing batch runs on a dispatch worker while block N+1's host
  phases execute (``pipeline.ENABLED = False`` opts out);
* ``engine``       — the optimistic fast path + exact-spec replay
  fallback that makes failure behavior literally the spec's.
"""
from .attestations import FastPathViolation
from .engine import apply_signed_blocks, reset_stats, stats

__all__ = ["apply_signed_blocks", "FastPathViolation", "reset_stats", "stats"]
