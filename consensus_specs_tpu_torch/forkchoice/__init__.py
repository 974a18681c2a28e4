"""Batched fork-choice engine: proto-array LMD-GHOST with vectorized
attestation ingestion, behaviorally pinned to the spec ``Store``.

Layers (see docs/architecture.md):

* ``proto_array``  — flat append-only block array, incremental subtree
  weights, O(blocks) ``find_head``;
* ``batch``        — spec-equivalent batched ``on_attestation`` with the
  latest-message fold vectorized over dense validator arrays;
* ``engine``       — the ``on_tick / on_block / on_attestations /
  get_head`` wrapper keeping a real spec ``Store`` and the proto-array
  in lockstep, with head caching and finalized-subtree pruning.
"""
from .engine import ForkChoiceEngine
from .proto_array import ProtoArray

__all__ = ["ForkChoiceEngine", "ProtoArray"]
