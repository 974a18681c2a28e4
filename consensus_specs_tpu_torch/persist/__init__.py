"""Durable persistence for the node.

Two layers:

* ``persist/atomic.py`` — THE torn-write-safe artifact discipline for
  every durable byte in the tree (unique-tempfile + ``os.replace``
  promotion, per-artifact SHA-256 digest, kind + format/ABI tag verified
  on load), the only sanctioned write path
  (analyzer rule IO01 turns a raw ``os.replace`` of a durable artifact
  outside ``persist/`` red).

* ``persist/store.py`` — the content-addressed on-disk checkpoint store:
  a finalized (state, block) anchor plus the since-finality window of
  blocks/states serialized as root-deduped merkle subtrees (packed
  columns ride as raw bytes and come back as lazily-materializing
  ``PackedLazySubtree``s), keyed by state root, bounded on disk with
  prune-on-finalization, and guarded by a corruption-degradation ladder:
  a damaged artifact is detected at load, quarantined, counted, flight-
  recorded — and recovery falls back to journal replay, never serving a
  wrong state.
"""
from .atomic import (  # noqa: F401
    ArtifactError,
    ArtifactCorrupt,
    ArtifactMissing,
    ArtifactStaleTag,
    read_artifact,
    write_artifact,
)

_STORE_EXPORTS = ("CheckpointStore", "CheckpointError", "CheckpointPayload",
                  "RestoredCheckpoint")


def __getattr__(name):
    # the store half pulls in stf/telemetry; loaded lazily so artifact-
    # only consumers keep their light import footprint
    if name in _STORE_EXPORTS:
        from . import store

        return getattr(store, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
