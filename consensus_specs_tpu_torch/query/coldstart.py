"""Checkpoint-sync under every cold start.

``state_build_s`` is the tax this module retires: every bench row, soak
profile, and firehose scaffold used to rebuild its anchor state from
genesis, seconds-to-half-a-minute per process at mainnet registry
sizes.  ``restore_or_build`` is the seam those builds route through
now: the state snapshots to a root-deduped subtree artifact (the
checkpoint store's tree codec under the atomic envelope) on first
build, and every later cold start decodes it back in milliseconds —
byte-identical, asserted once per artifact by re-encoding the decoded
tree and comparing streams.

Trust ladder, matching the store's: a missing artifact is a plain miss
(build), a stale tag is a codec/shape miss (build, re-snapshot), and
damage — digest mismatch, malformed stream, root mismatch, the
``query.restore`` chaos probe firing — quarantines the artifact
(``<path>.corrupt``), counts ``coldstart_corrupt``, flight-records, and
falls back to the literal build.  No path serves a wrong state.

``CSTPU_NO_CHECKPOINT_SYNC=1`` forces the literal build path (the cold
bench baselines stay measurable); ``CSTPU_SNAPSHOT_DIR`` overrides the
artifact directory (defaults to ``<repo>/.bench_cache/state_snapshots``,
beside the bench corpus cache).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Callable, Optional

from consensus_specs_tpu_torch import faults
from consensus_specs_tpu_torch.persist import atomic
from consensus_specs_tpu_torch.persist.store import (
    CheckpointError,
    decode_tree,
    encode_tree,
)
from consensus_specs_tpu_torch.telemetry import recorder

from . import stats

SNAPSHOT_KIND = "state-snapshot"
# bump on any codec or meta change: an old snapshot degrades to a
# stale-tag miss (rebuild + rewrite), never a misparse
FORMAT_TAG = "snap-v1"

_SITE_RESTORE = faults.site("query.restore")

# artifact paths whose decoded state already passed the once-per-artifact
# byte-identity check in this process
_VERIFIED = set()
_VERIFIED_LOCK = threading.Lock()


def _default_dir() -> str:
    env = os.environ.get("CSTPU_SNAPSHOT_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, ".bench_cache", "state_snapshots")


def _spec_ident(spec) -> str:
    return (f"{getattr(spec, 'fork', 'unknown')}_"
            f"{getattr(spec, 'preset_name', 'unknown')}")


def snapshot_path(spec, n_validators: int, label: str = "state",
                  cache_dir: Optional[str] = None) -> str:
    return os.path.join(
        cache_dir or _default_dir(),
        f"snap_{label}_{_spec_ident(spec)}_{int(n_validators)}.bin")


def _tag(spec, n_validators: int, label: str) -> str:
    # the tag binds codec generation, fork×preset, registry size, and
    # the builder variant: any mismatch is STALE, not damage
    return f"{FORMAT_TAG}:{_spec_ident(spec)}:{int(n_validators)}:{label}"


def forget_verified() -> None:
    """Drop the once-per-artifact verification memo (tests/bench: a
    restore timed after this pays the honest cold-process cost,
    byte-identity check included)."""
    with _VERIFIED_LOCK:
        _VERIFIED.clear()


def _encode_payload(state) -> bytes:
    root = bytes(state.hash_tree_root())  # memoizes every subtree root
    meta = {
        "root": root.hex(),
        "slot": int(state.slot),
        "n_validators": len(state.validators),
    }
    out = bytearray()
    raw = json.dumps(meta, sort_keys=True).encode()
    out += len(raw).to_bytes(4, "little")
    out += raw
    encode_tree(state.get_backing(), out, {})
    return bytes(out)


def _decode_payload(spec, payload):
    """(state, meta, tree_off); raises ``CheckpointError`` on any
    structural surprise or root mismatch."""
    try:
        n = int.from_bytes(payload[:4], "little")
        meta = json.loads(bytes(payload[4:4 + n]).decode())
        tree_off = 4 + n
        backing, end = decode_tree(payload, tree_off, [])
        state = spec.BeaconState.view_from_backing(backing)
    except CheckpointError:
        raise
    except Exception as exc:
        raise CheckpointError(f"malformed snapshot payload: {exc!r}")
    if end != len(payload):
        raise CheckpointError("snapshot payload has trailing bytes")
    # the content address must agree with the rebuilt tree (roots are
    # memoized from the stream; the digest vouched for the bytes, this
    # vouches meta and tree belong together)
    if bytes(state.hash_tree_root()) != bytes.fromhex(meta["root"]):
        raise CheckpointError("snapshot state root mismatch")
    return state, meta, tree_off


def _assert_byte_identical(state, payload, tree_off: int) -> None:
    """The once-per-artifact post-state identity: re-encoding the
    decoded backing must reproduce the artifact's tree stream exactly
    (codec round-trip == byte-identical state)."""
    out = bytearray()
    encode_tree(state.get_backing(), out, {})
    if bytes(out) != bytes(payload[tree_off:]):
        raise CheckpointError("snapshot re-encode diverged from artifact")


def _discard(path: str, exc: Exception) -> None:
    stats["coldstart_corrupt"] += 1
    atomic.quarantine(path)
    recorder.record("snapshot_corrupt", path=os.path.basename(path),
                    detail=repr(exc)[:160])


def write_snapshot(spec, state, n_validators: Optional[int] = None,
                   label: str = "state",
                   cache_dir: Optional[str] = None) -> Optional[str]:
    """Snapshot ``state`` for later cold starts.  The payload is
    round-tripped (decode + re-encode + root check) BEFORE the write —
    an artifact only exists once it is proven byte-identical.  Best
    effort: a read-only tree returns None (the cold path still works)."""
    n = len(state.validators) if n_validators is None else int(n_validators)
    path = snapshot_path(spec, n, label, cache_dir)
    payload = _encode_payload(state)
    decoded, _meta, tree_off = _decode_payload(spec, payload)
    _assert_byte_identical(decoded, payload, tree_off)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic.write_artifact(path, payload, SNAPSHOT_KIND,
                              _tag(spec, n, label))
    except OSError:
        return None
    stats["coldstart_writes"] += 1
    with _VERIFIED_LOCK:
        _VERIFIED.add(path)
    return path


def restore_or_build(spec, n_validators: int, build_fn: Callable,
                     label: str = "state",
                     cache_dir: Optional[str] = None):
    """The universal cold-start seam: restore the matching snapshot
    artifact if one exists (and verifies), else run ``build_fn`` and
    snapshot its result for the next process.  Honors
    ``CSTPU_NO_CHECKPOINT_SYNC=1`` (always build, never touch disk)."""
    if os.environ.get("CSTPU_NO_CHECKPOINT_SYNC") == "1":
        stats["coldstart_builds"] += 1
        return build_fn()
    n = int(n_validators)
    path = snapshot_path(spec, n, label, cache_dir)
    tag = _tag(spec, n, label)
    payload = None
    try:
        payload = atomic.read_artifact(path, SNAPSHOT_KIND, tag)
    except atomic.ArtifactMissing:
        pass
    except atomic.ArtifactStaleTag:
        # a foreign codec generation or builder variant: plain miss —
        # the rebuild overwrites it with the current shape
        pass
    except Exception as exc:
        _discard(path, exc)
    if payload is not None:
        try:
            _SITE_RESTORE()
            state, meta, tree_off = _decode_payload(spec, payload)
            if int(meta["n_validators"]) != n:
                raise CheckpointError("snapshot validator count mismatch")
            with _VERIFIED_LOCK:
                verified = path in _VERIFIED
            if not verified:
                _assert_byte_identical(state, payload, tree_off)
                with _VERIFIED_LOCK:
                    _VERIFIED.add(path)
            stats["coldstart_restores"] += 1
            return state
        except Exception as exc:
            # damage (or the chaos probe): quarantine and fall through
            # to the literal build — never serve a wrong state
            _discard(path, exc)
    state = build_fn()
    stats["coldstart_builds"] += 1
    write_snapshot(spec, state, n, label, cache_dir)
    return state
