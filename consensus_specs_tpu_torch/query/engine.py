"""The historical query engine: the checkpoint store
as the node's READ path.

A ``QueryEngine`` serves the light-client-shaped workload — state
summaries, per-validator balance/status, latest-vote lookups,
single-validator Merkle proofs, and full state-at-root — off checkpoint
ARTIFACTS, not off the apply loop's fork-choice store.  The artifact is
opened once through ``CheckpointStore.map_payload`` (envelope verified,
mmap kept open), its sections are indexed by OFFSET (meta JSON, the
packed latest-message table for binary search, block frames, and the
``streamproof`` entry table over the tree streams), and from then on:

* proofs walk entry offsets and emit sibling roots straight off the
  map — the state is never materialized, and every proof is verified
  in-engine against the stored state root before it is served (a
  poisoned buffer — the ``query.proof`` chaos probe — surfaces as
  ``QueryError``, never as a wrong answer);
* chunk reads (balance, validator status, list lengths) descend to a
  single generalized index and touch a few pages;
* ``state_at_root`` materializes through the bounded resident set
  (``resident.ResidentStates``): cold states spill, misses re-fault
  off the artifact.

Trouble mid-query rides the checkpoint store's corruption ladder: a candidate that
fails envelope verification is counted/quarantined by the store; one
that fails SECTION parsing is handed back via
``CheckpointStore.discard_corrupt`` — either way the engine falls to
the next-newest candidate and the apply loop never notices.  Readers
touch only store artifacts and engine-owned caches — never the apply
writer's fork-choice structures (the TH01 role contract for
"query-reader" threads).
"""
from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import List, Optional

from consensus_specs_tpu_torch import faults
from consensus_specs_tpu_torch.persist.store import (
    CheckpointError,
    CheckpointStore,
    decode_tree,
)
from consensus_specs_tpu_torch.ssz.gindex import get_generalized_index

from . import _set_live_engine, stats
from . import streamproof
from .resident import ResidentStates

_SITE_PROOF = faults.site("query.proof")

DEFAULT_MAX_ARTIFACTS = 2
DEFAULT_PROOF_CACHE_CAP = 256
DEFAULT_RESIDENT_CAP = 2


class QueryError(Exception):
    """A query that could not be answered CORRECTLY (verification
    failure, damaged section, injected fault).  Never a wrong answer:
    callers retry or degrade; the apply loop is unaffected."""


class _ArtifactIndex:
    """Offset index over one mapped checkpoint artifact."""

    __slots__ = ("path", "mapped", "meta", "eq_off", "n_eq", "lm_off",
                 "n_lm", "block_frames", "tree_off", "entries",
                 "tree_order", "tops", "head_state_root")

    def __init__(self, path, mapped):
        self.path = path
        self.mapped = mapped


def _u32(buf, off: int) -> int:
    return int.from_bytes(buf[off:off + 4], "little")


def _u64(buf, off: int) -> int:
    return int.from_bytes(buf[off:off + 8], "little")


def _parse_index(path: str, mapped) -> _ArtifactIndex:
    """Walk ``serialize_checkpoint``'s section layout recording offsets
    (nothing is decoded but the small meta JSON); raises
    ``CheckpointError`` on any structural surprise."""
    idx = _ArtifactIndex(path, mapped)
    buf, off, end = mapped.buf, mapped.start, mapped.stop
    try:
        n = _u32(buf, off)
        off += 4
        idx.meta = json.loads(bytes(buf[off:off + n]).decode())
        off += n
        idx.n_eq = _u32(buf, off)
        off += 4
        idx.eq_off = off
        off += 8 * idx.n_eq
        idx.n_lm = _u32(buf, off)
        off += 4
        idx.lm_off = off
        off += 48 * idx.n_lm
        window = [bytes.fromhex(h) for h in idx.meta["window"]]
        idx.block_frames = {}
        for root in window:
            n = _u32(buf, off)
            off += 4
            idx.block_frames[root] = (off, n)
            off += n
        if off > end:
            raise CheckpointError("checkpoint sections overrun the payload")
        idx.tree_off = off
        entries: List[Optional[tuple]] = []
        idx.tree_order = []
        idx.tops = {}
        for block_root in window:
            eid, off = streamproof.parse_tree(buf, off, entries)
            state_root = streamproof.entry_root(buf, entries, eid)
            idx.tree_order.append(state_root)
            idx.tops[state_root] = eid
        idx.entries = entries
        idx.head_state_root = bytes.fromhex(idx.meta["head_state_root"])
        if idx.head_state_root not in idx.tops:
            raise CheckpointError("head state missing from tree streams")
        if off != end:
            raise CheckpointError("trailing bytes after tree streams")
    except CheckpointError:
        raise
    except Exception as exc:
        raise CheckpointError(f"malformed checkpoint sections: {exc!r}")
    return idx


class QueryEngine:
    """Serving surface over a ``CheckpointStore``'s artifacts.  One lock
    guards the artifact index, the proof cache, and the resident set —
    queries from any number of reader threads serialize on it (the
    engine owns no thread; readers bring their own)."""

    def __init__(self, spec, store: CheckpointStore,
                 max_artifacts: int = DEFAULT_MAX_ARTIFACTS,
                 proof_cache_cap: int = DEFAULT_PROOF_CACHE_CAP,
                 resident_cap: int = DEFAULT_RESIDENT_CAP):
        self.spec = spec
        self._store = store
        self._lock = threading.RLock()
        self._artifacts: "OrderedDict[str, _ArtifactIndex]" = OrderedDict()
        self._max_artifacts = max(1, int(max_artifacts))
        self._proof_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._proof_cache_cap = max(1, int(proof_cache_cap))
        self._resident = ResidentStates(resident_cap)
        _set_live_engine(self)

    # -- telemetry -----------------------------------------------------------

    def cache_gauges(self) -> dict:
        with self._lock:
            return {
                "artifact_index_size": len(self._artifacts),
                "artifact_index_cap": self._max_artifacts,
                "proof_cache_size": len(self._proof_cache),
                "proof_cache_cap": self._proof_cache_cap,
                "resident_size": self._resident.size(),
                "resident_cap": self._resident.cap,
            }

    def reset(self) -> None:
        """Drop every cache (the registered CC01 invalidation): mapped
        artifacts close, proofs and resident states rebuild lazily."""
        with self._lock:
            for idx in self._artifacts.values():
                idx.mapped.close()
            self._artifacts.clear()
            self._proof_cache.clear()
            self._resident.clear()

    # -- artifact index ------------------------------------------------------

    def _current(self) -> Optional[_ArtifactIndex]:
        """The newest servable artifact: cached index, else map + parse,
        walking the candidate ladder on damage.  Caller holds the lock."""
        for path in self._store.candidates():
            idx = self._artifacts.get(path)
            if idx is not None:
                self._artifacts.move_to_end(path)
                return idx
            try:
                mapped = self._store.map_payload(path)
            except CheckpointError:
                # counted/quarantined by the store; next candidate
                stats["artifact_corrupt"] += 1
                continue
            try:
                idx = _parse_index(path, mapped)
            except Exception as exc:
                mapped.close()
                stats["artifact_corrupt"] += 1
                self._store.discard_corrupt(path, exc)
                continue
            stats["artifact_loads"] += 1
            self._artifacts[path] = idx
            while len(self._artifacts) > self._max_artifacts:
                _p, old = self._artifacts.popitem(last=False)
                old.mapped.close()
            return idx
        return None

    def _resolve(self, idx: _ArtifactIndex,
                 state_root: Optional[bytes]) -> tuple:
        sr = idx.head_state_root if state_root is None else bytes(state_root)
        eid = idx.tops.get(sr)
        return (sr, eid) if eid is not None else (sr, None)

    # -- queries -------------------------------------------------------------

    def summary(self) -> Optional[dict]:
        """Head/vote summary off the newest artifact's meta section."""
        with self._lock:
            idx = self._current()
            if idx is None:
                stats["queries_unserved"] += 1
                return None
            m = idx.meta
            stats["queries_served"] += 1
            return {
                "journal_pos": int(m["journal_pos"]),
                "head_block_root": m["window"][-1],
                "head_state_root": m["head_state_root"],
                "window_depth": len(m["window"]),
                "justified": list(m["justified"]),
                "finalized": list(m["finalized"]),
                "n_latest_messages": idx.n_lm,
                "n_equivocating": idx.n_eq,
                "time": int(m["time"]),
            }

    def historical_roots(self) -> List[bytes]:
        """State roots servable from the newest artifact (stream order,
        oldest first)."""
        with self._lock:
            idx = self._current()
            return list(idx.tree_order) if idx is not None else []

    def _chunk(self, idx, eid, gindex) -> bytes:
        return streamproof.node_root_at(
            idx.mapped.buf, idx.entries, eid, gindex)

    def _list_len(self, idx, eid, field: str) -> int:
        g = get_generalized_index(self.spec.BeaconState, field, "__len__")
        return _u64(self._chunk(idx, eid, g), 0)

    def balance_of(self, validator_index: int,
                   state_root: Optional[bytes] = None) -> Optional[int]:
        """One validator's balance: a single packed-chunk descent."""
        i = int(validator_index)
        with self._lock:
            idx = self._current()
            if idx is None:
                stats["queries_unserved"] += 1
                return None
            sr, eid = self._resolve(idx, state_root)
            if eid is None or i >= self._list_len(idx, eid, "balances"):
                stats["queries_unserved"] += 1
                return None
            g = get_generalized_index(self.spec.BeaconState, "balances", i)
            chunk = self._chunk(idx, eid, g)
            stats["queries_served"] += 1
            return int.from_bytes(chunk[(i % 4) * 8:(i % 4) * 8 + 8],
                                  "little")

    _STATUS_FIELDS = ("effective_balance", "activation_eligibility_epoch",
                      "activation_epoch", "exit_epoch", "withdrawable_epoch")

    def validator_status(self, validator_index: int,
                         state_root: Optional[bytes] = None) -> Optional[dict]:
        """One validator's lifecycle fields: a handful of chunk reads
        under the registry leaf — the state is never materialized."""
        i = int(validator_index)
        with self._lock:
            idx = self._current()
            if idx is None:
                stats["queries_unserved"] += 1
                return None
            sr, eid = self._resolve(idx, state_root)
            if eid is None or i >= self._list_len(idx, eid, "validators"):
                stats["queries_unserved"] += 1
                return None
            typ = self.spec.BeaconState
            out = {"index": i}
            for field in self._STATUS_FIELDS:
                g = get_generalized_index(typ, "validators", i, field)
                out[field] = _u64(self._chunk(idx, eid, g), 0)
            g = get_generalized_index(typ, "validators", i, "slashed")
            out["slashed"] = bool(self._chunk(idx, eid, g)[0])
            stats["queries_served"] += 1
            return out

    def proof_of_validator(self, validator_index: int,
                           state_root: Optional[bytes] = None) -> Optional[dict]:
        """A single-validator Merkle proof off the mmap'd tree stream,
        verified in-engine against the stored state root before it is
        served.  ``branch`` is leaf-side first (``is_valid_merkle_branch``
        / ``ssz.gindex.build_proof`` ordering)."""
        i = int(validator_index)
        with self._lock:
            idx = self._current()
            if idx is None:
                stats["queries_unserved"] += 1
                return None
            sr, eid = self._resolve(idx, state_root)
            if eid is None or i >= self._list_len(idx, eid, "validators"):
                stats["queries_unserved"] += 1
                return None
            g = get_generalized_index(self.spec.BeaconState, "validators", i)
            key = (idx.path, sr, g)
            cached = self._proof_cache.get(key)
            if cached is not None:
                self._proof_cache.move_to_end(key)
                stats["proof_cache_hits"] += 1
                leaf, branch = cached
            else:
                stats["proof_cache_misses"] += 1
                leaf, branch = streamproof.proof_at(
                    idx.mapped.buf, idx.entries, eid, g)
                self._proof_cache[key] = (leaf, branch)
                while len(self._proof_cache) > self._proof_cache_cap:
                    self._proof_cache.popitem(last=False)
            # the chaos probe models a poisoned serving buffer: the
            # in-engine verification below must catch it — a QueryError,
            # never a wrong proof
            leaf = _SITE_PROOF(leaf)
            if not streamproof.verify_proof(leaf, branch, g, sr):
                stats["faults_in"] += 1
                raise QueryError(
                    f"proof for validator {i} failed verification "
                    f"against state root {sr.hex()[:16]}")
            stats["proofs_served"] += 1
            stats["queries_served"] += 1
            return {"validator_index": i, "gindex": g, "leaf": leaf,
                    "branch": branch, "state_root": sr}

    def vote_of(self, validator_index: int) -> Optional[dict]:
        """The validator's latest message, by binary search over the
        packed (u64 index, u64 epoch, root) table on the map."""
        i = int(validator_index)
        with self._lock:
            idx = self._current()
            if idx is None:
                stats["queries_unserved"] += 1
                return None
            buf, base = idx.mapped.buf, idx.lm_off
            lo, hi = 0, idx.n_lm
            while lo < hi:
                mid = (lo + hi) // 2
                v = _u64(buf, base + 48 * mid)
                if v < i:
                    lo = mid + 1
                elif v > i:
                    hi = mid
                else:
                    off = base + 48 * mid
                    stats["queries_served"] += 1
                    return {"validator_index": i,
                            "epoch": _u64(buf, off + 8),
                            "root": bytes(buf[off + 16:off + 48])}
            stats["queries_served"] += 1
            return None

    def state_at_root(self, state_root: Optional[bytes] = None):
        """A materialized historical state, through the bounded resident
        set: a miss re-faults off the artifact (decode in stream order —
        REFs point backward across the window's trees)."""
        with self._lock:
            idx = self._current()
            if idx is None:
                stats["queries_unserved"] += 1
                return None
            sr, eid = self._resolve(idx, state_root)
            if eid is None:
                stats["queries_unserved"] += 1
                return None
            try:
                state = self._resident.get(
                    sr, lambda: self._materialize(idx, sr))
            except (CheckpointError, faults.InjectedFault,
                    faults.InjectedBackendCrash) as exc:
                # a failed refault (damage or the chaos probe) never
                # installed anything: the resident set is coherent and
                # the next query re-faults honestly
                stats["faults_in"] += 1
                raise QueryError(str(exc)) from exc
            stats["queries_served"] += 1
            return state

    def _materialize(self, idx: _ArtifactIndex, state_root: bytes):
        stats["state_materializations"] += 1
        nodes: List[Optional[object]] = []
        buf, off = idx.mapped.buf, idx.tree_off
        for root in idx.tree_order:
            backing, off = decode_tree(buf, off, nodes)
            if root == state_root:
                return self.spec.BeaconState.view_from_backing(backing)
        raise CheckpointError("state root missing from tree streams")
